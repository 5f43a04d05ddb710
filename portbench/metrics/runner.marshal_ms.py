"""runner.marshal_ms (ms): the host time run_sequence spends stacking,
rebasing and casting chunks of groups (the self time of its
`runner.marshal` spans, malio_tpu_torch/trace.py) over the untraced
window, per fused round of the window."""
import numpy as np

from portbench.core import program_trace


def read(run, cell):
    sp = program_trace.spans(run, cell, "runner.marshal")
    if sp is None or not run.get("attempted"):
        return None
    return float(np.sum(sp["self"])) / 1e6 / run["attempted"]
