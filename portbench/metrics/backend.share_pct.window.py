"""backend.share_pct.window (%): the share of the untraced window the host
spent in the back end's own work: the spans `posegraph.observe` (a
keyframe round: loop detection, the candidates' ICP, the relaxation and
the feedback, children included) less their `posegraph.read` children
(the host reads of the round's pose and cloud, which wait for the rounds
queued on the device: the round's time, not the back end's), and
`runner.correction` (the correction applied to the filter's carry), summed
over the window and divided by it (core/program_trace.py)."""
import numpy as np

from portbench.core import program_trace


def _total(run, cell, name):
    sp = program_trace.spans(run, cell, name)
    return None if sp is None else int(np.sum(sp["end"] - sp["start"]))


def read(run, cell):
    observe = _total(run, cell, "posegraph.observe")
    if observe is None:
        return None
    total = observe - (_total(run, cell, "posegraph.read") or 0)
    total += _total(run, cell, "runner.correction") or 0
    lo, hi = program_trace.window_ns(run, cell)
    return 100.0 * total / (hi - lo)
