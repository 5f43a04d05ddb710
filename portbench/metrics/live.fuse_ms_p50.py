"""live.fuse_ms_p50 (ms): the median host time of the push that fuses a
round, from the grouping decision through the padding, the stacking, the
upload and pipeline.step returning (the program's `online.fuse` spans,
malio_tpu_torch/trace.py), over the window up to its first traced
stretch. Logs the live path's spans (median ms, median self ms, count)
on an earlier line."""
import json

import numpy as np

from portbench.core import program_trace
from portbench.core.bench import log


def read(run, cell):
    table = program_trace.span_table(run, cell, "online.")
    if table:
        log("live spans: " + json.dumps(table))
    sp = program_trace.spans(run, cell, "online.fuse")
    return None if sp is None else float(np.median(sp["end"] - sp["start"])) / 1e6
