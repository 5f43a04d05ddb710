"""stage_insert_ms.window (ms): the median device time of the round's
`insert` stage over the untraced window: the insert's prefilter,
vh.insert, and the new carry and outputs; the interval between its two
stamps (malio_tpu_torch/trace.py) in each round replay."""
from portbench.core import program_trace


def read(run, cell):
    return program_trace.stage_ms(run, cell, "insert")
