"""stage_update_ms.window (ms): the median device time of the round's
`update` stage over the untraced window: the k-NN search and plane fits
(make_h_share), the iterated update and the select; the interval between
its two stamps (malio_tpu_torch/trace.py) in each round replay."""
from portbench.core import program_trace


def read(run, cell):
    return program_trace.stage_ms(run, cell, "update")
