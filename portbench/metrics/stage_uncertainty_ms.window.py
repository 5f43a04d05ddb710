"""stage_uncertainty_ms.window (ms): the median device time of the round's
`uncertainty` stage over the untraced window: the per-LiDAR and per-
epoch pose-uncertainty composition; the interval between its two stamps
(malio_tpu_torch/trace.py) in each round replay."""
from portbench.core import program_trace


def read(run, cell):
    return program_trace.stage_ms(run, cell, "uncertainty")
