"""stage_downsample_ms.window (ms): the median device time of the round's
`downsample` stage over the untraced window: the per-LiDAR voxel
downsample; the interval between its two stamps
(malio_tpu_torch/trace.py) in each round replay."""
from portbench.core import program_trace


def read(run, cell):
    return program_trace.stage_ms(run, cell, "downsample")
