"""stage_undistort_ms.window (ms): the median device time of the round's
`undistort` stage over the untraced window: IMU propagation, the spline
deskew and the uncertainty chains (prop.undistort), and an mp rank's
gather; the interval between its two stamps (malio_tpu_torch/trace.py)
in each round replay."""
from portbench.core import program_trace


def read(run, cell):
    return program_trace.stage_ms(run, cell, "undistort")
