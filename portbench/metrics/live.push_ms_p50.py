"""live.push_ms_p50 (ms): the median host time of a push_imu or push_scan
(the grouping, the IMU gate and, on the push that fuses a round, its
assembly and launch), from the benchmark's host-clock spans around each
call, over the window up to its traced stretch (modes/live.py)."""
import numpy as np


def read(run, cell):
    v = run.get("spans", {}).get("live.push_ms")
    return float(np.median(v)) if v else None
