"""A cell cut to a size the CPU runs in seconds, for the tests: a few
hundred points a LiDAR, a 2^15-slot map, short sequences and windows,
and no ate_m limit."""
from __future__ import annotations

PARAMS = dict(sequence_s=3.0, check_rounds=6, batch=4, check_sequences=4, chunk=4, tail_s=2.0,
              warmup_s=0.6, trace_s=0.5, trace_chunk=0)


def adjust(cell):
    c = cell.config["config"]
    c.update(max_raw_points=256, max_points_per_scan=192, map_capacity=1 << 15,
             knn_wide_budget=64)
    cell.config["sensors"]["points"] = [200] * c["num_lidars"]
    p = cell.workload["params"]
    for k, v in PARAMS.items():
        if k in p:
            p[k] = v
    # a few hundred points a LiDAR do not hold the odometry to the drive
    # (ate_m reads metres here), so the witness has nothing to say at this
    # size; the comparison with the reference runs in full
    cell.workload["check"].pop("ate_m", None)
