"""Measure-group assembly (the port's copy of the JAX package's
io/assemble.py): deterministic replay-side reimplementation of
sync_packages (laserMapping.cpp:310-396).

Host-side NumPy producing the padded arrays of a measure group
(propagate.MeasureGroup): per physical LiDAR, one scan per round;
the IMU stream is drained up to the round's latest scan end; the
continuation window takes the last drained sample plus the next
`imu_cont_len - 1` future samples (laserMapping.cpp:377-385).
"""
from __future__ import annotations

import numpy as np


def assemble_groups(cfg, imu_records, rounds, dtype=np.float64):
    """imu_records: (N, 7) [t, gyro, acc]; rounds: list of per-LiDAR dicts
    (beg_t, end_t, pts (P,4)). Yields dicts of numpy arrays shaped for
    propagate.MeasureGroup, plus bookkeeping fields.

    A round is emitted only when enough IMU exists past its end (the 0.2 s
    gate, laserMapping.cpp:313); trailing rounds without IMU coverage are
    dropped, matching the reference's behavior at sequence end."""
    L = cfg.num_lidars
    P = cfg.max_raw_points
    I = cfg.max_imu_per_group
    IC = cfg.imu_cont_len
    # IMU timestamp regression guard (imu_cbk "imu loop back",
    # laserMapping.cpp:258-262): drop out-of-order samples
    if imu_records.shape[0] > 1:
        keep = np.concatenate([[True], np.diff(imu_records[:, 0]) > 0])
        imu_records = imu_records[keep]
    imu_t = imu_records[:, 0]
    cursor = 0  # first undrained IMU index

    out = []
    for rnd in rounds:
        assert len(rnd) == L
        end_times = np.array([s["end_t"] for s in rnd])
        lidar_end = end_times.max()
        if imu_t[-1] - lidar_end < cfg.sync_lookahead:
            break  # not enough IMU lookahead; stop (end of stream)

        hi = int(np.searchsorted(imu_t, lidar_end, side="right"))
        sel = np.arange(cursor, hi)
        n_imu = sel.size
        if n_imu > I:
            raise ValueError(f"imu window {n_imu} exceeds capacity {I}")
        imu = np.zeros((I, 7), dtype)
        imu_mask = np.zeros((I,), bool)
        imu[:n_imu] = imu_records[sel]
        imu_mask[:n_imu] = True

        # continuation: last drained + next IC-1 future samples
        cont = np.zeros((IC, 7), dtype)
        cont_mask = np.zeros((IC,), bool)
        cont_src = []
        if n_imu > 0:
            cont_src.append(imu_records[hi - 1])
        cont_src.extend(imu_records[hi : hi + IC - 1])
        nc = min(len(cont_src), IC)
        if nc:
            cont[:nc] = np.stack(cont_src[:nc])
            cont_mask[:nc] = True

        pts = np.zeros((L, P, 4), dtype)
        pts_mask = np.zeros((L, P), bool)
        beg = np.zeros((L,), dtype)
        end = np.zeros((L,), dtype)
        for l, s in enumerate(rnd):
            p = s["pts"]
            n = min(p.shape[0], P)
            pts[l, :n] = p[:n]
            pts_mask[l, :n] = True
            beg[l] = s["beg_t"]
            end[l] = s["end_t"]

        cursor = hi
        out.append(
            dict(
                pts=pts,
                pts_mask=pts_mask,
                beg_t=beg,
                end_t=end,
                imu=imu,
                imu_mask=imu_mask,
                imu_cont=cont,
                imu_cont_mask=cont_mask,
            )
        )
    return out
