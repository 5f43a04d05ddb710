"""Dataset exporter: the inverse of the io.dataset readers (the port's copy
of the JAX package's io/export.py).

Writes a synthetic (or re-serialized) sequence as an on-disk City /
UrbanNav file-player tree — per-sensor <stamp_ns>.bin record files,
xsens_imu.csv, data_stamp.csv, optional Groundtruth.txt — using the exact
record layouts the readers (and the reference's file player,
file_player/src/ROSThread.cpp:600-1005) consume. This closes the loop
that real datasets would: `python -m malio_tpu_torch.run_dataset` can be
driven end to end (binary decode -> grouping -> assembly -> pipeline ->
ATE) without a recorded sequence.
"""
from __future__ import annotations

import pathlib

import numpy as np

from . import dataset as ds

# any fixed epoch works; realistic magnitude exercises the f64->relative
# rebasing exactly like real data does
EPOCH_NS = 1_600_000_000 * 10**9


def _ouster_records(rel_pts):
    r = np.zeros(rel_pts.shape[0], ds.OUSTER_DTYPE)
    r["x"], r["y"], r["z"] = rel_pts[:, 0], rel_pts[:, 1], rel_pts[:, 2]
    r["intensity"] = 100.0
    r["ring"] = np.arange(rel_pts.shape[0]) % 128
    r["t"] = np.round(rel_pts[:, 3] * 1e9).astype(np.uint64).astype(np.uint32)
    return r


def _livox_records(rel_pts, n_scans):
    r = np.zeros(rel_pts.shape[0], ds.LIVOX_DTYPE)
    r["x"], r["y"], r["z"] = rel_pts[:, 0], rel_pts[:, 1], rel_pts[:, 2]
    r["reflectivity"] = 100
    r["tag"] = 0x10  # passes the (tag & 0x30) gate (preprocess.cpp:82)
    r["line"] = np.arange(rel_pts.shape[0]) % n_scans
    r["offset_time"] = (
        np.round(rel_pts[:, 3] * 1e9).astype(np.uint64).astype(np.uint32)
    )
    return r


def _velodyne_records(rel_pts):
    r = np.zeros(rel_pts.shape[0], ds.VELODYNE_DTYPE)
    r["x"], r["y"], r["z"] = rel_pts[:, 0], rel_pts[:, 1], rel_pts[:, 2]
    r["intensity"] = 100.0
    r["ring"] = np.arange(rel_pts.shape[0]) % 16
    r["time"] = rel_pts[:, 3].astype(np.float32)  # seconds (unit scale 1e3->ms)
    return r


def write_dataset(
    root,
    imu,
    rounds,
    sensors,
    n_scans=None,
    traj=None,
    gt_rate=100.0,  # >=100 Hz so arbitrary scan-end stamps associate
    # within eval.ate.associate's 0.02 s window
    epoch_ns=EPOCH_NS,
):
    """Write a file-player tree under `root`.

    imu: (N, 7) [t_rel_sec, gyro, acc]; rounds: list over rounds of list
    over LiDARs of dicts (beg_t, end_t, pts (P,4) with ABSOLUTE
    sequence-relative per-point times in col 3) — the exact shape
    io.synthetic.SyntheticSequence.generate returns. sensors: one sensor
    key per LiDAR slot (ds.SENSOR_DIRS). traj: optional trajectory object
    with .pos(t) for Groundtruth.txt (TUM, absolute stamps)."""
    root = pathlib.Path(root)
    sd = root / "sensor_data"
    stamp_rows = []

    for l, sensor in enumerate(sensors):
        dirname, _ = ds.SENSOR_DIRS[sensor]
        d = sd / dirname
        d.mkdir(parents=True, exist_ok=True)
        for rnd in rounds:
            s = rnd[l]
            stamp = epoch_ns + int(round(s["beg_t"] * 1e9))
            rel = s["pts"].copy()
            rel[:, 3] -= s["beg_t"]
            if sensor == "ouster":
                recs = _ouster_records(rel)
            elif sensor.startswith("livox"):
                recs = _livox_records(rel, 8 if n_scans is None else n_scans[l])
            else:
                recs = _velodyne_records(rel)
            recs.tofile(d / f"{stamp}.bin")
            # data_stamp names are the reference's dispatch keys
            # ("ouster"/"livox_avia"/... , ROSThread.cpp:440-456), not the
            # on-disk directory names
            stamp_rows.append((stamp, sensor))

    # xsens_imu.csv, 11-column format (stamp, quat wxyz, gyro, acc)
    lines = []
    for row in np.asarray(imu, np.float64):
        stamp = epoch_ns + int(round(row[0] * 1e9))
        vals = [str(stamp), "1", "0", "0", "0"] + [f"{v:.9f}" for v in row[1:7]]
        lines.append(",".join(vals))
        stamp_rows.append((stamp, "imu"))
    (sd / "xsens_imu.csv").write_text("\n".join(lines) + "\n")

    # data_stamp.csv (global stamp -> sensor multimap, ROSThread.cpp:179-187)
    stamp_rows.sort()
    (sd / "data_stamp.csv").write_text(
        "\n".join(f"{s},{n}" for s, n in stamp_rows) + "\n"
    )

    if traj is not None:
        from ..eval import ate
        from ..io.synthetic import SyntheticSequence

        tg = np.arange(0.0, float(np.asarray(imu)[-1, 0]), 1.0 / gt_rate)
        pos = traj.pos(tg)
        yaw = SyntheticSequence.rot_angles(traj, tg)
        quat = np.stack(
            [np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], axis=-1
        )
        ate.write_tum(root / "Groundtruth.txt", tg + epoch_ns * 1e-9, pos, quat)
    return root
