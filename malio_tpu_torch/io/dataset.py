"""Readers for the MA-LIO City / UrbanNav file-player dataset layout (the
port's copy of the JAX package's io/dataset.py).

Record formats re-derived from the file player's decoders
(file_player/src/ROSThread.cpp):

  sensor_data/ouster/<stamp_ns>.bin      x,y,z f32 | intensity f32 |
                                         ring u16 | t u32 (ns)     (:940-960)
  sensor_data/Livox_avia/<stamp>.bin     x,y,z f32 | reflectivity u8 |
  sensor_data/Livox_tele/<stamp>.bin     tag u8 | line u8 | offset u32 (ns)
                                                                    (:780-818)
  sensor_data/VLP_left|right/<stamp>.bin x,y,z f32 | intensity f32 |
                                         ring u16 | time f32 (s)    (:616-623)
  sensor_data/xsens_imu.csv              stamp,q(4)[,euler(3),gyro(3),acc(3)
                                         [,mag(3)]] 8/11/17 cols   (:254-363)
  sensor_data/data_stamp.csv             stamp_ns,sensor_name       (:179-187)

Preprocess semantics re-derived from preprocess.cpp:
  Ouster  (:105-146): keep i % point_filter_num == 0, blind-range filter,
          per-point time = t ns -> ms (curvature), scan end = max time
  Livox   (:59-103):  line < N_SCANS and (tag & 0x30) in {0x00, 0x10};
          decimate by running valid count; time = offset/1e6 ms, drop >100ms;
          drop consecutive near-duplicates
  Velodyne(:148-212): time field * unit scale -> ms, decimate, blind
"""
from __future__ import annotations

import pathlib

import numpy as np

OUSTER_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
        ("ring", "<u2"), ("t", "<u4"),
    ]
)
LIVOX_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("reflectivity", "u1"),
        ("tag", "u1"), ("line", "u1"), ("offset_time", "<u4"),
    ]
)
VELODYNE_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
        ("ring", "<u2"), ("time", "<f4"),
    ]
)

SENSOR_DIRS = {
    "ouster": ("ouster", OUSTER_DTYPE),
    "livox_avia": ("Livox_avia", LIVOX_DTYPE),
    "livox_tele": ("Livox_tele", LIVOX_DTYPE),
    "vlp_left": ("VLP_left", VELODYNE_DTYPE),
    "vlp_right": ("VLP_right", VELODYNE_DTYPE),
}

# lid_type codes (preprocess.h:15)
AVIA, VELO16, OUST64 = 1, 2, 3

# TIME_UNIT enum (preprocess.h:16) -> scale of the raw per-point time field
# into milliseconds (preprocess.cpp:23-39): SEC=0, MS=1, US=2, NS=3
TIME_UNIT_SCALE = {0: 1e3, 1: 1.0, 2: 1e-3, 3: 1e-6}


def read_imu_csv(path):
    """xsens_imu.csv -> (N, 7) [t_sec, gyro(3), acc(3)], absolute seconds.

    Handles the 11- and 17-column row formats (8-column rows carry no
    gyro/acc and are skipped)."""
    ts, gyr, acc = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) == 11:
                stamp = int(parts[0])
                g = [float(v) for v in parts[5:8]]
                a = [float(v) for v in parts[8:11]]
            elif len(parts) == 17:
                stamp = int(parts[0])
                g = [float(v) for v in parts[5:8]]
                a = [float(v) for v in parts[8:11]]
            else:
                continue
            ts.append(stamp * 1e-9)
            gyr.append(g)
            acc.append(a)
    if not ts:
        return np.zeros((0, 7))
    return np.concatenate(
        [
            np.asarray(ts)[:, None],
            np.asarray(gyr),
            np.asarray(acc),
        ],
        axis=1,
    )


def _read_records(path, dtype):
    raw = np.fromfile(path, dtype=np.uint8)
    n = raw.size // dtype.itemsize
    return raw[: n * dtype.itemsize].view(dtype)


def decode_ouster(path, point_filter_num=1, blind=0.0, time_unit_scale=1e3):
    """-> (pts (N,4) [x,y,z,t_rel_sec], duration_sec). preprocess.cpp:105-146."""
    r = _read_records(path, OUSTER_DTYPE)
    keep = np.arange(r.size) % point_filter_num == 0
    xyz = np.stack([r["x"], r["y"], r["z"]], axis=-1)
    rng2 = np.sum(xyz * xyz, axis=-1)
    keep &= rng2 >= blind * blind
    t_ms = r["t"].astype(np.float64) * time_unit_scale * 1e-9
    pts = np.concatenate([xyz[keep], (t_ms[keep] / 1e3)[:, None]], axis=1)
    dur = float(t_ms[keep].max() / 1e3) if keep.any() else 0.0
    return pts.astype(np.float64), dur


def decode_livox(path, point_filter_num=1, n_scans=8, blind=0.0):
    """-> (pts (N,4), duration). preprocess.cpp:59-103 incl. tag filter."""
    r = _read_records(path, LIVOX_DTYPE)
    if r.size == 0:
        return np.zeros((0, 4)), 0.0
    tag_ok = ((r["tag"] & 0x30) == 0x10) | ((r["tag"] & 0x30) == 0x00)
    line_ok = r["line"] < n_scans
    valid = tag_ok & line_ok
    valid[0] = False  # reference loop starts at i=1
    vnum = np.cumsum(valid)
    keep = valid & (vnum % point_filter_num == 0)
    t_ms = r["offset_time"].astype(np.float64) / 1e6
    keep &= t_ms <= 100.0
    xyz = np.stack([r["x"], r["y"], r["z"]], axis=-1)
    # consecutive near-duplicate rejection + blind (preprocess.cpp:96)
    prev = np.roll(xyz, 1, axis=0)
    diff_ok = np.any(np.abs(xyz - prev) > 1e-7, axis=-1)
    rng2 = np.sum(xyz * xyz, axis=-1)
    keep &= diff_ok & (rng2 > blind * blind)
    pts = np.concatenate([xyz[keep], (t_ms[keep] / 1e3)[:, None]], axis=1)
    dur = float(t_ms[keep].max() / 1e3) if keep.any() else 0.0
    return pts.astype(np.float64), dur


def decode_velodyne(path, point_filter_num=1, blind=0.0, time_unit_scale=1e3):
    """-> (pts (N,4), duration). preprocess.cpp:148-212."""
    r = _read_records(path, VELODYNE_DTYPE)
    keep = np.arange(r.size) % point_filter_num == 0
    xyz = np.stack([r["x"], r["y"], r["z"]], axis=-1)
    rng2 = np.sum(xyz * xyz, axis=-1)
    keep &= rng2 > blind * blind
    t_ms = r["time"].astype(np.float64) * time_unit_scale
    pts = np.concatenate([xyz[keep], (t_ms[keep] / 1e3)[:, None]], axis=1)
    dur = float(t_ms[keep].max() / 1e3) if keep.any() else 0.0
    return pts.astype(np.float64), dur


def list_scan_files(root, sensor):
    d, _ = SENSOR_DIRS[sensor]
    p = pathlib.Path(root) / "sensor_data" / d
    files = sorted(p.glob("*.bin"), key=lambda q: int(q.stem))
    return files


def group_rounds_by_time(stamps_per_stream, period=None):
    """Timestamp-proximity round grouping (ApproximateTime semantics,
    laserMapping.cpp:902-913): for each round, the pivot is the latest
    stream head; every stream contributes its scan CLOSEST to the pivot,
    and any file jumped over is dropped for that round only. A missing
    scan file therefore desynchronizes one round, not the rest of the
    sequence (round-1 bug: index-paired grouping drifted forever).

    stamps_per_stream: list of sorted 1-D stamp arrays (seconds).
    Returns a list of per-round index tuples (one index per stream)."""
    n_streams = len(stamps_per_stream)
    if period is None:
        diffs = np.diff(stamps_per_stream[0])
        period = float(np.median(diffs)) if diffs.size else 0.1
    ptrs = [0] * n_streams
    rounds = []
    while all(p < len(st) for p, st in zip(ptrs, stamps_per_stream)):
        pivot = max(st[p] for p, st in zip(ptrs, stamps_per_stream))
        sel = []
        for s in range(n_streams):
            st = stamps_per_stream[s]
            i = ptrs[s]
            while i + 1 < len(st) and abs(st[i + 1] - pivot) <= abs(st[i] - pivot):
                i += 1
            sel.append(i)
        rounds.append(tuple(sel))
        ptrs = [i + 1 for i in sel]
    return rounds


def load_sequence(
    root,
    sensors,
    lid_types,
    point_filter_num,
    n_scans,
    blind=0.0,
    timestamp_unit=0,
    time_offset_lidar_to_imu=0.0,
):
    """Load a full dataset sequence -> (imu (N,7) rel-sec, rounds).

    sensors: list of sensor keys in physical-LiDAR order (e.g.
    ["ouster", "livox_avia", "livox_tele"] for City). Rounds are grouped by
    timestamp proximity (`group_rounds_by_time`). IMU stamps are shifted by
    -time_offset_lidar_to_imu (imu_cbk, laserMapping.cpp:255);
    timestamp_unit scales the raw per-point time fields (preprocess.h:16,
    parameters.cpp:52)."""
    root = pathlib.Path(root)
    imu = read_imu_csv(root / "sensor_data" / "xsens_imu.csv")
    if imu.size:
        imu = imu.copy()
        imu[:, 0] -= time_offset_lidar_to_imu
    unit_scale = TIME_UNIT_SCALE[int(timestamp_unit)]
    per = []
    for si, s in enumerate(sensors):
        files = list_scan_files(root, s)
        if not files:
            raise FileNotFoundError(
                f"no scan files for sensor '{s}' under "
                f"{root}/sensor_data/{SENSOR_DIRS[s][0]} — check the dataset "
                f"layout or use a config matching the available sensors"
            )
        stamps = np.array([int(f.stem) * 1e-9 for f in files])
        per.append((files, stamps))

    if not per:
        return imu, []

    # align: start all streams within half a period of the latest starter
    period = np.median(np.diff(per[0][1])) if len(per[0][1]) > 1 else 0.1
    t_start = max(p[1][0] for p in per)
    starts = [int(np.searchsorted(p[1], t_start - period / 2)) for p in per]
    sel_rounds = group_rounds_by_time(
        [p[1][s:] for p, s in zip(per, starts)], period=float(period)
    )

    t0 = min(imu[0, 0] if imu.size else np.inf, min(p[1][s] for p, s in zip(per, starts)))
    if imu.size:
        imu[:, 0] -= t0

    rounds = []
    for sel in sel_rounds:
        rnd = []
        for si, (s, (files, stamps), st) in enumerate(zip(sensors, per, starts)):
            f = files[st + sel[si]]
            beg = stamps[st + sel[si]] - t0
            if lid_types[si] == OUST64:
                pts, dur = decode_ouster(f, point_filter_num[si], blind, unit_scale)
            elif lid_types[si] == AVIA:
                pts, dur = decode_livox(f, point_filter_num[si], n_scans[si], blind)
            else:
                pts, dur = decode_velodyne(f, point_filter_num[si], blind, unit_scale)
            pts[:, 3] += beg  # per-point absolute relative time
            rnd.append(dict(beg_t=beg, end_t=beg + dur, pts=pts))
        rounds.append(rnd)
    return imu, rounds
