"""Host loop: IMU initialization + sequence replay over `pipeline.step`
(counterpart of malio_tpu/runner.py; laserMapping.cpp:831-1082). The first
round is skipped, IMU statistics accumulate until more than 10 samples,
then the filter is seeded and the fusion step takes over: a chunk at a
time through `pipeline.scan_steps`, or round by round where observers or
a callback need every round.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from . import state as st
from . import pipeline
from . import propagate as prop


@dataclasses.dataclass
class ImuInitializer:
    """Running mean/cov of the first IMU samples (IMU_Processing.hpp:147-208)."""

    n: int = 0
    mean_acc: np.ndarray = None
    mean_gyr: np.ndarray = None
    cov_acc: np.ndarray = None
    cov_gyr: np.ndarray = None

    def __post_init__(self):
        self.mean_acc = np.zeros(3)
        self.mean_gyr = np.zeros(3)
        self.cov_acc = np.full(3, 0.1)
        self.cov_gyr = np.full(3, 0.1)

    def update(self, imu, mask):
        for row, m in zip(imu, mask):
            if not m:
                continue
            gyr, acc = row[1:4], row[4:7]
            if self.n == 0:
                self.mean_acc = acc.copy()
                self.mean_gyr = gyr.copy()
                self.n = 1
            N = self.n
            self.mean_acc += (acc - self.mean_acc) / N
            self.mean_gyr += (gyr - self.mean_gyr) / N
            self.cov_acc = self.cov_acc * (N - 1.0) / N + (acc - self.mean_acc) ** 2 * (N - 1.0) / (N * N)
            self.cov_gyr = self.cov_gyr * (N - 1.0) / N + (gyr - self.mean_gyr) ** 2 * (N - 1.0) / (N * N)
            self.n += 1

    @property
    def done(self):
        return self.n > 10  # MAX_INI_COUNT


def initial_state(cfg, init: ImuInitializer, dtype=torch.float32, device="cuda") -> st.State:
    dev = pipeline.resolve_device(device)
    L = cfg.num_lidars
    x = st.identity_state(L, dtype, dev)
    ext_t = torch.as_tensor(np.asarray(cfg.extrinsic_T, np.float64).reshape(L, 3), dtype=dtype, device=dev)
    ext_q = torch.as_tensor(np.asarray(cfg.extrinsic_R, np.float64).reshape(L, 4), dtype=dtype, device=dev)
    ext_q = ext_q / torch.linalg.norm(ext_q, dim=-1, keepdim=True)
    grav = -init.mean_acc / np.linalg.norm(init.mean_acc) * st.S2_LENGTH
    return x._replace(
        ext_r=ext_q, ext_t=ext_t,
        bg=torch.as_tensor(init.mean_gyr, dtype=dtype, device=dev),
        grav=torch.as_tensor(grav, dtype=dtype, device=dev),
    )


def initial_covariance(cfg, dtype=torch.float32, device="cuda"):
    """P init: pose 1, ext+vel 1e-6 (ext from cfg.ext_cov_init), bg 1e-4,
    ba 1e-3, grav 1e-5."""
    dev = pipeline.resolve_device(device)
    n = st.dof(cfg.num_lidars)
    d = np.ones(n)
    d[6 : n - 8] = 1e-6
    d[6 : 6 + 6 * cfg.num_lidars] = cfg.ext_cov_init
    d[n - 8 : n - 5] = 1e-4
    d[n - 5 : n - 2] = 1e-3
    d[n - 2 :] = 1e-5
    return torch.as_tensor(np.diag(d), dtype=dtype, device=dev)


def process_noise(cfg, init: ImuInitializer, dtype=torch.float32, device="cuda"):
    """Q = diag([gyr, acc, b_gyr, b_acc]); gyr/acc measured in the IMU-init
    window ("measured", the reference quirk) or taken from the config."""
    dev = pipeline.resolve_device(device)
    if cfg.imu_noise_source == "config":
        gyr, acc = np.full(3, cfg.gyr_cov), np.full(3, cfg.acc_cov)
    elif cfg.imu_noise_source == "measured":
        gyr, acc = init.cov_gyr, init.cov_acc
    else:
        raise ValueError(
            f"imu_noise_source must be 'measured' or 'config', got {cfg.imu_noise_source!r}"
        )
    d = np.concatenate([gyr, acc, np.full(3, cfg.b_gyr_cov), np.full(3, cfg.b_acc_cov)])
    return torch.as_tensor(np.diag(d), dtype=dtype, device=dev)


def seed_carry(cfg, init: ImuInitializer, prev_last_imu, base0: float, dtype, device):
    """The first fused round's carry once the IMU statistics are done:
    state, covariance and process noise from them, and the last IMU
    sample before that round with its stamp moved onto the round's time
    origin base0 (times are rebased per group)."""
    x0 = initial_state(cfg, init, dtype, device)
    P0 = initial_covariance(cfg, dtype, device)
    Q = process_noise(cfg, init, dtype, device)
    carry = pipeline.init_carry(cfg, x0, P0, Q, dtype, device)
    last_imu = torch.as_tensor(np.asarray(prev_last_imu, np.float64), dtype=dtype, device=device)
    last_imu[0] += torch.tensor(-base0, dtype=dtype, device=device)
    return carry._replace(
        mean_acc_norm=torch.tensor(np.linalg.norm(init.mean_acc), dtype=dtype, device=device),
        last_imu=last_imu,
    )


def group_base(g):
    """Per-group time base (f64): the earliest scan begin."""
    return float(np.min(np.asarray(g["beg_t"], np.float64)))


def _chunk_arrays(chunk, dtype, prev_base):
    """Host group dicts stacked into the MeasureGroup fields as numpy
    arrays (leading axis K), rebased to per-group time origins in f64
    before the cast to `dtype`. Returns (field -> array, per-group bases)."""
    bases = np.asarray([group_base(g) for g in chunk], np.float64)
    shifts = np.diff(np.concatenate([[prev_base], bases]))
    pts = np.stack([np.asarray(g["pts"], np.float64) for g in chunk])
    pts[..., 3] -= bases[:, None, None]
    imu = np.stack([np.asarray(g["imu"], np.float64) for g in chunk])
    imu[..., 0] -= bases[:, None]
    cont = np.stack([np.asarray(g["imu_cont"], np.float64) for g in chunk])
    cont[..., 0] -= bases[:, None]
    beg = np.stack([np.asarray(g["beg_t"], np.float64) for g in chunk]) - bases[:, None]
    end = np.stack([np.asarray(g["end_t"], np.float64) for g in chunk]) - bases[:, None]

    def mask(key):
        return np.stack([np.asarray(g[key], bool) for g in chunk])

    arrays = dict(
        pts=pts.astype(dtype), pts_mask=mask("pts_mask"), beg_t=beg.astype(dtype),
        end_t=end.astype(dtype), imu=imu.astype(dtype), imu_mask=mask("imu_mask"),
        imu_cont=cont.astype(dtype), imu_cont_mask=mask("imu_cont_mask"),
        t_shift=shifts.astype(dtype),
    )
    return arrays, bases


def _stack_chunk(chunk, dtype, prev_base, device):
    """Stack host group dicts into one batched MeasureGroup (leading axis
    K), rebased to per-group time origins in f64 before the cast, and
    moved to the device in one transfer per field.
    Returns (device group, per-group bases)."""
    arrays, bases = _chunk_arrays(chunk, dtype, prev_base)
    return prop.MeasureGroup(**{k: torch.as_tensor(a).to(device) for k, a in arrays.items()}), bases


_SMALL = ("pos", "quat", "pose_cov", "end_time", "iterations", "n_effective",
          "map_size", "map_dropped", "nn_miss", "n_meas_dropped")


def run_sequence(cfg, groups: Iterable[dict], dtype=torch.float32, device="cuda",
                 callback=None, smoother=None, posegraph=None, prefetch_chunk: int = 16):
    """Replay measure groups through the pipeline. Returns a dict with the
    trajectory (t, pos, quat), per-round diagnostics and the final carry.

    With no hooks a full chunk of `prefetch_chunk` rounds runs through
    `pipeline.scan_steps`; hooks and the partial last chunk go round by
    round. `callback(carry, out, t_base)` runs after every round.
    `smoother` and `posegraph` are observers (WindowSmoother,
    PoseGraphBackend): `observe(out, t_base)` every round, `trajectory()`
    at the end (keys "smoothed" and "graph"). A correction the posegraph
    stages (`take_correction()`, after a loop closure) re-anchors the
    carry through `pipeline.apply_world_correction`."""
    dev = pipeline.resolve_device(device)
    groups = list(groups)
    init = ImuInitializer()
    carry = None
    last_imu_seed = np.zeros(7)

    def _track_last_imu(g):
        m = np.asarray(g["imu_mask"])
        if m.any():
            return np.asarray(g["imu"], np.float64)[m.nonzero()[0][-1]]
        return last_imu_seed

    start = 0
    for gi, g in enumerate(groups):
        prev_last_imu = last_imu_seed
        last_imu_seed = _track_last_imu(g)
        if gi > 0 and init.done:
            carry = seed_carry(cfg, init, prev_last_imu, group_base(groups[gi]), dtype, dev)
            start = gi
            break
        init.update(np.asarray(g["imu"], np.float64), g["imu_mask"])

    def observed():
        return dict(smoothed=smoother.trajectory() if smoother is not None else None,
                    graph=posegraph.trajectory() if posegraph is not None else None)

    if carry is None:
        return dict(t=np.zeros(0), pos=np.zeros((0, 3)), quat=np.zeros((0, 4)),
                    iterations=np.zeros(0, int), n_effective=np.zeros(0, int),
                    map_size=np.zeros(0, int), carry=None, **observed())

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    outs = []
    prev_base = group_base(groups[start])
    use_scan = callback is None and smoother is None and posegraph is None
    for c0 in range(start, len(groups), prefetch_chunk):
        chunk = groups[c0 : c0 + prefetch_chunk]
        gdev, bases = _stack_chunk(chunk, np_dtype, prev_base, dev)
        prev_base = float(bases[-1])
        chunk_outs = []
        if use_scan and len(chunk) == prefetch_chunk:
            carry, stacked = pipeline.scan_steps(cfg, carry, gdev, device=dev)
            for k in range(len(chunk)):
                chunk_outs.append(({f: getattr(stacked, f)[k] for f in _SMALL}, float(bases[k])))
        for k in range(len(chunk_outs), len(chunk)):
            group = prop.MeasureGroup(*(a[k] for a in gdev))
            carry, out = pipeline.step(cfg, carry, group, device=dev)
            chunk_outs.append(({f: getattr(out, f) for f in _SMALL}, float(bases[k])))
            if smoother is not None:
                smoother.observe(out, t_base=float(bases[k]))
            if posegraph is not None:
                posegraph.observe(out, t_base=float(bases[k]))
                corr = posegraph.take_correction() if hasattr(posegraph, "take_correction") else None
                if corr is not None:
                    # loop closure: re-anchor state, P, history, map and
                    # box onto the graph-corrected frame
                    dq, dtv = (torch.as_tensor(np.asarray(c), dtype=dtype, device=dev)
                               for c in corr)
                    carry = pipeline.apply_world_correction(cfg, carry, dq, dtv)
            if callback is not None:
                callback(carry, out, float(bases[k]))
        # one host transfer per chunk (keeps per-round point clouds off
        # the host and lets the device run ahead within a chunk)
        for o, b in chunk_outs:
            rec = {f: (o[f].cpu().numpy() if torch.is_tensor(o[f]) else np.asarray(o[f])) for f in _SMALL}
            rec["end_time"] = float(rec["end_time"]) + b  # absolute time in f64
            outs.append(rec)

    def col(f, dt=None):
        return np.asarray([o[f] for o in outs], dt)

    return dict(
        t=col("end_time"), pos=col("pos"), quat=col("quat"), pose_cov=col("pose_cov"),
        iterations=col("iterations", int), n_effective=col("n_effective", int),
        map_size=col("map_size", int), map_dropped=col("map_dropped", int),
        nn_miss=col("nn_miss", int), n_meas_dropped=col("n_meas_dropped", int),
        carry=carry, **observed(),
    )
