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
    origin base0 (times are rebased per group). The stamp is moved in f64
    before the cast, as the JAX live path does (malio_tpu/online.py:266-267):
    an f32 stamp near 1.7e9 s would sit on a 128 s grid."""
    x0 = initial_state(cfg, init, dtype, device)
    P0 = initial_covariance(cfg, dtype, device)
    Q = process_noise(cfg, init, dtype, device)
    carry = pipeline.init_carry(cfg, x0, P0, Q, dtype, device)
    last = np.array(prev_last_imu, np.float64)
    last[0] -= base0
    last_imu = torch.as_tensor(last, dtype=dtype, device=device)
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

