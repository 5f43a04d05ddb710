"""Cumulative uniform cubic SE(3) B-spline for continuous-time deskew
(counterpart of malio_tpu/spline.py; OpenVINS BsplineSE3 semantics with
control points on a fixed 0.01 s grid).

  pose(t) = P0 Exp(b0 d0) Exp(b1 d1) Exp(b2 d2),  d_j = Log(P_j^-1 P_{j+1})
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import se3, so3

CONTROL_DT = 0.01  # BsplineSE3.cpp:34


class Spline(NamedTuple):
    """Fields carry the leading batch axes of the trajectory that made the
    spline (one spline per sequence of a batch)."""

    t0: torch.Tensor  # (...,) timestamp of control point 0
    cps: torch.Tensor  # (..., C, 4, 4) control poses
    logs: torch.Tensor  # (..., C, 6) Log(cp_j^-1 cp_{j+1}) (last unused)
    num_valid: torch.Tensor  # (...,) int32 valid control points


def _finfo_max(dtype):
    return torch.finfo(dtype).max


def _rows(x, idx, trailing: int):
    """x (..., T, *tail) at indices idx (..., K) along the T axis."""
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * trailing), dim=-1 - trailing)


def feed_trajectory(times, poses_q, poses_t, valid, cap: int) -> Spline:
    """Control points from a timestamped pose list (times (..., T) with
    any leading batch axes); the last valid trajectory point is excluded,
    control point j sits at t0 + 0.01 j and interpolates its bounding
    trajectory poses linearly on SE(3)."""
    dtype = poses_t.dtype
    dev = times.device
    T = times.shape[-1]
    big = torch.full((), _finfo_max(times.dtype), dtype=times.dtype, device=dev)

    n_valid = torch.sum(valid, dim=-1)
    order = torch.argsort(torch.where(valid, times, big), dim=-1, stable=True)
    times_s = torch.take_along_dim(times, order, dim=-1)
    q_s = _rows(poses_q, order, 1)
    t_s = _rows(poses_t, order, 1)
    n_used = torch.clamp(n_valid - 1, min=0)[..., None]

    t0 = times_s[..., 0].contiguous()  # one per sequence, as the deskew kernel reads it
    cp_times = t0[..., None] + CONTROL_DT * torch.arange(cap, dtype=times.dtype, device=dev)
    masked_times = torch.where(torch.arange(T, device=dev) < n_used, times_s, big)
    hi = torch.searchsorted(masked_times.contiguous(), cp_times.contiguous(), right=True)
    cp_valid = hi < n_used
    hi_c = torch.minimum(torch.clamp(hi, min=1), torch.clamp(n_used - 1, min=1))
    lo_c = hi_c - 1

    T_lo = se3.make_se3(_rows(q_s, lo_c, 1), _rows(t_s, lo_c, 1))
    T_hi = se3.make_se3(_rows(q_s, hi_c, 1), _rows(t_s, hi_c, 1))
    t_lo = torch.take_along_dim(masked_times, lo_c, dim=-1)
    t_hi = torch.take_along_dim(masked_times, hi_c, dim=-1)
    lam = torch.where(
        t_hi > t_lo, (cp_times - t_lo) / torch.clamp(t_hi - t_lo, min=1e-12),
        torch.zeros_like(t_lo),
    ).to(dtype)
    delta = se3.log_se3(T_hi @ se3.inv_se3(T_lo))
    cps = se3.exp_se3(lam[..., None] * delta) @ T_lo
    num_valid = torch.sum(cp_valid, dim=-1).to(torch.int32)
    nxt = torch.roll(cps, -1, dims=-3)
    logs = se3.log_se3(se3.inv_se3(cps) @ nxt)
    return Spline(t0=t0, cps=cps, logs=logs, num_valid=num_valid)


def interval(sp: Spline, t):
    """Interval index, clamped index, fraction and ok flag of query times
    t (..., N), the leading axes those of the spline. ok needs control
    points j-1 .. j+2 around the query."""
    # divide by a device tensor: a CUDA division by a Python scalar is a
    # multiplication by its reciprocal, which can move j at a boundary
    dt = torch.full((), CONTROL_DT, dtype=t.dtype, device=t.device)
    nv = sp.num_valid[..., None]
    rel = (t - sp.t0[..., None]) / dt
    j = torch.floor(rel).to(torch.int32)
    ok = (j >= 1) & (j + 2 <= nv - 1)
    jc = torch.minimum(torch.clamp(j, min=1), torch.clamp(nv - 3, min=1))
    u = (rel - jc).to(sp.logs.dtype)
    return jc.long(), u, ok


def get_pose(sp: Spline, t):
    """Pose at times t (..., N), the leading axes those of the spline.
    Returns (q (..., N, 4), p (..., N, 3), ok (..., N))."""
    jc, u, ok = interval(sp, t)
    b0 = (5.0 + 3.0 * u - 3.0 * u * u + u * u * u) / 6.0
    b1 = (1.0 + 3.0 * u + 3.0 * u * u - 2.0 * u * u * u) / 6.0
    b2 = (u * u * u) / 6.0
    P0 = _rows(sp.cps, jc - 1, 2)
    A0 = se3.exp_se3(b0[..., None] * _rows(sp.logs, jc - 1, 1))
    A1 = se3.exp_se3(b1[..., None] * _rows(sp.logs, jc, 1))
    A2 = se3.exp_se3(b2[..., None] * _rows(sp.logs, jc + 1, 1))
    pose = P0 @ A0 @ A1 @ A2
    return so3.mat_to_quat(pose[..., :3, :3]), pose[..., :3, 3], ok


def get_pose_batch(sp: Spline, ts):
    """Query for (..., N) times (get_pose is already batched)."""
    return get_pose(sp, ts)
