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
    t0: torch.Tensor  # () timestamp of control point 0
    cps: torch.Tensor  # (C, 4, 4) control poses
    logs: torch.Tensor  # (C, 6) Log(cp_j^-1 cp_{j+1}) (last unused)
    num_valid: torch.Tensor  # () int32 valid control points


def _finfo_max(dtype):
    return torch.finfo(dtype).max


def feed_trajectory(times, poses_q, poses_t, valid, cap: int) -> Spline:
    """Control points from a timestamped pose list; the last valid
    trajectory point is excluded, control point j sits at t0 + 0.01 j and
    interpolates its bounding trajectory poses linearly on SE(3)."""
    dtype = poses_t.dtype
    dev = times.device
    T = times.shape[0]
    big = torch.tensor(_finfo_max(times.dtype), dtype=times.dtype, device=dev)

    n_valid = torch.sum(valid)
    order = torch.argsort(torch.where(valid, times, big), stable=True)
    times_s = times[order]
    q_s = poses_q[order]
    t_s = poses_t[order]
    n_used = torch.clamp(n_valid - 1, min=0)

    t0 = times_s[0]
    cp_times = t0 + CONTROL_DT * torch.arange(cap, dtype=times.dtype, device=dev)
    masked_times = torch.where(torch.arange(T, device=dev) < n_used, times_s, big)
    hi = torch.searchsorted(masked_times, cp_times, right=True)
    cp_valid = hi < n_used
    hi_c = torch.minimum(torch.clamp(hi, min=1), torch.clamp(n_used - 1, min=1))
    lo_c = hi_c - 1

    T_lo = se3.make_se3(q_s[lo_c], t_s[lo_c])
    T_hi = se3.make_se3(q_s[hi_c], t_s[hi_c])
    t_lo = masked_times[lo_c]
    t_hi = masked_times[hi_c]
    lam = torch.where(
        t_hi > t_lo, (cp_times - t_lo) / torch.clamp(t_hi - t_lo, min=1e-12),
        torch.zeros_like(t_lo),
    ).to(dtype)
    delta = se3.log_se3(T_hi @ se3.inv_se3(T_lo))
    cps = se3.exp_se3(lam[:, None] * delta) @ T_lo
    num_valid = torch.sum(cp_valid).to(torch.int32)
    nxt = torch.roll(cps, -1, dims=0)
    logs = se3.log_se3(se3.inv_se3(cps) @ nxt)
    return Spline(t0=t0, cps=cps, logs=logs, num_valid=num_valid)


def interval(sp: Spline, t):
    """Interval index, clamped index, fraction and ok flag of query times.
    ok needs control points j-1 .. j+2 around the query."""
    # divide by a device tensor: a CUDA division by a Python scalar is a
    # multiplication by its reciprocal, which can move j at a boundary
    dt = torch.full((), CONTROL_DT, dtype=t.dtype, device=t.device)
    rel = (t - sp.t0) / dt
    j = torch.floor(rel).to(torch.int32)
    ok = (j >= 1) & (j + 2 <= sp.num_valid - 1)
    jc = torch.minimum(torch.clamp(j, min=1), torch.clamp(sp.num_valid - 3, min=1))
    u = (rel - jc).to(sp.logs.dtype)
    return jc.long(), u, ok


def get_pose(sp: Spline, t):
    """Pose at time(s) t (any shape). Returns (q (...,4), p (...,3), ok)."""
    jc, u, ok = interval(sp, t)
    b0 = (5.0 + 3.0 * u - 3.0 * u * u + u * u * u) / 6.0
    b1 = (1.0 + 3.0 * u + 3.0 * u * u - 2.0 * u * u * u) / 6.0
    b2 = (u * u * u) / 6.0
    P0 = sp.cps[jc - 1]
    A0 = se3.exp_se3(b0[..., None] * sp.logs[jc - 1])
    A1 = se3.exp_se3(b1[..., None] * sp.logs[jc])
    A2 = se3.exp_se3(b2[..., None] * sp.logs[jc + 1])
    pose = P0 @ A0 @ A1 @ A2
    return so3.mat_to_quat(pose[..., :3, :3]), pose[..., :3, 3], ok


def get_pose_batch(sp: Spline, ts):
    """Query for (N,) times (get_pose is already batched)."""
    return get_pose(sp, ts)
