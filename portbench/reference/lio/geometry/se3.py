"""SE(3) primitives on 4x4 homogeneous matrices (any batch shape).
Counterpart of malio_tpu/geometry/se3.py."""
from __future__ import annotations

import torch

from .so3 import hat, log_so3_mat, quat_to_mat, mat_to_quat, _safe_sqrt_n2, _eye3


def _homogeneous(R, t):
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def exp_se3(xi):
    """se(3) 6-vector [w(3), u(3)] -> 4x4 transform."""
    w = xi[..., :3]
    u = xi[..., 3:]
    n2 = torch.sum(w * w, dim=-1)[..., None, None]
    small, n = _safe_sqrt_n2(n2)
    A = torch.where(small, 1.0 - n2 / 6.0, torch.sin(n) / n)
    B = torch.where(small, 0.5 - n2 / 24.0, (1.0 - torch.cos(n)) / (n * n))
    C = torch.where(small, 1.0 / 6.0 - n2 / 120.0, (1.0 - A) / (n * n))
    W = hat(w)
    I = _eye3(W)
    WW = W @ W
    R = I + A * W + B * WW
    V = I + B * W + C * WW
    t = (V @ u[..., None])[..., 0]
    return _homogeneous(R, t)


def log_se3(T):
    """4x4 transform -> se(3) 6-vector [w, u]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3_mat(R)
    n2 = torch.sum(w * w, dim=-1)[..., None]
    small, n = _safe_sqrt_n2(n2)
    W = hat(w / n)
    Wt = (W @ t[..., None])[..., 0]
    WWt = (W @ Wt[..., None])[..., 0]
    coef = torch.where(small, n2 / 12.0, 1.0 - n / (2.0 * torch.tan(0.5 * n)))
    u = t - 0.5 * n * Wt + coef * WWt
    u = torch.where(small, t, u)
    return torch.cat([w, u], dim=-1)


def inv_se3(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _homogeneous(Rt, ti)


def make_se3(q, t):
    return _homogeneous(quat_to_mat(q), t)


def se3_to_quat_t(T):
    return mat_to_quat(T[..., :3, :3]), T[..., :3, 3]


def adjoint(T):
    """Ad = [[R, hat(t) R], [0, R]] for tangent order [trans; rot]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Z = torch.zeros_like(R)
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bottom = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)
