"""SO(3) primitives on quaternions (plain tensor functions, any batch shape).

Quaternions are (..., 4) ordered [w, x, y, z] (Hamilton, active rotation).
Small-angle branches use the double-`where` guard: the untaken closed form
sees a clamped argument, so both branches stay finite at any input.
Counterpart of malio_tpu/geometry/so3.py.
"""
from __future__ import annotations

import torch

_SMALL = 1e-6
_SMALL2 = _SMALL * _SMALL


def cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _safe_sqrt_n2(n2):
    small = n2 < _SMALL2
    n2s = torch.where(small, torch.ones_like(n2), n2)
    return small, torch.sqrt(n2s)


def hat(v):
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_mul(q, r):
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate v (..., 3) by q (..., 4): v + 2 (w u x v + u x (u x v))."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def exp_so3(v):
    """Rotation vector (..., 3) -> quaternion (..., 4)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small, n = _safe_sqrt_n2(n2)
    k = torch.where(small, 0.5 - n2 / 48.0, torch.sin(0.5 * n) / n)
    w = torch.where(small, 1.0 - n2 / 8.0 + n2 * n2 / 384.0, torch.cos(0.5 * n))
    return torch.cat([w, k * v], dim=-1)


def log_so3(q):
    """Quaternion (..., 4) -> rotation vector (..., 3), shortest path."""
    q = torch.where(q[..., :1] >= 0, q, -q)
    w = q[..., :1]
    u = q[..., 1:]
    n2 = torch.sum(u * u, dim=-1, keepdim=True)
    small, n = _safe_sqrt_n2(n2)
    ang = 2.0 * torch.atan2(n, w)
    k = torch.where(small, 2.0 / w - 2.0 * n2 / (3.0 * w**3), ang / n)
    return k * u


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def mat_to_quat(R):
    """Rotation matrix -> quaternion, branch-free Shepperd (all four
    candidates, pick the dominant one)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    mags = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(mags, dim=-1)  # first maximum, as jnp.argmax
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[
        ..., 0, :
    ]
    q = quat_normalize(q)
    return torch.where(q[..., :1] >= 0, q, -q)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def A_matrix(v):
    """Left Jacobian of Exp: I + (1-cos n)/n^2 hat(v) + (1 - sin n/n)/n^2 hat(v)^2."""
    n2 = torch.sum(v * v, dim=-1)[..., None, None]
    small, n = _safe_sqrt_n2(n2)
    c1 = torch.where(small, 0.5 - n2 / 24.0, (1.0 - torch.cos(n)) / (n * n))
    c2 = torch.where(small, 1.0 / 6.0 - n2 / 120.0, (1.0 - torch.sin(n) / n) / (n * n))
    V = hat(v)
    return _eye3(V) + c1 * V + c2 * (V @ V)


def exp_so3_mat(v):
    """Rotation vector -> rotation matrix (Rodrigues)."""
    n2 = torch.sum(v * v, dim=-1)[..., None, None]
    small, n = _safe_sqrt_n2(n2)
    s = torch.where(small, 1.0 - n2 / 6.0, torch.sin(n) / n)
    c = torch.where(small, 0.5 - n2 / 24.0, (1.0 - torch.cos(n)) / (n * n))
    V = hat(v)
    return _eye3(V) + s * V + c * (V @ V)


def log_so3_mat(R):
    return log_so3(mat_to_quat(R))


def boxplus(q, delta):
    """q * Exp(delta)."""
    return quat_normalize(quat_mul(q, exp_so3(delta)))


def boxminus(q, other):
    """Log(other^-1 * q)."""
    return log_so3(quat_mul(quat_conj(other), q))
