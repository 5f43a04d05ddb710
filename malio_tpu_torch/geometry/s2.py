"""S2 sphere manifold (2-DOF) for the gravity state, pole axis x, radius
9.809 (MTK::S2<double, 98090, 10000, 1>). Counterpart of
malio_tpu/geometry/s2.py."""
from __future__ import annotations

import math

import torch

from .so3 import hat, exp_so3_mat, A_matrix, cross

_SMALL = 1e-7
DEFAULT_LENGTH = 9.809


def s2_bx(v, length=DEFAULT_LENGTH):
    """Tangent basis at v (3x2); fixed frame at the pole's antipode."""
    l = length
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    denom = l + x
    safe = denom > _SMALL
    sd = torch.where(safe, denom, torch.ones_like(denom))
    main = torch.stack(
        [
            torch.stack([-y, -z], dim=-1),
            torch.stack([l - y * y / sd, -z * y / sd], dim=-1),
            torch.stack([-z * y / sd, l - z * z / sd], dim=-1),
        ],
        dim=-2,
    ) / l
    fallback = torch.zeros_like(main)
    fallback[..., 1, 1].fill_(-1.0)
    fallback[..., 2, 0].fill_(1.0)
    return torch.where(safe[..., None, None], main, fallback)


def s2_boxplus(v, delta, length=DEFAULT_LENGTH):
    Bu = (s2_bx(v, length) @ delta[..., None])[..., 0]
    return (exp_so3_mat(Bu) @ v[..., None])[..., 0]


def s2_boxminus(v, other, length=DEFAULT_LENGTH):
    c = cross(v, other)
    n2c = torch.sum(c * c, dim=-1)
    v_cos = torch.sum(v * other, dim=-1)
    tiny = n2c < 1e-12
    v_sin = torch.sqrt(torch.where(tiny, torch.ones_like(n2c), n2c))
    theta = torch.atan2(v_sin, v_cos)
    scale = torch.where(tiny, 1.0 / v_cos - n2c / (3.0 * v_cos**3), theta / v_sin)
    Bx_o = s2_bx(other, length)
    w = (Bx_o.transpose(-1, -2) @ cross(other, v)[..., None])[..., 0]
    main = scale[..., None] * w
    anti = tiny & (v_cos < 0)
    fallback = torch.stack(
        [torch.full_like(theta, math.pi), torch.zeros_like(theta)], dim=-1
    ).to(v.dtype)
    return torch.where(anti[..., None], fallback, main)


def s2_mx(v, delta, length=DEFAULT_LENGTH):
    """d(v boxplus delta)/d delta, 3x2."""
    Bx = s2_bx(v, length)
    Bu = (Bx @ delta[..., None])[..., 0]
    small = torch.sum(delta * delta, dim=-1) < _SMALL * _SMALL
    hv = hat(v)
    small_res = -hv @ Bx
    R = exp_so3_mat(Bu)
    big_res = -R @ hv @ A_matrix(Bu).transpose(-1, -2) @ Bx
    return torch.where(small[..., None, None], small_res, big_res)


def s2_nx_yy(v, length=DEFAULT_LENGTH):
    """1/l^2 Bx^T hat(v)."""
    Bx = s2_bx(v, length)
    return Bx.transpose(-1, -2) @ hat(v) / (length * length)


def s2_project(v, length=DEFAULT_LENGTH):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True) * length
