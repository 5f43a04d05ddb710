"""Filter state manifold (counterpart of malio_tpu/state.py).

Tangent layout for L LiDARs (DOF n = 17 + 6L):
  pos [0,3) rot [3,6) ext_r[l] [6+3l,9+3l) ext_t[l] [6+3L+3l, ...)
  vel [6+6L,9+6L) bg [9+6L,12+6L) ba [12+6L,15+6L) grav [15+6L,17+6L)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .geometry import so3, s2

S2_LENGTH = s2.DEFAULT_LENGTH
GRAVITY = 9.81


class State(NamedTuple):
    pos: torch.Tensor  # (3,)
    rot: torch.Tensor  # (4,) [w,x,y,z]
    ext_r: torch.Tensor  # (L, 4)
    ext_t: torch.Tensor  # (L, 3)
    vel: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    grav: torch.Tensor  # (3,) |grav| == S2_LENGTH

    @property
    def num_lidars(self) -> int:
        return self.ext_r.shape[-2]

    @property
    def dof(self) -> int:
        return 17 + 6 * self.num_lidars

    def map(self, fn):
        return State(*(fn(a) for a in self))


def where_state(cond, a: State, b: State) -> State:
    """Field by field: a where cond holds, else b. cond is () or one flag
    per sequence of a batch (B,)."""
    return State(*(torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())), x, y)
                   for x, y in zip(a, b)))


def identity_state(num_lidars: int, dtype=torch.float32, device="cuda") -> State:
    kw = dict(dtype=dtype, device=resolve_device(device))
    quat_id = torch.tensor([1.0, 0.0, 0.0, 0.0], **kw)
    return State(
        pos=torch.zeros(3, **kw),
        rot=quat_id,
        ext_r=quat_id.repeat(num_lidars, 1),
        ext_t=torch.zeros((num_lidars, 3), **kw),
        vel=torch.zeros(3, **kw),
        bg=torch.zeros(3, **kw),
        ba=torch.zeros(3, **kw),
        grav=torch.tensor([0.0, 0.0, -S2_LENGTH], **kw),
    )


def idx_pos(L):
    return 0


def idx_rot(L):
    return 3


def idx_ext_r(L, l):
    return 6 + 3 * l


def idx_ext_t(L, l):
    return 6 + 3 * L + 3 * l


def idx_vel(L):
    return 6 + 6 * L


def idx_bg(L):
    return 9 + 6 * L


def idx_ba(L):
    return 12 + 6 * L


def idx_grav(L):
    return 15 + 6 * L


def dof(L):
    return 17 + 6 * L


def so3_block_starts(L):
    return [idx_rot(L)] + [idx_ext_r(L, l) for l in range(L)]


def boxplus(x: State, dx) -> State:
    """x ⊞ dx with dx an (..., n) tangent vector (leading axes as x's)."""
    L = x.num_lidars
    dx = dx.to(x.pos.dtype)
    o = 6 + 6 * L
    return State(
        pos=x.pos + dx[..., 0:3],
        rot=so3.boxplus(x.rot, dx[..., 3:6]),
        ext_r=so3.boxplus(x.ext_r, dx[..., 6 : 6 + 3 * L].unflatten(-1, (L, 3))),
        ext_t=x.ext_t + dx[..., 6 + 3 * L : 6 + 6 * L].unflatten(-1, (L, 3)),
        vel=x.vel + dx[..., o : o + 3],
        bg=x.bg + dx[..., o + 3 : o + 6],
        ba=x.ba + dx[..., o + 6 : o + 9],
        grav=s2.s2_boxplus(x.grav, dx[..., o + 9 : o + 11]),
    )


def boxminus(x1: State, x2: State):
    """(..., n) tangent vector x1 ⊟ x2."""
    return torch.cat(
        [
            x1.pos - x2.pos,
            so3.boxminus(x1.rot, x2.rot),
            so3.boxminus(x1.ext_r, x2.ext_r).flatten(-2),
            (x1.ext_t - x2.ext_t).flatten(-2),
            x1.vel - x2.vel,
            x1.bg - x2.bg,
            x1.ba - x2.ba,
            s2.s2_boxminus(x1.grav, x2.grav),
        ],
        dim=-1,
    )


def oplus(x: State, f, dt) -> State:
    """Euler step x ⊕ (f dt); only the pos, rot and vel rows of f move."""
    L = x.num_lidars
    return x._replace(
        pos=x.pos + f[..., 0:3] * dt,
        rot=so3.boxplus(x.rot, f[..., 3:6] * dt),
        vel=x.vel + f[..., 6 + 6 * L : 9 + 6 * L] * dt,
    )
