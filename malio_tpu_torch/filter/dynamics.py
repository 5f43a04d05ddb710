"""Process model and discrete transition Jacobians (counterpart of
malio_tpu/filter/dynamics.py).

pos' = vel, rot' = gyro - bg, vel' = R (acc - ba) + grav. F = F_x1 + dt f_x
with the SO(3) rows transported by Exp/A and the S2 rows by the chart
transport Nx Mx (esekfom.hpp:388-492). Functions accept batched states
(leading axes on every field) so a whole propagation pass builds its
Jacobians in one call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import so3, s2
from .. import state as st
from ..device import resolve_device


class Input(NamedTuple):
    acc: torch.Tensor  # (..., 3)
    gyro: torch.Tensor  # (..., 3)


def process_noise_matrix(gyr_cov, acc_cov, b_gyr_cov, b_acc_cov,
                         dtype=torch.float32, device="cuda"):
    """12x12 diagonal Q, noise order [ng, na, nbg, nba]."""
    d = torch.tensor(
        [gyr_cov] * 3 + [acc_cov] * 3 + [b_gyr_cov] * 3 + [b_acc_cov] * 3,
        dtype=dtype, device=resolve_device(device),
    )
    return torch.diag(d)


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def step_mean(x: st.State, u: Input, dt) -> st.State:
    """Mean-only Euler step."""
    omega = u.gyro - x.bg
    acc_b = u.acc - x.ba
    a_world = _mv(so3.quat_to_mat(x.rot), acc_b) + x.grav
    return x._replace(
        pos=x.pos + x.vel * dt,
        rot=so3.boxplus(x.rot, omega * dt),
        vel=x.vel + a_world * dt,
    )


def transition(x: st.State, u: Input, dt):
    """Euler mean step plus the discrete error-state Jacobians.

    x fields and u may carry leading batch axes; dt is a tensor of the
    batch shape (or a scalar). Returns (x_next, F (..., n, n), Fw (..., n, 12))."""
    L = x.num_lidars
    n = st.dof(L)
    dtype = x.pos.dtype
    dev = x.pos.device
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    batch = x.pos.shape[:-1]
    dtm = dt[..., None, None]

    omega = u.gyro - x.bg
    acc_b = u.acc - x.ba
    R = so3.quat_to_mat(x.rot)
    a_world = _mv(R, acc_b) + x.grav
    x_next = x._replace(
        pos=x.pos + x.vel * dt[..., None],
        rot=so3.boxplus(x.rot, omega * dt[..., None]),
        vel=x.vel + a_world * dt[..., None],
    )

    i_rot, i_vel = st.idx_rot(L), st.idx_vel(L)
    i_bg, i_ba, i_g = st.idx_bg(L), st.idx_ba(L), st.idx_grav(L)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.eye(n, dtype=dtype, device=dev).repeat(*batch, 1, 1)
    F[..., 0:3, i_vel : i_vel + 3] = I3 * dtm
    A_neg = so3.A_matrix(-omega * dt[..., None])
    F[..., i_rot : i_rot + 3, i_rot : i_rot + 3] = so3.exp_so3_mat(-omega * dt[..., None])
    F[..., i_rot : i_rot + 3, i_bg : i_bg + 3] = -dtm * A_neg
    F[..., i_vel : i_vel + 3, i_rot : i_rot + 3] = -dtm * (R @ so3.hat(acc_b))
    F[..., i_vel : i_vel + 3, i_ba : i_ba + 3] = -dtm * R
    zero2 = torch.zeros(*batch, 2, dtype=dtype, device=dev)
    Mx0 = s2.s2_mx(x.grav, zero2)
    F[..., i_vel : i_vel + 3, i_g : i_g + 2] = dtm * Mx0
    F[..., i_g : i_g + 2, i_g : i_g + 2] = s2.s2_nx_yy(x_next.grav) @ Mx0

    Fw = torch.zeros(*batch, n, 12, dtype=dtype, device=dev)
    Fw[..., i_rot : i_rot + 3, 0:3] = -dtm * A_neg
    Fw[..., i_vel : i_vel + 3, 3:6] = -dtm * R
    Fw[..., i_bg : i_bg + 3, 6:9] = dtm * I3
    Fw[..., i_ba : i_ba + 3, 9:12] = dtm * I3
    return x_next, F, Fw


def predict(x: st.State, P, u: Input, dt, Q):
    """Propagate mean and covariance."""
    x_next, F, Fw = transition(x, u, dt)
    P_next = F @ P @ F.T + Fw @ Q @ Fw.T
    return x_next, P_next


def parallel_covariance(Fs, Qts, P0):
    """All-prefix covariance propagation P_k = F_k P_{k-1} F_k^T + Qt_k.

    The affine maps (F, Q) compose associatively,
    (F2, Q2) o (F1, Q1) = (F2 F1, F2 Q1 F2^T + Q2), so an inclusive
    Hillis-Steele scan reduces the chain in ceil(log2 N) batched levels.
    Fs, Qts: (N, n, n). Returns (N, n, n) covariances after each step."""
    G, S = Fs, Qts
    N = Fs.shape[0]
    d = 1
    while d < N:
        Fa, Qa = G[:-d], S[:-d]
        Fb, Qb = G[d:], S[d:]
        G = torch.cat([G[:d], Fb @ Fa], dim=0)
        S = torch.cat([S[:d], Fb @ Qa @ Fb.transpose(-1, -2) + Qb], dim=0)
        d *= 2
    return G @ P0 @ G.transpose(-1, -2) + S
