"""Iterated error-state Kalman filter on the LIO manifold (counterpart of
malio_tpu/filter/esekf.py; update_iterated_dyn_share_modified,
esekfom.hpp:495-721).

Information form on the active (pose + extrinsics) block, solved in f64:
  P_temp = J^-T P0^-1 J^-1;  P_temp[:a,:a] += H^T R^-1 H;  K = P_temp^-1 H^T R^-1
The loop runs at most max_iter iterations and stops on the host when its
`done` flag is set; the convergence bookkeeping and the Newton-Schulz
gates are host reads (one small device read each).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..geometry import so3, s2
from .. import state as st


class HShareResult(NamedTuple):
    valid: torch.Tensor  # () bool: any effective feature
    h: torch.Tensor  # (M,) weighted residuals
    H: torch.Tensor  # (M, active) weighted Jacobian rows
    R: torch.Tensor  # (M,) per-point measurement noise
    mask: torch.Tensor  # (M,) bool effective rows


def _inv3(B):
    c0 = so3.cross(B[1], B[2])
    c1 = so3.cross(B[2], B[0])
    c2 = so3.cross(B[0], B[1])
    det = torch.dot(B[0], c0)
    det = torch.where(det.abs() > 1e-300, det, torch.full_like(det, 1e-300))
    return torch.stack([c0, c1, c2], dim=-1) / det


def _inv2(B):
    det = B[0, 0] * B[1, 1] - B[0, 1] * B[1, 0]
    det = torch.where(det.abs() > 1e-300, det, torch.full_like(det, 1e-300))
    return torch.stack(
        [torch.stack([B[1, 1], -B[0, 1]]), torch.stack([-B[1, 0], B[0, 0]])]
    ) / det


def _tangent_transport(x_lin: st.State, dx, x_prop: st.State, with_inverse=False):
    """Block-diagonal chart transport J (A(dx_seg)^T per SO(3) block,
    Nx Mx for S2), and optionally J^-1 from blockwise closed forms."""
    L = x_lin.num_lidars
    n = st.dof(L)
    J = torch.eye(n, dtype=dx.dtype, device=dx.device)
    Jinv = J.clone() if with_inverse else None
    for s in st.so3_block_starts(L):
        blk = so3.A_matrix(dx[s : s + 3]).transpose(-1, -2)
        J[s : s + 3, s : s + 3] = blk
        if with_inverse:
            Jinv[s : s + 3, s : s + 3] = _inv3(blk)
    gi = st.idx_grav(L)
    Nx = s2.s2_nx_yy(x_lin.grav.to(dx.dtype))
    Mx = s2.s2_mx(x_prop.grav.to(dx.dtype), dx[gi : gi + 2])
    g_blk = Nx @ Mx
    J[gi : gi + 2, gi : gi + 2] = g_blk
    if with_inverse:
        Jinv[gi : gi + 2, gi : gi + 2] = _inv2(g_blk)
        return J, Jinv
    return J


def _chol_unrolled(A, pivot_floor: float):
    """Cholesky factor by n rank-1 downdates with a floored pivot: a pivot
    under the floor keeps sqrt(floor) on the diagonal and zeroes its
    column (modified Cholesky), so a slightly indefinite operand does not
    detonate. torch.linalg.cholesky would raise on exactly those operands."""
    n = A.shape[0]
    idx = torch.arange(n, device=A.device)
    L = torch.zeros_like(A)
    M = A
    for j in range(n):
        hit = M[j, j] < pivot_floor
        piv = torch.sqrt(torch.clamp(M[j, j], min=pivot_floor))
        col = torch.where(idx >= j, M[:, j] / piv, torch.zeros_like(piv))
        col = torch.where(hit, torch.where(idx == j, piv, torch.zeros_like(piv)), col)
        L[:, j] = col
        M = M - col[:, None] * col[None, :]
    return L


def _lower_inverse_unrolled(L):
    """L^-1 by n forward substitutions."""
    n = L.shape[0]
    I = torch.eye(n, dtype=L.dtype, device=L.device)
    V = torch.zeros_like(L)
    for i in range(n):
        s = L[i] @ V
        V[i] = (I[i] - s) / L[i, i]
    return V


def _spd_inverse(A):
    """Inverse of a nominally SPD matrix: Jacobi equilibration, floored
    Cholesky, triangular inverse."""
    A = 0.5 * (A + A.T)
    d = torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    inv_d = 1.0 / d
    As = A * inv_d[:, None] * inv_d[None, :]
    As = 0.5 * (As + As.T)
    floor = 1e-5 if A.dtype == torch.float32 else 1e-10
    Linv = _lower_inverse_unrolled(_chol_unrolled(As, floor))
    return (Linv.T @ Linv) * inv_d[:, None] * inv_d[None, :]


def _sbound(E):
    """Spectral-norm bound sqrt(||E||_1 ||E||_inf)."""
    aE = E.abs()
    return torch.sqrt(torch.max(aE.sum(0)) * torch.max(aE.sum(1)))


class IEKFResult(NamedTuple):
    x: st.State
    P: torch.Tensor
    iterations: int
    valid: bool
    cache: Any
    Pi: Any = None


def update_iterated(
    x0: st.State,
    P0,
    h_share_fn,
    cache0: Any,
    max_iter: int,
    limit: float = 1e-3,
    r_floor_check: float = 1e-4,
    r_floor_value: float = 1e-3,
    search_on_converge: bool = True,
    Pi0=None,
) -> IEKFResult:
    """Iterated update; h_share_fn(x, search: bool, cache) -> (HShareResult,
    cache). Pi0 warm-starts the information-matrix inverse (Newton-Schulz,
    entry gate 0.95, verified to 1e-7, else the direct inverse)."""
    L = x0.num_lidars
    n = st.dof(L)
    act = 6 * (L + 1)
    dtype = P0.dtype
    sdtype = torch.float64
    dev = P0.device
    I_n = torch.eye(n, dtype=sdtype, device=dev)
    P0s = P0.to(sdtype)
    P0_inv = _spd_inverse(P0s)

    i, t, converge = -1, 0, True
    x, x_lin = x0, x0
    K_xa = torch.zeros((n, act), dtype=sdtype, device=dev)
    dx_out = torch.zeros((n,), dtype=sdtype, device=dev)
    ever_valid = False
    cache = cache0
    Pi_prev = torch.zeros((n, n), dtype=sdtype, device=dev) if Pi0 is None else Pi0.to(sdtype)
    done = False
    while not done:
        search = (converge and i > -1) if search_on_converge else False
        res, cache = h_share_fn(x, search, cache)

        dx = st.boxminus(x, x0).to(sdtype)
        J, Jinv = _tangent_transport(x, dx, x0, with_inverse=True)
        dx_new = J @ dx

        w_mask = res.mask.to(sdtype)
        R_eff = torch.where(res.R < r_floor_check, torch.full_like(res.R, r_floor_value), res.R).to(sdtype)
        w = w_mask / R_eff
        HTw = res.H.T.to(sdtype) * w[None, :]
        HTH = HTw @ res.H.to(sdtype)

        P_temp = Jinv.T @ P0_inv @ Jinv
        P_temp[:act, :act] += HTH

        r0 = float(_sbound(I_n - P_temp @ Pi_prev))
        if r0 < 0.95:
            X = Pi_prev + Pi_prev @ (I_n - P_temp @ Pi_prev)
            X = 0.5 * (X + X.T)
            for _ in range(3):
                X = X @ (2.0 * I_n - P_temp @ X)
                X = 0.5 * (X + X.T)
            X_w = X
        else:
            X_w = Pi_prev
        r1 = float(_sbound(I_n - P_temp @ X_w))
        Pi = X_w if r1 < 1e-7 else _spd_inverse(P_temp)

        Pia = Pi[:, :act]
        K_h = Pia @ (HTw @ res.h.to(sdtype))
        K_xa_new = Pia @ HTH
        dx_o = K_h + K_xa_new @ dx_new[:act] - dx_new
        flags = torch.stack([res.valid, torch.all(dx_o.abs() < limit)]).tolist()
        valid, small = bool(flags[0]), bool(flags[1])
        if not valid:
            dx_o = torch.zeros_like(dx_o)
        x_new = st.boxplus(x, dx_o)

        conv_new = small and valid
        t_new = t + int(conv_new)
        conv_new = conv_new or (t_new == 0 and i == max_iter - 2)
        done = (t_new > 1 or i == max_iter - 1) if valid else (i == max_iter - 1)
        i, t, converge = i + 1, t_new, conv_new
        x_lin, x = x, x_new
        K_xa, dx_out = K_xa_new, dx_o
        ever_valid = ever_valid or valid
        Pi_prev = Pi

    # rebuild the last iteration's tangent covariance at its linearization
    # state, then the final covariance update (esekfom.hpp:665-714)
    dx_lin = st.boxminus(x_lin, x0).to(sdtype)
    J_lin = _tangent_transport(x_lin, dx_lin, x0)
    P_t = J_lin @ P0s @ J_lin.T
    J2 = _tangent_transport(x, dx_out, x0)
    L_mat = J2 @ P_t @ J2.T
    P_cols = P_t @ J2.T
    K2 = J2 @ K_xa
    P_new = L_mat - K2 @ P_cols[:act, :]
    P_new = (0.5 * (P_new + P_new.T)).to(dtype)
    if not ever_valid:
        return IEKFResult(x=x0, P=P0, iterations=i + 1, valid=False, cache=cache, Pi=Pi_prev)
    return IEKFResult(x=x, P=P_new, iterations=i + 1, valid=True, cache=cache, Pi=Pi_prev)
