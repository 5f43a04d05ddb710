"""Iterated error-state Kalman filter on the LIO manifold (counterpart of
malio_tpu/filter/esekf.py; update_iterated_dyn_share_modified,
esekfom.hpp:495-721).

Information form on the active (pose + extrinsics) block, solved in f64:
  P_temp = J^-T P0^-1 J^-1;  P_temp[:a,:a] += H^T R^-1 H;  K = P_temp^-1 H^T R^-1
Every quantity carries a leading batch axis B of independent sequences.
The loop keeps i, t, converge, valid, done and ever_valid per sequence on
the device, freezes a sequence once it is done and runs max_iter + 1
iterations: the reference's lax.while_loop under vmap, with no host read.
Each iteration re-searches where a sequence's `converge` asks for it and
takes the direct inverse where the Newton-Schulz inverse fails its
verification, both as per-sequence selects (the reference's lax.conds).
An mp rank runs the same loop: its h_share_fn returns every rank's
measurement rows, so every rank computes the same bits and no rank needs
another's decision.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..geometry import so3, s2
from .. import state as st
from .. import tree
from ..linalg import mm


class HShareResult(NamedTuple):
    valid: torch.Tensor  # ([B]) bool: any effective feature
    h: torch.Tensor  # ([B,] M) weighted residuals
    H: torch.Tensor  # ([B,] M, active) weighted Jacobian rows
    R: torch.Tensor  # ([B,] M) per-point measurement noise
    mask: torch.Tensor  # ([B,] M) bool effective rows


def _inv3(B):
    b0, b1, b2 = B.unbind(-2)
    c0 = so3.cross(b1, b2)
    c1 = so3.cross(b2, b0)
    c2 = so3.cross(b0, b1)
    det = (b0 * c0).sum(-1)
    det = torch.where(det.abs() > 1e-300, det, torch.full_like(det, 1e-300))
    return torch.stack([c0, c1, c2], dim=-1) / det[..., None, None]


def _inv2(B):
    a, b, c, d = B[..., 0, 0], B[..., 0, 1], B[..., 1, 0], B[..., 1, 1]
    det = a * d - b * c
    det = torch.where(det.abs() > 1e-300, det, torch.full_like(det, 1e-300))
    return torch.stack(
        [torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2
    ) / det[..., None, None]


def _tangent_transport(x_lin: st.State, dx, x_prop: st.State, with_inverse=False):
    """Block-diagonal chart transport J (A(dx_seg)^T per SO(3) block,
    Nx Mx for S2), and optionally J^-1 from blockwise closed forms; dx
    (..., n) with the states' leading axes."""
    L = x_lin.num_lidars
    n = st.dof(L)
    J = torch.eye(n, dtype=dx.dtype, device=dx.device).expand(*dx.shape[:-1], n, n).clone()
    Jinv = J.clone() if with_inverse else None
    for s in st.so3_block_starts(L):
        blk = so3.A_matrix(dx[..., s : s + 3]).transpose(-1, -2)
        J[..., s : s + 3, s : s + 3] = blk
        if with_inverse:
            Jinv[..., s : s + 3, s : s + 3] = _inv3(blk)
    gi = st.idx_grav(L)
    Nx = s2.s2_nx_yy(x_lin.grav.to(dx.dtype))
    Mx = s2.s2_mx(x_prop.grav.to(dx.dtype), dx[..., gi : gi + 2])
    g_blk = Nx @ Mx
    J[..., gi : gi + 2, gi : gi + 2] = g_blk
    if with_inverse:
        Jinv[..., gi : gi + 2, gi : gi + 2] = _inv2(g_blk)
        return J, Jinv
    return J


def _chol_unrolled(A, pivot_floor: float):
    """Cholesky factor of A (..., n, n) by n rank-1 downdates with a
    floored pivot: a pivot under the floor keeps sqrt(floor) on the
    diagonal and zeroes its column (modified Cholesky), so a slightly
    indefinite operand does not detonate. torch.linalg.cholesky would
    raise on exactly those operands."""
    n = A.shape[-1]
    idx = torch.arange(n, device=A.device)
    below = idx[None, :] >= idx[:, None]  # row j: the entries at or below the diagonal
    diag = torch.eye(n, dtype=torch.bool, device=A.device)
    L = torch.zeros_like(A)
    M = A
    for j in range(n):
        mjj = M[..., j, j][..., None]
        hit = mjj < pivot_floor
        piv = torch.sqrt(torch.clamp(mjj, min=pivot_floor))
        col = torch.where(below[j], M[..., :, j] / piv, 0.0)
        col = torch.where(hit, torch.where(diag[j], piv, 0.0), col)
        L[..., :, j] = col
        M = M - col[..., :, None] * col[..., None, :]
    return L


def _lower_inverse_unrolled(L):
    """L^-1 by n forward substitutions."""
    n = L.shape[-1]
    I = torch.eye(n, dtype=L.dtype, device=L.device)
    V = torch.zeros_like(L)
    for i in range(n):
        s = mm(L[..., i : i + 1, :], V)[..., 0, :]
        V[..., i, :] = (I[i] - s) / L[..., i, i : i + 1]
    return V


def _spd_inverse(A):
    """Inverse of a nominally SPD matrix (..., n, n): Jacobi equilibration,
    floored Cholesky, triangular inverse."""
    A = 0.5 * (A + A.transpose(-1, -2))
    d = torch.sqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-30))
    inv_d = 1.0 / d
    scale = inv_d[..., :, None] * inv_d[..., None, :]
    As = A * scale
    As = 0.5 * (As + As.transpose(-1, -2))
    floor = 1e-5 if A.dtype == torch.float32 else 1e-10
    Linv = _lower_inverse_unrolled(_chol_unrolled(As, floor))
    return mm(Linv.transpose(-1, -2), Linv) * scale


def _sbound(E):
    """Spectral-norm bound sqrt(||E||_1 ||E||_inf), per matrix."""
    aE = E.abs()
    return torch.sqrt(torch.amax(aE.sum(-2), -1) * torch.amax(aE.sum(-1), -1))


class IEKFResult(NamedTuple):
    x: st.State
    P: torch.Tensor
    iterations: Any  # ([B]) int32 iterations run by each sequence
    valid: Any  # ([B]) bool: some iteration had an effective feature
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
    """Iterated update of B sequences; h_share_fn(x, search, cache) ->
    (HShareResult, cache), with `search` False (no sequence re-searches:
    `search_on_converge` off) or a (B,) bool tensor (see
    measurement.make_h_share). Pi0 warm-starts the information-matrix
    inverse (Newton-Schulz, entry gate 0.95 per sequence, verified to
    1e-7, else the direct inverse)."""
    L = x0.num_lidars
    n = st.dof(L)
    act = 6 * (L + 1)
    dtype = P0.dtype
    sdtype = torch.float64
    dev = P0.device
    B = P0.shape[0]
    I_n = torch.eye(n, dtype=sdtype, device=dev)
    P0s = P0.to(sdtype)
    P0_inv = _spd_inverse(P0s)

    i = torch.full((B,), -1, dtype=torch.int32, device=dev)
    t = torch.zeros((B,), dtype=torch.int32, device=dev)
    converge = torch.ones((B,), dtype=torch.bool, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    ever_valid = torch.zeros((B,), dtype=torch.bool, device=dev)
    x, x_lin = x0, x0
    K_xa = torch.zeros((B, n, act), dtype=sdtype, device=dev)
    dx_out = torch.zeros((B, n), dtype=sdtype, device=dev)
    cache = cache0
    Pi_prev = torch.zeros((B, n, n), dtype=sdtype, device=dev) if Pi0 is None else Pi0.to(sdtype)
    for _ in range(max_iter + 1):  # i runs from -1 to max_iter - 1
        # the first iteration never re-searches (i == -1)
        search = converge & (i > -1) if search_on_converge else False
        res, cache_new = h_share_fn(x, search, cache)

        dx = st.boxminus(x, x0).to(sdtype)
        J, Jinv = _tangent_transport(x, dx, x0, with_inverse=True)
        dx_new = mm(J, dx[..., None])[..., 0]

        w_mask = res.mask.to(sdtype)
        R_eff = torch.where(res.R < r_floor_check, torch.full_like(res.R, r_floor_value), res.R).to(sdtype)
        w = w_mask / R_eff
        HTw = res.H.transpose(-1, -2).to(sdtype) * w[:, None, :]
        HTH = mm(HTw, res.H.to(sdtype))

        P_temp = mm(mm(Jinv.transpose(-1, -2), P0_inv), Jinv)
        P_temp[:, :act, :act] += HTH

        # Newton-Schulz from the previous inverse where its residual bound
        # is under 0.95, computed for all and kept per sequence
        E0 = I_n - mm(P_temp, Pi_prev)
        X = Pi_prev + mm(Pi_prev, E0)
        X = 0.5 * (X + X.transpose(-1, -2))
        for _ in range(3):
            X = mm(X, 2.0 * I_n - mm(P_temp, X))
            X = 0.5 * (X + X.transpose(-1, -2))
        X_w = torch.where((_sbound(E0) < 0.95)[:, None, None], X, Pi_prev)
        verified = _sbound(I_n - mm(P_temp, X_w)) < 1e-7
        Pi = torch.where(verified[:, None, None], X_w, _spd_inverse(P_temp))

        Pia = Pi[..., :act]
        K_h = mm(Pia, mm(HTw, res.h.to(sdtype)[..., None]))
        K_xa_new = mm(Pia, HTH)
        dx_o = (K_h + mm(K_xa_new, dx_new[:, :act, None]))[..., 0] - dx_new
        valid = res.valid
        small = torch.all(dx_o.abs() < limit, dim=-1)
        dx_o = torch.where(valid[:, None], dx_o, torch.zeros_like(dx_o))
        x_new = st.boxplus(x, dx_o)

        conv_new = small & valid
        t_new = t + conv_new.to(torch.int32)
        conv_new = conv_new | ((t_new == 0) & (i == max_iter - 2))
        last = i == max_iter - 1
        done_new = torch.where(valid, (t_new > 1) | last, last)

        # a sequence that is done keeps everything as it was
        run = ~done
        x_lin = tree.where(run, x, x_lin)
        x = tree.where(run, x_new, x)
        cache = tree.where(run, cache_new, cache)
        K_xa = torch.where(run[:, None, None], K_xa_new, K_xa)
        dx_out = torch.where(run[:, None], dx_o, dx_out)
        Pi_prev = torch.where(run[:, None, None], Pi, Pi_prev)
        ever_valid = ever_valid | (run & valid)
        t = torch.where(run, t_new, t)
        converge = torch.where(run, conv_new, converge)
        i = torch.where(run, i + 1, i)
        done = done | (run & done_new)

    # rebuild the last iteration's tangent covariance at its linearization
    # state, then the final covariance update (esekfom.hpp:665-714)
    dx_lin = st.boxminus(x_lin, x0).to(sdtype)
    J_lin = _tangent_transport(x_lin, dx_lin, x0)
    P_t = mm(mm(J_lin, P0s), J_lin.transpose(-1, -2))
    J2 = _tangent_transport(x, dx_out, x0)
    L_mat = mm(mm(J2, P_t), J2.transpose(-1, -2))
    P_cols = mm(P_t, J2.transpose(-1, -2))
    K2 = mm(J2, K_xa)
    P_new = L_mat - mm(K2, P_cols[:, :act, :])
    P_new = (0.5 * (P_new + P_new.transpose(-1, -2))).to(dtype)
    return IEKFResult(
        x=tree.where(ever_valid, x, x0), P=torch.where(ever_valid[:, None, None], P_new, P0),
        iterations=i + 1, valid=ever_valid, cache=cache, Pi=Pi_prev,
    )
