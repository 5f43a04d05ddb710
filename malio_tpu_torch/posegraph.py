"""Keyframe pose graph with loop closure: the global back end above the
sliding-window BA (counterpart of malio_tpu/posegraph.py; the reference's
trajectory is filter-only, laserMapping.cpp:1070-1071).

  * detect_loops: revisit candidates by position radius and time gap;
  * refine_loop_edge / icp_point_to_plane: a relative-pose measurement by
    point-to-plane ICP against a fixed per-voxel plane model of the older
    keyframe, coarse then fine;
  * edge_system / optimize: dense damped Gauss-Newton over all keyframe
    poses, per-edge blocks from forward-mode Jacobians
    (torch.func.vmap(torch.func.jacfwd(...)));
  * optimize_sparse: the odometry chain as a block-tridiagonal system
    (block Thomas: the kernel csrc/block_tridiag.cu on the card) plus the
    loop couplings by the Woodbury identity;
  * PoseGraphBackend: the host-side back end riding alongside the filter.

Node tangents are [rotation(0:3); translation(3:6)] (ba._window_cost's
layout); edge residuals are [trans; rot]. Sums over edges and cells are
order-fixed (segment.segment_sum), so a relaxation and an ICP gate give
the same bits on every run on the card.

The solvers and the ICP are the reference's jitted programs: on the card
each is a CUDA graph captured at its first call (graph.run; an LM
iteration replayed `iters` times, a whole ICP stage replayed once), and
reads nothing on the host. The `_eager` versions run the same bodies op
by op, as the CPU does.

Tracing (trace.py): the sparse LM iteration stamps its five stages
(trace.SPARSE_STAGES: edge blocks, assembly of T, b and the one-hot U,
the block-tridiagonal solve, the Woodbury S solve, the LM step with its
cost); the other programs get graph.run's begin and end stamps. The back
end's keyframe rounds are host spans, `posegraph.observe` with children
`posegraph.read` (the host reads of the round's pose and cloud, which wait
for the rounds queued on the device), `posegraph.detect`, `posegraph.icp`
(a candidate's refinement and the host read of its quality),
`posegraph.relax` and `posegraph.feedback`, and counters
`posegraph.keyframes`, `posegraph.candidates` (candidates refined),
`posegraph.loops_closed`, `posegraph.relaxes` and `posegraph.corrections`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import graph, trace
from .device import resolve_device
from .geometry import so3
from .linalg import eigh3
from .ops import block_tridiag
from .preprocess import cell_ids
from .segment import segment_sum


class EdgeSet(NamedTuple):
    i: torch.Tensor  # (E,) int64 source keyframe
    j: torch.Tensor  # (E,) int64 target keyframe
    zq: torch.Tensor  # (E, 4) measured relative rotation (i -> j)
    zt: torch.Tensor  # (E, 3) measured relative translation (in frame i)
    w: torch.Tensor  # (E,) scalar information weight
    mask: torch.Tensor  # (E,) bool


def empty_edges(E: int, dtype=torch.float64, device="cuda") -> EdgeSet:
    dev = resolve_device(device)
    zq = torch.zeros((E, 4), dtype=dtype, device=dev)
    zq[:, 0] = 1.0
    idx = torch.zeros((E,), dtype=torch.int64, device=dev)
    return EdgeSet(i=idx, j=idx.clone(), zq=zq, zt=torch.zeros((E, 3), dtype=dtype, device=dev),
                   w=torch.zeros((E,), dtype=dtype, device=dev),
                   mask=torch.zeros((E,), dtype=torch.bool, device=dev))


def relative_pose(qi, ti, qj, tj):
    """Z = T_i^-1 T_j as (q, t)."""
    return so3.quat_mul(so3.quat_conj(qi), qj), so3.quat_rotate_inv(qi, tj - ti)


def _edge_residual(qi, ti, qj, tj, zq, zt, dxi, dxj):
    """Residual [trans; rot] (..., 6) of edges (i, j) with the tangent
    perturbations dx = [rot(0:3); trans(3:6)] applied to both poses."""
    qi = so3.boxplus(qi, dxi[..., :3])
    qj = so3.boxplus(qj, dxj[..., :3])
    rq, rt = relative_pose(qi, ti + dxi[..., 3:], qj, tj + dxj[..., 3:])
    return torch.cat([rt - zt, so3.log_so3(so3.quat_mul(so3.quat_conj(zq), rq))], dim=-1)


def _edge_weight(edges: EdgeSet):
    return edges.w * edges.mask.to(edges.w.dtype)


def _edges_cost(q, t, edges: EdgeSet):
    """sum over edges of w * |r|^2 at the poses."""
    z = torch.zeros((edges.zt.shape[0], 6), dtype=edges.zt.dtype, device=edges.zt.device)
    r = _edge_residual(q[edges.i], t[edges.i], q[edges.j], t[edges.j], edges.zq, edges.zt, z, z)
    return torch.sum(_edge_weight(edges) * torch.sum(r * r, dim=-1))


def _edge_blocks(q, t, edges: EdgeSet):
    """Per-edge Gauss-Newton pieces: He (E, 12, 12) = w J^T J,
    Je (E, 6, 12) = sqrt(w) J, be (E, 12) = w J^T r, ce (E,) = w r.r, with
    J the residual's Jacobian in both poses' tangents."""
    z12 = torch.zeros((12,), dtype=t.dtype, device=t.device)

    def one(qi, ti, qj, tj, zq, zt):
        def res(dx12):
            return _edge_residual(qi, ti, qj, tj, zq, zt, dx12[:6], dx12[6:])
        return res(z12), torch.func.jacfwd(res)(z12)

    r, J = torch.func.vmap(one)(q[edges.i], t[edges.i], q[edges.j], t[edges.j], edges.zq, edges.zt)
    wm = _edge_weight(edges)
    Jt = J.transpose(-1, -2)
    return (wm[:, None, None] * (Jt @ J), torch.sqrt(wm)[:, None, None] * J,
            wm[:, None] * (Jt @ r[..., None])[..., 0], wm * torch.sum(r * r, dim=-1))


def edge_system(q, t, edges: EdgeSet):
    """Weighted Gauss-Newton system of the edge set at the poses q (K, 4),
    t (K, 3): H (K, 6, K, 6), b (K, 6), cost ()."""
    K = q.shape[0]
    He, _, be, ce = _edge_blocks(q, t, edges)
    i, j = edges.i, edges.j
    blocks = torch.cat([He[:, :6, :6], He[:, :6, 6:], He[:, 6:, :6], He[:, 6:, 6:]])
    pairs = torch.cat([i * K + i, i * K + j, j * K + i, j * K + j])
    H = segment_sum(blocks, pairs, K * K).reshape(K, K, 6, 6).permute(0, 2, 1, 3)
    b = segment_sum(torch.cat([be[:, :6], be[:, 6:]]), torch.cat([i, j]), K)
    return H, b, torch.sum(ce)


def _lm_step(q, t, dx, c, lam, cost_fn):
    """Apply dx (K, 6) if it lowers the cost: (q, t, lam, cost after dx)."""
    q_new = so3.boxplus(q, dx[:, :3])
    t_new = t + dx[:, 3:]
    c_new = cost_fn(q_new, t_new)
    accept = c_new < c
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
    return torch.where(accept, q_new, q), torch.where(accept, t_new, t), lam, c_new


def _solve(A, b):
    """A^-1 b with no host read: torch.linalg.solve checks its factorisation's
    status on the host, solve_ex(check_errors=False) leaves it on the card."""
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


def _lm(program, body, q, t, group, iters, damping, static, eager):
    """`iters` LM iterations body((q, t, lam), group) -> ((q, t, lam),
    (cost before, cost after)) from lam = damping: op by op (eager), or
    replays of the iteration captured for (program, static, shapes), the
    counterpart of the reference's jitted lax.scan. Returns (q, t, final
    cost, initial cost); the initial cost is the first iteration's."""
    if iters < 1:
        raise ValueError(f"{program}: iters must be >= 1, got {iters}")
    lam = torch.full((), damping, dtype=t.dtype, device=t.device)
    key = (program, static, graph.signature(q, t, group))
    (q, t, _), (c, c_new) = graph.run(key, body, (q, t, lam), group, iters, eager)
    return q, t, c_new[-1], c[0]


def _optimize_body(gauge: int):
    def body(carry, edges):
        q, t, lam = carry
        K = q.shape[0]
        n = 6 * K
        H, b, _ = edge_system(q, t, edges)
        c = _edges_cost(q, t, edges)
        Hf = H.reshape(n, n).clone()
        gsl = torch.arange(6, device=t.device) + 6 * gauge
        Hf[gsl, gsl] += 1e8
        # the absolute floor keeps edge-less node blocks solvable
        Hd = (Hf + lam * torch.diag(torch.clamp(torch.diagonal(Hf), min=1e-9))
              + 1e-6 * torch.eye(n, dtype=t.dtype, device=t.device))
        dx = -_solve(Hd, b.reshape(n)).reshape(K, 6)
        q, t, lam, c_new = _lm_step(q, t, dx, c, lam, lambda qq, tt: _edges_cost(qq, tt, edges))
        return (q, t, lam), (c, c_new)
    return body


def optimize(q, t, edges: EdgeSet, iters: int = 10, damping=1e-4, gauge: int = 0):
    """Dense damped Gauss-Newton (LM) over all keyframe poses; the gauge
    node is pinned by a strong prior. Returns (q, t, final cost, initial
    cost). On a card the iteration is a CUDA graph captured once per
    shape and gauge and replayed `iters` times; `optimize_eager` launches
    it op by op (the CPU's way), with the same bits."""
    return _lm("optimize", _optimize_body(gauge), q, t, edges, iters, damping, gauge,
               eager=t.device.type != "cuda")


def optimize_eager(q, t, edges: EdgeSet, iters: int = 10, damping=1e-4, gauge: int = 0):
    """`optimize` op by op."""
    return _lm("optimize", _optimize_body(gauge), q, t, edges, iters, damping, gauge, eager=True)


def _block_tridiag_solve(D, Boff, RHS):
    """T Y = RHS for the block-tridiagonal T (D diagonal blocks, T[i, i+1]
    = Boff[i]) by block Thomas: the kernel csrc/block_tridiag.cu on the
    card, its plain version on the CPU (ops/block_tridiag.py)."""
    return block_tridiag.block_tridiag_solve(D, Boff, RHS)


def _sparse_body(gauge: int):
    def body(carry, edges):
        q, t, lam = carry
        odo, loops = edges
        K = q.shape[0]
        dtype, dev = t.dtype, t.device
        Lcap = loops.i.shape[0]

        def cost_fn(qq, tt):
            return _edges_cost(qq, tt, odo) + _edges_cost(qq, tt, loops)

        trace.stamp("optimize_sparse", 0, dev)
        He_o, _, be_o, _ = _edge_blocks(q, t, odo)
        _, Je_l, be_l, _ = _edge_blocks(q, t, loops)
        trace.stamp("optimize_sparse", 1, dev)
        D = segment_sum(torch.cat([He_o[:, :6, :6], He_o[:, 6:, 6:]]), torch.cat([odo.i, odo.j]), K)
        # odometry edge (i, i + 1): its off-diagonal block sits at row i
        Boff = segment_sum(
            torch.where(odo.mask[:, None, None], He_o[:, :6, 6:], torch.zeros_like(He_o[:, :6, 6:])),
            torch.clamp(odo.i, max=K - 2), K - 1)
        b = segment_sum(torch.cat([be_o[:, :6], be_o[:, 6:], be_l[:, :6], be_l[:, 6:]]),
                        torch.cat([odo.i, odo.j, loops.i, loops.j]), K)
        # loop couplings: w J^T J = G G^T with G = (sqrt(w) J)^T, exact
        # rank-6 factors
        G = Je_l.transpose(-1, -2)
        c = cost_fn(q, t)
        # damping and the gauge prior live on T's diagonal
        dD = lam * torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-9) + 1e-6
        D = D + torch.diag_embed(dD)
        D[gauge] = D[gauge] + 1e8 * torch.eye(6, dtype=dtype, device=dev)
        # dense U (K, 6, 6L), nonzero only at each loop's (i, j) rows,
        # built by one-hot contraction
        onehot_i = (torch.arange(K, device=dev)[:, None] == loops.i[None, :]).to(dtype)
        onehot_j = (torch.arange(K, device=dev)[:, None] == loops.j[None, :]).to(dtype)
        Ui = torch.einsum("ke,eab->keab", onehot_i, G[:, :6, :])
        Uj = torch.einsum("ke,eab->keab", onehot_j, G[:, 6:, :])
        U = (Ui + Uj).permute(0, 2, 1, 3).reshape(K, 6, 6 * Lcap)
        rhs = torch.cat([b[..., None], U], dim=-1)
        trace.stamp("optimize_sparse", 2, dev)
        Y = _block_tridiag_solve(D, Boff, rhs)
        trace.stamp("optimize_sparse", 3, dev)
        Yb, YU = Y[..., 0], Y[..., 1:]
        UtYb = torch.einsum("kca,kc->a", U, Yb)
        S = torch.eye(6 * Lcap, dtype=dtype, device=dev) + torch.einsum("kca,kcb->ab", U, YU)
        dx = Yb - torch.einsum("kca,a->kc", YU, _solve(S, UtYb))
        trace.stamp("optimize_sparse", 4, dev)
        q, t, lam, c_new = _lm_step(q, t, -dx, c, lam, cost_fn)
        trace.stamp("optimize_sparse", 5, dev)
        return (q, t, lam), (c, c_new)
    return body


def optimize_sparse(q, t, odo: EdgeSet, loops: EdgeSet, iters: int = 10, damping=1e-4,
                    gauge: int = 0):
    """Structured Gauss-Newton over all keyframe poses. The odometry chain
    (edges with j = i + 1) assembles into a block-tridiagonal T, solved
    exactly by block Thomas; each loop edge adds a rank-6 coupling
    U_e U_e^T, handled by the Woodbury identity over the 6L-wide loop
    space:

      H = T + U U^T,
      H^-1 b = Y_b - Y_U (I + U^T Y_U)^-1 U^T Y_b,   Y_* = T^-1 [b, U].

    Returns (q, t, final cost, initial cost). On a card the iteration is a
    CUDA graph captured once per shape and gauge and replayed `iters`
    times; `optimize_sparse_eager` launches it op by op (the CPU's way),
    with the same bits."""
    return _lm("optimize_sparse", _sparse_body(gauge), q, t, (odo, loops), iters, damping, gauge,
               eager=t.device.type != "cuda")


def optimize_sparse_eager(q, t, odo: EdgeSet, loops: EdgeSet, iters: int = 10, damping=1e-4,
                          gauge: int = 0):
    """`optimize_sparse` op by op."""
    return _lm("optimize_sparse", _sparse_body(gauge), q, t, (odo, loops), iters, damping, gauge,
               eager=True)


def _plane_model(pts, mask, cell_size, num_cells: int, min_pts: int):
    """Fixed target plane model: the target cloud voxelised into hashed
    cells, a plane per cell (centroid, smallest-eigenvector normal and a
    planarity gate). Returns (centroid (C, 3), normal (C, 3), valid (C,)).
    The normal's sign may differ from LAPACK's (linalg.eigh3); every use
    of it is sign-invariant."""
    dtype = pts.dtype
    h = cell_ids(pts, cell_size, num_cells)
    w = mask.to(dtype)
    n = segment_sum(w, h, num_cells)
    s1 = segment_sum(pts * w[:, None], h, num_cells)
    s2 = segment_sum(pts[:, :, None] * pts[:, None, :] * w[:, None, None], h, num_cells)
    n_safe = torch.clamp(n, min=1.0)
    c = s1 / n_safe[:, None]
    cov = s2 / n_safe[:, None, None] - c[:, :, None] * c[:, None, :]
    lam, normal = eigh3(cov + 1e-12 * torch.eye(3, dtype=dtype, device=pts.device))
    valid = (n >= min_pts) & (lam[:, 0] < 0.1 * torch.clamp(lam[:, 1], min=1e-12))
    return c, normal, valid


def _icp_body(cell_size, num_cells: int, min_pts: int, iters: int, damping, huber):
    def body(pose, clouds):
        zq, zt = pose
        tgt_pts, tgt_mask, src_pts, src_mask = clouds
        dtype, dev = tgt_pts.dtype, tgt_pts.device
        cs = torch.full((), cell_size, dtype=dtype, device=dev)
        c, nrm, valid = _plane_model(tgt_pts, tgt_mask, cs, num_cells, min_pts)
        z6 = torch.zeros((6,), dtype=dtype, device=dev)

        def residuals(zq, zt, dx):
            p = so3.quat_rotate(so3.boxplus(zq, dx[:3])[None], src_pts) + (zt + dx[3:])[None]
            h = cell_ids(p.detach(), cs, num_cells)
            r = torch.sum(nrm[h] * (p - c[h]), dim=-1)
            w = (valid[h] & src_mask).to(dtype)
            aw = r.detach().abs()
            w = w * torch.where(aw <= huber, torch.ones_like(aw), huber / torch.clamp(aw, min=1e-12))
            return r, w

        def rms(zq, zt):
            r, w = residuals(zq, zt, z6)
            return torch.sqrt(torch.sum(w * r * r) / torch.clamp(torch.sum(w), min=1.0)), w

        rms0, _ = rms(zq, zt)
        eye = torch.eye(6, dtype=dtype, device=dev)
        for _ in range(iters):
            r, w = residuals(zq, zt, z6)
            J = torch.func.jacfwd(lambda dx, zq=zq, zt=zt: residuals(zq, zt, dx)[0])(z6)  # (M, 6)
            Jw = J * w[:, None]
            dx = -_solve(Jw.T @ J + damping * eye, Jw.T @ r)
            zq, zt = so3.boxplus(zq, dx[:3]), zt + dx[3:]
        rms1, w1 = rms(zq, zt)
        frac = torch.sum(w1 > 0).to(dtype) / torch.clamp(torch.sum(src_mask), min=1).to(dtype)
        # quality judges the final alignment against the larger of the
        # initial rms and the Huber scale: a converged edge scores ~frac,
        # a non-overlapping or degenerate one ~0
        quality = frac * torch.clamp(1.0 - rms1 / torch.clamp(rms0, min=huber), min=0.0)
        return (zq, zt), quality
    return body


def _icp(tgt_pts, tgt_mask, src_pts, src_mask, zq0, zt0, cell_size, num_cells, min_pts, iters,
         damping, huber, eager):
    static = (cell_size, num_cells, min_pts, iters, damping, huber)
    clouds = (tgt_pts, tgt_mask, src_pts, src_mask)
    (zq, zt), quality = graph.run(("icp", static, graph.signature(zq0, zt0, clouds)),
                                  _icp_body(*static), (zq0, zt0), clouds, 1, eager)
    return zq, zt, quality[0]


def icp_point_to_plane(tgt_pts, tgt_mask, src_pts, src_mask, zq0, zt0, cell_size=0.5,
                       num_cells: int = 8192, min_pts: int = 5, iters: int = 10, damping=1e-6,
                       huber=0.3):
    """Point-to-plane ICP of a source cloud onto the fixed plane model of a
    target cloud: Gauss-Newton on the relative pose Z, re-associating by
    cell each iteration, Huber-weighted. Returns (zq, zt, quality) with
    quality = matched fraction * (1 - rms1 / max(rms0, huber)). On a card
    the whole of it (plane model, `iters` iterations, quality) is one CUDA
    graph captured once per shape and static argument and replayed;
    `icp_point_to_plane_eager` launches it op by op, with the same bits."""
    return _icp(tgt_pts, tgt_mask, src_pts, src_mask, zq0, zt0, cell_size, num_cells, min_pts,
                iters, damping, huber, eager=tgt_pts.device.type != "cuda")


def icp_point_to_plane_eager(tgt_pts, tgt_mask, src_pts, src_mask, zq0, zt0, cell_size=0.5,
                             num_cells: int = 8192, min_pts: int = 5, iters: int = 10,
                             damping=1e-6, huber=0.3):
    """`icp_point_to_plane` op by op."""
    return _icp(tgt_pts, tgt_mask, src_pts, src_mask, zq0, zt0, cell_size, num_cells, min_pts,
                iters, damping, huber, eager=True)


def _refine(icp, q_i, t_i, cloud_i, mask_i, q_j, t_j, cloud_j, mask_j, cell_size, num_cells,
            min_pts, iters):
    zq0, zt0 = relative_pose(q_i, t_i, q_j, t_j)
    zq1, zt1, qual1 = icp(cloud_i, mask_i, cloud_j, mask_j, zq0, zt0, cell_size=cell_size,
                          num_cells=num_cells, min_pts=min_pts, iters=iters)
    zq2, zt2, qual2 = icp(cloud_i, mask_i, cloud_j, mask_j, zq1, zt1, cell_size=cell_size / 2.0,
                          num_cells=num_cells, min_pts=min_pts, iters=iters, huber=0.15)
    use_fine = qual2 >= qual1
    return (torch.where(use_fine, zq2, zq1), torch.where(use_fine, zt2, zt1),
            torch.maximum(qual1, qual2))


def refine_loop_edge(q_i, t_i, cloud_i, mask_i, q_j, t_j, cloud_j, mask_j, cell_size=0.5,
                     num_cells: int = 8192, min_pts: int = 5, iters: int = 10):
    """Loop-edge measurement: coarse-to-fine point-to-plane ICP of
    keyframe j's cloud onto keyframe i's plane model from the current
    estimates. The coarse stage (cell_size) has the basin for metres of
    drift, the fine one (cell_size / 2, half the Huber scale) polishes;
    the stage with the better quality is kept (on sparse clouds the fine
    cells can fall under min_pts). Returns (zq, zt, quality). On a card
    each stage replays its own captured graph (icp_point_to_plane); the
    relative pose before and the pick after are a few launches;
    `refine_loop_edge_eager` launches it all op by op."""
    return _refine(icp_point_to_plane, q_i, t_i, cloud_i, mask_i, q_j, t_j, cloud_j, mask_j,
                   cell_size, num_cells, min_pts, iters)


def refine_loop_edge_eager(q_i, t_i, cloud_i, mask_i, q_j, t_j, cloud_j, mask_j, cell_size=0.5,
                           num_cells: int = 8192, min_pts: int = 5, iters: int = 10):
    """`refine_loop_edge` op by op."""
    return _refine(icp_point_to_plane_eager, q_i, t_i, cloud_i, mask_i, q_j, t_j, cloud_j,
                   mask_j, cell_size, num_cells, min_pts, iters)


def detect_loops(pos, times, current, radius, min_time_gap, exclude_last=2):
    """Host-side revisit candidates for keyframe `current`: earlier
    keyframes (its immediate predecessors skipped) within `radius` metres
    and more than `min_time_gap` seconds older, nearest first."""
    pos = np.asarray(pos)
    times = np.asarray(times)
    c = int(current)
    if c < exclude_last + 1:
        return np.zeros(0, int)
    prior = np.arange(0, c - exclude_last)
    d = np.linalg.norm(pos[prior] - pos[c][None], axis=1)
    dt = times[c] - times[prior]
    cand = prior[(d < radius) & (dt > min_time_gap)]
    return cand[np.argsort(np.linalg.norm(pos[cand] - pos[c][None], axis=1))]


def _h(*arrays):
    """Host arrays as f64 CPU tensors, for the port's so3 on the host."""
    return [torch.as_tensor(np.asarray(a, np.float64)) for a in arrays]


def _left_delta(q_to, t_to, q_from, t_from):
    """World-frame left delta dT with dT o T_from = T_to: (dq, R(dq), dt)."""
    a, b = _h(q_to, q_from)
    dq = so3.quat_normalize(so3.quat_mul(a, so3.quat_conj(b)))
    Rd = so3.quat_to_mat(dq).numpy()
    return dq.numpy(), Rd, np.asarray(t_to) - Rd @ np.asarray(t_from)


@dataclasses.dataclass
class PoseGraphBackend:
    """Global keyframe graph riding alongside the filter odometry.

    observe() every fusion round: every `keyframe_every` rounds the pose
    and the base LiDAR's body-frame cloud become a keyframe and an
    odometry edge; a revisit (detect_loops) adds an ICP loop edge and a
    global relaxation. trajectory() returns the graph-optimised keyframe
    poses. The store lives on the host (numpy); ICP and the relaxation run
    on `device` (the card unless device="cpu").

    feedback=True: after each relaxation the world-frame correction that
    maps the newest keyframe's odometry pose onto its optimised pose is
    staged (take_correction) and the store moves into the corrected frame;
    run_sequence applies it to the filter carry
    (pipeline.apply_world_correction).
    """

    capacity: int = 2048
    loop_capacity: int = 64
    keyframe_every: int = 5
    cloud_points: int = 1024
    loop_radius: float = 3.0
    min_time_gap: float = 10.0
    max_loops_per_kf: int = 1
    odom_weight: float = 1.0
    loop_weight: float = 3.0
    min_quality: float = 0.2
    # keyframe clouds are voxel-downsampled (~1 point per filter_size_surf
    # cell), so the ICP plane cells are a few times coarser
    cell_size: float = 1.0
    icp_min_pts: int = 4
    icp_iters: int = 10
    relax_iters: int = 10
    dtype: object = torch.float64
    feedback: bool = False
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        K, P = self.capacity, self.cloud_points
        self.q = np.tile([1.0, 0, 0, 0], (K, 1))
        self.t = np.zeros((K, 3))
        self.clouds = np.zeros((K, P, 3), np.float32)
        self.masks = np.zeros((K, P), bool)
        self.times = np.zeros(K)
        self.count = 0
        # (i, j, zq, zt, w, kind) with kind "odo" or "loop", an explicit
        # tag: a loop edge remapped onto adjacent kept nodes by _decimate
        # stays a loop edge
        self.edges = []
        self._round = 0
        self.n_loop_edges = 0
        self.opt_q = None
        self.opt_t = None
        self.relaxed_count = 0
        self._pending = None
        self.n_feedback = 0  # corrections staged

    def observe(self, out, t_base=0.0):
        self._round += 1
        if self._round % self.keyframe_every:
            return
        with trace.span("posegraph.observe"):
            self._keyframe(out, t_base)

    def _keyframe(self, out, t_base):
        """A keyframe round: the keyframe, its odometry edge, its loop
        candidates refined, and a relax (with feedback) if one closed."""
        trace.count("posegraph.keyframes")
        if self.count >= self.capacity:
            # decimate instead of dropping new keyframes: every other
            # keyframe merges away, odometry composes exactly, loop edges
            # remap onto kept endpoints, the keyframe cadence doubles
            self._decimate()
        k = self.count
        P = self.cloud_points
        # host reads of the round's pose and cloud (the reference reads
        # them too): they wait for the rounds queued on the device
        with trace.span("posegraph.read"):
            pts = _np(out.kf_pts)[:P]
            msk = _np(out.kf_mask)[:P]
            quat, pos, end_time = _np(out.quat), _np(out.pos), float(out.end_time)
        if pts.shape[0] < P:
            pts = np.concatenate([pts, np.zeros((P - pts.shape[0], 3))])
            msk = np.concatenate([msk, np.zeros(P - msk.shape[0], bool)])
        self.q[k] = quat
        self.t[k] = pos
        self.clouds[k] = pts
        self.masks[k] = msk
        self.times[k] = end_time + t_base
        self.count += 1

        if k > 0:
            zq, zt = relative_pose(*_h(self.q[k - 1], self.t[k - 1], self.q[k], self.t[k]))
            self.edges.append((k - 1, k, zq.numpy(), zt.numpy(), self.odom_weight, "odo"))

        with trace.span("posegraph.detect"):
            cands = detect_loops(self.t[: self.count], self.times[: self.count], k,
                                 self.loop_radius, self.min_time_gap)
        kw = dict(dtype=self.dtype, device=self.device)
        closed = 0
        for j in cands[: self.max_loops_per_kf]:
            trace.count("posegraph.candidates")
            with trace.span("posegraph.icp"):
                zq, zt, quality = refine_loop_edge(
                    torch.as_tensor(self.q[j], **kw), torch.as_tensor(self.t[j], **kw),
                    torch.as_tensor(self.clouds[j], **kw),
                    torch.as_tensor(self.masks[j], device=self.device),
                    torch.as_tensor(self.q[k], **kw), torch.as_tensor(self.t[k], **kw),
                    torch.as_tensor(self.clouds[k], **kw),
                    torch.as_tensor(self.masks[k], device=self.device),
                    cell_size=self.cell_size, min_pts=self.icp_min_pts, iters=self.icp_iters,
                )
                quality = float(quality)
            if quality < self.min_quality:
                continue
            # a marginal edge pulls gently, a crisp one firmly
            self.edges.append((int(j), k, _np(zq), _np(zt), self.loop_weight * quality, "loop"))
            self.n_loop_edges += 1
            closed += 1
        if closed:
            trace.count("posegraph.loops_closed", closed)
            self.relax()
            if self.feedback:
                with trace.span("posegraph.feedback"):
                    self._apply_feedback(k)

    def _apply_feedback(self, k):
        """Stage dT = T_opt[k] o T_odom[k]^-1 (the world-frame left delta at
        the newest keyframe) and move the store onto the optimised
        trajectory; the gauge stays pinned at node 0. Odometry edges are
        relative and stay as they are."""
        n = self.count
        dq, Rd, dt = _left_delta(self.opt_q[k], self.opt_t[k], self.q[k], self.t[k])
        self.q[:n] = self.opt_q[:n]
        self.t[:n] = self.opt_t[:n]
        self.n_feedback += 1
        trace.count("posegraph.corrections")
        # compose with a correction not yet taken: dT_new o dT_old
        if self._pending is not None:
            pq, pt = self._pending
            a, b = _h(dq, pq)
            self._pending = (so3.quat_normalize(so3.quat_mul(a, b)).numpy(), Rd @ pt + dt)
        else:
            self._pending = (dq, dt)

    @staticmethod
    def _z_compose(z1, z2):
        """T(a, c) = T(a, b) T(b, c) on (q, t) pairs."""
        q1, t1, q2, t2 = _h(*z1, *z2)
        return so3.quat_mul(q1, q2).numpy(), z1[1] + so3.quat_rotate(q1, t2).numpy()

    @staticmethod
    def _z_inv(z):
        q, t = _h(*z)
        qi = so3.quat_conj(q)
        return qi.numpy(), -so3.quat_rotate(qi, t).numpy()

    def _decimate(self):
        """Halve the keyframe density: keep every other keyframe (and the
        newest), compose the odometry across removed nodes, and remap loop
        edges onto kept endpoints by composing with the odometry between."""
        n = self.count
        keep = list(range(0, n, 2))
        if keep[-1] != n - 1:
            keep.append(n - 1)
        remap = {old: new for new, old in enumerate(keep)}
        odo_z = {e[0]: (e[2], e[3]) for e in self.edges if e[5] == "odo"}

        def chain(a, b):
            z = (np.array([1.0, 0, 0, 0]), np.zeros(3))
            for s in range(a, b):
                z = self._z_compose(z, odo_z[s])
            return z

        new_edges = []
        for a, b in zip(keep[:-1], keep[1:]):
            zq, zt = chain(a, b)
            new_edges.append((remap[a], remap[b], zq, zt, self.odom_weight, "odo"))
        floor_keep = {old: old - (old % 2) for old in range(n)}
        for (i, j, zq, zt, w, kind) in self.edges:
            if kind == "odo":
                continue  # rebuilt above
            i2 = i if i in remap else floor_keep[i]
            j2 = j if j in remap else floor_keep[j]
            if i2 == j2:
                continue
            z = (np.asarray(zq), np.asarray(zt))
            if i2 != i:
                z = self._z_compose(chain(i2, i), z)
            if j2 != j:
                z = self._z_compose(z, self._z_inv(chain(j2, j)))
            new_edges.append((remap[i2], remap[j2], z[0], z[1], w, "loop"))

        idx = np.asarray(keep)
        m = len(keep)
        self.q[:m] = self.q[idx]
        self.t[:m] = self.t[idx]
        self.clouds[:m] = self.clouds[idx]
        self.masks[:m] = self.masks[idx]
        self.times[:m] = self.times[idx]
        self.count = m
        self.edges = new_edges
        self.keyframe_every *= 2
        self.opt_q = self.opt_t = None
        self.relaxed_count = 0

    def take_correction(self):
        """One-shot: the staged world-frame correction (dq [w, x, y, z],
        dt (3,)) or None."""
        c, self._pending = self._pending, None
        return c

    def _pack_edges(self, items, E):
        i = np.zeros(E, np.int64)
        j = np.zeros(E, np.int64)
        zq = np.tile([1.0, 0, 0, 0], (E, 1))
        zt = np.zeros((E, 3))
        w = np.zeros(E)
        m = np.zeros(E, bool)
        for e, (ei, ej, q, t, we, _kind) in enumerate(items[:E]):
            i[e], j[e], zq[e], zt[e], w[e], m[e] = ei, ej, q, t, we, True
        kw = dict(dtype=self.dtype, device=self.device)
        return EdgeSet(i=torch.as_tensor(i, device=self.device),
                       j=torch.as_tensor(j, device=self.device), zq=torch.as_tensor(zq, **kw),
                       zt=torch.as_tensor(zt, **kw), w=torch.as_tensor(w, **kw),
                       mask=torch.as_tensor(m, device=self.device))

    def _edge_sets(self):
        odo = [e for e in self.edges if e[5] == "odo"]
        # loop overflow keeps the newest loop edges
        loops = [e for e in self.edges if e[5] == "loop"][-self.loop_capacity:]
        return (self._pack_edges(odo, self.capacity - 1),
                self._pack_edges(loops, self.loop_capacity))

    def relax(self):
        """Global structured Gauss-Newton (optimize_sparse) over the whole
        capacity, from the raw odometry every time, so the estimate is a
        function of (odometry, edges) alone. Nodes past `count` are inert
        (damped identity blocks; the gauge prior pins node 0). Returns
        (final cost, initial cost)."""
        K = self.capacity
        trace.count("posegraph.relaxes")
        with trace.span("posegraph.relax"):
            odo, loops = self._edge_sets()
            kw = dict(dtype=self.dtype, device=self.device)
            q_opt, t_opt, c1, c0 = optimize_sparse(
                torch.as_tensor(self.q[:K], **kw), torch.as_tensor(self.t[:K], **kw), odo, loops,
                iters=self.relax_iters,
            )
            self.opt_q = q_opt.cpu().numpy().copy()
            self.opt_t = t_opt.cpu().numpy().copy()
            # nodes the optimiser saw live: later keyframes chain onto them
            self.relaxed_count = self.count
            return float(c1), float(c0)

    def trajectory(self):
        """Graph-optimised keyframe trajectory (t, pos, quat). Keyframes
        added after the last relax have no optimised pose (their slots hold
        the solver's inert values): they are chained onto the last relaxed
        node by the raw odometry, T_k = dT o T_raw[k] with
        dT = T_opt[rc-1] o T_raw[rc-1]^-1."""
        n = self.count
        if n == 0:
            return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))
        if self.opt_q is None:
            return self.times[:n].copy(), self.t[:n].copy(), self.q[:n].copy()
        rc = min(self.relaxed_count, n)
        out_q = np.array(self.opt_q[:n])
        out_t = np.array(self.opt_t[:n])
        if 0 < rc < n:
            a = rc - 1
            dq, Rd, dt = _left_delta(out_q[a], out_t[a], self.q[a], self.t[a])
            for k in range(rc, n):
                d, qk = _h(dq, self.q[k])
                out_q[k] = so3.quat_normalize(so3.quat_mul(d, qk)).numpy()
                out_t[k] = Rd @ self.t[k] + dt
        return self.times[:n].copy(), out_t, out_q


def _np(x):
    """A host copy of a tensor or array-like."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
