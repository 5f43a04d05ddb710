"""Sliding-window plane bundle adjustment over keyframes (counterpart of
malio_tpu/ba.py).

A window of keyframe poses is refined by minimising the BALM-style plane
cost

    C(T_1..T_W) = sum over cells of N_c * lambda_min(Cov_c({T_w p_i}))

over coarse hashed voxels that collect the points of every keyframe in
the window. lambda_min of a cell's scatter is the point-to-plane squared
residual sum minimised over the plane, so the planes drop out and the
system is pose-only. The damped Newton iteration takes its gradient and
Hessian on the 6(W-1) tangent from torch.func.grad / hessian.

The per-cell sums are order-fixed (segment.segment_sum), so the cost and
its planarity gate are the same bits on every run on the card. On the
card optimize_window replays one captured iteration (graph.run), with no
host read inside; optimize_window_eager runs it op by op.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import graph
from .device import resolve_device
from .geometry import so3
from .linalg import eigh3
from .preprocess import cell_ids
from .segment import segment_sum


class KeyframeWindow(NamedTuple):
    q: torch.Tensor  # (W, 4) keyframe rotations (body -> world)
    t: torch.Tensor  # (W, 3) keyframe translations
    pts: torch.Tensor  # (W, P, 3) points in each keyframe's body frame
    mask: torch.Tensor  # (W, P)
    valid: torch.Tensor  # (W,) keyframe slots in use


def empty_window(W: int, P: int, dtype=torch.float32, device="cuda") -> KeyframeWindow:
    kw = dict(dtype=dtype, device=resolve_device(device))
    q = torch.zeros((W, 4), **kw)
    q[:, 0] = 1.0
    return KeyframeWindow(
        q=q, t=torch.zeros((W, 3), **kw), pts=torch.zeros((W, P, 3), **kw),
        mask=torch.zeros((W, P), dtype=torch.bool, device=kw["device"]),
        valid=torch.zeros((W,), dtype=torch.bool, device=kw["device"]),
    )


def push_keyframe(win: KeyframeWindow, q, t, pts, mask) -> KeyframeWindow:
    """Slide the window: drop the oldest keyframe, append the new one."""
    return KeyframeWindow(
        q=torch.cat([win.q[1:], q[None]]),
        t=torch.cat([win.t[1:], t[None]]),
        pts=torch.cat([win.pts[1:], pts[None]]),
        mask=torch.cat([win.mask[1:], mask[None]]),
        valid=torch.cat([win.valid[1:], torch.ones((1,), dtype=torch.bool, device=win.valid.device)]),
    )


def _window_cost(dx, win: KeyframeWindow, cell_size, num_cells: int, min_pts: int):
    """Plane cost of the window with the tangent perturbation dx (W, 6),
    [rot(3); trans(3)] boxplus. Keyframe 0 is the gauge (the caller zeroes
    its delta)."""
    q = so3.boxplus(win.q, dx[:, :3])
    t = win.t + dx[:, 3:]
    W, P, _ = win.pts.shape
    world = so3.quat_rotate(q[:, None, :], win.pts) + t[:, None, :]
    w = (win.mask & win.valid[:, None]).to(world.dtype)
    flat = world.reshape(W * P, 3)
    wf = w.reshape(W * P)

    # cells come from the geometry as it stands, constant under
    # differentiation
    cells = cell_ids(flat.detach(), cell_size, num_cells)
    n = segment_sum(wf, cells, num_cells)
    s1 = segment_sum(flat * wf[:, None], cells, num_cells)
    s2 = segment_sum(flat[:, :, None] * flat[:, None, :] * wf[:, None, None], cells, num_cells)
    n_safe = torch.clamp(n, min=1.0)
    mean = s1 / n_safe[:, None]
    cov = s2 / n_safe[:, None, None] - mean[:, :, None] * mean[:, None, :]
    # lambda_min(Cov) = min_n n^T Cov n with the minimising normal frozen
    # per evaluation (no derivative through eigh, whose gap divisions blow
    # up on nearly in-plane-degenerate cells): exact first-order gradients
    # by the envelope theorem, a polynomial pose dependence. The normal is
    # linalg.eigh3's closed form (its sign, which may differ from LAPACK's,
    # cancels); it is finite in every cell, also those the gate drops,
    # whose n * lmin the where below masks (a NaN there would still reach
    # the Hessian as NaN * 0).
    eye = torch.eye(3, dtype=world.dtype, device=world.device)
    lam_sg, nvec = eigh3(cov.detach() + 1e-9 * eye)
    lmin = torch.einsum("ci,cij,cj->c", nvec, cov, nvec)
    # planarity gate: hash-collided or corner cells are not plane-like
    planar = lam_sg[:, 0] < 0.05 * torch.clamp(lam_sg[:, 1], min=1e-12)
    active = (n >= min_pts) & planar
    return torch.sum(torch.where(active, n * lmin, torch.zeros_like(lmin)))


def _window_body(cell_size, num_cells: int, min_pts: int):
    def body(carry, fixed):
        q, t, lam = carry
        pts, mask, valid = fixed
        win = KeyframeWindow(q, t, pts, mask, valid)
        W = q.shape[0]
        dtype, dev = t.dtype, t.device
        cs = torch.full((), cell_size, dtype=dtype, device=dev)
        pin = torch.zeros((1, 6), dtype=dtype, device=dev)

        def cost(dx_free):  # keyframe 0 stays put (gauge)
            return _window_cost(torch.cat([pin, dx_free.reshape(W - 1, 6)]), win, cs, num_cells,
                                min_pts)

        z = torch.zeros((6 * (W - 1),), dtype=dtype, device=dev)
        c = cost(z)
        g = torch.func.grad(cost)(z)
        H = torch.func.hessian(cost)(z)
        Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
        # solve_ex leaves the factorisation's status on the card
        step = -torch.linalg.solve_ex(Hd, g, check_errors=False)[0]
        c_new = cost(step)
        accept = c_new < c
        dx = torch.cat([pin, torch.where(accept, step, z).reshape(W - 1, 6)])
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3)
        return (so3.boxplus(q, dx[:, :3]), t + dx[:, 3:], lam), (c, c_new)
    return body


def _optimize_window(win, cell_size, num_cells, min_pts, iters, damping, eager):
    if iters < 1:
        raise ValueError(f"optimize_window: iters must be >= 1, got {iters}")
    static = (cell_size, num_cells, min_pts)
    fixed = (win.pts, win.mask, win.valid)
    carry = (win.q, win.t, torch.full((), damping, dtype=win.t.dtype, device=win.t.device))
    (q, t, _), (c, c_new) = graph.run(("optimize_window", static, graph.signature(carry, fixed)),
                                      _window_body(*static), carry, fixed, iters, eager)
    return win._replace(q=q, t=t), c_new[-1], c[0]


def optimize_window(win: KeyframeWindow, cell_size=1.0, num_cells: int = 4096, min_pts: int = 6,
                    iters: int = 8, damping=1e-3):
    """Damped (Levenberg-Marquardt) Newton over the pose window, `iters`
    steps, each accepted only if it lowers the cost (damping halves) or
    rejected (damping x4), damping clipped to [1e-6, 1e3].

    Returns (refined window, final cost, initial cost). On a card the step
    is a CUDA graph captured once per shape and static argument and
    replayed `iters` times; `optimize_window_eager` launches it op by op
    (the CPU's way), with the same bits."""
    return _optimize_window(win, cell_size, num_cells, min_pts, iters, damping,
                            eager=win.t.device.type != "cuda")


def optimize_window_eager(win: KeyframeWindow, cell_size=1.0, num_cells: int = 4096,
                          min_pts: int = 6, iters: int = 8, damping=1e-3):
    """`optimize_window` op by op."""
    return _optimize_window(win, cell_size, num_cells, min_pts, iters, damping, eager=True)
