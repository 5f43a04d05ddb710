"""The plain reference of the pose-graph back end: loop candidates, the
point-to-plane ICP and its coarse-to-fine pick, the global relaxation and
the world-frame correction it feeds back, written from the description
the program publishes (malio_tpu_torch/posegraph.py's docstrings) in plain
PyTorch, float64 unless a control asks for less. It imports nothing of
the program; the reference round it corrects is reference/lio's.

  detect_loops   earlier keyframes, its two predecessors skipped, within
                 `radius` metres and more than `min_time_gap` seconds
                 older, nearest first;
  icp            one stage: the target cloud's points hashed into
                 `num_cells` cells (the Teschner hash of the int32 cell
                 key, reimplemented), a plane a cell (centroid, smallest
                 eigenvector, kept with >= min_pts points and smallest
                 eigenvalue under a tenth of the middle one), then
                 Gauss-Newton on the relative pose, re-associating by
                 cell each iteration, Huber-weighted, and the quality
                 matched fraction x (1 - rms1 / max(rms0, huber));
  refine         the coarse stage at cell_size (Huber 0.3), the fine one
                 at cell_size / 2 (Huber 0.15) from the coarse result, the
                 better quality kept;
  fit_gap        how differently two relative poses fit the target's
                 planes (the residuals' change over the matched points);
  relax          damped Gauss-Newton (LM) over the live nodes as one dense
                 6n x 6n system solved by torch.linalg.solve, the damping
                 lam diag(H_odometry) + 1e-6 and a 1e8 prior on node 0;
  left_delta     the world-frame correction dT with dT o T_from = T_to;
  world_correction  that correction applied to a reference/lio carry:
                 state, P, IMU history, map re-hash, box and eviction.

Departures from the program, each a different road to the same numbers:
rotations compose as quaternions of this file's own; a cell's plane comes
from a two-pass covariance (centroid first) and LAPACK's eigh, not from
running sums and a closed-form 3x3 eigensolver; the ICP's Jacobian is
analytic, n^T [s x R^T n]; the relaxation's Jacobian is forward-mode
through the whole residual vector at once and the system is dense over
the live nodes, where the program assembles a block-tridiagonal odometry
chain plus loop couplings by the Woodbury identity over all its capacity
(nodes past the live ones are inert there: no edge reaches them).
"""
from __future__ import annotations

import numpy as np
import torch

from .lio import pipeline, runner, tree
from .lio import propagate as prop
from .lio import state as st
from .lio.device import set_carry_dtype
from .lio.geometry import s2, so3
from .lio.map import voxel_hash as vh
from .replay import FIELDS, _Captured, _init_seq

F64 = torch.float64
MASK32 = 0xFFFFFFFF
HASH_PRIMES = (73856093, 19349663, 83492791)
NUM_CELLS = 8192  # the ICP's hashed cells (posegraph.icp_point_to_plane's default)
HUBER_COARSE, HUBER_FINE = 0.3, 0.15
ICP_DAMPING = 1e-6
RELAX_DAMPING = 1e-4
GAUGE_PRIOR = 1e8


# -- rotations: unit quaternions [w, x, y, z] ------------------------------

def qmul(a, b):
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    return torch.cat([aw * bw - torch.sum(av * bv, -1, keepdim=True),
                      aw * bv + bw * av + torch.linalg.cross(av, bv, dim=-1)], dim=-1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnorm(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qmat(q):
    """The rotation matrix of q."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def qrot(q, v):
    return (qmat(q) @ v[..., None])[..., 0]


def qexp(v):
    """Rotation vector -> quaternion (a series near zero, so forward-mode
    derivatives stay finite there)."""
    n2 = torch.sum(v * v, -1, keepdim=True)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    k = torch.where(small, 0.5 - n2 / 48.0, torch.sin(0.5 * n) / n)
    w = torch.where(small, 1.0 - n2 / 8.0, torch.cos(0.5 * n))
    return torch.cat([w, k * v], dim=-1)


def qlog(q):
    """Quaternion -> rotation vector, the shorter way round."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w, u = q[..., :1], q[..., 1:]
    n2 = torch.sum(u * u, -1, keepdim=True)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    k = torch.where(small, 2.0 / w - 2.0 * n2 / (3.0 * w ** 3), 2.0 * torch.atan2(n, w) / n)
    return k * u


def boxplus(q, d):
    """q o Exp(d): a right-sided perturbation."""
    return qnorm(qmul(q, qexp(d)))


def angle(qa, qb):
    """The angle between two orientations (rad), from the vector part of
    qa^-1 qb (an arccos of their dot product loses half the digits near 0)."""
    d = qmul(qconj(qnorm(qa)), qnorm(qb))
    return 2.0 * torch.atan2(torch.linalg.norm(d[..., 1:], dim=-1), torch.abs(d[..., 0]))


def relative(qi, ti, qj, tj):
    """T_i^-1 T_j as (q, t)."""
    return qmul(qconj(qi), qj), qrot(qconj(qi), tj - ti)


# -- loop candidates ----------------------------------------------------------

def detect_loops(pos, times, current, radius, min_time_gap, exclude_last=2):
    """Candidate keyframes for keyframe `current` (see the module's
    docstring), nearest first (ties in index order)."""
    pos, times = np.asarray(pos, np.float64), np.asarray(times, np.float64)
    c = int(current)
    out = []
    for j in range(0, max(0, c - exclude_last)):
        d = float(np.sqrt(np.sum((pos[j] - pos[c]) ** 2)))
        if d < radius and times[c] - times[j] > min_time_gap:
            out.append((d, j))
    return [j for _, j in sorted(out)]


# -- ICP ------------------------------------------------------------------------

def cell_of(pts, cell_size, num_cells):
    """The hashed cell of each point: the xor of the int32 cell key's
    wrapped products with three primes, as an unsigned 32-bit value,
    modulo num_cells."""
    k = torch.floor(pts / cell_size).to(torch.int64) & MASK32
    h = torch.zeros(k.shape[:-1], dtype=torch.int64, device=pts.device)
    for a, p in enumerate(HASH_PRIMES):
        h = h ^ ((k[..., a] * p) & MASK32)
    return h % num_cells


def plane_model(pts, mask, cell_size, num_cells, min_pts):
    """(centroid (C, 3), unit normal (C, 3), valid (C,)) of each cell."""
    h = cell_of(pts, cell_size, num_cells)
    w = mask.to(pts.dtype)
    n = torch.zeros(num_cells, dtype=pts.dtype).index_add_(0, h, w)
    c = torch.zeros(num_cells, 3, dtype=pts.dtype).index_add_(0, h, pts * w[:, None])
    c = c / n.clamp(min=1.0)[:, None]
    d = (pts - c[h]) * w[:, None]
    cov = torch.zeros(num_cells, 3, 3, dtype=pts.dtype).index_add_(
        0, h, d[:, :, None] * d[:, None, :]) / n.clamp(min=1.0)[:, None, None]
    lam, vec = torch.linalg.eigh(cov)
    valid = (n >= min_pts) & (lam[:, 0] < 0.1 * lam[:, 1].clamp(min=1e-12))
    return c, vec[:, :, 0], valid


def icp(tgt, tgt_mask, src, src_mask, zq, zt, cell_size, min_pts, iters, huber,
        damping=ICP_DAMPING, num_cells=NUM_CELLS, dtype=F64):
    """One ICP stage of src onto tgt's plane model from (zq, zt): returns
    (zq, zt, quality)."""
    tgt, src, zq, zt = (torch.as_tensor(a).to(dtype) for a in (tgt, src, zq, zt))
    tgt_mask, src_mask = torch.as_tensor(tgt_mask).bool(), torch.as_tensor(src_mask).bool()
    cs = torch.tensor(cell_size, dtype=dtype)
    c, nrm, valid = plane_model(tgt, tgt_mask, cs, num_cells, min_pts)

    def residuals(zq, zt):
        p = qrot(zq, src) + zt
        h = cell_of(p, cs, num_cells)
        r = torch.sum(nrm[h] * (p - c[h]), -1)
        w = (valid[h] & src_mask).to(dtype)
        a = r.abs()
        w = w * torch.where(a <= huber, torch.ones_like(a), huber / a.clamp(min=1e-12))
        return r, w, nrm[h]

    def rms(zq, zt):
        r, w, _ = residuals(zq, zt)
        return torch.sqrt(torch.sum(w * r * r) / torch.sum(w).clamp(min=1.0)), w

    rms0, _ = rms(zq, zt)
    for _ in range(iters):
        r, w, n = residuals(zq, zt)
        a = (qmat(zq).transpose(-1, -2) @ n[..., None])[..., 0]  # R^T n
        J = torch.cat([torch.linalg.cross(src, a, dim=-1), n], dim=-1)  # (M, 6)
        A = (J * w[:, None]).T @ J + damping * torch.eye(6, dtype=dtype)
        dx = -torch.linalg.solve(A, (J * w[:, None]).T @ r)
        zq, zt = boxplus(zq, dx[:3]), zt + dx[3:]
    rms1, w1 = rms(zq, zt)
    frac = torch.sum(w1 > 0).to(dtype) / torch.sum(src_mask).clamp(min=1).to(dtype)
    quality = frac * torch.clamp(1.0 - rms1 / rms0.clamp(min=huber), min=0.0)
    return zq, zt, quality


def fit_gap(tgt, tgt_mask, src, src_mask, pose, ref_pose, cell_size, min_pts,
            num_cells=NUM_CELLS):
    """How differently two relative poses (q, t) fit src onto tgt's plane
    model at cell_size (the coarse stage's): the RMS, over the source points
    that fall in a planar cell at `ref_pose`, of the change of their
    point-to-plane residuals between the poses, n . (p_pose - p_ref) (m). A
    difference the planes do not see (a slide along them, which an ICP on
    sparse clouds leaves to round-off) reads ~0; one they see reads its
    size."""
    tgt, src = (torch.as_tensor(np.asarray(a, np.float64)) for a in (tgt, src))
    tgt_mask, src_mask = torch.as_tensor(tgt_mask).bool(), torch.as_tensor(src_mask).bool()
    (qa, ta), (qb, tb) = ((torch.as_tensor(np.asarray(x, np.float64)) for x in pose_)
                          for pose_ in (pose, ref_pose))
    cs = torch.tensor(cell_size, dtype=F64)
    _, nrm, valid = plane_model(tgt, tgt_mask, cs, num_cells, min_pts)
    pb = qrot(qnorm(qb), src) + tb
    h = cell_of(pb, cs, num_cells)
    w = (valid[h] & src_mask).to(F64)
    d = torch.sum(nrm[h] * (qrot(qnorm(qa), src) + ta - pb), -1)
    return float(torch.sqrt(torch.sum(w * d * d) / torch.sum(w).clamp(min=1.0)))


def refine(q_i, t_i, cloud_i, mask_i, q_j, t_j, cloud_j, mask_j, cell_size, min_pts, iters,
           dtype=F64):
    """The loop edge i -> j by coarse-to-fine ICP of j's cloud onto i's:
    (zq, zt, quality) as float64 numpy."""
    q_i, t_i, q_j, t_j = (torch.as_tensor(np.asarray(a, np.float64)).to(dtype)
                          for a in (q_i, t_i, q_j, t_j))
    zq0, zt0 = relative(q_i, t_i, q_j, t_j)
    args = (cloud_i, mask_i, cloud_j, mask_j)
    q1, t1, g1 = icp(*args, zq0, zt0, cell_size, min_pts, iters, HUBER_COARSE, dtype=dtype)
    q2, t2, g2 = icp(*args, q1, t1, cell_size / 2.0, min_pts, iters, HUBER_FINE, dtype=dtype)
    zq, zt = (q2, t2) if g2 >= g1 else (q1, t1)
    return (zq.to(F64).numpy(), zt.to(F64).numpy(), float(max(g1, g2)))


# -- relaxation -------------------------------------------------------------------

def _edges(edges, n, dtype):
    """The masked edges of a packed set (dict of arrays i, j, zq, zt, w,
    mask), every endpoint a live node."""
    m = np.asarray(edges["mask"], bool)
    i, j = np.asarray(edges["i"])[m].astype(np.int64), np.asarray(edges["j"])[m].astype(np.int64)
    if len(i) and max(i.max(), j.max()) >= n:
        raise ValueError("an edge reaches a node past the live ones")
    t = (lambda a: torch.as_tensor(np.asarray(a, np.float64)[m]).to(dtype))
    return torch.as_tensor(i), torch.as_tensor(j), t(edges["zq"]), t(edges["zt"]), t(edges["w"])


def _residual(q, t, e):
    """All edges' residuals [trans; rot] (E, 6) at the poses."""
    i, j, zq, zt, _ = e
    rq, rt = relative(q[i], t[i], q[j], t[j])
    return torch.cat([rt - zt, qlog(qmul(qconj(zq), rq))], dim=-1)


def _cost(q, t, sets):
    return sum(torch.sum(e[4] * torch.sum(_residual(q, t, e) ** 2, -1)) for e in sets)


def _system(q, t, e, n):
    """w J^T J (6n, 6n) and w J^T r (6n,) of one edge set, J by forward
    mode through every residual at once in all nodes' tangents."""
    dtype = t.dtype

    def res(dx):
        d = dx.reshape(n, 6)
        return _residual(boxplus(q, d[:, :3]), t + d[:, 3:], e).reshape(-1)

    z = torch.zeros(6 * n, dtype=dtype)
    r = res(z)
    J = torch.func.jacfwd(res)(z)  # (6E, 6n)
    w = e[4].repeat_interleave(6)
    return (J * w[:, None]).T @ J, (J * w[:, None]).T @ r


def relax(q, t, odo, loops, n, iters=10, damping=RELAX_DAMPING, dtype=F64):
    """`iters` LM iterations over the live nodes 0 .. n - 1 from (q, t),
    on the odometry and loop edge sets (packed as the program packs them).
    Returns (q (n, 4), t (n, 3)) as float64 numpy."""
    q = torch.as_tensor(np.asarray(q, np.float64)[:n]).to(dtype)
    t = torch.as_tensor(np.asarray(t, np.float64)[:n]).to(dtype)
    eo, el = _edges(odo, n, dtype), _edges(loops, n, dtype)
    lam = torch.tensor(damping, dtype=dtype)
    prior = torch.zeros(6 * n, dtype=dtype)
    prior[:6] = GAUGE_PRIOR
    for _ in range(iters):
        Ho, bo = _system(q, t, eo, n)
        Hl, bl = _system(q, t, el, n)
        c = _cost(q, t, (eo, el))
        damp = lam * torch.diagonal(Ho).clamp(min=1e-9) + 1e-6 + prior
        dx = -torch.linalg.solve(Ho + Hl + torch.diag(damp), bo + bl).reshape(n, 6)
        q1, t1 = boxplus(q, dx[:, :3]), t + dx[:, 3:]
        accept = bool(_cost(q1, t1, (eo, el)) < c)
        lam = torch.clamp(lam * (0.5 if accept else 4.0), 1e-8, 1e4)
        if accept:
            q, t = q1, t1
    return q.to(F64).numpy(), t.to(F64).numpy()


def left_delta(q_to, t_to, q_from, t_from):
    """(dq, dt) with dT o T_from = T_to, float64 numpy."""
    a, b = (torch.as_tensor(np.asarray(x, np.float64)) for x in (q_to, q_from))
    dq = qnorm(qmul(a, qconj(b)))
    dt = torch.as_tensor(np.asarray(t_to, np.float64)) - qrot(dq, torch.as_tensor(
        np.asarray(t_from, np.float64)))
    return dq.numpy(), dt.numpy()


# -- the correction of the reference round's carry -----------------------------------

def world_correction(cfg, carry, dq, dt):
    """A reference/lio carry (one sequence) moved by T' = dT o T: pose,
    velocity and gravity turned (the rotation tangent is right-sided, so
    its block stays the identity; gravity crosses its S2 chart), P
    conjugated by that Jacobian, the IMU history moved with its
    covariances turned, every map point moved and re-hashed into a fresh
    table, the local box re-centred on the corrected pose and the map
    evicted to it, the warm start Pi dropped."""
    dtype = carry.x.pos.dtype
    dq = so3.quat_normalize(torch.as_tensor(dq).to(dtype=dtype, device=carry.x.pos.device))
    dt = torch.as_tensor(dt).to(dtype=dtype, device=dq.device)
    x = carry.x
    L = x.ext_r.shape[0]
    R = so3.quat_to_mat(dq)
    grav = so3.quat_rotate(dq, x.grav)
    x2 = x._replace(pos=so3.quat_rotate(dq, x.pos) + dt,
                    rot=so3.quat_normalize(so3.quat_mul(dq, x.rot)),
                    vel=so3.quat_rotate(dq, x.vel), grav=grav)
    J = torch.eye(carry.P.shape[0], dtype=dtype, device=dq.device)
    p, v, g = st.idx_pos(L), st.idx_vel(L), st.idx_grav(L)
    J[p : p + 3, p : p + 3] = R
    J[v : v + 3, v : v + 3] = R
    J[g : g + 2, g : g + 2] = s2.s2_nx_yy(grav) @ R @ s2.s2_mx(
        x.grav, torch.zeros(2, dtype=dtype, device=dq.device))
    J = J.to(carry.P.dtype)
    h = carry.hist
    Rb = torch.eye(6, dtype=dtype, device=dq.device)
    Rb[:3, :3] = R
    hist = h._replace(q=so3.quat_normalize(so3.quat_mul(dq[None], h.q)),
                      p=so3.quat_rotate(dq[None], h.p) + dt,
                      cov=Rb[None] @ h.cov @ Rb.T[None])
    half = torch.tensor(cfg.cube_len / 2.0, dtype=dtype, device=dq.device)
    lo, hi = x2.pos - half, x2.pos + half
    return carry._replace(x=x2, P=J @ carry.P @ J.T, hist=hist,
                          map=vh.evict_outside(vh.transform(carry.map, dq, dt), lo, hi),
                          box_min=lo, box_max=hi, box_init=torch.ones_like(carry.box_init),
                          Pi=torch.zeros_like(carry.Pi))


def replay_corrected(cfg, groups, corrections, device="cuda", control=None,
                     dtype=torch.float32):
    """The reference round over one sequence's groups (IMU-initialised as
    the program's runner does), with the correction corrections[r] =
    (dq, dt) applied to the carry after fused round r, cast to the points'
    dtype as the program's runner casts it. `control` is None or "tf32"
    (reference/replay.CONTROLS). Returns {field: array (1, R, ...)} as
    reference/replay.replay does; on a card the round is one captured
    CUDA graph, the corrections applied between replays."""
    tf32 = control == "tf32"
    if control not in (None, "tf32"):
        raise ValueError(f"the corrected replay takes no control {control!r}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    set_carry_dtype(torch.float64)
    graph = None
    try:
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        carry, stream, base = _init_seq(cfg, groups, dtype, device)
        carry = tree.unsqueeze(carry)
        captured = torch.device(device).type == "cuda"
        out = {f: [] for f in FIELDS}
        for k in range(len(stream)):
            a, bs = runner._chunk_arrays([stream[k]], np_dtype, base)
            base = float(bs[0])
            group = prop.MeasureGroup(**{f: torch.as_tensor(a[f]).to(device)
                                         for f in prop.MeasureGroup._fields})
            if captured:
                if graph is None:
                    graph = _Captured(
                        lambda c, g: pipeline.step_eager(cfg, c, g, device=device), carry, group)
                o = graph.step(group)
            else:
                carry, o = pipeline.step_eager(cfg, carry, group, device=device)
            for f in FIELDS:
                v = getattr(o, f).detach().cpu().numpy()
                out[f].append(v.astype(np.float64) + base if f == "end_time" else v)
            if k in corrections:
                dq, dt = corrections[k]
                cur = graph.carry if captured else carry
                new = tree.unsqueeze(world_correction(cfg, tree.squeeze(cur), dq, dt))
                if captured:
                    for d, s in zip(tree.leaves(graph.carry), tree.leaves(new)):
                        d.copy_(s)
                else:
                    carry = new
        return {f: np.stack(v, axis=1) if v else np.zeros((1, 0)) for f, v in out.items()}
    finally:
        del graph
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
