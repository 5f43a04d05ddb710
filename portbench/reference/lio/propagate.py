"""IMU processing: propagation, continuous-time deskew, epoch uncertainty
(counterpart of malio_tpu/propagate.py; ImuProcess::UndistortPcl,
IMU_Processing.hpp:210-523), as fixed-shape batched tensor work:

  1. trim the rolling IMU-rate pose history;
  2. seed it with the optimized pose at the previous scan end;
  3. backward covariance/pose re-propagation over the retained history;
  4. forward propagation over the group's IMU pairs;
  5. continuation propagation on future IMU past the scan end;
  6. B-spline fit over the history and a deskew of every LiDAR point
     (ops/deskew.py: the CUDA kernel on the card);
  7. final partial-dt predict to the group end, pose snapped to the spline;
  8. per-LiDAR per-epoch uncertainty chains and temporal-compensation poses.

Times are relative to the current group; the host keeps absolute f64 time.
Every field carries a leading batch axis B of independent sequences (one
history, one spline and one set of frames each).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import state as st
from . import spline as spl
from . import tree
from . import uncertainty as unc
from .device import resolve_device
from .filter import dynamics
from .linalg import mm
from .ops import deskew as deskew_ops, kernel_enabled

BACKWARD_MIN_INDEX = 2
HISTORY_RETENTION = 0.2


class History(NamedTuple):
    t: torch.Tensor  # ([B,] CAP)
    q: torch.Tensor  # ([B,] CAP, 4)
    p: torch.Tensor  # ([B,] CAP, 3)
    cov: torch.Tensor  # ([B,] CAP, 6, 6)
    inp: torch.Tensor  # ([B,] CAP, 6)
    n: torch.Tensor  # ([B]) int32 valid count


def empty_history(cap: int, dtype=torch.float32, device="cuda") -> History:
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    q = torch.zeros((cap, 4), **kw)
    q[:, 0] = 1.0
    return History(
        t=torch.zeros((cap,), **kw), q=q, p=torch.zeros((cap, 3), **kw),
        cov=torch.zeros((cap, 6, 6), **kw), inp=torch.zeros((cap, 6), **kw),
        n=torch.zeros((), dtype=torch.int32, device=device),
    )


class MeasureGroup(NamedTuple):
    pts: torch.Tensor  # ([B,] L, P, 4) x, y, z, t
    pts_mask: torch.Tensor  # ([B,] L, P)
    beg_t: torch.Tensor  # ([B,] L)
    end_t: torch.Tensor  # ([B,] L)
    imu: torch.Tensor  # ([B,] I, 7) [t, gyro, acc]
    imu_mask: torch.Tensor  # ([B,] I)
    imu_cont: torch.Tensor  # ([B,] IC, 7)
    imu_cont_mask: torch.Tensor  # ([B,] IC)
    t_shift: torch.Tensor  # ([B]) this group's time base minus the previous one


class UndistortResult(NamedTuple):
    x: st.State
    P: torch.Tensor
    hist: History
    last_in: torch.Tensor
    last_imu: torch.Tensor
    pts_deskewed: torch.Tensor  # ([B,] L, P, 3)
    pt_epoch: torch.Tensor  # ([B,] L, P) int64
    base: torch.Tensor  # ([B]) int64 latest-ending LiDAR
    tc_q: torch.Tensor
    tc_t: torch.Tensor
    tc_cov: torch.Tensor
    unc_q: torch.Tensor  # ([B,] L, E, 4)
    unc_t: torch.Tensor
    unc_cov: torch.Tensor
    epoch_count: torch.Tensor  # ([B,] L)
    lt_q: torch.Tensor
    lt_t: torch.Tensor
    lt_cov: torch.Tensor


def _pose_cov6(P):
    return P[..., :6, :6]


def _ext_cov6(P, L):
    """Extrinsic pose covariances of every LiDAR, (..., L, 6, 6), [trans; rot]."""
    it = st.idx_ext_t(L, 0)
    ir = st.idx_ext_r(L, 0)
    out = []
    for l in range(L):
        a, b = it + 3 * l, ir + 3 * l
        tt = P[..., a : a + 3, a : a + 3]
        tr = P[..., a : a + 3, b : b + 3]
        rr = P[..., b : b + 3, b : b + 3]
        out.append(torch.cat([torch.cat([tt, tr], -1), torch.cat([tr.transpose(-1, -2), rr], -1)], -2))
    return torch.stack(out, dim=-3)


def _batch_propagate(x0: st.State, P0, gyros, accs, dts, valids, Q):
    """One propagation pass over K steps of B sequences (inputs (B, K, ...)):
    a sequential mean loop, batched Jacobians, then the log-depth
    all-prefix covariance (dynamics.parallel_covariance).
    Returns (x_final, P_final, post-step states (B, K, ...), Ps (B, K, n, n))."""
    n = P0.shape[-1]
    dtype = P0.dtype
    x = x0
    pres, posts = [], []
    # every step's mean is computed and kept where the sequence takes the
    # step (the reference's masked lax.scan): no host read
    for k in range(gyros.shape[1]):
        x2 = dynamics.step_mean(x, dynamics.Input(acc=accs[:, k], gyro=gyros[:, k]), dts[:, k])
        x2 = st.where_state(valids[:, k], x2, x)
        pres.append(x)
        posts.append(x2)
        x = x2
    pre = tree.stack(pres, 1)
    post = tree.stack(posts, 1)
    _, F, Fw = dynamics.transition(pre, dynamics.Input(acc=accs, gyro=gyros), dts)
    Qt = mm(mm(Fw, Q[:, None]), Fw.transpose(-1, -2))
    I = torch.eye(n, dtype=dtype, device=P0.device)
    v = valids[..., None, None]
    Fs = torch.where(v, F.to(dtype), I)
    Qts = torch.where(v, Qt.to(dtype), torch.zeros_like(I))
    Ps = dynamics.parallel_covariance(Fs, Qts, P0)
    return x, Ps[:, -1], post, Ps


def _compact_history(h: History, keep):
    """The kept entries (B, CAP) of each history first, in time order."""
    big = torch.finfo(h.t.dtype).max
    order = torch.argsort(torch.where(keep, h.t, torch.full_like(h.t, big)), dim=-1, stable=True)
    return History(
        t=tree.take(h.t, order), q=tree.take(h.q, order), p=tree.take(h.p, order),
        cov=tree.take(h.cov, order), inp=tree.take(h.inp, order),
        n=torch.sum(keep, dim=-1).to(torch.int32),
    )


def _put(buf, tgt, val):
    """buf (B, CAP, ...) with val (B, K, ...) written at slots tgt (B, K);
    slot CAP is a dump row that is dropped."""
    padded = torch.cat([buf, torch.zeros_like(buf[:, :1])], dim=1)
    B = buf.shape[0]
    padded[torch.arange(B, device=buf.device)[:, None], tgt] = val.to(buf.dtype)
    return padded[:, : buf.shape[1]]


def _append(h: History, t, q, p, cov, inp, valid):
    """Append masked entries (B, K, ...) in order; entries past the
    capacity are dropped."""
    cap = h.t.shape[1]
    pos = h.n[:, None] + torch.cumsum(valid.to(torch.int64), 1) - 1
    tgt = torch.where(valid & (pos < cap), pos, torch.full_like(pos, cap))
    return History(
        t=_put(h.t, tgt, t), q=_put(h.q, tgt, q), p=_put(h.p, tgt, p), cov=_put(h.cov, tgt, cov),
        inp=_put(h.inp, tgt, inp), n=h.n + torch.sum(valid, dim=1).to(torch.int32),
    )


def undistort(cfg, x: st.State, P, hist: History, group: MeasureGroup, Q,
              last_in, last_imu, last_end_t, mean_acc_norm, shard=None) -> UndistortResult:
    """One round's undistortion for B sequences (every argument with a
    leading B). With `shard` (an mp group) `group.pts` holds this rank's
    slice of the raw point axis: the per-point results (`pts_deskewed`,
    `pt_epoch`) are the slice's, and the deskew kernel takes the layout of
    the whole set."""
    B = P.shape[0]
    L = x.num_lidars
    dtype = x.pos.dtype
    dev = x.pos.device
    cap = hist.t.shape[1]
    E = cfg.epoch_capacity
    big = torch.finfo(dtype).max
    ar_L = torch.arange(L, device=dev)

    g_scale = (cfg.gravity / mean_acc_norm)[:, None]

    hist = hist._replace(t=hist.t - group.t_shift[:, None])
    last_end_t = last_end_t - group.t_shift
    last_imu = last_imu.clone()
    last_imu[:, 0] = last_imu[:, 0] - group.t_shift

    base = torch.argmax(group.end_t, dim=-1)
    pcl_end = torch.amax(group.end_t, dim=-1)
    pcl_beg = tree.take(group.beg_t, torch.argmin(group.end_t, dim=-1))

    imu_t = group.imu[..., 0]
    last_imu_idx = torch.argmax(torch.where(group.imu_mask, imu_t, torch.full_like(imu_t, -big)), dim=-1)
    imu_end = tree.take(imu_t, last_imu_idx)
    imu_beg = last_imu[:, 0]

    # ---- 1. trim history ----
    live = torch.arange(cap, device=dev) < hist.n[:, None]
    keep = live & (hist.t + HISTORY_RETENTION >= pcl_beg[:, None]) & (hist.t <= imu_beg[:, None])
    hist = _compact_history(hist, keep)

    # ---- 2. seed with the optimized pose at the last scan end ----
    hist = _append(
        hist, t=last_end_t[:, None], q=x.rot[:, None], p=x.pos[:, None],
        cov=_pose_cov6(P)[:, None], inp=last_in[:, None], valid=(last_end_t != 0.0)[:, None],
    )

    # ---- 3. backward re-propagation ----
    rev = torch.arange(cap - 1, 0, -1, device=dev)
    bactive = (rev >= BACKWARD_MIN_INDEX) & (rev <= hist.n[:, None] - 1)
    bdts = hist.t[:, rev - 1] - hist.t[:, rev]
    _, _, bposts, bPs = _batch_propagate(
        x, P, hist.inp[:, rev, 0:3], hist.inp[:, rev, 3:6], bdts, bactive, Q
    )
    wslot = torch.where(bactive, rev - 1, torch.full_like(rev, cap))
    hist = hist._replace(
        q=_put(hist.q, wslot, bposts.rot), p=_put(hist.p, wslot, bposts.pos),
        cov=_put(hist.cov, wslot, bPs[..., :6, :6]),
    )

    # ---- 4. forward propagation ----
    head = torch.cat([last_imu[:, None], group.imu[:, :-1]], dim=1)
    tails = group.imu
    valid_f = group.imu_mask & (tails[..., 0] >= last_end_t[:, None])
    f_gyro = 0.5 * (head[..., 1:4] + tails[..., 1:4])
    f_acc = 0.5 * (head[..., 4:7] + tails[..., 4:7]) * g_scale[:, None]
    f_dts = tails[..., 0] - torch.maximum(head[..., 0], last_end_t[:, None])
    x_f, P_f, fposts, fPs = _batch_propagate(x, P, f_gyro, f_acc, f_dts, valid_f, Q)
    hist = _append(hist, tails[..., 0], fposts.rot, fposts.pos, fPs[..., :6, :6],
                   torch.cat([f_gyro, f_acc], -1), valid_f)

    # ---- 5. continuation on future IMU ----
    c_head = group.imu_cont[:, :-1]
    c_tail = group.imu_cont[:, 1:]
    valid_c = group.imu_cont_mask[:, :-1] & group.imu_cont_mask[:, 1:]
    c_gyro = 0.5 * (c_head[..., 1:4] + c_tail[..., 1:4])
    c_acc = 0.5 * (c_head[..., 4:7] + c_tail[..., 4:7]) * g_scale[:, None]
    c_dts = c_tail[..., 0] - c_head[..., 0]
    _, _, cposts, cPs = _batch_propagate(x_f, P_f, c_gyro, c_acc, c_dts, valid_c, Q)
    hist = _append(hist, c_tail[..., 0], cposts.rot, cposts.pos, cPs[..., :6, :6],
                   torch.cat([c_gyro, c_acc], -1), valid_c)

    # ---- spline over the history ----
    live = torch.arange(cap, device=dev) < hist.n[:, None]
    sp = spl.feed_trajectory(hist.t, hist.q, hist.p, live, cfg.spline_capacity)

    # ---- 7. final partial-dt predict to pcl_end ----
    c1 = group.imu_cont[:, 1]
    last7 = tree.take(group.imu, last_imu_idx)
    ratio = ((pcl_end - last7[:, 0]) / torch.clamp(c1[:, 0] - last7[:, 0], min=1e-9))[:, None]
    gyro_i = ratio * last7[:, 1:4] + (1.0 - ratio) * c1[:, 1:4]
    acc_i = (ratio * last7[:, 4:7] + (1.0 - ratio) * c1[:, 4:7]) * g_scale
    u_last = dynamics.Input(acc=acc_i, gyro=gyro_i)
    x_f, F, Fw = dynamics.transition(x_f, u_last, pcl_end - imu_end)
    F = F.to(P_f.dtype)
    P_f = mm(mm(F, P_f), F.transpose(-1, -2)) + mm(mm(Fw, Q), Fw.transpose(-1, -2)).to(P_f.dtype)

    sq, spos, sok = spl.get_pose(sp, pcl_end[:, None])
    x_f = x_f._replace(pos=torch.where(sok, spos[:, 0], x_f.pos),
                       rot=torch.where(sok, sq[:, 0], x_f.rot))

    # ---- per-LiDAR scan-end frames ----
    masked_t = torch.where(live, hist.t, torch.full_like(hist.t, big)).contiguous()
    cp0 = torch.searchsorted(masked_t, group.end_t.contiguous(), right=True)
    lt_q_all, lt_t_all, _ = spl.get_pose_batch(sp, group.end_t)
    is_base = ar_L[None, :] == base[:, None]
    lt_q = torch.where(is_base[..., None], x_f.rot[:, None], lt_q_all)
    lt_t = torch.where(is_base[..., None], x_f.pos[:, None], lt_t_all)
    lt_cov = torch.where(
        is_base[..., None, None], _pose_cov6(P_f).to(dtype)[:, None],
        tree.take(hist.cov, torch.clamp(cp0, 0, cap - 1)),
    )

    # ---- 6. point deskew (all sequences in one launch) ----
    ext_q, ext_t = x_f.ext_r, x_f.ext_t
    if kernel_enabled(cfg.deskew_kernel, group.pts):
        whole = {} if shard is None else {"layout_points": group.pts[..., 0].numel() * shard.size}
        out = deskew_ops.deskew_points(group.pts, sp, ext_q, ext_t, lt_q, lt_t, **whole)
    else:
        out = deskew_ops.deskew_points_plain(group.pts, sp, ext_q, ext_t, lt_q, lt_t)
    pts_deskewed = out[..., :3]

    flat_t = group.pts[..., 3].reshape(B, -1).contiguous()
    rank = torch.searchsorted(masked_t, flat_t, right=True).reshape(B, L, -1)
    pt_epoch = torch.clamp(cp0[..., None] - rank, min=0)

    # ---- 8. per-epoch uncertainty chains ----
    ks = torch.arange(E, device=dev)
    jmat = cp0[..., None] - ks
    first_above_beg = torch.searchsorted(masked_t, group.beg_t.contiguous(), right=True)
    epoch_count = torch.clamp(cp0 - first_above_beg + 1, 1, E)
    jmat_c = torch.clamp(jmat, 0, cap - 1)
    tau = torch.minimum(group.end_t[..., None], tree.take(hist.t, jmat_c))
    eq, ep, _ = spl.get_pose_batch(sp, tau.reshape(B, -1))
    pt_pose = unc.Pose(q=eq.reshape(B, L, E, 4), t=ep.reshape(B, L, E, 3),
                       cov=tree.take(hist.cov, jmat_c))

    ext_pose = unc.Pose(q=ext_q, t=ext_t, cov=_ext_cov6(P_f, L).to(dtype))
    lt_pose = unc.Pose(q=lt_q, t=lt_t, cov=lt_cov)

    def col(p: unc.Pose):  # (B, L, ...) -> (B, L, 1, ...) to broadcast over epochs
        return unc.Pose(p.q[:, :, None], p.t[:, :, None], p.cov[:, :, None])

    a = unc.compound_pose(pt_pose, col(ext_pose))
    b = unc.compound_inv_pose(col(lt_pose), a)
    chain = unc.compound_inv_pose(col(ext_pose), b)

    # ---- temporal compensation poses ----
    lt_b = unc.Pose(*(tree.take(f, base)[:, None] for f in lt_pose))
    tc = unc.compound_inv_pose(lt_b, lt_pose)
    q_id = torch.eye(4, dtype=dtype, device=dev)[0]
    tc_q = torch.where(is_base[..., None], q_id, tc.q)
    tc_t = torch.where(is_base[..., None], torch.zeros_like(tc.t), tc.t)
    tc_cov = torch.where(is_base[..., None, None], torch.zeros_like(tc.cov), tc.cov)

    return UndistortResult(
        x=x_f, P=P_f, hist=hist, last_in=torch.cat([gyro_i, acc_i], -1),
        last_imu=last7, pts_deskewed=pts_deskewed,
        pt_epoch=pt_epoch, base=base, tc_q=tc_q, tc_t=tc_t, tc_cov=tc_cov,
        unc_q=chain.q, unc_t=chain.t, unc_cov=chain.cov, epoch_count=epoch_count,
        lt_q=lt_q, lt_t=lt_t, lt_cov=lt_cov,
    )
