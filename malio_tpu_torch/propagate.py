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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import state as st
from . import spline as spl
from . import uncertainty as unc
from .filter import dynamics
from .ops import deskew as deskew_ops, kernel_enabled

BACKWARD_MIN_INDEX = 2
HISTORY_RETENTION = 0.2


class History(NamedTuple):
    t: torch.Tensor  # (CAP,)
    q: torch.Tensor  # (CAP, 4)
    p: torch.Tensor  # (CAP, 3)
    cov: torch.Tensor  # (CAP, 6, 6)
    inp: torch.Tensor  # (CAP, 6)
    n: torch.Tensor  # () int32 valid count


def empty_history(cap: int, dtype=torch.float32, device="cpu") -> History:
    kw = dict(dtype=dtype, device=device)
    q = torch.zeros((cap, 4), **kw)
    q[:, 0] = 1.0
    return History(
        t=torch.zeros((cap,), **kw), q=q, p=torch.zeros((cap, 3), **kw),
        cov=torch.zeros((cap, 6, 6), **kw), inp=torch.zeros((cap, 6), **kw),
        n=torch.zeros((), dtype=torch.int32, device=device),
    )


class MeasureGroup(NamedTuple):
    pts: torch.Tensor  # (L, P, 4) x, y, z, t
    pts_mask: torch.Tensor  # (L, P)
    beg_t: torch.Tensor  # (L,)
    end_t: torch.Tensor  # (L,)
    imu: torch.Tensor  # (I, 7) [t, gyro, acc]
    imu_mask: torch.Tensor  # (I,)
    imu_cont: torch.Tensor  # (IC, 7)
    imu_cont_mask: torch.Tensor  # (IC,)
    t_shift: torch.Tensor  # () this group's time base minus the previous one


class UndistortResult(NamedTuple):
    x: st.State
    P: torch.Tensor
    hist: History
    last_in: torch.Tensor
    last_imu: torch.Tensor
    pts_deskewed: torch.Tensor  # (L, P, 3)
    pt_epoch: torch.Tensor  # (L, P) int64
    base: torch.Tensor  # () int64 latest-ending LiDAR
    tc_q: torch.Tensor
    tc_t: torch.Tensor
    tc_cov: torch.Tensor
    unc_q: torch.Tensor  # (L, E, 4)
    unc_t: torch.Tensor
    unc_cov: torch.Tensor
    epoch_count: torch.Tensor  # (L,)
    lt_q: torch.Tensor
    lt_t: torch.Tensor
    lt_cov: torch.Tensor


def _pose_cov6(P):
    return P[:6, :6]


def _ext_cov6(P, L):
    """Extrinsic pose covariances of every LiDAR, (L, 6, 6), [trans; rot]."""
    it = st.idx_ext_t(L, 0)
    ir = st.idx_ext_r(L, 0)
    out = []
    for l in range(L):
        a, b = it + 3 * l, ir + 3 * l
        tt = P[a : a + 3, a : a + 3]
        tr = P[a : a + 3, b : b + 3]
        rr = P[b : b + 3, b : b + 3]
        out.append(torch.cat([torch.cat([tt, tr], -1), torch.cat([tr.T, rr], -1)], -2))
    return torch.stack(out)


def _stack_states(states):
    return st.State(*(torch.stack(f) for f in zip(*states)))


def _batch_propagate(x0: st.State, P0, gyros, accs, dts, valids, Q):
    """One propagation pass: a sequential mean loop, batched Jacobians,
    then the log-depth all-prefix covariance (dynamics.parallel_covariance).
    Returns (x_final, P_final, post-step states (batched), Ps)."""
    n = P0.shape[0]
    dtype = P0.dtype
    x = x0
    pres, posts = [], []
    for k in range(gyros.shape[0]):
        x2 = dynamics.step_mean(x, dynamics.Input(acc=accs[k], gyro=gyros[k]), dts[k])
        x2 = st.where_state(valids[k], x2, x)
        pres.append(x)
        posts.append(x2)
        x = x2
    pre = _stack_states(pres)
    post = _stack_states(posts)
    _, F, Fw = dynamics.transition(pre, dynamics.Input(acc=accs, gyro=gyros), dts)
    Qt = Fw @ Q @ Fw.transpose(-1, -2)
    I = torch.eye(n, dtype=dtype, device=P0.device)
    v = valids[:, None, None]
    Fs = torch.where(v, F.to(dtype), I)
    Qts = torch.where(v, Qt.to(dtype), torch.zeros_like(I))
    Ps = dynamics.parallel_covariance(Fs, Qts, P0)
    return x, Ps[-1], post, Ps


def _compact_history(h: History, keep):
    big = torch.finfo(h.t.dtype).max
    order = torch.argsort(torch.where(keep, h.t, torch.full_like(h.t, big)), stable=True)
    return History(
        t=h.t[order], q=h.q[order], p=h.p[order], cov=h.cov[order],
        inp=h.inp[order], n=torch.sum(keep).to(torch.int32),
    )


def _append(h: History, t, q, p, cov, inp, valid):
    """Append masked entries (leading dim K) in order; entries past the
    capacity are dropped."""
    cap = h.t.shape[0]
    pos = h.n + torch.cumsum(valid.to(torch.int64), 0) - 1
    tgt = torch.where(valid & (pos < cap), pos, torch.full_like(pos, cap))

    def put(buf, val):
        padded = torch.cat([buf, torch.zeros_like(buf[:1])], dim=0)
        padded[tgt] = val.to(buf.dtype)
        return padded[:cap]

    return History(
        t=put(h.t, t), q=put(h.q, q), p=put(h.p, p), cov=put(h.cov, cov),
        inp=put(h.inp, inp), n=h.n + torch.sum(valid).to(torch.int32),
    )


def undistort(cfg, x: st.State, P, hist: History, group: MeasureGroup, Q,
              last_in, last_imu, last_end_t, mean_acc_norm) -> UndistortResult:
    L = x.num_lidars
    dtype = x.pos.dtype
    dev = x.pos.device
    cap = hist.t.shape[0]
    E = cfg.epoch_capacity
    big = torch.finfo(dtype).max
    ar_L = torch.arange(L, device=dev)

    g_scale = cfg.gravity / mean_acc_norm

    hist = hist._replace(t=hist.t - group.t_shift)
    last_end_t = last_end_t - group.t_shift
    last_imu = last_imu.clone()
    last_imu[0] = last_imu[0] - group.t_shift

    base = torch.argmax(group.end_t)
    pcl_end = torch.max(group.end_t)
    pcl_beg = group.beg_t[torch.argmin(group.end_t)]

    imu_t = group.imu[:, 0]
    last_imu_idx = torch.argmax(torch.where(group.imu_mask, imu_t, torch.full_like(imu_t, -big)))
    imu_end = imu_t[last_imu_idx]
    imu_beg = last_imu[0]

    # ---- 1. trim history ----
    live = torch.arange(cap, device=dev) < hist.n
    keep = live & (hist.t + HISTORY_RETENTION >= pcl_beg) & (hist.t <= imu_beg)
    hist = _compact_history(hist, keep)

    # ---- 2. seed with the optimized pose at the last scan end ----
    hist = _append(
        hist, t=last_end_t[None], q=x.rot[None], p=x.pos[None],
        cov=_pose_cov6(P)[None], inp=last_in[None], valid=(last_end_t != 0.0).reshape(1),
    )

    # ---- 3. backward re-propagation ----
    rev = torch.arange(cap - 1, 0, -1, device=dev)
    bactive = (rev >= BACKWARD_MIN_INDEX) & (rev <= hist.n - 1)
    bdts = hist.t[rev - 1] - hist.t[rev]
    _, _, bposts, bPs = _batch_propagate(
        x, P, hist.inp[rev, 0:3], hist.inp[rev, 3:6], bdts, bactive, Q
    )
    wslot = torch.where(bactive, rev - 1, torch.full_like(rev, cap))

    def bput(buf, val):
        padded = torch.cat([buf, torch.zeros_like(buf[:1])], dim=0)
        padded[wslot] = val.to(buf.dtype)
        return padded[:cap]

    hist = hist._replace(
        q=bput(hist.q, bposts.rot), p=bput(hist.p, bposts.pos), cov=bput(hist.cov, bPs[:, :6, :6])
    )

    # ---- 4. forward propagation ----
    head = torch.cat([last_imu[None], group.imu[:-1]], dim=0)
    tails = group.imu
    valid_f = group.imu_mask & (tails[:, 0] >= last_end_t)
    f_gyro = 0.5 * (head[:, 1:4] + tails[:, 1:4])
    f_acc = 0.5 * (head[:, 4:7] + tails[:, 4:7]) * g_scale
    f_dts = tails[:, 0] - torch.maximum(head[:, 0], last_end_t)
    x_f, P_f, fposts, fPs = _batch_propagate(x, P, f_gyro, f_acc, f_dts, valid_f, Q)
    hist = _append(hist, tails[:, 0], fposts.rot, fposts.pos, fPs[:, :6, :6],
                   torch.cat([f_gyro, f_acc], -1), valid_f)

    # ---- 5. continuation on future IMU ----
    c_head = group.imu_cont[:-1]
    c_tail = group.imu_cont[1:]
    valid_c = group.imu_cont_mask[:-1] & group.imu_cont_mask[1:]
    c_gyro = 0.5 * (c_head[:, 1:4] + c_tail[:, 1:4])
    c_acc = 0.5 * (c_head[:, 4:7] + c_tail[:, 4:7]) * g_scale
    c_dts = c_tail[:, 0] - c_head[:, 0]
    _, _, cposts, cPs = _batch_propagate(x_f, P_f, c_gyro, c_acc, c_dts, valid_c, Q)
    hist = _append(hist, c_tail[:, 0], cposts.rot, cposts.pos, cPs[:, :6, :6],
                   torch.cat([c_gyro, c_acc], -1), valid_c)

    # ---- spline over the history ----
    live = torch.arange(cap, device=dev) < hist.n
    sp = spl.feed_trajectory(hist.t, hist.q, hist.p, live, cfg.spline_capacity)

    # ---- 7. final partial-dt predict to pcl_end ----
    c1 = group.imu_cont[1]
    last7 = group.imu[last_imu_idx]
    ratio = (pcl_end - last7[0]) / torch.clamp(c1[0] - last7[0], min=1e-9)
    gyro_i = ratio * last7[1:4] + (1.0 - ratio) * c1[1:4]
    acc_i = (ratio * last7[4:7] + (1.0 - ratio) * c1[4:7]) * g_scale
    u_last = dynamics.Input(acc=acc_i, gyro=gyro_i)
    x_f, F, Fw = dynamics.transition(x_f, u_last, pcl_end - imu_end)
    F = F.to(P_f.dtype)
    P_f = F @ P_f @ F.T + (Fw @ Q @ Fw.T).to(P_f.dtype)

    sq, spos, sok = spl.get_pose(sp, pcl_end)
    x_f = x_f._replace(pos=torch.where(sok, spos, x_f.pos), rot=torch.where(sok, sq, x_f.rot))

    # ---- per-LiDAR scan-end frames ----
    masked_t = torch.where(live, hist.t, torch.full_like(hist.t, big)).contiguous()
    cp0 = torch.searchsorted(masked_t, group.end_t.contiguous(), right=True)
    lt_q_all, lt_t_all, _ = spl.get_pose_batch(sp, group.end_t)
    is_base = ar_L == base
    lt_q = torch.where(is_base[:, None], x_f.rot[None], lt_q_all)
    lt_t = torch.where(is_base[:, None], x_f.pos[None], lt_t_all)
    lt_cov = torch.where(
        is_base[:, None, None], _pose_cov6(P_f).to(dtype)[None], hist.cov[torch.clamp(cp0, 0, cap - 1)]
    )

    # ---- 6. point deskew ----
    ext_q, ext_t = x_f.ext_r, x_f.ext_t
    if kernel_enabled(cfg.deskew_kernel, group.pts):
        out = deskew_ops.deskew_points(group.pts, sp, ext_q, ext_t, lt_q, lt_t)
    else:
        out = deskew_ops.deskew_points_plain(group.pts, sp, ext_q, ext_t, lt_q, lt_t)
    pts_deskewed = out[..., :3]

    flat_t = group.pts[..., 3].reshape(-1).contiguous()
    rank = torch.searchsorted(masked_t, flat_t, right=True).reshape(L, -1)
    pt_epoch = torch.clamp(cp0[:, None] - rank, min=0)

    # ---- 8. per-epoch uncertainty chains ----
    ks = torch.arange(E, device=dev)
    jmat = cp0[:, None] - ks[None, :]
    first_above_beg = torch.searchsorted(masked_t, group.beg_t.contiguous(), right=True)
    epoch_count = torch.clamp(cp0 - first_above_beg + 1, 1, E)
    jmat_c = torch.clamp(jmat, 0, cap - 1)
    tau = torch.minimum(group.end_t[:, None], hist.t[jmat_c])
    eq, ep, _ = spl.get_pose_batch(sp, tau.reshape(-1))
    pt_pose = unc.Pose(q=eq.reshape(L, E, 4), t=ep.reshape(L, E, 3), cov=hist.cov[jmat_c])

    ext_pose = unc.Pose(q=ext_q, t=ext_t, cov=_ext_cov6(P_f, L).to(dtype))
    lt_pose = unc.Pose(q=lt_q, t=lt_t, cov=lt_cov)

    def col(p: unc.Pose):  # (L, ...) -> (L, 1, ...) to broadcast over epochs
        return unc.Pose(p.q[:, None], p.t[:, None], p.cov[:, None])

    a = unc.compound_pose(pt_pose, col(ext_pose))
    b = unc.compound_inv_pose(col(lt_pose), a)
    chain = unc.compound_inv_pose(col(ext_pose), b)

    # ---- temporal compensation poses ----
    lt_b = unc.Pose(lt_pose.q[base][None], lt_pose.t[base][None], lt_pose.cov[base][None])
    tc = unc.compound_inv_pose(lt_b, lt_pose)
    q_id = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    tc_q = torch.where(is_base[:, None], q_id[None], tc.q)
    tc_t = torch.where(is_base[:, None], torch.zeros_like(tc.t), tc.t)
    tc_cov = torch.where(is_base[:, None, None], torch.zeros_like(tc.cov), tc.cov)

    return UndistortResult(
        x=x_f, P=P_f, hist=hist, last_in=torch.cat([gyro_i, acc_i]),
        last_imu=group.imu[last_imu_idx], pts_deskewed=pts_deskewed,
        pt_epoch=pt_epoch, base=base, tc_q=tc_q, tc_t=tc_t, tc_cov=tc_cov,
        unc_q=chain.q, unc_t=chain.t, unc_cov=chain.cov, epoch_count=epoch_count,
        lt_q=lt_q, lt_t=lt_t, lt_cov=lt_cov,
    )
