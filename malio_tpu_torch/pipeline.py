"""The per-scan-group fusion step and its carry (counterpart of
malio_tpu/pipeline.py; laserMapping.cpp:941-1078):

  undistort (IMU propagate + spline deskew + uncertainty chains)
  -> per-LiDAR voxel downsample -> measurement-lane compaction
  -> sliding local-map box maintenance + eviction
  -> per-LiDAR/epoch pose-uncertainty composition
  -> iterated ESKF update with the three weighting laws
  -> map insertion with the lowest-covariance voxel policy

Points and the map are f32 on the flagship path; P, Pi and the IEKF solve
are f64. `step` runs on the device of the carry, which must be `device`.
It steps B independent sequences in lockstep when the carry and the group
carry a leading batch axis B (the semantics of jax.vmap(pipeline.step)),
and one sequence as the batch of one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import state as st
from . import tree
from . import propagate as prop
from . import preprocess as pre
from . import measurement as meas
from . import uncertainty as unc
from .device import resolve_device
from .filter import esekf
from .geometry import s2, so3
from .map import voxel_hash as vh


class LioCarry(NamedTuple):
    """One sequence's carry, or B sequences' with a leading axis B on every
    field (tree.stack of B carries)."""

    x: st.State
    P: torch.Tensor  # ([B,] n, n) f64
    Q: torch.Tensor  # ([B,] 12, 12) process noise, point dtype
    hist: prop.History
    map: vh.VoxelHashMap
    last_in: torch.Tensor  # ([B,] 6)
    last_imu: torch.Tensor  # ([B,] 7)
    last_end_t: torch.Tensor  # ([B])
    mean_acc_norm: torch.Tensor  # ([B])
    box_min: torch.Tensor  # ([B,] 3)
    box_max: torch.Tensor  # ([B,] 3)
    box_init: torch.Tensor  # ([B]) bool
    map_init: torch.Tensor  # ([B]) bool
    step_count: torch.Tensor  # ([B]) int32
    first_t: torch.Tensor  # ([B])
    Pi: torch.Tensor  # ([B,] n, n) f64 previous round's information inverse


class StepOutput(NamedTuple):
    pos: torch.Tensor
    quat: torch.Tensor
    pose_cov: torch.Tensor
    end_time: torch.Tensor
    iterations: torch.Tensor  # ([B]) int32
    n_effective: torch.Tensor
    map_size: torch.Tensor
    map_load: torch.Tensor
    map_dropped: torch.Tensor
    n_insert: torch.Tensor
    nn_miss: torch.Tensor
    med_normal_y: torch.Tensor
    kf_pts: torch.Tensor
    kf_mask: torch.Tensor
    world_pts: torch.Tensor
    world_mask: torch.Tensor
    n_meas_dropped: torch.Tensor
    w_loc: torch.Tensor


def init_carry(cfg, x0: st.State, P0, Q, dtype=torch.float32, device="cuda") -> LioCarry:
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    n = P0.shape[0]
    return LioCarry(
        x=x0.map(lambda a: a.to(dev)),
        P=P0.to(device=dev, dtype=torch.float64),
        Pi=torch.zeros((n, n), dtype=torch.float64, device=dev),
        Q=Q.to(**kw),
        hist=prop.empty_history(cfg.traj_capacity, dtype, dev),
        map=vh.create(cfg.map_capacity, cfg.filter_size_map, dtype, dev),
        last_in=torch.zeros(6, **kw),
        last_imu=torch.zeros(7, **kw),
        last_end_t=torch.zeros((), **kw),
        mean_acc_norm=torch.tensor(cfg.gravity, **kw),
        box_min=torch.zeros(3, **kw),
        box_max=torch.zeros(3, **kw),
        box_init=torch.tensor(False, device=dev),
        map_init=torch.tensor(False, device=dev),
        step_count=torch.zeros((), dtype=torch.int32, device=dev),
        first_t=torch.zeros((), **kw),
    )


def _fov_segment(cfg, box_min, box_max, box_init, pos_lid):
    """Sliding local-map box update (lasermap_fov_segment) of B sequences.
    Returns (box_min, box_max, box_init, moved)."""
    half = cfg.cube_len / 2.0
    thresh = cfg.mov_threshold * cfg.det_range
    near_lo = (pos_lid - box_min).abs() <= thresh
    near_hi = (pos_lid - box_max).abs() <= thresh
    need_move = torch.any(near_lo | near_hi, dim=-1)
    mov_dist = max(
        (cfg.cube_len - 2.0 * cfg.mov_threshold * cfg.det_range) * 0.5 * 0.9,
        cfg.det_range * (cfg.mov_threshold - 1.0),
    )
    zero = torch.zeros_like(pos_lid)
    shift = torch.where(near_lo, zero - mov_dist, torch.where(near_hi, zero + mov_dist, zero))
    init, move = box_init[:, None], need_move[:, None]
    new_min = torch.where(init, torch.where(move, box_min + shift, box_min), pos_lid - half)
    new_max = torch.where(init, torch.where(move, box_max + shift, box_max), pos_lid + half)
    return new_min, new_max, torch.ones_like(box_init), box_init & need_move


def _points_to_world(x: st.State, pts, pt_lidar, tc_q, tc_t):
    """pointBodyToWorld with temporal compensation, points (B, M, 3)."""
    in_imu = so3.quat_rotate(
        tree.take(tc_q, pt_lidar),
        so3.quat_rotate(tree.take(x.ext_r, pt_lidar), pts) + tree.take(x.ext_t, pt_lidar),
    ) + tree.take(tc_t, pt_lidar)
    return so3.quat_rotate(x.rot[:, None], in_imu) + x.pos[:, None]


def _nanmedian(v, mask):
    """jnp.nanmedian over v[mask] per sequence (v, mask (B, M)): linear
    interpolation between the two middle values (torch.nanmedian would
    return the lower one)."""
    s, _ = torch.sort(torch.where(mask, v, torch.full_like(v, float("nan"))), dim=-1)
    c = torch.sum(mask, dim=-1, keepdim=True)
    pos = 0.5 * (c.to(v.dtype) - 1.0)
    lo = torch.clamp(torch.floor(pos), min=0).long()
    hi = torch.clamp(lo + 1, max=torch.clamp(c - 1, min=0))
    w = pos - lo.to(v.dtype)
    med = (torch.gather(s, -1, lo) * (1.0 - w) + torch.gather(s, -1, hi) * w)[:, 0]
    return torch.where(c[:, 0] > 0, med, torch.full_like(med, float("nan")))


def step(cfg, carry: LioCarry, group: prop.MeasureGroup, device="cuda"):
    """One fusion round of B sequences in lockstep (carry and group with a
    leading B), or of one sequence (without it: the batch of one). Returns
    (new carry, StepOutput) in the form it was given.

    Each sequence gets what the reference's jax.vmap(pipeline.step) gives
    it: where the reference branches (the map_init cond, the IEKF loop,
    the re-search cond, the k-NN tier) the port selects per sequence, and
    the host reads one value for the batch, never one per sequence."""
    dev = resolve_device(device)
    if carry.P.device.type != dev.type or group.pts.device.type != dev.type:
        raise ValueError(f"step: carry and group must live on {dev}")
    if carry.P.dim() == 2:  # one sequence: a batch of one
        new_carry, out = step(cfg, tree.unsqueeze(carry), tree.unsqueeze(group), device=dev)
        return tree.squeeze(new_carry), tree.squeeze(out)
    B = carry.P.shape[0]
    L = cfg.num_lidars
    dtype = carry.x.pos.dtype
    M_DS = cfg.max_points_per_scan
    M = L * M_DS

    und = prop.undistort(
        cfg, carry.x, carry.P, carry.hist, group, carry.Q, carry.last_in,
        carry.last_imu, carry.last_end_t, carry.mean_acc_norm,
    )

    # ---- per-LiDAR voxel downsample (every LiDAR of every sequence in one call) ----
    ds_pts, ds_aux, ds_mask = pre.voxel_downsample(
        und.pts_deskewed, und.pt_epoch[..., None].to(dtype), group.pts_mask,
        cfg.filter_size_surf, M_DS,
    )
    ds_epoch = torch.round(ds_aux[..., 0]).long()
    flat_pts = ds_pts.reshape(B, M, 3)
    flat_epoch = ds_epoch.reshape(B, M)
    flat_mask = ds_mask.reshape(B, M)
    flat_lidar = torch.arange(L, device=dev).repeat_interleave(M_DS).expand(B, M)

    # ---- measurement-lane compaction (cfg.max_meas_points) ----
    n_meas_dropped = torch.zeros((B,), dtype=torch.int32, device=dev)
    if cfg.max_meas_points is not None and cfg.max_meas_points < M:
        Mc = cfg.max_meas_points
        order = torch.argsort((~flat_mask).to(torch.uint8), dim=-1, stable=True)[:, :Mc]
        n_meas_dropped = torch.clamp(torch.sum(flat_mask, dim=-1) - Mc, min=0).to(torch.int32)
        flat_pts = torch.take_along_dim(flat_pts, order[..., None], dim=1)
        flat_epoch = torch.gather(flat_epoch, 1, order)
        flat_mask = torch.gather(flat_mask, 1, order)
        flat_lidar = torch.gather(flat_lidar, 1, order)
        M = Mc

    # ---- local map box + eviction ----
    pos_lid = und.x.pos + so3.quat_rotate(und.x.rot, tree.take(und.x.ext_t, und.base))
    box_min, box_max, box_init, moved = _fov_segment(
        cfg, carry.box_min, carry.box_max, carry.box_init, pos_lid
    )
    big = torch.finfo(dtype).max
    e_min = torch.where(moved[:, None], box_min, torch.full_like(box_min, -big))
    e_max = torch.where(moved[:, None], box_max, torch.full_like(box_max, big))
    map_state = vh.evict_outside(carry.map, e_min, e_max)

    # ---- per-LiDAR/epoch pose uncertainty composition ----
    ext_cov = prop._ext_cov6(und.P, L).to(dtype)  # (B, L, 6, 6)
    u = unc.Pose(und.unc_q, und.unc_t, und.unc_cov)  # (B, L, E, ...)
    e = unc.Pose(und.x.ext_r[:, :, None], und.x.ext_t[:, :, None], ext_cov[:, :, None])
    bb = unc.Pose(*(tree.take(f, und.base)[:, None, None] for f in (und.x.ext_r, und.x.ext_t, ext_cov)))
    a = unc.compound_pose(e, u)
    t = unc.compound_pose(
        unc.Pose(und.tc_q[:, :, None], und.tc_t[:, :, None], und.tc_cov[:, :, None]), a
    )
    c = unc.compound_inv_pose(bb, t)
    is_base_l = (torch.arange(L, device=dev) == und.base[:, None])[..., None]
    unc_comp = unc.Pose(
        q=torch.where(is_base_l[..., None], u.q, c.q),
        t=torch.where(is_base_l[..., None], u.t, c.t),
        cov=torch.where(is_base_l[..., None, None], u.cov, c.cov),
    )

    scan_data = meas.ScanData(
        pts_body=flat_pts, pt_lidar=flat_lidar, pt_epoch=flat_epoch,
        pt_mask=flat_mask, tc_q=und.tc_q, tc_t=und.tc_t, base=und.base,
        unc_q=unc_comp.q, unc_t=unc_comp.t, unc_cov=unc_comp.cov,
        epoch_count=und.epoch_count,
    )

    # ---- the round's k-NN search + iterated update (where the map exists) ----
    h_share, cache0 = meas.make_h_share(cfg, map_state, scan_data, und.x)
    upd = esekf.IEKFResult(
        x=und.x, P=und.P, iterations=torch.zeros((B,), dtype=torch.int32, device=dev),
        valid=torch.zeros((B,), dtype=torch.bool, device=dev), cache=cache0, Pi=carry.Pi,
    )
    if bool(carry.map_init.any()):  # host read: the update runs if any sequence has a map
        run = esekf.update_iterated(
            und.x, und.P, h_share, cache0, max_iter=cfg.max_iteration,
            limit=cfg.converge_limit, search_on_converge=not cfg.single_search,
            Pi0=carry.Pi,
        )
        upd = tree.where(carry.map_init, run, upd)

    # ---- map insertion (map_incremental) ----
    init_col = carry.map_init[:, None]
    normal_y = torch.where(init_col, upd.cache.normal_y, torch.full((), 0.001, dtype=dtype, device=dev))
    world_pts = _points_to_world(upd.x, flat_pts, flat_lidar, und.tc_q, und.tc_t)
    beg_min = torch.amin(group.beg_t, dim=-1)
    first_t = torch.where(carry.step_count == 0, beg_min, carry.first_t - group.t_shift)
    ekf_inited = ((beg_min - first_t) >= cfg.init_time)[:, None]
    fs = cfg.filter_size_map
    mid = (torch.floor(world_pts / torch.full((), fs, dtype=dtype, device=dev)) + 0.5) * fs
    dist_mid = torch.sum((world_pts - mid) ** 2, dim=-1)
    nn = upd.cache.nn_pts
    k_valid = torch.arange(nn.shape[-2], device=dev) < upd.cache.nn_cnt[..., None]
    near0_far = torch.all((nn[..., 0, :] - mid).abs() > 0.5 * fs, dim=-1)
    nn_d_mid = torch.sum((nn - mid[..., None, :]) ** 2, dim=-1)
    full_set = upd.cache.nn_cnt >= meas.NUM_MATCH
    nn_closer = torch.any((nn_d_mid < dist_mid[..., None]) & k_valid, dim=-1) & full_set
    need_add = near0_far | ~nn_closer
    prefilter = torch.where(
        (upd.cache.nn_cnt > 0) & ekf_inited & init_col, need_add, torch.ones_like(need_add)
    )
    ins_mask = flat_mask & (normal_y <= cfg.cov_threshold) & prefilter
    map_state = vh.insert(map_state, world_pts, normal_y, ins_mask)

    end_t = torch.amax(group.end_t, dim=-1)
    new_carry = LioCarry(
        x=upd.x, P=upd.P, Pi=upd.Pi, Q=carry.Q, hist=und.hist, map=map_state,
        last_in=und.last_in, last_imu=und.last_imu, last_end_t=end_t,
        mean_acc_norm=carry.mean_acc_norm, box_min=box_min, box_max=box_max,
        box_init=box_init, map_init=torch.ones_like(carry.map_init),
        step_count=carry.step_count + 1, first_t=first_t,
    )
    msize = vh.size(map_state)
    bq = tree.take(upd.x.ext_r, und.base)
    out = StepOutput(
        pos=upd.x.pos,
        quat=upd.x.rot,
        pose_cov=upd.P[:, :6, :6],
        end_time=end_t,
        iterations=upd.iterations,
        n_effective=torch.sum(upd.cache.selected, dim=-1),
        map_size=msize,
        map_load=msize.to(dtype) / cfg.map_capacity,
        map_dropped=map_state.n_dropped,
        n_insert=torch.sum(ins_mask, dim=-1),
        nn_miss=upd.cache.n_miss,
        med_normal_y=_nanmedian(normal_y, flat_mask),
        kf_pts=so3.quat_rotate(bq[:, None], tree.take(ds_pts, und.base))
        + tree.take(upd.x.ext_t, und.base)[:, None],
        kf_mask=tree.take(ds_mask, und.base),
        world_pts=world_pts,
        world_mask=flat_mask,
        n_meas_dropped=n_meas_dropped,
        w_loc=upd.cache.w_loc,
    )
    return new_carry, out


def scan_steps(cfg, carry: LioCarry, groups: prop.MeasureGroup, device="cuda"):
    """`step` over a chunk of K measure groups (fields with a leading K
    axis, then B for a batched carry): the carry after the last round and
    a StepOutput whose fields are stacked on a leading K axis, exactly K
    sequential `step` calls. A whole chunk is the unit a later CUDA-graph
    capture would take."""
    dev = resolve_device(device)
    outs = []
    for k in range(groups.pts.shape[0]):
        carry, out = step(cfg, carry, prop.MeasureGroup(*(a[k] for a in groups)), device=dev)
        outs.append(out)
    stacked = StepOutput(*(
        torch.stack(f) if torch.is_tensor(f[0]) else torch.tensor(f, device=dev)
        for f in zip(*outs)
    ))
    return carry, stacked


def apply_world_correction(cfg, carry: LioCarry, dq, dt) -> LioCarry:
    """Apply a world-frame rigid correction T' = dT o T (from the pose-graph
    back end after a loop closure) to the whole carry, so odometry goes on
    from the graph-corrected pose:

      * the rotation tangent is right-sided, so rotation blocks keep J = I;
        pos and vel tangents turn by R(dq);
      * gravity is a world vector, g' = R(dq) g, carried across the S2
        chart by J_g = Nx(g') R(dq) Mx(g, 0); extrinsics and biases are
        body-frame (J = I); P' = J P J^T;
      * the IMU-rate history moves with the state, its covariances
        conjugated by blockdiag(R, I);
      * the map re-hashes through voxel_hash.transform, the local box is
        re-centred on the corrected pose and the map evicted to it.

    The IEKF warm start Pi is dropped: the information matrix changed
    frame."""
    dtype = carry.x.pos.dtype
    dq = so3.quat_normalize(dq.to(dtype))
    dt = dt.to(dtype)
    x = carry.x
    L = x.ext_r.shape[0]
    R = so3.quat_to_mat(dq)
    # a rotation keeps |g|: no projection back onto the default sphere
    g_new = so3.quat_rotate(dq, x.grav)
    x2 = x._replace(
        pos=so3.quat_rotate(dq, x.pos) + dt,
        rot=so3.quat_normalize(so3.quat_mul(dq, x.rot)),
        vel=so3.quat_rotate(dq, x.vel),
        grav=g_new,
    )

    n = carry.P.shape[0]
    J = torch.eye(n, dtype=dtype, device=R.device)
    J[0:3, 0:3] = R
    ov = st.idx_vel(L)
    J[ov : ov + 3, ov : ov + 3] = R
    og = st.idx_grav(L)
    J[og : og + 2, og : og + 2] = (
        s2.s2_nx_yy(g_new) @ R @ s2.s2_mx(x.grav, torch.zeros(2, dtype=dtype, device=R.device))
    )
    J = J.to(carry.P.dtype)
    P2 = J @ carry.P @ J.T

    h = carry.hist
    Rb = torch.zeros((6, 6), dtype=dtype, device=R.device)
    Rb[:3, :3] = R
    Rb[3:, 3:] = torch.eye(3, dtype=dtype, device=R.device)
    h2 = h._replace(
        q=so3.quat_normalize(so3.quat_mul(dq[None], h.q)),
        p=so3.quat_rotate(dq[None], h.p) + dt,
        cov=torch.einsum("ij,njk,lk->nil", Rb, h.cov, Rb),
    )

    half = torch.tensor(cfg.cube_len / 2.0, dtype=dtype, device=R.device)
    box_min = x2.pos - half
    box_max = x2.pos + half
    map2 = vh.evict_outside(vh.transform(carry.map, dq, dt), box_min, box_max)
    return carry._replace(
        x=x2, P=P2, hist=h2, map=map2, box_min=box_min, box_max=box_max,
        box_init=torch.ones_like(carry.box_init), Pi=torch.zeros_like(carry.Pi),
    )
