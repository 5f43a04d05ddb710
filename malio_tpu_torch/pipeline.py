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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import state as st
from . import propagate as prop
from . import preprocess as pre
from . import measurement as meas
from . import uncertainty as unc
from .device import resolve_device
from .filter import esekf
from .geometry import so3
from .map import voxel_hash as vh


class LioCarry(NamedTuple):
    x: st.State
    P: torch.Tensor  # (n, n) f64
    Q: torch.Tensor  # (12, 12) process noise, point dtype
    hist: prop.History
    map: vh.VoxelHashMap
    last_in: torch.Tensor  # (6,)
    last_imu: torch.Tensor  # (7,)
    last_end_t: torch.Tensor  # ()
    mean_acc_norm: torch.Tensor  # ()
    box_min: torch.Tensor  # (3,)
    box_max: torch.Tensor  # (3,)
    box_init: torch.Tensor  # () bool
    map_init: torch.Tensor  # () bool
    step_count: torch.Tensor  # () int32
    first_t: torch.Tensor  # ()
    Pi: torch.Tensor  # (n, n) f64 previous round's information inverse


class StepOutput(NamedTuple):
    pos: torch.Tensor
    quat: torch.Tensor
    pose_cov: torch.Tensor
    end_time: torch.Tensor
    iterations: int
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
    """Sliding local-map box update (lasermap_fov_segment). Returns
    (box_min, box_max, box_init, moved)."""
    half = cfg.cube_len / 2.0
    thresh = cfg.mov_threshold * cfg.det_range
    near_lo = (pos_lid - box_min).abs() <= thresh
    near_hi = (pos_lid - box_max).abs() <= thresh
    need_move = torch.any(near_lo | near_hi)
    mov_dist = max(
        (cfg.cube_len - 2.0 * cfg.mov_threshold * cfg.det_range) * 0.5 * 0.9,
        cfg.det_range * (cfg.mov_threshold - 1.0),
    )
    zero = torch.zeros_like(pos_lid)
    shift = torch.where(near_lo, zero - mov_dist, torch.where(near_hi, zero + mov_dist, zero))
    new_min = torch.where(box_init, torch.where(need_move, box_min + shift, box_min), pos_lid - half)
    new_max = torch.where(box_init, torch.where(need_move, box_max + shift, box_max), pos_lid + half)
    return new_min, new_max, torch.ones_like(box_init), box_init & need_move


def _points_to_world(x: st.State, pts, pt_lidar, tc_q, tc_t):
    """pointBodyToWorld with temporal compensation."""
    in_imu = so3.quat_rotate(
        tc_q[pt_lidar], so3.quat_rotate(x.ext_r[pt_lidar], pts) + x.ext_t[pt_lidar]
    ) + tc_t[pt_lidar]
    return so3.quat_rotate(x.rot[None], in_imu) + x.pos[None]


def _nanmedian(v, mask):
    """jnp.nanmedian over v[mask]: linear interpolation between the two
    middle values (torch.nanmedian would return the lower one)."""
    s, _ = torch.sort(torch.where(mask, v, torch.full_like(v, float("nan"))))
    c = torch.sum(mask)
    pos = 0.5 * (c.to(v.dtype) - 1.0)
    lo = torch.clamp(torch.floor(pos), min=0).long()
    hi = torch.clamp(lo + 1, max=torch.clamp(c - 1, min=0))
    w = pos - lo.to(v.dtype)
    med = s[lo] * (1.0 - w) + s[hi] * w
    return torch.where(c > 0, med, torch.full_like(med, float("nan")))


def step(cfg, carry: LioCarry, group: prop.MeasureGroup, device="cuda"):
    """One fusion round. Returns (new carry, StepOutput)."""
    dev = resolve_device(device)
    if carry.P.device.type != dev.type or group.pts.device.type != dev.type:
        raise ValueError(f"step: carry and group must live on {dev}")
    L = cfg.num_lidars
    dtype = carry.x.pos.dtype
    M_DS = cfg.max_points_per_scan
    M = L * M_DS

    und = prop.undistort(
        cfg, carry.x, carry.P, carry.hist, group, carry.Q, carry.last_in,
        carry.last_imu, carry.last_end_t, carry.mean_acc_norm,
    )

    # ---- per-LiDAR voxel downsample ----
    ds = [
        pre.voxel_downsample(
            und.pts_deskewed[l], und.pt_epoch[l][:, None].to(dtype),
            group.pts_mask[l], cfg.filter_size_surf, M_DS,
        )
        for l in range(L)
    ]
    ds_pts = torch.stack([d[0] for d in ds])
    ds_epoch = torch.stack([torch.round(d[1][:, 0]).long() for d in ds])
    ds_mask = torch.stack([d[2] for d in ds])
    flat_pts = ds_pts.reshape(M, 3)
    flat_epoch = ds_epoch.reshape(M)
    flat_mask = ds_mask.reshape(M)
    flat_lidar = torch.arange(L, device=dev).repeat_interleave(M_DS)

    # ---- measurement-lane compaction (cfg.max_meas_points) ----
    n_meas_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.max_meas_points is not None and cfg.max_meas_points < M:
        Mc = cfg.max_meas_points
        order = torch.argsort((~flat_mask).to(torch.uint8), stable=True)[:Mc]
        n_meas_dropped = torch.clamp(torch.sum(flat_mask) - Mc, min=0).to(torch.int32)
        flat_pts = flat_pts[order]
        flat_epoch = flat_epoch[order]
        flat_mask = flat_mask[order]
        flat_lidar = flat_lidar[order]
        M = Mc

    # ---- local map box + eviction ----
    pos_lid = und.x.pos + so3.quat_rotate(und.x.rot, und.x.ext_t[und.base])
    box_min, box_max, box_init, moved = _fov_segment(
        cfg, carry.box_min, carry.box_max, carry.box_init, pos_lid
    )
    big = torch.finfo(dtype).max
    e_min = torch.where(moved, box_min, torch.full_like(box_min, -big))
    e_max = torch.where(moved, box_max, torch.full_like(box_max, big))
    map_state = vh.evict_outside(carry.map, e_min, e_max)

    # ---- per-LiDAR/epoch pose uncertainty composition ----
    ext_cov = prop._ext_cov6(und.P, L).to(dtype)  # (L, 6, 6)
    u = unc.Pose(und.unc_q, und.unc_t, und.unc_cov)  # (L, E, ...)
    e = unc.Pose(und.x.ext_r[:, None], und.x.ext_t[:, None], ext_cov[:, None])
    bb = unc.Pose(und.x.ext_r[und.base], und.x.ext_t[und.base], ext_cov[und.base])
    a = unc.compound_pose(e, u)
    t = unc.compound_pose(
        unc.Pose(und.tc_q[:, None], und.tc_t[:, None], und.tc_cov[:, None]), a
    )
    c = unc.compound_inv_pose(unc.Pose(bb.q[None, None], bb.t[None, None], bb.cov[None, None]), t)
    is_base_l = torch.arange(L, device=dev) == und.base
    unc_comp = unc.Pose(
        q=torch.where(is_base_l[:, None, None], u.q, c.q),
        t=torch.where(is_base_l[:, None, None], u.t, c.t),
        cov=torch.where(is_base_l[:, None, None, None], u.cov, c.cov),
    )

    scan_data = meas.ScanData(
        pts_body=flat_pts, pt_lidar=flat_lidar, pt_epoch=flat_epoch,
        pt_mask=flat_mask, tc_q=und.tc_q, tc_t=und.tc_t, base=und.base,
        unc_q=unc_comp.q, unc_t=unc_comp.t, unc_cov=unc_comp.cov,
        epoch_count=und.epoch_count,
    )

    # ---- the round's k-NN search + iterated update (once the map exists) ----
    h_share, cache0 = meas.make_h_share(cfg, map_state, scan_data, und.x)
    map_init = bool(carry.map_init)
    if map_init:
        upd = esekf.update_iterated(
            und.x, und.P, h_share, cache0, max_iter=cfg.max_iteration,
            limit=cfg.converge_limit, search_on_converge=not cfg.single_search,
            Pi0=carry.Pi,
        )
    else:
        upd = esekf.IEKFResult(x=und.x, P=und.P, iterations=0, valid=False,
                               cache=cache0, Pi=carry.Pi)

    # ---- map insertion (map_incremental) ----
    normal_y = upd.cache.normal_y if map_init else torch.full((M,), 0.001, dtype=dtype, device=dev)
    world_pts = _points_to_world(upd.x, flat_pts, flat_lidar, und.tc_q, und.tc_t)
    beg_min = torch.min(group.beg_t)
    first_t = torch.where(carry.step_count == 0, beg_min, carry.first_t - group.t_shift)
    ekf_inited = (beg_min - first_t) >= cfg.init_time
    fs = cfg.filter_size_map
    mid = (torch.floor(world_pts / torch.full((), fs, dtype=dtype, device=dev)) + 0.5) * fs
    dist_mid = torch.sum((world_pts - mid) ** 2, dim=-1)
    nn = upd.cache.nn_pts
    k_valid = torch.arange(nn.shape[1], device=dev)[None, :] < upd.cache.nn_cnt[:, None]
    near0_far = torch.all((nn[:, 0] - mid).abs() > 0.5 * fs, dim=-1)
    nn_d_mid = torch.sum((nn - mid[:, None, :]) ** 2, dim=-1)
    full_set = upd.cache.nn_cnt >= meas.NUM_MATCH
    nn_closer = torch.any((nn_d_mid < dist_mid[:, None]) & k_valid, dim=-1) & full_set
    need_add = near0_far | ~nn_closer
    prefilter = torch.where(
        (upd.cache.nn_cnt > 0) & ekf_inited & carry.map_init, need_add, torch.ones_like(need_add)
    )
    ins_mask = flat_mask & (normal_y <= cfg.cov_threshold) & prefilter
    map_state = vh.insert(map_state, world_pts, normal_y, ins_mask)

    end_t = torch.max(group.end_t)
    new_carry = LioCarry(
        x=upd.x, P=upd.P, Pi=upd.Pi, Q=carry.Q, hist=und.hist, map=map_state,
        last_in=und.last_in, last_imu=und.last_imu, last_end_t=end_t,
        mean_acc_norm=carry.mean_acc_norm, box_min=box_min, box_max=box_max,
        box_init=box_init, map_init=torch.ones_like(carry.map_init),
        step_count=carry.step_count + 1, first_t=first_t,
    )
    msize = vh.size(map_state)
    bq = upd.x.ext_r[und.base]
    out = StepOutput(
        pos=upd.x.pos,
        quat=upd.x.rot,
        pose_cov=upd.P[:6, :6],
        end_time=end_t,
        iterations=upd.iterations,
        n_effective=torch.sum(upd.cache.selected),
        map_size=msize,
        map_load=msize.to(dtype) / cfg.map_capacity,
        map_dropped=map_state.n_dropped,
        n_insert=torch.sum(ins_mask),
        nn_miss=upd.cache.n_miss,
        med_normal_y=_nanmedian(normal_y, flat_mask),
        kf_pts=so3.quat_rotate(bq[None], ds_pts[und.base]) + upd.x.ext_t[und.base][None],
        kf_mask=ds_mask[und.base],
        world_pts=world_pts,
        world_mask=flat_mask,
        n_meas_dropped=n_meas_dropped,
        w_loc=upd.cache.w_loc,
    )
    return new_carry, out
