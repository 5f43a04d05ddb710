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
and one sequence as the batch of one. On a card the round is compiled, as
the reference jits it: one CUDA graph a config and shape (graph.py), which
`scan_steps` replays round after round; an mp rank's round over NCCL is
one graph too, with its collectives inside (the reference's
make_sharded_step). `step_eager` is the same round launched op by op,
which the CPU and the mp ranks over gloo run.
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
from .device import carry_dtype, resolve_device
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
        P=P0.to(device=dev, dtype=carry_dtype()),
        Pi=torch.zeros((n, n), dtype=carry_dtype(), device=dev),
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


def _lanes(shard, M: int, *xs):
    """This rank's contiguous share of the M lanes of each x (B, M, ...)."""
    if M % shard.size:
        raise ValueError(f"step: {shard.size} ranks do not divide {M} measurement lanes")
    n = M // shard.size
    return tuple(x[:, shard.rank * n : (shard.rank + 1) * n] for x in xs)


def _check(dev, carry, group):
    if carry.P.device.type != dev.type or group.pts.device.type != dev.type:
        raise ValueError(f"step: carry and group must live on {dev}")


def step_eager(cfg, carry: LioCarry, group: prop.MeasureGroup, device="cuda", shard=None):
    """The round launched op by op (the body the compiled round captures);
    same contract as `step`.

    Each sequence gets what the reference's jax.vmap(pipeline.step) gives
    it: where the reference branches (the map_init cond, the IEKF loop,
    the re-search cond, the k-NN tier) the port computes both sides for
    every sequence and selects per sequence, so the round reads nothing
    on the host.

    `shard` (an mp group, distributed/collectives.py) runs the round over
    its ranks, as the JAX package's mp mesh axis does
    (distributed/sharding.py): `group.pts` / `pts_mask` hold this rank's
    slice of the raw point axis and `carry.map.tab` its rows of every
    sequence's table; every other field is the same on every rank. Each
    rank deskews its raw slice, which one exact gather joins before the
    downsample; after the lane compaction it searches, fits and weights
    its share of the measurement lanes; the insert takes every lane and
    writes the rank's rows. The outputs and the new carry's replicated
    fields come out the same on every rank."""
    dev = resolve_device(device)
    _check(dev, carry, group)
    if carry.P.dim() == 2:  # one sequence: a batch of one
        new_carry, out = _round(cfg, *tree.unsqueeze((carry, group)), dev, shard)
        return tree.squeeze(new_carry), tree.squeeze(out)
    return _round(cfg, carry, group, dev, shard)


def _round(cfg, carry: LioCarry, group: prop.MeasureGroup, dev, shard):
    """The eager round of a batched carry and group."""
    if shard is not None and group.pts.shape[-2] * shard.size != cfg.max_raw_points:
        raise ValueError(f"step: a rank holds {group.pts.shape[-2]} raw points a LiDAR, not "
                         f"{cfg.max_raw_points} / {shard.size}")
    B = carry.P.shape[0]
    L = cfg.num_lidars
    dtype = carry.x.pos.dtype
    M_DS = cfg.max_points_per_scan
    M = L * M_DS

    und = prop.undistort(
        cfg, carry.x, carry.P, carry.hist, group, carry.Q, carry.last_in,
        carry.last_imu, carry.last_end_t, carry.mean_acc_norm, shard=shard,
    )
    pts_deskewed, pt_epoch, pts_mask = und.pts_deskewed, und.pt_epoch, group.pts_mask
    if shard is not None:  # every rank's raw slice, joined along the point axis
        parts = shard.gather(pts_deskewed, pt_epoch, pts_mask)
        pts_deskewed, pt_epoch, pts_mask = (torch.cat(p.unbind(0), dim=2) for p in parts)

    # ---- per-LiDAR voxel downsample (every LiDAR of every sequence in one call) ----
    ds_pts, ds_aux, ds_mask = pre.voxel_downsample(
        pts_deskewed, pt_epoch[..., None].to(dtype), pts_mask, cfg.filter_size_surf, M_DS,
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

    # the lanes this rank searches, fits and weights (all of them unsharded)
    loc_pts, loc_epoch, loc_mask, loc_lidar = (
        (flat_pts, flat_epoch, flat_mask, flat_lidar) if shard is None
        else _lanes(shard, M, flat_pts, flat_epoch, flat_mask, flat_lidar)
    )
    scan_data = meas.ScanData(
        pts_body=loc_pts, pt_lidar=loc_lidar, pt_epoch=loc_epoch,
        pt_mask=loc_mask, tc_q=und.tc_q, tc_t=und.tc_t, base=und.base,
        unc_q=unc_comp.q, unc_t=unc_comp.t, unc_cov=unc_comp.cov,
        epoch_count=und.epoch_count,
    )

    # ---- the round's k-NN search + iterated update (where the map exists) ----
    # the update runs for every sequence and is kept where it has a map
    # (the reference's lax.cond on map_init, a select under vmap)
    h_share, cache0 = meas.make_h_share(cfg, map_state, scan_data, und.x, shard=shard)
    no_map = esekf.IEKFResult(
        x=und.x, P=und.P, iterations=torch.zeros((B,), dtype=torch.int32, device=dev),
        valid=torch.zeros((B,), dtype=torch.bool, device=dev), cache=cache0, Pi=carry.Pi,
    )
    run = esekf.update_iterated(
        und.x, und.P, h_share, cache0, max_iter=cfg.max_iteration,
        limit=cfg.converge_limit, search_on_converge=not cfg.single_search,
        Pi0=carry.Pi,
    )
    upd = tree.where(carry.map_init, run, no_map)

    # ---- map insertion (map_incremental) ----
    init_col = carry.map_init[:, None]
    normal_y = torch.where(init_col, upd.cache.normal_y, torch.full((), 0.001, dtype=dtype, device=dev))
    world_pts = _points_to_world(upd.x, flat_pts, flat_lidar, und.tc_q, und.tc_t)
    loc_world = world_pts if shard is None else _lanes(shard, M, world_pts)[0]
    beg_min = torch.amin(group.beg_t, dim=-1)
    first_t = torch.where(carry.step_count == 0, beg_min, carry.first_t - group.t_shift)
    ekf_inited = ((beg_min - first_t) >= cfg.init_time)[:, None]
    fs = cfg.filter_size_map
    mid = (torch.floor(loc_world / torch.full((), fs, dtype=dtype, device=dev)) + 0.5) * fs
    dist_mid = torch.sum((loc_world - mid) ** 2, dim=-1)
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
    ins_mask = loc_mask & (normal_y <= cfg.cov_threshold) & prefilter
    n_effective = torch.sum(upd.cache.selected, dim=-1)
    if shard is not None:  # the insert and the outputs take every rank's lanes
        g_ny, g_ins, g_eff = shard.gather(normal_y, ins_mask, n_effective)
        normal_y, ins_mask = torch.cat(g_ny.unbind(0), dim=1), torch.cat(g_ins.unbind(0), dim=1)
        n_effective = g_eff.sum(0)
    map_state = vh.insert(map_state, world_pts, normal_y, ins_mask, shard=shard)

    end_t = torch.amax(group.end_t, dim=-1)
    new_carry = LioCarry(
        x=upd.x, P=upd.P, Pi=upd.Pi, Q=carry.Q, hist=und.hist, map=map_state,
        last_in=und.last_in, last_imu=und.last_imu, last_end_t=end_t,
        mean_acc_norm=carry.mean_acc_norm, box_min=box_min, box_max=box_max,
        box_init=box_init, map_init=torch.ones_like(carry.map_init),
        step_count=carry.step_count + 1, first_t=first_t,
    )
    msize = vh.size(map_state, shard)
    bq = tree.take(upd.x.ext_r, und.base)
    out = StepOutput(
        pos=upd.x.pos,
        quat=upd.x.rot,
        pose_cov=upd.P[:, :6, :6],
        end_time=end_t,
        iterations=upd.iterations,
        n_effective=n_effective,
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

