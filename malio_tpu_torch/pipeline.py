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

The round carries 7 stamps of the tracer (trace.py), which bound its six
stages (trace.ROUND_STAGES): undistort, downsample, compact_evict,
uncertainty, update, insert. On a card each is a one-thread kernel in the
stream (a node of the captured graph), on the CPU a reading of the host
clock.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import graph, trace
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


def _lanes(shard, M: int, *xs):
    """This rank's contiguous share of the M lanes of each x (B, M, ...)."""
    if M % shard.size:
        raise ValueError(f"step: {shard.size} ranks do not divide {M} measurement lanes")
    n = M // shard.size
    return tuple(x[:, shard.rank * n : (shard.rank + 1) * n] for x in xs)


def _compiled_round(cfg, carry: LioCarry, group: prop.MeasureGroup,
                    shard=None) -> graph.CompiledRound:
    """The round captured at these batched shapes on this card (captured
    at the first call), one per (config, shapes, dtypes, card, mp group:
    the ShardGroup itself, so its rank, size and backend)."""
    dev = carry.P.device
    return graph.compiled(("round", cfg, graph.signature(carry, group), shard),
                          lambda c, g: _round(cfg, c, g, dev, shard), carry, group, shard,
                          stamped=True)


def compiled_rounds():
    """Every round captured so far (graph.CompiledRound), in capture order."""
    return [r for _, r in graph.captures("round")]


def _check(dev, carry, group):
    if carry.P.device.type != dev.type or group.pts.device.type != dev.type:
        raise ValueError(f"step: carry and group must live on {dev}")


def step(cfg, carry: LioCarry, group: prop.MeasureGroup, device="cuda", shard=None):
    """One fusion round of B sequences in lockstep (carry and group with a
    leading B), or of one sequence (without it: the batch of one). Returns
    (new carry, StepOutput) in the form it was given.

    On a card the round is the compiled one, the port's jax.jit: a CUDA
    graph captured at the first call for this config, these shapes and
    this `shard` (graph.CompiledRound), with its inputs copied in and its
    outputs cloned out. An mp rank's round (`shard`) is compiled where the
    group is `capturable` (NCCL, a card a rank: the collectives go into
    the graph; the reference's jit of make_sharded_step). On the CPU, and
    with a shard over gloo, whose collectives go through the host, it is
    `step_eager`, whose bits the graph replays."""
    dev = resolve_device(device)
    _check(dev, carry, group)
    if dev.type != "cuda" or (shard is not None and not shard.capturable):
        return step_eager(cfg, carry, group, device=dev, shard=shard)
    if carry.P.dim() == 2:  # one sequence: a batch of one
        new_carry, out = _compiled_round(cfg, *tree.unsqueeze((carry, group)), shard)(
            *tree.unsqueeze((carry, group)))
        return tree.squeeze(new_carry), tree.squeeze(out)
    return _compiled_round(cfg, carry, group, shard)(carry, group)


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

    trace.stamp("round", 0, dev)  # undistort
    und = prop.undistort(
        cfg, carry.x, carry.P, carry.hist, group, carry.Q, carry.last_in,
        carry.last_imu, carry.last_end_t, carry.mean_acc_norm, shard=shard,
    )
    pts_deskewed, pt_epoch, pts_mask = und.pts_deskewed, und.pt_epoch, group.pts_mask
    if shard is not None:  # every rank's raw slice, joined along the point axis
        parts = shard.gather(pts_deskewed, pt_epoch, pts_mask)
        pts_deskewed, pt_epoch, pts_mask = (torch.cat(p.unbind(0), dim=2) for p in parts)

    trace.stamp("round", 1, dev)  # downsample
    # ---- per-LiDAR voxel downsample (every LiDAR of every sequence in one call) ----
    ds_pts, ds_aux, ds_mask = pre.voxel_downsample(
        pts_deskewed, pt_epoch[..., None].to(dtype), pts_mask, cfg.filter_size_surf, M_DS,
    )
    ds_epoch = torch.round(ds_aux[..., 0]).long()
    flat_pts = ds_pts.reshape(B, M, 3)
    flat_epoch = ds_epoch.reshape(B, M)
    flat_mask = ds_mask.reshape(B, M)
    flat_lidar = torch.arange(L, device=dev).repeat_interleave(M_DS).expand(B, M)

    trace.stamp("round", 2, dev)  # compact_evict
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

    trace.stamp("round", 3, dev)  # uncertainty
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

    trace.stamp("round", 4, dev)  # update
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

    trace.stamp("round", 5, dev)  # insert
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
    trace.stamp("round", 6, dev)
    return new_carry, out


def scan_steps(cfg, carry: LioCarry, groups: prop.MeasureGroup, device="cuda"):
    """`step` over a chunk of K measure groups (fields with a leading K
    axis, then B for a batched carry): the carry after the last round and
    a StepOutput whose fields are stacked on a leading K axis, the results
    of K sequential `step` calls. On a card it replays the compiled round
    K times, the carry going from round to round on the card (the
    reference's lax.scan with its body compiled once); on the CPU it runs
    K `step_eager` calls."""
    dev = resolve_device(device)
    _check(dev, carry, groups)
    if dev.type == "cuda":
        if carry.P.dim() == 3:
            return _compiled_round(cfg, carry, tree.index(groups, 0)).scan(carry, groups)
        c1, g1 = tree.unsqueeze(carry), tree.map_tensors(lambda a: a[:, None], groups)
        new_carry, stacked = _compiled_round(cfg, c1, tree.index(g1, 0)).scan(c1, g1)
        return tree.squeeze(new_carry), tree.map_tensors(lambda a: a[:, 0], stacked)
    outs = []
    for k in range(groups.pts.shape[0]):
        carry, out = step_eager(cfg, carry, tree.index(groups, k), device=dev)
        outs.append(out)
    return carry, tree.stack(outs)


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
    frame.

    A carry whose map holds fewer cells than `cfg.map_capacity` is one mp
    rank's shard (distributed/sharding.carry_sharding): the re-hash needs
    the whole table, and no distributed path corrects one, so it raises."""
    if carry.map.capacity != cfg.map_capacity:
        raise NotImplementedError(
            f"apply_world_correction: the carry's map holds {carry.map.capacity} of the "
            f"config's {cfg.map_capacity} cells (a shard of a row-sharded map); a world "
            f"correction of a sharded map is not supported"
        )
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
