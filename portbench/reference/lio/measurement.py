"""Point-to-plane measurement model with the three uncertainty weighting
laws (counterpart of malio_tpu/measurement.py; h_share_model,
laserMapping.cpp:552-760): the round's one gathering k-NN search, plane
fits on the 5 nearest candidates, masked min/max normalizations and a 3x3
eigen-solve for the localization weight, over a padded (M,) point set.
Every field carries a leading batch axis B of independent sequences;
`make_h_share` also takes one sequence without it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import so3
from . import state as st
from . import tree
from . import uncertainty as unc
from .filter.esekf import HShareResult
from .linalg import eigvalsh3, mm
from .map import voxel_hash as vh
from .ops import kernel_enabled

NUM_MATCH = vh.NUM_MATCH_POINTS  # 5
NN_REJECT_D2 = 5.0  # laserMapping.cpp:587
CAND_K = 16


class ScanData(NamedTuple):
    pts_body: torch.Tensor  # ([B,] M, 3) deskewed points, own LiDAR end frame
    pt_lidar: torch.Tensor  # ([B,] M) int64 physical LiDAR index
    pt_epoch: torch.Tensor  # ([B,] M) int64 uncertainty epoch index
    pt_mask: torch.Tensor  # ([B,] M) bool
    tc_q: torch.Tensor  # ([B,] L, 4) temporal comp rotation (identity at base)
    tc_t: torch.Tensor  # ([B,] L, 3)
    base: torch.Tensor  # ([B]) int64 base LiDAR
    unc_q: torch.Tensor  # ([B,] L, E, 4)
    unc_t: torch.Tensor  # ([B,] L, E, 3)
    unc_cov: torch.Tensor  # ([B,] L, E, 6, 6)
    epoch_count: torch.Tensor  # ([B,] L)


class HShareCache(NamedTuple):
    normal: torch.Tensor  # ([B,] M, 3)
    d: torch.Tensor  # ([B,] M)
    plane_cov: torch.Tensor  # ([B,] M)
    plane_valid: torch.Tensor  # ([B,] M) bool
    searched: torch.Tensor  # ([B,] M) bool
    selected: torch.Tensor  # ([B,] M) bool
    normal_y: torch.Tensor  # ([B,] M) per-point covariance for map insertion
    nn_pts: torch.Tensor  # ([B,] M, 5, 3)
    nn_cnt: torch.Tensor  # ([B,] M) int32
    cand_pts: torch.Tensor  # ([B,] M, CAND_K, 3)
    cand_covs: torch.Tensor  # ([B,] M, CAND_K)
    cand_valid: torch.Tensor  # ([B,] M, CAND_K) bool
    n_miss: torch.Tensor  # ([B]) int32
    w_loc: torch.Tensor  # ([B]) localization weight of the last iteration


def _dot(a, b):
    return (a * b).sum(-1)


def _esti_plane(nn_pts, nn_covs, plane_th: float, cov_threshold: float):
    """Plane fit over 5 neighbors per row (common_lib.h:144-190), batched
    over the leading axes: centered normal equations with the mean folded
    back by Sherman-Morrison. Returns (normal, d, plane_valid, plane_cov)."""
    A = nn_pts  # (..., 5, 3)
    k_pts = float(A.shape[-2])
    c = A.mean(dim=-2)  # (..., 3)
    B = A - c[..., None, :]
    G = B.transpose(-1, -2) @ B
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    G = G + (1e-12 * (tr + 1.0))[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    g0, g1, g2 = G.unbind(-2)
    c0 = so3.cross(g1, g2)
    c1 = so3.cross(g2, g0)
    c2 = so3.cross(g0, g1)
    det = _dot(g0, c0)
    safe_det = torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
    inv_det = torch.where(det.abs() > 1e-30, 1.0 / safe_det, torch.zeros_like(det))
    y = inv_det[..., None] * torch.stack([_dot(c0, c), _dot(c1, c), _dot(c2, c)], dim=-1)
    n = -(k_pts * y) / (1.0 + k_pts * _dot(c, y))[..., None]
    norm = torch.linalg.norm(n, dim=-1)
    safe = torch.clamp(norm, min=1e-12)
    normal = n / safe[..., None]
    d = 1.0 / safe
    resid = (A @ normal[..., None])[..., 0] + d[..., None]
    plane_valid = torch.all(resid.abs() <= plane_th, dim=-1) & (norm > 1e-9)
    w = nn_covs
    cov_sum = torch.sum((cov_threshold - w).abs(), dim=-1)
    frac = (cov_threshold - w) / torch.clamp(cov_sum, min=1e-20)[..., None]
    plane_cov = torch.where(w[..., 0] > 1e-5, torch.sum(frac * frac * w, dim=-1),
                            torch.zeros_like(cov_sum))
    return normal, d, plane_valid, plane_cov


def _frames(x: st.State, data: ScanData):
    """Per point (B, M): the base LiDAR's extrinsic (bq, bt (B, ...)), the
    point's own extrinsic and temporal compensation, and is-base."""
    pl = data.pt_lidar
    return (tree.take(x.ext_r, data.base), tree.take(x.ext_t, data.base),
            tree.take(x.ext_r, pl), tree.take(x.ext_t, pl),
            tree.take(data.tc_q, pl), tree.take(data.tc_t, pl), pl == data.base[:, None])


def _world_points(x: st.State, data: ScanData, frames):
    """Deskewed points -> base LiDAR frame (temporal compensation for the
    others) -> IMU -> world."""
    p = data.pts_body
    bq, bt, ext_q_p, ext_t_p, tcq, tct, is_base = frames
    p_nb = so3.quat_rotate_inv(
        bq[:, None],
        so3.quat_rotate(tcq, so3.quat_rotate(ext_q_p, p) + ext_t_p) + tct - bt[:, None],
    )
    p_base = torch.where(is_base[..., None], p, p_nb)
    p_imu = so3.quat_rotate(bq[:, None], p_base) + bt[:, None]
    p_world = so3.quat_rotate(x.rot[:, None], p_imu) + x.pos[:, None]
    return p_base, p_imu, p_world


def _rank_and_fit(cfg, cand_pts, cand_covs, cand_valid, pt_mask, p_world, dtype):
    """Top-5 neighbors + plane fits from the candidate cache at the current
    pose (the re-search body; gather-free)."""
    big = torch.finfo(dtype).max
    d2 = vh._sqdist(cand_pts, p_world[..., None, :])
    d2 = torch.where(cand_valid, d2, torch.full_like(d2, big))
    nn_d2, idx = vh.topk_min(d2, NUM_MATCH)
    nn_pts = torch.take_along_dim(cand_pts, idx[..., None], dim=-2)
    nn_covs = torch.take_along_dim(cand_covs, idx, dim=-1)
    nn_cnt = torch.sum(nn_d2 < big, dim=-1).to(torch.int32)
    searched = pt_mask & (nn_cnt >= NUM_MATCH) & (nn_d2[..., NUM_MATCH - 1] <= NN_REJECT_D2)
    lanes = torch.arange(NUM_MATCH, device=nn_cnt.device)
    nn_covs = torch.where(lanes < nn_cnt[..., None], nn_covs, torch.zeros_like(nn_covs))
    normal, d, plane_valid, plane_cov = _esti_plane(nn_pts, nn_covs, cfg.plane_th, cfg.cov_threshold)
    return normal, d, plane_valid, plane_cov, searched, nn_pts, nn_cnt


def make_h_share(cfg, map_state: vh.VoxelHashMap, data: ScanData, x0: st.State, shard=None):
    """The h_share closure for one fusion round of B sequences plus the
    initial cache holding the round's one gathering k-NN search at the
    propagated x0. In-loop re-searches re-rank the cached CAND_K
    candidates.

    h_share(x, search, cache) -> (HShareResult, cache): `search` is a
    Python bool (every sequence or none re-searches) or a (B,) bool tensor
    (the re-search is computed for all and kept where it holds, the
    reference's lax.cond under vmap). One sequence without the batch axis
    gives a closure over unbatched states and caches.

    With `shard` (an mp group, distributed/collectives.py) `data`'s
    per-point fields hold this rank's measurement lanes and `map_state`
    its rows of the map: the search reads the whole table (voxel_hash
    `whole_map`, gathered once), the validity count and the weighting laws' extremes
    take every rank's lanes, and h_share returns every rank's measurement
    rows (HShareResult over all M lanes), so the localization weight and
    the update sum them in one process's order; the cache keeps this
    rank's lanes."""
    if data.pts_body.dim() == 2:
        h_b, cache0 = make_h_share(cfg, *tree.unsqueeze((map_state, data, x0)), shard=shard)

        def h_one(x, search, cache):
            s = search if isinstance(search, bool) else search.reshape(1)
            return tree.squeeze(h_b(tree.unsqueeze(x), s, tree.unsqueeze(cache)))

        return h_one, tree.squeeze(cache0)

    L = data.tc_q.shape[-2]
    dtype = data.pts_body.dtype
    dev = data.pts_body.device
    B, M = data.pts_body.shape[:2]
    p = data.pts_body
    pl = data.pt_lidar
    E = data.unc_q.shape[-2]
    ar_B = torch.arange(B, device=dev)[:, None]

    def _epoch_pose(e_idx):
        return unc.Pose(q=data.unc_q[ar_B, pl, e_idx], t=data.unc_t[ar_B, pl, e_idx],
                        cov=data.unc_cov[ar_B, pl, e_idx])

    cnt = tree.take(data.epoch_count, pl)
    e_sel = torch.clamp(torch.where(data.pt_epoch >= cnt, cnt - 2, data.pt_epoch), 0, E - 1)
    r_trace = unc.point_uncertainty_trace(p, _epoch_pose(e_sel))
    e_un = torch.clamp(torch.where(data.pt_epoch >= cnt - 1, cnt - 2, data.pt_epoch), 0, E - 1)
    r_trace_un = unc.point_uncertainty_trace(p, _epoch_pose(e_un))

    _, _, p_world0 = _world_points(x0, data, _frames(x0, data))
    (_, _, _, _, n_miss, cand_pts, c_covs, cand_valid) = vh.knn_cached(
        map_state,
        p_world0,
        radius=cfg.knn_radius,
        wide_radius=cfg.knn_wide_radius,
        wide_budget=cfg.knn_wide_budget,
        qmask=data.pt_mask,
        accept_d2=NN_REJECT_D2,
        accept_k=NUM_MATCH,
        cache_k=CAND_K,
        use_kernel=kernel_enabled(cfg.knn_kernel, p),
        shard=shard,
    )
    cand_covs = torch.where(cand_valid, c_covs, torch.zeros_like(c_covs))
    fit0 = _rank_and_fit(cfg, cand_pts, cand_covs, cand_valid, data.pt_mask, p_world0, dtype)
    normal0, d0, plane_valid0, plane_cov0, searched0, nn_pts0, nn_cnt0 = fit0
    cache0 = HShareCache(
        normal=normal0, d=d0, plane_cov=plane_cov0, plane_valid=plane_valid0,
        searched=searched0, selected=searched0,
        normal_y=torch.zeros((B, M), dtype=dtype, device=dev),
        nn_pts=nn_pts0, nn_cnt=nn_cnt0, cand_pts=cand_pts, cand_covs=cand_covs,
        cand_valid=cand_valid, n_miss=n_miss,
        w_loc=torch.ones((B,), dtype=dtype, device=dev),
    )
    big = torch.finfo(dtype).max

    def h_share(x: st.State, search, cache: HShareCache):
        frames = _frames(x, data)
        bq, bt, ext_q_p, ext_t_p, tcq, _, is_base = frames
        p_base, p_imu, p_world = _world_points(x, data, frames)

        # correspondence re-search (gated like dyn_share.converge), per
        # sequence: the reference's lax.cond, a select under vmap
        reuse = (cache.normal, cache.d, cache.plane_valid, cache.plane_cov,
                 cache.searched, cache.selected, cache.nn_pts, cache.nn_cnt)
        if search is False:
            fit = reuse
        else:
            normal, d, plane_valid, plane_cov, searched, nn_pts, nn_cnt = _rank_and_fit(
                cfg, cache.cand_pts, cache.cand_covs, cache.cand_valid,
                data.pt_mask, p_world, dtype,
            )
            fit = (normal, d, plane_valid, plane_cov, searched, searched, nn_pts, nn_cnt)
            if search is not True:
                fit = tree.where(search, fit, reuse)
        normal, d, plane_valid, plane_cov, searched, prev_sel, nn_pts, nn_cnt = fit
        pd2 = torch.sum(normal * p_world, dim=-1) + d
        r_base = torch.linalg.norm(p_base, dim=-1)
        score = 1.0 - 0.9 * pd2.abs() / torch.sqrt(torch.clamp(r_base, min=1e-9))
        selected = prev_sel & plane_valid & (score > 0.1)
        eff = selected.to(dtype)
        n_eff = torch.sum(eff, dim=-1)
        pc_max = torch.amax(torch.where(selected, plane_cov, torch.full_like(plane_cov, -big)), -1)
        pc_min = torch.amin(torch.where(selected, plane_cov, torch.full_like(plane_cov, big)), -1)
        r_max = torch.amax(torch.where(selected, r_trace, torch.full_like(r_trace, -big)), -1)
        r_min = torch.amin(torch.where(selected, r_trace, torch.full_like(r_trace, big)), -1)
        if shard is not None:  # over every rank's lanes
            g = shard.gather(n_eff, pc_max, pc_min, r_max, r_min)
            n_eff, pc_max, r_max = g[0].sum(0), g[1].amax(0), g[3].amax(0)
            pc_min, r_min = g[2].amin(0), g[4].amin(0)
        valid = n_eff >= 1.0

        # plane weighting law (laserMapping.cpp:649-656)
        span = (pc_max - pc_min)[:, None]
        norm01 = (plane_cov - pc_min[:, None]) / torch.where(span > 0, span, torch.ones_like(span))
        w_plane_lin = 1.0 / ((cfg.plane_cov_max - cfg.plane_cov_min) * norm01 + cfg.plane_cov_min)
        w_plane = torch.where(
            plane_cov == 0.0,
            torch.ones_like(plane_cov),
            torch.where(span > 0, w_plane_lin,
                        torch.full_like(plane_cov, (cfg.plane_cov_max + cfg.plane_cov_min) / 2.0)),
        )

        # H rows (laserMapping.cpp:658-707)
        C = so3.quat_rotate_inv(x.rot[:, None], normal)
        A_col = (so3.hat(p_imu) @ C[..., None])[..., 0]
        C_ext = torch.where(is_base[..., None], C, so3.quat_rotate_inv(tcq, C))
        p_for_B = torch.where(is_base[..., None], p_base, p)
        eq = torch.where(is_base[..., None], bq[:, None].expand(B, M, 4), ext_q_p)
        B_col = (so3.hat(p_for_B) @ so3.quat_rotate_inv(eq, C_ext)[..., None])[..., 0]
        slot = torch.where(is_base, data.base[:, None], pl)
        onehot = (slot[..., None] == torch.arange(L, device=dev)).to(dtype)
        H_ext_r = (onehot[..., None] * B_col[..., None, :]).reshape(B, M, 3 * L)
        H_ext_t = (onehot[..., None] * C_ext[..., None, :]).reshape(B, M, 3 * L)
        if not cfg.extrinsic_est_en:
            H_ext_r = torch.zeros_like(H_ext_r)
            H_ext_t = torch.zeros_like(H_ext_t)
        H = torch.cat([normal, A_col, H_ext_r, H_ext_t], dim=-1)

        normal_y = torch.where(selected, r_trace, r_trace_un)

        # point weighting law (laserMapping.cpp:710-722)
        r_span = (r_max - r_min)[:, None]
        lo = r_min[:, None] + r_span * cfg.range_min
        hi = r_min[:, None] + r_span * cfg.range_max
        lin = (cfg.point_cov_max - cfg.point_cov_min) * (r_trace - lo) / torch.clamp(
            (cfg.range_max - cfg.range_min) * r_span, min=1e-20
        ) + cfg.point_cov_min
        R_eff = torch.where(
            r_trace < lo,
            torch.full_like(r_trace, cfg.point_cov_min),
            torch.where(r_trace > hi, torch.full_like(r_trace, cfg.point_cov_max), lin),
        )

        Hw = H * (w_plane * eff)[..., None]
        hw = (-pd2) * w_plane * eff
        R_rows, rows = R_eff, selected
        if shard is not None:
            # every rank's rows in lane order: the sums over them below and
            # the update's HtH / Hth then add as one process adds them
            Hw, hw, R_rows, rows = (torch.cat(g.unbind(0), dim=1)
                                    for g in shard.gather(Hw, hw, R_eff, selected))

        # localization weight (laserMapping.cpp:744-759)
        Hp = Hw[..., :3]
        evals = eigvalsh3(mm(Hp.transpose(-1, -2), Hp))  # ascending
        sigma = torch.sqrt(torch.clamp(evals, min=0.0))
        ratio = sigma[..., 0] / torch.clamp(sigma[..., 2], min=1e-20)
        w_loc = torch.where(
            ratio > cfg.localize_thresh_max,
            torch.full_like(ratio, cfg.localize_cov_max),
            torch.where(
                ratio < cfg.localize_thresh_min,
                torch.full_like(ratio, cfg.localize_cov_min),
                (cfg.localize_cov_max - cfg.localize_cov_min)
                * (ratio - cfg.localize_thresh_min)
                / (cfg.localize_thresh_max - cfg.localize_thresh_min)
                + cfg.localize_cov_min,
            ),
        )
        Hw = Hw * w_loc[:, None, None]
        hw = hw * w_loc[:, None]

        new_cache = HShareCache(
            normal=normal, d=d, plane_cov=plane_cov, plane_valid=plane_valid,
            searched=searched, selected=selected, normal_y=normal_y,
            nn_pts=nn_pts, nn_cnt=nn_cnt, cand_pts=cache.cand_pts,
            cand_covs=cache.cand_covs, cand_valid=cache.cand_valid,
            n_miss=cache.n_miss, w_loc=w_loc.to(dtype),
        )
        return HShareResult(valid=valid, h=hw, H=Hw, R=R_rows, mask=rows), new_cache

    return h_share, cache0
