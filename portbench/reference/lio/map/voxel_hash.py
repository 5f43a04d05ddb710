"""Device-resident voxel-hash map with batched k-NN (counterpart of
malio_tpu/map/voxel_hash.py, the replacement of the reference's ikd-Tree).

`tab` is (R, SLOTS, 5): row r holds SLOTS slots of [fp, x, y, z, cov] and
is keyed by a supervoxel (a 2x2x2 block of map voxels, key >> 1). A voxel
keeps the lowest-covariance point offered to it; insert is one sort plus
one uniquely-indexed write; searches gather whole supervoxel rows and rank
by true distance. The int32 hash and fingerprint are emulated in int64
with 32-bit masks, bit-equal to the JAX package for negative keys too.

Every function returns a new map and leaves its input untouched, as the
JAX package does (one table copy per insert or eviction).

A batch of B maps (one per sequence) stacks the fields: `tab` (B, R,
SLOTS, 5), `n_dropped` / `n_evicted` (B,). The round's functions
(`lookup`, `insert`, `evict_outside`, `size`, `_window_rows`,
`_knn_window`, `knn_cached`) take either form; on a batch they address
the tables as one flat (B * R, SLOTS, 5) table with sequence b's rows at
b * R, and give each sequence what it would get alone, bit for bit.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import tree
from ..device import resolve_device
from ..geometry import so3
from ..ops import kernel_enabled, knn as knn_ops, merge as merge_ops
from ..ops.knn import sqdist as _sqdist, topk_extract as _topk_extract, topk_min  # noqa: F401
from ..preprocess import MASK32, mul32

_P1, _P2, _P3 = 73856093, 19349663, 83492791
_F1, _F2, _F3 = 1540483477, 1274126177, 868864169
SLOTS = 32
NUM_MATCH_POINTS = 5
CACHE_K = 16
_WINDOW_CHUNK = 64


class VoxelHashMap(NamedTuple):
    tab: torch.Tensor  # ([B,] R, SLOTS, 5) rows [fp, x, y, z, cov]
    voxel_size: torch.Tensor  # ([B])
    n_dropped: torch.Tensor  # ([B]) int32 cumulative insert overflow drops
    n_evicted: torch.Tensor  # ([B]) int32 cumulative evict-replace displacements

    @property
    def capacity(self) -> int:
        return self.tab.shape[-3] * SLOTS

    @property
    def flat(self):
        return self.tab.reshape(-1, 5)


def create(capacity: int, voxel_size: float, dtype=torch.float32, device="cuda") -> VoxelHashMap:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    device = resolve_device(device)
    assert capacity >= SLOTS
    R = capacity // SLOTS
    tab = torch.zeros((R, SLOTS, 5), dtype=dtype, device=device)
    tab[:, :, 4] = float("inf")
    return VoxelHashMap(
        tab=tab,
        voxel_size=torch.tensor(voxel_size, dtype=dtype, device=device),
        n_dropped=torch.zeros((), dtype=torch.int32, device=device),
        n_evicted=torch.zeros((), dtype=torch.int32, device=device),
    )


def voxel_key(m: VoxelHashMap, pts):
    """int64 voxel keys (values in int32 range) of pts ([B,] ..., 3)."""
    vs = m.voxel_size
    vs = vs.reshape(vs.shape + (1,) * (pts.dim() - vs.dim()))
    return torch.floor(pts / vs).to(torch.int32).to(torch.int64)


def _batch_rows(m: VoxelHashMap, rows):
    """The table and row ids a gather reads: a batched map's tables as one
    flat (B * R, SLOTS, 5) table with rows (B, ...) offset by b * R."""
    if m.tab.dim() == 3:
        return m.tab, rows
    B, R = m.tab.shape[:2]
    off = (torch.arange(B, device=rows.device) * R).reshape((B,) + (1,) * (rows.dim() - 1))
    return m.tab.reshape(B * R, SLOTS, 5), rows + off


def _num_rows(m: VoxelHashMap, shard=None) -> int:
    """Rows of one sequence's whole table; a shard holds 1/size of them."""
    R = m.tab.shape[-3]
    return R if shard is None else R * shard.size


def whole_map(m: VoxelHashMap, shard=None) -> VoxelHashMap:
    """The map with every sequence's whole table, the table a window search
    reads. On a map whose rows are sharded over an mp group (each rank
    owning a contiguous range of every sequence's rows) the ranks' row
    ranges are gathered in row order (one exact all-gather), the port's
    form of GSPMD's gather over the row-sharded table: the same bits on
    every rank as the unsharded table, and the same shape, so its rows are
    addressed as the unsharded round addresses them. Unsharded: m."""
    if shard is None:
        return m
    parts = shard.stack(m.tab)  # (size, [B,] R / size, SLOTS, 5)
    return m._replace(tab=parts.movedim(0, -4).reshape(*m.tab.shape[:-3], -1, SLOTS, 5))


def _svx(keys):
    """Supervoxel key: arithmetic shift, floor(k / 2) for negatives too."""
    return keys >> 1


def _wrap(a):
    """Low 32 bits of an int64 product (the int32 wraparound result)."""
    return a & MASK32


def _hash(svx_keys, num_rows: int):
    """Row index of a supervoxel key: xor of int32 products, murmur mix."""
    h = (
        _wrap(svx_keys[..., 0] * _P1)
        ^ _wrap(svx_keys[..., 1] * _P2)
        ^ _wrap(svx_keys[..., 2] * _P3)
    )
    u = h ^ (h >> 16)
    u = mul32(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = mul32(u, 0x846CA68B)
    u = u ^ (u >> 16)
    return u & (num_rows - 1)


def _fingerprint(keys):
    """Nonzero 23-bit fingerprint of a voxel key (0 marks an empty slot)."""
    h = _wrap(
        _wrap(keys[..., 0] * _F1) + _wrap(keys[..., 1] * _F2) + _wrap(keys[..., 2] * _F3)
    )
    u = h ^ (h >> 16)
    u = mul32(u, 0x85EBCA6B)
    u = u ^ (u >> 13)
    u = mul32(u, 0xC2B2AE35)
    u = u ^ (u >> 16)
    f = u >> 9
    return torch.where(f == 0, torch.ones_like(f), f)


def _first_true(mask):
    """Index of the first True along the last axis (0 if none), like
    jnp.argmax on a boolean array."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def lookup(m: VoxelHashMap, keys):
    """Flat slot (of its own sequence's table) holding each voxel key:
    (slot, found), slot 0 where not found (mask with `found`)."""
    R = m.tab.shape[-3]
    b = _hash(_svx(keys), R)
    tab, g = _batch_rows(m, b)
    rows = tab[g]  # ([B,] ..., SLOTS, 5)
    want = _fingerprint(keys).to(m.tab.dtype)
    match = rows[..., 0] == want[..., None]
    found = torch.any(match, dim=-1)
    slot = b * SLOTS + _first_true(match)
    return torch.where(found, slot, torch.zeros_like(slot)), found


def _segment_rank(seg_start, member):
    memi = member.to(torch.int64)
    exc = torch.cumsum(memi, 0) - memi
    base = torch.cummax(torch.where(seg_start, exc, torch.full_like(exc, -1)), 0).values
    return exc - base


def insert(m: VoxelHashMap, pts, covs, mask, shard=None) -> VoxelHashMap:
    """Insert world points ([B,] N, 3) with stored covariances: one sort by
    (sequence, row, voxel fingerprint, cov, batch index) and one
    uniquely-indexed write. Lowest covariance wins a voxel; new voxels take
    the rank-th empty lane of their row; a full row may displace its worst
    record once (counted in n_evicted) or drops the candidate (counted in
    n_dropped).

    On a row-sharded map (`shard`, see `whole_map`) every rank takes
    all N points, treats the rows it does not own as "no row" and writes
    its own rows; a row's decisions depend on that row's points alone, so
    each comes out as on the whole table. The drop and eviction counts are
    summed over the ranks."""
    if m.tab.dim() == 3:
        return tree.squeeze(insert(*tree.unsqueeze((m, pts, covs, mask)), shard=shard))
    B, R = m.tab.shape[:2]
    T = R * SLOTS
    N = pts.shape[1]
    dtype = m.tab.dtype
    dev = m.tab.device
    keys = voxel_key(m, pts)
    fp = _fingerprint(keys).reshape(-1)
    b = _hash(_svx(keys), _num_rows(m, shard))
    if shard is not None:  # the rank's own rows, numbered from 0
        b = b - shard.rank * R
        mask = mask & (b >= 0) & (b < R)
    b = torch.where(mask, b, torch.full_like(keys[..., 0], R))
    # sort key of (sequence, row): each sequence's rows and its "no row" R
    # sit after the previous sequence's
    g = (b + torch.arange(B, device=dev)[:, None] * (R + 1)).reshape(-1)
    b = b.reshape(-1)
    covf = torch.where(mask, covs.to(dtype), torch.full_like(covs, float("inf"), dtype=dtype)).reshape(-1)

    # lexicographic (sequence and row, fp, cov, index): chained stable
    # sorts, least significant key first; the index tiebreak is the
    # stability itself. Sequence s fills sorted positions [s N, (s+1) N).
    o = torch.argsort(covf, stable=True)
    o = o[torch.argsort(fp[o], stable=True)]
    o = o[torch.argsort(g[o], stable=True)]
    g_s, b_s, fp_s, cov_s = g[o], b[o], fp[o], covf[o]
    pts_s = pts.to(dtype).reshape(B * N, 3)[o]
    live = b_s < R
    rec_s = torch.cat([fp_s.to(dtype)[:, None], pts_s, cov_s[:, None]], dim=-1)

    prev_g = torch.cat([torch.full((1,), -1, dtype=g_s.dtype, device=dev), g_s[:-1]])
    prev_fp = torch.cat([torch.full((1,), -1, dtype=fp_s.dtype, device=dev), fp_s[:-1]])
    row_start = g_s != prev_g
    vox_first = live & (row_start | (fp_s != prev_fp))

    grow = (o // N) * R + torch.clamp(b_s, max=R - 1)  # row of the flat (B * R) table
    rows = m.tab.reshape(B * R, SLOTS, 5)[grow]  # (B N, SLOTS, 5)
    fps = rows[..., 0]
    match = fps == fp_s.to(dtype)[:, None]
    found = torch.any(match, dim=-1)
    mlane = _first_true(match)
    stored_cov = torch.gather(rows[..., 4], 1, mlane[:, None])[:, 0]

    upd = vox_first & found & (cov_s < stored_cov)
    claimer = vox_first & ~found
    rank = _segment_rank(row_start, claimer)
    empty = fps == 0
    n_empty = torch.sum(empty, dim=-1)
    csum = torch.cumsum(empty.to(torch.int64), dim=-1)
    clane = _first_true((csum == (rank + 1)[:, None]) & empty)
    fits = claimer & (rank < n_empty)

    over = claimer & (rank >= n_empty)
    occ_cov = torch.where(empty, torch.full_like(rows[..., 4], -float("inf")), rows[..., 4])
    vcov, _ = torch.max(occ_cov, dim=-1)
    vlane = torch.argmax(occ_cov, dim=-1)
    seg_id = torch.cumsum(row_start.to(torch.int64), 0) - 1
    row_upd = torch.zeros(B * N, dtype=torch.int64, device=dev).index_add_(
        0, seg_id, upd.to(torch.int64)
    )[seg_id]
    evict = over & (rank == n_empty) & (cov_s < vcov) & (row_upd == 0)

    writes = upd | fits | evict
    lane = torch.where(upd, mlane, torch.where(evict, vlane, clane))
    slot = grow * SLOTS + lane
    # the writes are unique; a lane that writes nothing targets -1, which
    # the merge skips (csrc/merge_rows.cu on the card)
    tgt = torch.where(writes, slot, torch.full_like(slot, -1))
    tab = merge_ops.merge_rows(m.tab.reshape(B * T, 5), tgt, rec_s)
    dropped = torch.sum((over & ~evict).reshape(B, N), dim=-1).to(torch.int32)
    evicted = torch.sum(evict.reshape(B, N), dim=-1).to(torch.int32)
    if shard is not None:
        dropped, evicted = shard.sum(dropped, evicted)
    return m._replace(
        tab=tab.reshape(B, R, SLOTS, 5),
        n_dropped=m.n_dropped + dropped,
        n_evicted=m.n_evicted + evicted,
    )


def evict_outside(m: VoxelHashMap, box_min, box_max) -> VoxelHashMap:
    """Free every cell whose point lies outside [box_min, box_max] (([B,] 3),
    each sequence's own box)."""
    flat = m.tab.reshape(*m.tab.shape[:-3], -1, 5)
    lo, hi = box_min[..., None, :], box_max[..., None, :]
    inside = torch.all((flat[..., 1:4] >= lo) & (flat[..., 1:4] <= hi), dim=-1)
    keep = (flat[..., 0] != 0) & inside
    new = flat.clone()
    new[..., 0] = torch.where(keep, flat[..., 0], torch.zeros_like(flat[..., 0]))
    new[..., 4] = torch.where(keep, flat[..., 4], torch.full_like(flat[..., 4], float("inf")))
    return m._replace(tab=new.reshape(m.tab.shape))


def transform(m: VoxelHashMap, dq, dt) -> VoxelHashMap:
    """Every stored point moved by the world-frame correction
    p' = R(dq) p + dt and re-hashed into a fresh table through `insert`
    (a loop closure re-anchoring the world frame). Covariances ride along;
    points meeting in one voxel keep the lowest covariance, and a full
    target row counts into n_dropped."""
    fresh = create(m.capacity, 1.0, m.tab.dtype, m.tab.device)._replace(
        voxel_size=m.voxel_size, n_dropped=m.n_dropped, n_evicted=m.n_evicted
    )
    pts, covs, occ = flatten(m)
    pts = so3.quat_rotate(dq[None], pts) + dt
    covs = torch.where(occ, covs, torch.full_like(covs, float("inf")))
    return insert(fresh, pts, covs, occ)


def size(m: VoxelHashMap, shard=None):
    """Occupied cells ([B]); of the whole table for a row-sharded map."""
    n = torch.sum(m.tab[..., 0] != 0, dim=(-2, -1))
    return n if shard is None else shard.sum(n)


def flatten(m: VoxelHashMap):
    """Live map contents as flat views: (pts (T, 3), covs (T,), occ (T,))."""
    flat = m.flat
    return flat[:, 1:4], flat[:, 4], flat[:, 0] != 0


def extract_points(m: VoxelHashMap):
    """Host-side compaction of flatten(): numpy (pts (n, 3), covs (n,))
    of the occupied cells, the input of a map dump."""
    pts, covs, occ = (a.cpu().numpy() for a in flatten(m))
    return pts[occ], covs[occ]


def _masked_take(m: VoxelHashMap, mask, max_results: int):
    """The first max_results masked slots in slot order, padded with slot
    T - 1 (jnp.nonzero(size=, fill_value=T-1)): (pts (K, 3), covs (K,),
    valid (K,), total) with `total` the full match count, which may exceed
    K."""
    T = m.capacity
    dev = m.tab.device
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (rank < max_results), rank, torch.full_like(rank, max_results))
    idx = torch.full((max_results + 1,), T - 1, dtype=torch.int64, device=dev)
    idx[tgt] = torch.arange(T, device=dev)  # slot max_results is the dump
    idx = idx[:max_results]
    total = torch.sum(mask).to(torch.int32)
    pts, covs, _ = flatten(m)
    valid = torch.arange(max_results, device=dev) < total
    return pts[idx], covs[idx], valid, total


def box_search(m: VoxelHashMap, box_min, box_max, max_results: int = 1024):
    """Stored points inside an axis-aligned box, the ikd-tree Box_Search
    analog: up to max_results points plus the true match count."""
    pts, _, occ = flatten(m)
    inside = torch.all((pts >= box_min) & (pts <= box_max), dim=-1)
    return _masked_take(m, occ & inside, max_results)


def radius_search(m: VoxelHashMap, center, radius, max_results: int = 1024):
    """Stored points within `radius` of `center`, the ikd-tree
    Radius_Search analog."""
    pts, _, occ = flatten(m)
    return _masked_take(m, occ & (_sqdist(pts, center) <= radius * radius), max_results)


@functools.lru_cache(maxsize=None)
def _svx_ball_offsets(radius: int) -> np.ndarray:
    """Supervoxel offsets from the anchor (v - radius) >> 1 that can hold a
    cell within `radius` voxels of a query voxel v, for either parity."""
    span = radius + 1
    d = np.arange(span)
    offs = np.stack(np.meshgrid(d, d, d, indexing="ij"), -1).reshape(-1, 3)
    keep = []
    for o in offs:
        ok = False
        for eps in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                    (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)):
            gap2 = 0.0
            for ax in range(3):
                deltas = [2 * o[ax] - radius - eps[ax], 2 * o[ax] - radius - eps[ax] + 1]
                g = max(min(abs(v) for v in deltas) - 1, 0)
                gap2 += g * g
            if gap2 <= radius * radius:
                ok = True
                break
        if ok:
            keep.append(o)
    return np.asarray(keep, np.int32)


@functools.lru_cache(maxsize=None)
def _offsets(radius: int, device):
    """The ball-pruned offsets on `device`, made once (a copy from the host
    in a round would stall it)."""
    return torch.as_tensor(_svx_ball_offsets(radius), dtype=torch.int64, device=device)


def _dup_rows(b_all):
    """Offset j is dead if an earlier offset hashed to the same row."""
    V = b_all.shape[-1]
    if V <= 1:
        return torch.zeros(b_all.shape, dtype=torch.bool, device=b_all.device)
    eq = b_all[..., :, None] == b_all[..., None, :]
    tri = torch.tril(torch.ones((V, V), dtype=torch.bool, device=b_all.device), -1)
    return torch.any(eq & tri, dim=-1)


def _window_rows(m: VoxelHashMap, queries, radius: int, qmask=None):
    """The window of each query ([B,] Q, 3): its supervoxel rows ([B,] Q, V)
    of its own sequence's table over the ball-pruned offsets of `radius`,
    and which of them are alive (not a repeat of an earlier offset's row,
    and the query not masked off). Masked queries fetch row 0."""
    offs = _offsets(radius, m.tab.device)
    anchors = _svx(voxel_key(m, queries) - radius)
    b_all = _hash(anchors[..., None, :] + offs, m.tab.shape[-3])  # ([B,] Q, V)
    if qmask is not None:
        b_all = torch.where(qmask[..., None], b_all, torch.zeros_like(b_all))
    alive = ~_dup_rows(b_all)
    if qmask is not None:
        alive = alive & qmask[..., None]
    return b_all, alive


def _take(x, idx):
    """take_along_axis on axis 1 for (Q, C) or (Q, C, 3)."""
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))
    return torch.gather(x, 1, idx)


def _knn_window(m: VoxelHashMap, queries, k: int, radius: int, use_kernel: bool = False):
    """k nearest stored points over the supervoxel window of `radius`, for
    queries ([B,] Q, 3) in their own sequence's table. The kernel path
    hands the whole window of every sequence to one launch of the fused
    window kernel; the plain path streams it in chunks of _WINDOW_CHUNK
    rows with a running top-k merge."""
    dtype = m.tab.dtype
    queries = queries.to(dtype).contiguous()
    dev = m.tab.device
    lead = queries.shape[:-1]
    big = torch.finfo(dtype).max
    b_all, alive = _window_rows(m, queries, radius)
    V = b_all.shape[-1]
    tab, rows = _batch_rows(m, b_all)
    rows, alive, queries = rows.reshape(-1, V), alive.reshape(-1, V), queries.reshape(-1, 3)
    Q = queries.shape[0]

    def unflat(*outs):
        return tuple(o.reshape(*lead, *o.shape[1:]) for o in outs)

    if use_kernel:
        nn_pts, nn_covs, nn_d2 = knn_ops.knn_window(tab, queries, rows, alive, k)
        return unflat(nn_pts, nn_covs, nn_d2, torch.sum(nn_d2 < big, dim=-1))

    def chunk_candidates(b_c, alive_c):
        win = tab[b_c]
        occ = (win[..., 0] != 0) & alive_c[..., None]
        cpts = win[..., 1:4]
        d2 = _sqdist(cpts, queries[:, None, None, :])
        d2 = torch.where(occ, d2, torch.full_like(d2, big))
        C = b_c.shape[1]
        return (
            cpts.reshape(Q, C * SLOTS, 3),
            win[..., 4].reshape(Q, C * SLOTS),
            d2.reshape(Q, C * SLOTS),
        )

    if V <= _WINDOW_CHUNK:
        cand_pts, cand_cov, d2 = chunk_candidates(rows, alive)
        nn_d2, idx = topk_min(d2, k)
        return unflat(_take(cand_pts, idx), _take(cand_cov, idx), nn_d2,
                      torch.sum(nn_d2 < big, dim=-1))

    nchunks = -(-V // _WINDOW_CHUNK)
    chunk = -(-V // nchunks)
    pad = nchunks * chunk - V
    b_p = torch.cat([rows, torch.zeros((Q, pad), dtype=rows.dtype, device=dev)], dim=1)
    alive_p = torch.cat([alive, torch.zeros((Q, pad), dtype=torch.bool, device=dev)], dim=1)
    b_pts = torch.zeros((Q, k, 3), dtype=dtype, device=dev)
    b_covs = torch.zeros((Q, k), dtype=dtype, device=dev)
    b_d2 = torch.full((Q, k), big, dtype=dtype, device=dev)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        c_pts, c_covs, c_d2 = chunk_candidates(b_p[:, sl], alive_p[:, sl])
        all_pts = torch.cat([b_pts, c_pts], dim=1)
        all_covs = torch.cat([b_covs, c_covs], dim=1)
        all_d2 = torch.cat([b_d2, c_d2], dim=1)
        b_d2, idx = topk_min(all_d2, k)
        b_pts, b_covs = _take(all_pts, idx), _take(all_covs, idx)
    return unflat(b_pts, b_covs, b_d2, torch.sum(b_d2 < big, dim=-1))


def knn(
    m: VoxelHashMap,
    queries,
    k: int = NUM_MATCH_POINTS,
    radius: int = 1,
    wide_radius: int = 0,
    wide_budget: int = 0,
    qmask=None,
    accept_d2=5.0,
    accept_k: int | None = None,
):
    """Batched k-NN over the voxel neighbourhood with budgeted escalation.

    Returns nn_pts (Q, k, 3), nn_covs (Q, k), nn_d2 (Q, k) ascending,
    nn_cnt (Q,) and n_miss (): the queries (within qmask) that fail the
    acceptance rule (accept_k found, the accept_k-th d2 <= accept_d2)
    after the search. With wide_radius > radius and wide_budget > 0, up to
    wide_budget failing queries are searched again over the wide window
    and their results spliced back (rank by prefix count, one uniquely
    indexed inverse permutation, a gather and a select). On an f32 CUDA map
    both windows run the fused window kernel."""
    use_kernel = kernel_enabled(None, m.tab)
    dtype = m.tab.dtype
    dev = m.tab.device
    queries = queries.to(dtype).contiguous()
    res = _knn_window(m, queries, k, radius, use_kernel=use_kernel)
    ak = accept_k if accept_k is not None else k
    acc = torch.full((), accept_d2, dtype=dtype, device=dev)

    def misses(r):
        _, _, d2, cnt = r
        need = ~((cnt >= ak) & (d2[:, ak - 1] <= acc))
        return need & qmask if qmask is not None else need

    if wide_budget <= 0 or wide_radius <= radius:
        return (*res, torch.sum(misses(res)).to(torch.int32))

    Q = queries.shape[0]
    need = misses(res)
    needi = need.to(torch.int64)
    rank = torch.cumsum(needi, 0) - needi
    valid = need & (rank < wide_budget)
    ar = torch.arange(Q, device=dev)
    inv = torch.full((wide_budget + Q,), Q, dtype=torch.int64, device=dev)
    inv[torch.where(valid, rank, wide_budget + ar)] = ar
    safe = torch.clamp(inv[:wide_budget], max=Q - 1)
    wide = _knn_window(m, queries[safe], k, wide_radius, use_kernel=use_kernel)
    r = torch.clamp(rank, max=wide_budget - 1)
    res = tuple(
        torch.where(valid.reshape((Q,) + (1,) * (base.dim() - 1)), w[r], base)
        for base, w in zip(res, wide)
    )
    return (*res, torch.sum(misses(res)).to(torch.int32))


def knn_cached(
    m: VoxelHashMap,
    queries,
    radius: int = 1,
    wide_radius: int = 0,
    wide_budget: int = 0,
    qmask=None,
    accept_d2=5.0,
    accept_k: int = NUM_MATCH_POINTS,
    cache_k: int = CACHE_K,
    use_kernel: bool = False,
    shard=None,
):
    """k-NN (k = accept_k) plus the compact top-`cache_k` candidate cache,
    for queries ([B,] Q, 3) in their own sequence's map.

    Returns (nn_pts ([B,] Q, ak, 3), nn_covs, nn_d2, nn_cnt, n_miss ([B]),
    cache_pts ([B,] Q, cache_k, 3), cache_covs, cache_valid). Queries
    failing the acceptance rule (accept_k found, accept_k-th d2 <=
    accept_d2) are re-searched over the ball-pruned wide window, up to
    wide_budget of them per sequence, in one search at the budget whatever
    the demand: the round reads nothing on the host. Each escalated query's
    wide search is its own, so each sequence's result is the one it would
    get alone.

    On a row-sharded map (`shard`) each rank searches its own queries
    (its measurement lanes): both windows read the whole table, gathered
    once (`whole_map`), the escalation ranks and budget count every rank's
    escalations of the sequence (an exclusive prefix of the ranks'
    counts), and n_miss is summed over the ranks."""
    assert cache_k >= accept_k, (cache_k, accept_k)
    dtype = m.tab.dtype
    dev = m.tab.device
    queries = queries.to(dtype).contiguous()
    Q = queries.shape[-2]
    big = torch.finfo(dtype).max
    m = whole_map(m, shard)  # once: both windows read it
    b_all, alive = _window_rows(m, queries, radius, qmask)
    V = b_all.shape[-1]
    tab, rows = _batch_rows(m, b_all)
    window = knn_ops.knn_window if use_kernel else knn_ops.knn_window_plain
    cache = window(tab, queries.reshape(-1, 3), rows.reshape(-1, V), alive.reshape(-1, V), cache_k)
    cache_pts, cache_covs, cache_d2 = (c.reshape(*queries.shape[:-1], *c.shape[1:]) for c in cache)
    cache_valid = cache_d2 < big

    ak = accept_k
    nn_pts, nn_covs, nn_d2 = cache_pts[..., :ak, :], cache_covs[..., :ak], cache_d2[..., :ak]
    nn_cnt = torch.sum(nn_d2 < big, dim=-1)
    acc = torch.full((), accept_d2, dtype=dtype, device=dev)

    def misses(d2k, cnt):
        need = ~((cnt >= ak) & (d2k[..., ak - 1] <= acc))
        if qmask is not None:
            need = need & qmask
        return need

    def n_missed(d2k, cnt):
        n = torch.sum(misses(d2k, cnt), dim=-1).to(torch.int32)
        return n if shard is None else shard.sum(n)

    if wide_budget <= 0 or wide_radius <= radius:
        n_miss = n_missed(nn_d2, nn_cnt)
        return (nn_pts, nn_covs, nn_d2, nn_cnt, n_miss, cache_pts, cache_covs, cache_valid)

    need = misses(nn_d2, nn_cnt)
    needi = need.to(torch.int64)
    rank = torch.cumsum(needi, -1) - needi  # the query's slot in this rank's wide search
    grank = rank  # its rank among the sequence's escalations
    if shard is not None:
        counts = shard.gather(torch.sum(needi, -1))
        grank = rank + (torch.cumsum(counts, 0) - counts)[shard.rank][..., None]
    budget = wide_budget
    valid = need & (grank < budget)
    ar = torch.arange(Q, device=dev).expand(rank.shape)
    tgt = torch.where(valid, rank, budget + ar)
    inv = torch.full((*rank.shape[:-1], budget + Q), Q, dtype=torch.int64, device=dev)
    inv.scatter_(-1, tgt, ar)
    safe = torch.clamp(inv[..., :budget], max=Q - 1)
    w_pts, w_covs, w_d2, w_cnt = _knn_window(
        m, torch.take_along_dim(queries, safe[..., None], dim=-2), cache_k, wide_radius,
        use_kernel=use_kernel,
    )
    r = torch.clamp(rank, max=budget - 1)
    w_pts_r = torch.take_along_dim(w_pts, r[..., None, None], dim=-3)
    w_covs_r, w_d2_r = (torch.take_along_dim(w, r[..., None], dim=-2) for w in (w_covs, w_d2))
    w_cnt_r = torch.take_along_dim(w_cnt, r, dim=-1)
    vcol = valid[..., None]
    o_pts = torch.where(vcol[..., None], w_pts_r[..., :ak, :], nn_pts)
    o_covs = torch.where(vcol, w_covs_r[..., :ak], nn_covs)
    o_d2 = torch.where(vcol, w_d2_r[..., :ak], nn_d2)
    o_cnt = torch.where(valid, torch.clamp(w_cnt_r, max=ak), nn_cnt)
    lanes = torch.arange(cache_k, device=dev)
    w_valid = lanes < torch.clamp(w_cnt_r, max=cache_k)[..., None]
    cache_pts = torch.where(vcol[..., None], w_pts_r, cache_pts)
    cache_covs = torch.where(vcol, w_covs_r, cache_covs)
    cache_valid = torch.where(vcol, w_valid, cache_valid)
    n_miss = n_missed(o_d2, o_cnt)
    return (o_pts, o_covs, o_d2, o_cnt, n_miss, cache_pts, cache_covs, cache_valid)
