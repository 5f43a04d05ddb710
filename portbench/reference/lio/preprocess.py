"""Voxel-grid downsampling (counterpart of malio_tpu/preprocess.py;
pcl::VoxelGrid at laserMapping.cpp:968-983): one centroid per occupied
voxel, auxiliary channels averaged too, in a fixed-capacity padded batch.

The voxel hash is uint32 arithmetic on the int32 cell keys, emulated in
int64 with 32-bit masks so it is bit-equal to the JAX package. The segment
sums use `torch.segment_reduce` over the sorted, contiguous segments: one
sequential sum per segment, so the f32 centroids are deterministic on the
card (an `index_add_` would sum with atomics in a run-dependent order).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_P1 = 73856093
_P2 = 19349663
_P3 = 83492791


def mul32(a, c: int):
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a constant c < 2^32,
    split in 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return ((a * lo) + (((a * hi) & 0xFFFF) << 16)) & MASK32


def spatial_hash(keys):
    """xor of the wrapped products of int32 cell keys (..., 3), taken as
    uint32: the Teschner spatial hash, as a uint32 value in int64."""
    k = keys & MASK32
    return mul32(k[..., 0], _P1) ^ mul32(k[..., 1], _P2) ^ mul32(k[..., 2], _P3)


def cell_ids(pts, cell_size, num_cells: int):
    """Hashed cell of each point among num_cells: the spatial hash of its
    int32 cell key modulo num_cells. cell_size may be a tensor (true
    division, as JAX divides)."""
    return spatial_hash(torch.floor(pts / cell_size).to(torch.int32).to(torch.int64)) % num_cells


def floor_div(pts, size: float):
    """floor(pts / size) as int64. Divides by a device tensor: on the card
    a division by a Python scalar multiplies by its reciprocal, which can
    move a point across a cell boundary."""
    s = torch.full((), size, dtype=pts.dtype, device=pts.device)
    return torch.floor(pts / s).to(torch.int32).to(torch.int64)


def voxel_downsample(pts, aux, mask, voxel_size: float, out_cap: int):
    """pts ([G...,] P, 3), aux ([G...,] P, A), mask ([G...,] P) ->
    (out ([G...,] out_cap, 3), aux_out ([G...,] out_cap, A),
    mask_out ([G...,] out_cap)). Each group along the leading axes (a
    sequence's LiDAR) is downsampled on its own, all in one sort: the group
    index is the high word of the sort key, so no voxel merges across
    groups and each group's result equals its own call bit for bit."""
    lead, P = pts.shape[:-2], pts.shape[-2]
    G = 1
    for d in lead:
        G *= d
    dev = pts.device
    h = spatial_hash(floor_div(pts, voxel_size)).reshape(G, P)
    h = torch.where(mask.reshape(G, P), h, torch.full_like(h, MASK32))
    gid = torch.arange(G, device=dev)[:, None]
    key = ((gid << 32) | h).reshape(-1)

    order = torch.argsort(key, stable=True)
    key_s = key[order]
    pts_s = pts.reshape(G * P, 3)[order]
    aux_s = aux.reshape(G * P, -1)[order]
    ones = mask.reshape(-1)[order].to(pts.dtype)

    start = torch.ones_like(key_s, dtype=torch.bool)
    start[1:] = key_s[1:] != key_s[:-1]
    seg_id = (torch.cumsum(start.to(torch.int64), 0) - 1).reshape(G, P)
    seg_id = seg_id - seg_id[:, :1]  # a group's first point starts its segment 0
    # segments past out_cap -> the group's dump segment out_cap
    seg = (torch.clamp(seg_id, max=out_cap) + gid * (out_cap + 1)).reshape(-1)
    lengths = torch.zeros(G * (out_cap + 1), dtype=torch.int64, device=dev).scatter_add_(
        0, seg, torch.ones_like(seg))

    def seg_sum(x):
        out = torch.segment_reduce(x, "sum", lengths=lengths, axis=0, unsafe=True, initial=0)
        return out.reshape(*lead, out_cap + 1, *x.shape[1:])[..., :out_cap, :]

    cnt = seg_sum(ones[:, None])[..., 0]
    sum_xyz = seg_sum(pts_s * ones[:, None])
    sum_aux = seg_sum(aux_s * ones[:, None])
    valid = cnt > 0
    denom = torch.clamp(cnt, min=1.0)
    return sum_xyz / denom[..., None], sum_aux / denom[..., None], valid
