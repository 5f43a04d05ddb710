"""Voxel-grid downsampling (counterpart of malio_tpu/preprocess.py;
pcl::VoxelGrid at laserMapping.cpp:968-983): one centroid per occupied
voxel, auxiliary channels averaged too, in a fixed-capacity padded batch.

The voxel hash is uint32 arithmetic on the int32 cell keys, emulated in
int64 with 32-bit masks so it is bit-equal to the JAX package. The segment
sums add each sorted, contiguous segment's rows in row order, so the f32
centroids are deterministic on the card (an `index_add_` would sum with
atomics in a run-dependent order): on the card one launch of the kernel
`ops.voxel_sums` (csrc/voxel_sums.cu), which never walks the masked rows;
on the CPU `voxel_sums_plain`, three `torch.segment_reduce` sums, with the
same bits.
"""
from __future__ import annotations

import torch

from .ops.voxel_sums import voxel_sums

MASK32 = 0xFFFFFFFF
MASKED = 1 << 32  # the sort key of a masked slot, past every 32-bit hash
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


def voxel_sort(pts, mask, voxel_size: float):
    """The downsample's sort of G groups: pts (G, P, 3), mask (G, P) ->
    (order (G P,) int64 the sorted rows' indices into the flat (G P) rows,
    seg (G, P) int64 each sorted row's voxel segment within its group). A
    group's rows sort by voxel hash, its masked rows last under the key
    MASKED, in a segment that no valid row shares. (The JAX package keys
    them MASK32, a hash that a valid point can have too; in that shared
    segment the masked rows add only zeros, so the sums agree.) A group's
    first row starts segment 0, each new key the next."""
    G, P = mask.shape
    h = spatial_hash(floor_div(pts, voxel_size)).reshape(G, P)
    h = torch.where(mask, h, torch.full_like(h, MASKED))
    gid = torch.arange(G, device=pts.device)[:, None]
    key = ((gid << 33) | h).reshape(-1)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    start = torch.ones_like(key_s, dtype=torch.bool)
    start[1:] = key_s[1:] != key_s[:-1]
    seg = (torch.cumsum(start.to(torch.int64), 0) - 1).reshape(G, P)
    return order, seg - seg[:, :1]  # a group's first point starts its segment 0


def voxel_sums_plain(pts, aux, mask, order, seg, out_cap: int):
    """The plain version of `ops.voxel_sums`, with its arguments: each
    group's segments below out_cap summed by `torch.segment_reduce` over
    the sorted rows, those past it into a dump segment that is dropped."""
    G, P = mask.shape
    gid = torch.arange(G, device=pts.device)[:, None]
    seg = (torch.clamp(seg, max=out_cap) + gid * (out_cap + 1)).reshape(-1)
    lengths = torch.zeros(G * (out_cap + 1), dtype=torch.int64, device=pts.device).scatter_add_(
        0, seg, torch.ones_like(seg))
    pts_s = pts.reshape(G * P, 3)[order]
    aux_s = aux.reshape(G * P, aux.shape[-1])[order]
    ones = mask.reshape(-1)[order].to(pts.dtype)

    def seg_sum(x):
        out = torch.segment_reduce(x, "sum", lengths=lengths, axis=0, unsafe=True, initial=0)
        return out.reshape(G, out_cap + 1, *x.shape[1:])[:, :out_cap]

    cnt = seg_sum(ones[:, None])[..., 0]
    sum_xyz = seg_sum(pts_s * ones[:, None])
    sum_aux = seg_sum(aux_s * ones[:, None])
    valid = cnt > 0
    denom = torch.clamp(cnt, min=1.0)
    return sum_xyz / denom[..., None], sum_aux / denom[..., None], valid


def voxel_downsample(pts, aux, mask, voxel_size: float, out_cap: int):
    """pts ([G...,] P, 3), aux ([G...,] P, A), mask ([G...,] P) ->
    (out ([G...,] out_cap, 3), aux_out ([G...,] out_cap, A),
    mask_out ([G...,] out_cap)). Each group along the leading axes (a
    sequence's LiDAR) is downsampled on its own, all in one sort: the group
    index is the high word of the sort key, so no voxel merges across
    groups and each group's result equals its own call bit for bit. The
    sums run in `ops.voxel_sums` on the card, in `voxel_sums_plain` on the
    CPU."""
    lead, P, A = pts.shape[:-2], pts.shape[-2], aux.shape[-1]
    G = 1
    for d in lead:
        G *= d
    pts, aux, mask = (pts.reshape(G, P, 3).contiguous(), aux.reshape(G, P, A).contiguous(),
                      mask.reshape(G, P).contiguous())
    order, seg = voxel_sort(pts, mask, voxel_size)
    sums = voxel_sums if pts.device.type == "cuda" else voxel_sums_plain
    out, aux_out, valid = sums(pts, aux, mask, order, seg, out_cap)
    return (out.reshape(*lead, out_cap, 3), aux_out.reshape(*lead, out_cap, A),
            valid.reshape(*lead, out_cap))
