"""The voxel downsample's segment sums: the CUDA kernel `csrc/voxel_sums.cu`,
one launch a `preprocess.voxel_downsample` call on the card. Its plain
PyTorch version is `preprocess.voxel_sums_plain` (three
`torch.segment_reduce` sums), which CPU tensors run. Not a port of a TPU
kernel: the JAX package sums the segments with scatter-adds
(malio_tpu/preprocess.py:50-60).

`voxel_sums` takes the rows as the downsample's sort left them and returns
what the plain version returns, bit for bit: each kept segment's rows are
added in row order, and the segment of the masked rows and those past
`out_cap` are not walked. It takes contiguous f32 or f64 CUDA tensors on
one card and raises a ValueError on anything else; it has no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = _build.load("voxel_sums").voxel_sums_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 4)
        _fn = fn
    return _fn


def voxel_sums(pts, aux, mask, order, seg, out_cap: int):
    """pts (G, P, 3), aux (G, P, A) of one float type, mask (G, P) bool,
    order (G P,) int64 the sort's indices into the flat (G P) rows, seg
    (G, P) int64 each sorted row's segment within its group, as
    `preprocess.voxel_sort` gives them (the masked rows in a segment of
    their own) -> (centroids
    (G, out_cap, 3), aux means (G, out_cap, A), valid (G, out_cap))."""
    G, P = mask.shape[0], mask.shape[-1]
    A = aux.shape[-1]
    args = {"pts": (pts, pts.dtype, (G, P, 3)), "aux": (aux, pts.dtype, (G, P, A)),
            "mask": (mask, torch.bool, (G, P)), "order": (order, torch.int64, (G * P,)),
            "seg": (seg, torch.int64, (G, P))}
    if pts.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"voxel_sums kernel: pts must be float32 or float64, got {pts.dtype}")
    dev = pts.device
    for name, (t, dtype, shape) in args.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"voxel_sums kernel: {name} is {t.dtype} {tuple(t.shape)}, "
                             f"want {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"voxel_sums kernel: {name} is not contiguous")
    for name, (t, _, _) in args.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"voxel_sums kernel: {name} must lie on the CUDA device of pts, "
                             f"got {t.device} and {dev}")
    out = torch.empty((G, out_cap, 3), dtype=pts.dtype, device=dev)
    aux_out = torch.empty((G, out_cap, A), dtype=pts.dtype, device=dev)
    valid = torch.empty((G, out_cap), dtype=torch.bool, device=dev)
    err = _lib()(pts.data_ptr(), aux.data_ptr(), mask.data_ptr(), order.data_ptr(),
                 seg.data_ptr(), G, P, out_cap, A,
                 int(pts.dtype == torch.float64), out.data_ptr(), aux_out.data_ptr(),
                 valid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "voxel_sums_launch")
    if G * max(P, out_cap):
        count_launch(voxel_sums, (G, P, out_cap))
    return out, aux_out, valid


voxel_sums.launches = 0
# (groups G, raw slots P, out_cap) -> launches
voxel_sums.launches_by_shape = {}
voxel_sums.captured = {}  # the same, recorded into CUDA graphs
