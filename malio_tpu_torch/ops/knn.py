"""k-NN candidate select/compact: the CUDA kernel `csrc/knn_select.cu`
(which replaces the TPU kernel malio_tpu/ops/knn_pallas.py:topk_candidates)
and its plain PyTorch version, `topk_min` plus extraction of the selected
lanes (malio_tpu/map/voxel_hash.py:492-497).

Both select on the same precomputed masked d2 bits, ties go to the lowest
lane, and extraction is rounding-free, so kernel and plain version are
bit-equal. `topk_candidates` takes a CPU tensor to the plain version and a
CUDA tensor to the kernel; there is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def topk_min(d2, k: int):
    """k smallest values of d2 (..., C), ascending, with their lanes: k
    rounds of argmin (first minimum) and knock-out with finfo.max."""
    big = torch.finfo(d2.dtype).max
    vals, idxs = [], []
    cur = d2
    for _ in range(k):
        i = torch.argmin(cur, dim=-1, keepdim=True)
        vals.append(torch.gather(cur, -1, i))
        idxs.append(i)
        cur = cur.scatter(-1, i, big)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def topk_candidates_plain(d2, cand_pts, cand_covs, K: int):
    """d2 (Q, C) with invalid lanes at finfo.max, cand_pts (Q, C, 3),
    cand_covs (Q, C) with invalid lanes zeroed. Returns (pts (Q, K, 3),
    covs (Q, K), d2 (Q, K) ascending). The selected lanes are read with a
    gather, which gives the same bits as the one-hot contraction of the
    JAX twin (one exact product per output, the rest zeros)."""
    nn_d2, idx = topk_min(d2, K)
    pts = torch.gather(cand_pts, 1, idx[..., None].expand(*idx.shape, 3))
    covs = torch.gather(cand_covs, 1, idx)
    return pts, covs, nn_d2


def _lib():
    lib = _build.load("knn_select")
    fn = lib.knn_select_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    return fn


def _need(t, name, shape):
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"knn kernel: {name} must be a contiguous float32 CUDA tensor, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"knn kernel: {name} has shape {tuple(t.shape)}, want {shape}")


def topk_candidates(d2, cand_pts, cand_covs, K: int):
    """Top-K candidates per query row; same contract as
    `topk_candidates_plain`. CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if d2.device.type == "cpu":
        return topk_candidates_plain(d2, cand_pts, cand_covs, K)
    Q, C = d2.shape
    _need(d2, "d2", (Q, C))
    _need(cand_pts, "cand_pts", (Q, C, 3))
    _need(cand_covs, "cand_covs", (Q, C))
    if not 0 < K <= C:
        raise ValueError(f"knn kernel: K={K} must lie in [1, C={C}]")
    out_pts = torch.empty((Q, K, 3), dtype=d2.dtype, device=d2.device)
    out_covs = torch.empty((Q, K), dtype=d2.dtype, device=d2.device)
    out_d2 = torch.empty((Q, K), dtype=d2.dtype, device=d2.device)
    stream = torch.cuda.current_stream(d2.device).cuda_stream
    err = _lib()(
        d2.data_ptr(), cand_pts.data_ptr(), cand_covs.data_ptr(), Q, C, K,
        out_pts.data_ptr(), out_covs.data_ptr(), out_d2.data_ptr(), stream,
    )
    _build.check(err, "knn_select_launch")
    topk_candidates.launches += 1
    by_width = topk_candidates.launches_by_width
    by_width[C] = by_width.get(C, 0) + 1
    return out_pts, out_covs, out_d2


topk_candidates.launches = 0
topk_candidates.launches_by_width = {}  # window width C -> launches
