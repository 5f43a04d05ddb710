"""k-NN window search: the fused CUDA kernel `csrc/knn_window.cu` (which
replaces the TPU kernel malio_tpu/ops/knn_pallas.py:topk_candidates and the
gather/mask/d2 stage that feeds it, malio_tpu/map/voxel_hash.py:464-497)
and its plain PyTorch version, the gather + mask + select chain.

The plain select stage keeps the JAX package's names: `topk_min`,
`topk_candidates_plain` and `topk_extract` (`_topk_extract` there). Both
versions take the same masked d2 bits (`sqdist` sums x, y, z in that order,
with no fused multiply-add), ties go to the lowest lane, and extraction is
rounding-free, so kernel and plain version are bit-equal. `knn_window`
takes CPU tensors to the plain version and CUDA tensors to the kernel;
there is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KMAX = 16  # the kernel's register list length: the largest K it takes


def sqdist(pts, q):
    """Squared distances ((dx*dx + dy*dy) + dz*dz), each op rounded on its
    own, as the JAX package's op-by-op jnp.sum((p - q)**2, -1) gives them
    and as csrc/knn_window.cu computes them."""
    d = pts - q
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


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


def topk_extract(queries, cand_pts, cand_covs, cand_valid, k: int):
    """Top-k nearest candidates with their values: the masked d2, the
    zeroed covariances of invalid lanes, then the select."""
    big = torch.finfo(cand_covs.dtype).max
    d2 = sqdist(cand_pts, queries[:, None, :])
    d2 = torch.where(cand_valid, d2, torch.full_like(d2, big))
    cand_covs = torch.where(cand_valid, cand_covs, torch.zeros_like(cand_covs))
    return topk_candidates_plain(d2, cand_pts, cand_covs, k)


def knn_window_plain(tab, queries, rows, alive, K: int):
    """Top-K of each query's window. tab (R, SLOTS, 5) rows [fp, x, y, z,
    cov]; queries (Q, 3); rows (Q, V) table row ids; alive (Q, V) bool.
    Lane v * SLOTS + s is valid if tab[rows[q, v], s, 0] != 0 and
    alive[q, v]. Returns (pts (Q, K, 3), covs (Q, K), d2 (Q, K))."""
    Q, V = rows.shape
    S = tab.shape[1]
    win = tab[rows]  # (Q, V, SLOTS, 5)
    occ = (win[..., 0] != 0) & alive[..., None]
    return topk_extract(
        queries, win[..., 1:4].reshape(Q, V * S, 3), win[..., 4].reshape(Q, V * S),
        occ.reshape(Q, V * S), K,
    )


_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = _build.load("knn_window").knn_window_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        _fn = fn
    return _fn


def _need(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"knn_window: {name} must be a contiguous {dtype} tensor on {device}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"knn_window: {name} has shape {tuple(t.shape)}, want {shape}")


def knn_window(tab, queries, rows, alive, K: int):
    """Top-K of each query's window; same contract as `knn_window_plain`.
    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which takes float32 tab and queries, int64 rows, bool alive, all
    contiguous on one card, and 1 <= K <= KMAX. The row ids must lie in
    [0, R): the kernel does not check them."""
    args = (tab, queries, rows, alive)
    if all(t.device.type == "cpu" for t in args):
        return knn_window_plain(tab, queries, rows, alive, K)
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"knn_window: tensors must lie on one CUDA device, tab is on {dev}")
    Q, V = rows.shape
    _need(tab, "tab", torch.float32, (tab.shape[0], 32, 5), dev)
    _need(queries, "queries", torch.float32, (Q, 3), dev)
    _need(rows, "rows", torch.int64, (Q, V), dev)
    _need(alive, "alive", torch.bool, (Q, V), dev)
    if not 0 < K <= KMAX:
        raise ValueError(f"knn_window: K={K} must lie in [1, {KMAX}]")
    out_pts = torch.empty((Q, K, 3), dtype=tab.dtype, device=dev)
    out_covs = torch.empty((Q, K), dtype=tab.dtype, device=dev)
    out_d2 = torch.empty((Q, K), dtype=tab.dtype, device=dev)
    err = _lib()(
        tab.data_ptr(), queries.data_ptr(), rows.data_ptr(), alive.data_ptr(), Q, V, K,
        out_pts.data_ptr(), out_covs.data_ptr(), out_d2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "knn_window_launch")
    knn_window.launches += 1
    by_shape = knn_window.launches_by_shape
    by_shape[Q, V, K] = by_shape.get((Q, V, K), 0) + 1
    return out_pts, out_covs, out_d2


knn_window.launches = 0
knn_window.launches_by_shape = {}  # (queries Q, window rows V, K) -> launches
