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

import torch


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

