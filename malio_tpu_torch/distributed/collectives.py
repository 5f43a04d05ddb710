"""The exchanges of a sharded fusion round over one torch.distributed group
(port-only: in the JAX package GSPMD inserts them for the mesh's mp axis,
malio_tpu/distributed/sharding.py:1-19).

Every exchange is one all-reduce SUM on integers, so every one is exact:

  * `gather` stacks each rank's part in rank order. Each rank writes its
    part, viewed as integers (f32 as int32, f64 as int64, bool as 0/1),
    into its own row of a zero buffer, and the ranks SUM the buffers:
    x + 0 = x, bit for bit, -0.0 and NaN payloads included. Several
    tensors of any dtype travel in one buffer (int64).
  * `assemble` is the same for a table whose rows each rank owns: a row
    is nonzero on its owner only.
  * `union` adds 0/1 flags and keeps where any rank set one; `sum` adds
    counts.
  * min and max are taken after a `gather`, and so are the sums over
    measurement lanes: the ranks' rows are gathered in lane order and
    summed as one process sums them, so every rank computes the single
    process's bits.
  * `agree` returns every rank's value of something the host is about to
    branch on, so that every rank can take the same branch: a rank that
    skipped a collective would hang the others.

Gloo takes all-reduce and broadcast on CUDA tensors, so the exchanges
need nothing else; each gloo collective on a CUDA tensor synchronises
the host. `calls` counts the collectives issued.
"""
from __future__ import annotations

import functools
import operator

import numpy as np
import torch
import torch.distributed as dist

_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}


def _to_words(x):
    """x as a flat int64 tensor that `_from_words` turns back bit for bit."""
    x = x.contiguous()
    if x.dtype in _INT_VIEW:
        x = x.view(_INT_VIEW[x.dtype])
    return x.reshape(-1).to(torch.int64)


def _from_words(w, like, lead=()):
    shape = tuple(lead) + tuple(like.shape)
    if like.dtype == torch.bool:
        return (w != 0).reshape(shape)
    if like.dtype in _INT_VIEW:
        return w.to(_INT_VIEW[like.dtype]).view(like.dtype).reshape(shape)
    return w.to(like.dtype).reshape(shape)


class ShardGroup:
    """One process group of `size` ranks, this process at `rank` in it."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        self.calls = 0

    def _sum(self, buf):
        self.calls += 1
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def gather(self, *xs):
        """Every rank's value of each x, stacked on a new leading axis of
        length `size` in rank order (one collective for all of them)."""
        words = [_to_words(x) for x in xs]
        sizes = [w.numel() for w in words]
        buf = torch.zeros((self.size, sum(sizes)), dtype=torch.int64, device=xs[0].device)
        buf[self.rank] = torch.cat(words)
        buf = self._sum(buf)
        parts = torch.split(buf, sizes, dim=1)
        out = [_from_words(p, x, (self.size,)) for p, x in zip(parts, xs)]
        return out[0] if len(xs) == 1 else out

    def assemble(self, x):
        """x summed over the ranks as integers: exact where every element
        is nonzero on at most one rank (a table filled by the owners of its
        rows)."""
        w = x.contiguous()
        if w.dtype in _INT_VIEW:
            return self._sum(w.view(_INT_VIEW[w.dtype]).clone()).view(x.dtype)
        if w.dtype == torch.bool:
            return self._sum(w.to(torch.int32)) != 0
        return self._sum(w.clone())

    def union(self, flags):
        """flags (bool) set on any rank."""
        return self._sum(flags.to(torch.int32)) > 0

    def sum(self, *xs):
        """Each x (a count) summed over the ranks (one collective)."""
        gs = self.gather(*xs)
        out = [functools.reduce(operator.add, g.unbind(0)) for g in (gs if len(xs) > 1 else [gs])]
        return out[0] if len(xs) == 1 else out

    def agree(self, x) -> np.ndarray:
        """Every rank's value of x on the host, (size, *x.shape): the
        caller branches on a reduction of it that every rank computes
        alike."""
        return self.gather(x).cpu().numpy()
