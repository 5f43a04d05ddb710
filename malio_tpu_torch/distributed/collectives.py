"""The exchanges of a sharded fusion round over one torch.distributed group
(port-only: in the JAX package GSPMD inserts them for the mesh's mp axis,
malio_tpu/distributed/sharding.py:1-19).

Every exchange is a copy or an integer sum, so every one is exact:

  * `stack` puts every rank's value of x (one shape and dtype on every
    rank) on a new leading axis in rank order: one all-gather, a copy.
    Gloo gathers no CUDA tensor, so there each rank writes its x, viewed
    as integers (f32 as int32, f64 as int64, bool as uint8), into its
    own row of a zero buffer and the ranks SUM the buffers: x + 0 = x,
    bit for bit, -0.0 and NaN payloads included. `sharding` gathers the
    global carry and outputs with it too.
  * `gather` is `stack` of several tensors of any dtype in one buffer of
    int64 words (bool as 0/1).
  * `sum` adds counts; min and max are taken after a `gather`, and so
    are the sums over measurement lanes: the ranks' rows are gathered in
    lane order and summed as one process sums them, so every rank
    computes the single process's bits.

Backends: over NCCL (a card a rank) the collectives go into a CUDA graph
with the rest of the round (`capturable`; pipeline.step captures the
round then). Each gloo collective on a CUDA tensor goes through the host,
which a capture cannot hold, so a round over gloo runs eagerly.

Counts: `calls` counts the collectives issued and `bytes` the bytes of
their output buffers by kind ("all_reduce", "all_gather"). One recorded
while its stream is being captured counts in `captured` instead; each
replay of the graph adds the round's record (`add`), as ops.count_launch
and ops.add_launches count kernels.
"""
from __future__ import annotations

import functools
import operator

import torch
import torch.distributed as dist

_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bool: torch.uint8}


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


def _add(counts, record, n=1):
    for k, v in record.items():
        counts[k] = counts.get(k, 0) + v * n


class ShardGroup:
    """One process group of `size` ranks, this process at `rank` in it,
    over `backend` ("nccl" or "gloo")."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        self.backend = dist.get_backend(group)
        self.calls = 0
        self.bytes = {}
        self.captured = {}  # "calls" and bytes by kind, recorded into CUDA graphs

    def __repr__(self):
        return f"ShardGroup(rank={self.rank}, size={self.size}, backend={self.backend!r})"

    @property
    def capturable(self) -> bool:
        """Whether a round over this group can be one CUDA graph: its
        collectives run over NCCL, which records them into the capturing
        stream. Over gloo they go through the host."""
        return self.backend == "nccl"

    def add(self, record, n: int = 1):
        """Count n replays of a graph whose collectives over this group are
        `record` (a difference of two `captured`)."""
        self.calls += record.get("calls", 0) * n
        _add(self.bytes, {k: v for k, v in record.items() if k != "calls"}, n)

    def _count(self, kind, out):
        record = {"calls": 1, kind: out.numel() * out.element_size()}
        if out.is_cuda and torch.cuda.is_current_stream_capturing():
            _add(self.captured, record)
        else:
            self.add(record)

    def _sum(self, buf):
        self._count("all_reduce", buf)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def stack(self, x):
        """Every rank's x (one shape and dtype on every rank) on a new
        leading axis of length `size`, in rank order."""
        x = x.contiguous()
        if self.backend == "gloo" and x.is_cuda:
            w = x.view(_INT_VIEW[x.dtype]) if x.dtype in _INT_VIEW else x
            buf = torch.zeros((self.size,) + tuple(x.shape), dtype=w.dtype, device=x.device)
            buf[self.rank] = w
            return self._sum(buf).view(x.dtype)
        out = torch.empty(self.size * x.numel(), dtype=x.dtype, device=x.device)
        self._count("all_gather", out)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=self.group)
        return out.view((self.size,) + tuple(x.shape))

    def gather(self, *xs):
        """Every rank's value of each x, stacked on a new leading axis of
        length `size` in rank order (one collective for all of them)."""
        words = [_to_words(x) for x in xs]
        sizes = [w.numel() for w in words]
        parts = torch.split(self.stack(torch.cat(words)), sizes, dim=1)
        out = [_from_words(p, x, (self.size,)) for p, x in zip(parts, xs)]
        return out[0] if len(xs) == 1 else out

    def sum(self, *xs):
        """Each x (a count) summed over the ranks (one collective)."""
        gs = self.gather(*xs)
        out = [functools.reduce(operator.add, g.unbind(0)) for g in (gs if len(xs) > 1 else [gs])]
        return out[0] if len(xs) == 1 else out
