"""Order-fixed segment sums: the port's counterpart of JAX's
`zeros(...).at[ids].add(values)`.

On the card `index_add_` sums with atomics, in an order that changes from
run to run, so float sums (and every gate that reads them) would too.
`segment_sum` sorts the rows by id (stably, so each segment keeps row
order) and sums every contiguous segment sequentially with
`torch.segment_reduce`, as `preprocess.voxel_sums_plain` does: the result
is the same bits on every run, and each segment is summed in the order a
sequential scatter-add takes.

The sum is linear in the values, so it carries its own derivatives: the
forward-mode derivative is the same sum of the tangent, the reverse-mode
one gathers each segment's gradient back to its rows, and under
`torch.func.vmap` the batch axis moves behind the row axis. That lets
`torch.func.grad`, `hessian` and `jacfwd` go through it (segment_reduce
itself has no forward-mode derivative).
"""
from __future__ import annotations

import torch


class _SortedSegmentSum(torch.autograd.Function):
    """Sums of the contiguous segments of rows already sorted by segment:
    x (N, ...) -> (S, ...), lengths (S,) summing to N, seg (N,) the
    segment of each row."""

    @staticmethod
    def forward(x, lengths, seg):
        return torch.segment_reduce(x, "sum", lengths=lengths, axis=0, unsafe=True, initial=0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.lengths, ctx.seg = inputs

    @staticmethod
    def backward(ctx, g):
        return g[ctx.seg], None, None

    @staticmethod
    def jvp(ctx, t, _lengths, _seg):
        return _SortedSegmentSum.apply(t, ctx.lengths, ctx.seg)

    @staticmethod
    def vmap(info, in_dims, x, lengths, seg):
        if in_dims[0] is None:
            return _SortedSegmentSum.apply(x, lengths, seg), None
        return _SortedSegmentSum.apply(x.movedim(in_dims[0], 1), lengths, seg), 1


def segment_sum(values, ids, num_segments: int):
    """out[s] = sum of values[r] over the rows r with ids[r] == s, for
    s in [0, num_segments), each segment summed in row order. values
    (N, ...), ids (N,) int64 in [0, num_segments). Differentiable in
    values (ids are constants)."""
    order = torch.argsort(ids, stable=True)
    lengths = torch.zeros(num_segments, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    return _SortedSegmentSum.apply(values[order], lengths, ids[order])
