"""Leading-axis helpers over NamedTuples of tensors (a carry, a measure
group, a step's output): add or drop the batch axis, stack, take one
sequence, and select per sequence. Leaves that are not tensors (None, a
Python number) pass through unchanged."""
from __future__ import annotations

import torch


def map_tensors(fn, tree):
    """fn applied to every tensor leaf of nested NamedTuples and tuples."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, a) for a in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, a) for a in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def leaves(tree):
    """The tensor leaves of nested NamedTuples and tuples, in field order."""
    if hasattr(tree, "_fields") or isinstance(tree, (tuple, list)):
        return [leaf for a in tree for leaf in leaves(a)]
    return [tree] if torch.is_tensor(tree) else []


def unsqueeze(tree):
    """A batch of one: every leaf gains a leading axis of length 1."""
    return map_tensors(lambda a: a[None], tree)


def squeeze(tree):
    """The only sequence of a batch of one."""
    return map_tensors(lambda a: a[0], tree)


def index(tree, i):
    """Sequence (or round) i along the leading axis."""
    return map_tensors(lambda a: a[i], tree)


def stack(trees, dim: int = 0):
    """NamedTuples (or tuples) of equal structure stacked leaf by leaf along
    `dim`."""
    first = trees[0]
    if hasattr(first, "_fields"):
        return type(first)(*(stack(list(f), dim) for f in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(stack(list(f), dim) for f in zip(*trees))
    return torch.stack(trees, dim) if torch.is_tensor(first) else first


def take(x, idx):
    """Per sequence b: x[b, idx[b]]. x (B, T, *tail), idx (B, *K) ->
    (B, *K, *tail): one gather for the whole batch."""
    B = x.shape[0]
    ar = torch.arange(B, device=x.device).reshape((B,) + (1,) * (idx.dim() - 1))
    return x[ar, idx]


def bcast(cond, like):
    """cond (B,) shaped to broadcast over a leaf (B, ...)."""
    return cond.reshape(cond.shape + (1,) * (like.dim() - cond.dim()))


def where(cond, a, b):
    """Per sequence: leaf of `a` where cond (B,) holds, else of `b` (a leaf
    that is the same tensor in both is passed through, not copied)."""
    if a is b:
        return a
    if hasattr(a, "_fields"):
        return type(a)(*(where(cond, x, y) for x, y in zip(a, b)))
    if isinstance(a, (tuple, list)):
        return type(a)(where(cond, x, y) for x, y in zip(a, b))
    if not torch.is_tensor(a):
        return a
    return torch.where(bcast(cond, a), a, b)
