"""Checkpoint / resume of the LIO carry (counterpart of
malio_tpu/checkpoint.py).

The whole filter and map state is one nested NamedTuple, so a checkpoint
is a flat .npz of its leaves. The keys are the JAX package's key-path
strings, "." + field name, nested with "/" (".x/.pos", ".map/.tab",
".step_count"), so a carry saved by either package loads in the other.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from .device import resolve_device


def _key(prefix, field):
    """A leaf's key as JAX prints its key path: ".x/.pos"."""
    return f"{prefix}/.{field}" if prefix else f".{field}"


def _leaves(tree, prefix=""):
    """(key, leaf) pairs of a nested NamedTuple."""
    for f in tree._fields:
        key = _key(prefix, f)
        v = getattr(tree, f)
        if hasattr(v, "_fields"):
            yield from _leaves(v, key)
        else:
            yield key, v


def save(path, carry):
    leaves = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
              for k, v in _leaves(carry)}
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **leaves)


def load(path, template):
    """The carry saved at `path`, in the structure of `template` (a carry
    of the same shapes, e.g. from pipeline.init_carry), each leaf with the
    dtype and on the device of the template's. ValueError on a shape
    mismatch."""
    with np.load(path) as data:
        def build(tree, prefix=""):
            kw = {}
            for f in tree._fields:
                key = _key(prefix, f)
                leaf = getattr(tree, f)
                if hasattr(leaf, "_fields"):
                    kw[f] = build(leaf, key)
                    continue
                arr = data[key]
                if arr.shape != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {tuple(leaf.shape)}")
                kw[f] = torch.as_tensor(arr).to(dtype=leaf.dtype, device=resolve_device(leaf.device))
            return type(tree)(**kw)

        return build(template)
