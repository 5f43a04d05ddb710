"""Carry the filter state across between the two packages.

The JAX package's pytrees (LioCarry, State, History, MeasureGroup,
VoxelHashMap) travel as nested dicts of numpy arrays keyed by field name;
these functions turn such dicts into the port's NamedTuples of tensors and
back, so both packages can step from the same carry. Dtypes are kept as
given. The port never sees a JAX object: the caller flattens that side.
Like the package's entry points, they put the tensors on the card unless
the caller passes `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import state as st
from . import propagate as prop
from . import pipeline
from .map import voxel_hash as vh


def _t(a, device):
    return torch.as_tensor(np.array(a, copy=True)).to(device)


def _build(cls, d, device, nested=None):
    device = pipeline.resolve_device(device)
    nested = nested or {}
    kw = {}
    for f in cls._fields:
        if f in nested:
            kw[f] = _build(nested[f], d[f], device)
        else:
            kw[f] = _t(d[f], device)
    return cls(**kw)


def state_from_numpy(d, device="cuda") -> st.State:
    return _build(st.State, d, device)


def group_from_numpy(d, device="cuda") -> prop.MeasureGroup:
    return _build(prop.MeasureGroup, d, device)


def map_from_numpy(d, device="cuda") -> vh.VoxelHashMap:
    return _build(vh.VoxelHashMap, d, device)


def carry_from_numpy(d, device="cuda") -> pipeline.LioCarry:
    return _build(
        pipeline.LioCarry, d, device,
        nested={"x": st.State, "hist": prop.History, "map": vh.VoxelHashMap},
    )


def to_numpy(obj):
    """NamedTuple of tensors (nested) -> nested dict of numpy arrays."""
    if hasattr(obj, "_fields"):
        return {f: to_numpy(getattr(obj, f)) for f in obj._fields}
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def carry_to_numpy(carry: pipeline.LioCarry) -> dict:
    return to_numpy(carry)
