"""Carry the filter state across between the two packages.

The JAX package's pytrees (LioCarry, State, History, MeasureGroup,
VoxelHashMap, KeyframeWindow, EdgeSet) travel as nested dicts of numpy
arrays keyed by field name; these functions turn such dicts into the
port's NamedTuples of tensors and back, so both packages can step from the
same carry. A JAX carry of B sequences stacked with jnp.stack (the
reference's distributed/sharding.py batch_carries) crosses over as one
batched carry, its groups stacked likewise. The back-end observers (PoseGraphBackend, WindowSmoother)
travel as their stores: the host fields as they are, the smoother's
keyframe window as a nested dict. Dtypes are kept as given. The port never
sees a JAX object: the caller flattens that side. Like the package's entry
points, they put the tensors on the card unless the caller passes
`device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ba
from . import posegraph as pg
from . import state as st
from . import propagate as prop
from . import pipeline
from .map import voxel_hash as vh

# the store of each back-end observer: what it has learned so far
_STORES = {
    "PoseGraphBackend": ("q", "t", "clouds", "masks", "times", "count", "edges", "_round",
                         "n_loop_edges", "opt_q", "opt_t", "relaxed_count", "_pending",
                         "n_feedback", "keyframe_every"),
    "WindowSmoother": ("win", "_round", "_kf_count", "_kf_times", "refined"),
}


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


def window_from_numpy(d, device="cuda") -> ba.KeyframeWindow:
    return _build(ba.KeyframeWindow, d, device)


def edges_from_numpy(d, device="cuda") -> pg.EdgeSet:
    e = _build(pg.EdgeSet, d, device)
    return e._replace(i=e.i.long(), j=e.j.long())


def store_from_numpy(obj, d, device="cuda"):
    """Set a PoseGraphBackend's or WindowSmoother's store from `d` (field
    name -> value, read off the JAX package's observer; the window as a
    nested dict); returns obj."""
    for f in _STORES[type(obj).__name__]:
        v = d[f]
        if f == "win":
            v = window_from_numpy(v, device)
        elif isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, (list, dict)):
            v = type(v)(v)
        setattr(obj, f, v)
    return obj


def to_numpy(obj):
    """NamedTuple of tensors (nested) -> nested dict of numpy arrays."""
    if hasattr(obj, "_fields"):
        return {f: to_numpy(getattr(obj, f)) for f in obj._fields}
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def carry_to_numpy(carry: pipeline.LioCarry) -> dict:
    return to_numpy(carry)
