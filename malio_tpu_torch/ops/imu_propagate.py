"""The IMU mean propagation chain: the CUDA kernel `csrc/imu_propagate.cu`,
one launch a propagation pass of `propagate._batch_propagate`. Its plain
PyTorch version is `propagate._mean_chain_plain` (K `dynamics.step_mean`
steps, each kept where its valid flag holds), which a CPU or a float64
state runs. Not a port of a TPU kernel: the JAX package runs the same
chain as a lax.scan (malio_tpu/propagate.py:136-142).

`mean_chain` takes f32 CUDA tensors only and raises a ValueError on what
the kernel does not take; it has no fallback. Only pos, rot and vel change
along the chain, so the kernel returns the K + 1 states s_0 .. s_K of B
sequences as one (B, K + 1, 10) tensor, `STATE_WIDTH` floats [pos 3,
rot 4, vel 3] a state: `states` turns a slice of it into a State whose
other fields are x0's, expanded, not copied. The kernel computes the plain
version's arithmetic in its order: the two agree to rounding, not bit for
bit.
"""
from __future__ import annotations

import ctypes

import torch

from .. import state as st
from . import _build, count_launch

STATE_WIDTH = 10  # pos 3, rot 4, vel 3

_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = _build.load("imu_propagate").imu_propagate_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        _fn = fn
    return _fn


def _need(t, name, dtype, shape):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"imu_propagate kernel: {name} must be a contiguous {dtype} CUDA tensor, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"imu_propagate kernel: {name} has shape {tuple(t.shape)}, want {shape}")


def mean_chain(x0: st.State, gyros, accs, dts, valids):
    """K mean steps of B sequences in one launch: x0 with fields (B, ...),
    gyros and accs (B, K, 3), dts (B, K) f32, valids (B, K) bool, all
    contiguous on one card. Returns the states (B, K + 1, STATE_WIDTH)."""
    B, K = dts.shape[0], dts.shape[-1]
    f32 = torch.float32
    for t, name, w in ((x0.pos, "pos", 3), (x0.rot, "rot", 4), (x0.vel, "vel", 3),
                       (x0.bg, "bg", 3), (x0.ba, "ba", 3), (x0.grav, "grav", 3)):
        _need(t, name, f32, (B, w))
    _need(gyros, "gyros", f32, (B, K, 3))
    _need(accs, "accs", f32, (B, K, 3))
    _need(dts, "dts", f32, (B, K))
    _need(valids, "valids", torch.bool, (B, K))
    dev = dts.device
    args = (x0.pos, x0.rot, x0.vel, x0.bg, x0.ba, x0.grav, gyros, accs, dts, valids)
    if any(t.device != dev for t in args):
        raise ValueError(f"imu_propagate kernel: tensors must lie on one CUDA device, got "
                         f"{sorted({str(t.device) for t in args})}")
    out = torch.empty((B, K + 1, STATE_WIDTH), dtype=f32, device=dev)
    err = _lib()(*(t.data_ptr() for t in args), B, K, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "imu_propagate_launch")
    if B:
        count_launch(mean_chain, (B, K))
    return out


def states(x0: st.State, s) -> st.State:
    """The states s (B, ..., STATE_WIDTH) of `mean_chain` as a State: pos,
    rot and vel are views of s, the other fields x0's expanded over s's
    middle axes."""
    mid = s.shape[1:-1]

    def const(a):  # (B, ...) -> (B, *mid, ...)
        return a.reshape(a.shape[:1] + (1,) * len(mid) + a.shape[1:]).expand(
            a.shape[:1] + mid + a.shape[1:])

    return st.State(pos=s[..., 0:3], rot=s[..., 3:7], ext_r=const(x0.ext_r),
                    ext_t=const(x0.ext_t), vel=s[..., 7:10], bg=const(x0.bg), ba=const(x0.ba),
                    grav=const(x0.grav))


mean_chain.launches = 0
# (sequences B, steps K) -> launches
mean_chain.launches_by_shape = {}
mean_chain.captured = {}  # the same, recorded into CUDA graphs
