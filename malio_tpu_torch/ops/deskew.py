"""Spline deskew of every raw point to its LiDAR's scan-end frame: the CUDA
kernel `csrc/deskew.cu` (which replaces the TPU kernel
malio_tpu/ops/deskew_pallas.py:deskew_points) and its plain PyTorch
version, the eager path of propagate.undistort over spline.get_pose_batch.

  p' = ext^-1 (lt^-1 (pose(t) (ext p + t_ext) + (trans(t) - t_lt)) - t_ext)

`deskew_points` takes a CPU tensor to the plain version and a CUDA tensor
to the kernel; there is no other fallback. The kernel works on rotation
matrices, the plain version on quaternions, both in f32: the kernel is
within atol 2e-5 of the plain version run in f64 (the exact deskew), with
the f32 plain version's ok flags. (Two f32 results of the deskew's chain
lie up to ~5 ulp apart 35 m out, so the f32 plain version is no reference
at that limit.) The kernel takes all LiDARs of all B
sequences of a batch in one launch, up to its caps (MAX_LIDARS,
MAX_CONTROL_POINTS and MAX_SEQUENCES in the .cu); past them the wrapper
raises a ValueError.
"""
from __future__ import annotations

import ctypes

import torch

from .. import spline as spl
from .. import tree
from ..geometry import so3
from . import _build


def deskew_points_plain(pts, sp: spl.Spline, ext_q, ext_t, lt_q, lt_t):
    """pts ([B,] L, N, 4) [x, y, z, t]; per-sequence spline (fields with
    the leading [B]); per-LiDAR ext_q/lt_q ([B,] L, 4), ext_t/lt_t
    ([B,] L, 3). Returns ([B,] L, N, 4): deskewed xyz and the ok flag (0/1)."""
    lead, (L, N) = pts.shape[:-3], pts.shape[-3:-1]
    p_in = pts[..., :3]
    pq, pp, pok = spl.get_pose_batch(sp, pts[..., 3].reshape(*lead, L * N))
    pq = pq.reshape(*lead, L, N, 4)
    pp = pp.reshape(*lead, L, N, 3)
    pok = pok.reshape(*lead, L, N)
    eq, et = ext_q[..., None, :], ext_t[..., None, :]
    pl_imu = so3.quat_rotate(pq, so3.quat_rotate(eq, p_in) + et)
    in_lt = so3.quat_rotate_inv(lt_q[..., None, :].expand(pq.shape), pl_imu + (pp - lt_t[..., None, :]))
    p_deskew = so3.quat_rotate_inv(eq.expand(pq.shape), in_lt - et)
    xyz = torch.where(pok[..., None], p_deskew, p_in)
    return torch.cat([xyz, pok[..., None].to(pts.dtype)], dim=-1)


_fn = None

REFUSED = -1  # csrc/deskew.cu: deskew_launch's answer to what it does not take
# up to this many points (all LiDARs) a launch runs three lanes per point
# and reads the spline through the read-only cache; above it one lane per
# point with the spline staged in shared memory. chip_smoke.py's layout
# sweep puts the crossover on an H100 at ~24,600 points with times in
# random order and ~40,000 in a scan's order
THREE_LANES_MAX_POINTS = 32768


def _lib():
    global _fn
    if _fn is None:
        fn = _build.load("deskew").deskew_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def _need(t, name, dtype, shape):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"deskew kernel: {name} must be a contiguous {dtype} CUDA tensor, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"deskew kernel: {name} has shape {tuple(t.shape)}, want {shape}")


def lanes_for(points: int) -> int:
    """Lanes per point of the kernel's layout for this many points."""
    return 3 if points <= THREE_LANES_MAX_POINTS else 1


def deskew_points(pts, sp: spl.Spline, ext_q, ext_t, lt_q, lt_t, layout_points=None):
    """Deskew ([B,] L, N, 4) points; same contract as `deskew_points_plain`.
    CPU tensors run the plain version; CUDA tensors launch the kernel once
    for all B sequences, in the layout `lanes_for(B * L * N)` picks, or
    `lanes_for(layout_points)` for a slice of a larger set (a rank's raw
    points), so that each point gets the bits the whole set would. It
    reads the spline and the quaternion frames as they are: the wrapper
    launches no other device work."""
    if pts.device.type == "cpu":
        return deskew_points_plain(pts, sp, ext_q, ext_t, lt_q, lt_t)
    n = pts[..., 0].numel() if layout_points is None else layout_points
    return _launch(pts, sp, ext_q, ext_t, lt_q, lt_t, lanes_for(n))


def _launch(pts, sp, ext_q, ext_t, lt_q, lt_t, lanes):
    """The kernel with `lanes` (1 or 3) per point over ([B,] L, N, 4)
    points; chip_smoke.py and the card tests time and check each layout
    through it. Block row b of the grid works on sequence b alone; one
    sequence is launched as a batch of one."""
    if pts.dim() == 3:
        args = tree.unsqueeze((pts, sp, ext_q, ext_t, lt_q, lt_t))
        return _launch(*args, lanes)[0]
    B, L, N = pts.shape[0], pts.shape[1], pts.shape[2]
    C = sp.cps.shape[1]
    f32 = torch.float32
    _need(pts, "pts", f32, (B, L, N, 4))
    _need(sp.cps, "cps", f32, (B, C, 4, 4))
    _need(sp.logs, "logs", f32, (B, C, 6))
    _need(sp.t0, "t0", f32, (B,))
    _need(sp.num_valid, "num_valid", torch.int32, (B,))
    for t, name, w in ((ext_q, "ext_q", 4), (ext_t, "ext_t", 3), (lt_q, "lt_q", 4), (lt_t, "lt_t", 3)):
        _need(t, name, f32, (B, L, w))
    if pts.data_ptr() % 16:
        raise ValueError("deskew kernel: pts must be 16-byte aligned")
    out = torch.empty_like(pts)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = _lib()(
        pts.data_ptr(), B, L, N, sp.cps.data_ptr(), sp.logs.data_ptr(), C, sp.t0.data_ptr(),
        sp.num_valid.data_ptr(), ext_q.data_ptr(), ext_t.data_ptr(), lt_q.data_ptr(),
        lt_t.data_ptr(), ctypes.c_float(spl.CONTROL_DT), lanes, out.data_ptr(), stream,
    )
    if err == REFUSED:
        raise ValueError(f"deskew kernel: it does not take {B} sequences of {L} LiDARs with {C} "
                         f"control points and {lanes} lanes a point (caps in csrc/deskew.cu)")
    _build.check(err, "deskew_launch")
    if B * L * N:
        deskew_points.launches += 1
        by_shape = deskew_points.launches_by_shape
        by_shape[B, L, N, C] = by_shape.get((B, L, N, C), 0) + 1
    return out


deskew_points.launches = 0
# (sequences B, LiDARs L, points N, control points C) -> launches
deskew_points.launches_by_shape = {}
