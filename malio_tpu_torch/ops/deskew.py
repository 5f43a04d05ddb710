"""Spline deskew of every raw point to its LiDAR's scan-end frame: the CUDA
kernel `csrc/deskew.cu` (which replaces the TPU kernel
malio_tpu/ops/deskew_pallas.py:deskew_points) and its plain PyTorch
version, the eager path of propagate.undistort over spline.get_pose_batch.

  p' = ext^-1 (lt^-1 (pose(t) (ext p + t_ext) + (trans(t) - t_lt)) - t_ext)

`deskew_points` takes a CPU tensor to the plain version and a CUDA tensor
to the kernel; there is no other fallback. The kernel works on rotation
matrices, the plain version on quaternions: they agree to f32 round-off
(atol 2e-5) with equal ok flags. The kernel takes all LiDARs in one
launch, up to its caps (MAX_LIDARS and MAX_CONTROL_POINTS in the .cu);
past them the wrapper raises a ValueError.
"""
from __future__ import annotations

import ctypes

import torch

from .. import spline as spl
from ..geometry import so3
from . import _build


def deskew_points_plain(pts, sp: spl.Spline, ext_q, ext_t, lt_q, lt_t):
    """pts (L, N, 4) [x, y, z, t]; per-LiDAR ext_q/lt_q (L, 4), ext_t/lt_t
    (L, 3). Returns (L, N, 4): deskewed xyz and the ok flag (0/1)."""
    L = pts.shape[0]
    p_in = pts[..., :3]
    pq, pp, pok = spl.get_pose_batch(sp, pts[..., 3].reshape(-1))
    pq = pq.reshape(L, -1, 4)
    pp = pp.reshape(L, -1, 3)
    pok = pok.reshape(L, -1)
    pl_imu = so3.quat_rotate(pq, so3.quat_rotate(ext_q[:, None], p_in) + ext_t[:, None])
    in_lt = so3.quat_rotate_inv(lt_q[:, None].expand(pq.shape), pl_imu + (pp - lt_t[:, None, :]))
    p_deskew = so3.quat_rotate_inv(ext_q[:, None].expand(pq.shape), in_lt - ext_t[:, None])
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
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int] + [ctypes.c_void_p] * 6
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


def deskew_points(pts, sp: spl.Spline, ext_q, ext_t, lt_q, lt_t):
    """Deskew (L, N, 4) points; same contract as `deskew_points_plain`.
    CPU tensors run the plain version; CUDA tensors launch the kernel in
    the layout `lanes_for(L * N)` picks. It reads the spline and the
    quaternion frames as they are: the wrapper launches no other device
    work."""
    if pts.device.type == "cpu":
        return deskew_points_plain(pts, sp, ext_q, ext_t, lt_q, lt_t)
    return _launch(pts, sp, ext_q, ext_t, lt_q, lt_t, lanes_for(pts.shape[0] * pts.shape[1]))


def _launch(pts, sp, ext_q, ext_t, lt_q, lt_t, lanes):
    """The kernel with `lanes` (1 or 3) per point; chip_smoke.py and the
    card tests time and check each layout through it."""
    L, N = pts.shape[0], pts.shape[1]
    C = sp.cps.shape[0]
    f32 = torch.float32
    _need(pts, "pts", f32, (L, N, 4))
    _need(sp.cps, "cps", f32, (C, 4, 4))
    _need(sp.logs, "logs", f32, (C, 6))
    _need(sp.t0, "t0", f32, ())
    _need(sp.num_valid, "num_valid", torch.int32, ())
    for t, name, w in ((ext_q, "ext_q", 4), (ext_t, "ext_t", 3), (lt_q, "lt_q", 4), (lt_t, "lt_t", 3)):
        _need(t, name, f32, (L, w))
    if pts.data_ptr() % 16:
        raise ValueError("deskew kernel: pts must be 16-byte aligned")
    out = torch.empty_like(pts)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = _lib()(
        pts.data_ptr(), L, N, sp.cps.data_ptr(), sp.logs.data_ptr(), C, sp.t0.data_ptr(),
        sp.num_valid.data_ptr(), ext_q.data_ptr(), ext_t.data_ptr(), lt_q.data_ptr(),
        lt_t.data_ptr(), ctypes.c_float(spl.CONTROL_DT), lanes, out.data_ptr(), stream,
    )
    if err == REFUSED:
        raise ValueError(f"deskew kernel: it does not take {L} LiDARs with {C} control points "
                         f"and {lanes} lanes a point (caps in csrc/deskew.cu)")
    _build.check(err, "deskew_launch")
    if L * N:
        deskew_points.launches += 1
        by_shape = deskew_points.launches_by_shape
        by_shape[L, N, C] = by_shape.get((L, N, C), 0) + 1
    return out


deskew_points.launches = 0
deskew_points.launches_by_shape = {}  # (LiDARs L, points N, control points C) -> launches
