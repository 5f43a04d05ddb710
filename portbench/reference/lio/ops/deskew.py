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

import torch

from .. import spline as spl
from .. import tree
from ..geometry import so3


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

