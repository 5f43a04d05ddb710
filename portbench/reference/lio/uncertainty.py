"""Point-wise inter-LiDAR uncertainty propagation: Barfoot 4th-order SE(3)
compounding and the per-point covariance trace (counterpart of
malio_tpu/uncertainty.py; associate_uct.hpp). Covariance tangent order is
[translation(0:3); rotation(3:6)]; every function takes any batch shape."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import so3, se3


class Pose(NamedTuple):
    q: torch.Tensor  # (..., 4)
    t: torch.Tensor  # (..., 3)
    cov: torch.Tensor  # (..., 6, 6)


def pose_matrix(p: Pose):
    return se3.make_se3(p.q, p.t)


def _T(A):
    return A.transpose(-1, -2)


def _covop1(B):
    """-tr(B) I + B."""
    tr = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return -tr * so3._eye3(B) + B


def _covop2(B, C):
    return _covop1(B) @ _covop1(C) + _covop1(C @ B)


def _fourth_order(cov_1_prime, cov_2):
    c1rr = cov_1_prime[..., 0:3, 0:3]
    c1rp = cov_1_prime[..., 0:3, 3:6]
    c1pp = cov_1_prime[..., 3:6, 3:6]
    c2rr = cov_2[..., 0:3, 0:3]
    c2rp = cov_2[..., 0:3, 3:6]
    c2pp = cov_2[..., 3:6, 3:6]

    def a_mat(cpp, crp):
        Z = torch.zeros_like(cpp)
        top = torch.cat([_covop1(cpp), _covop1(crp + _T(crp))], dim=-1)
        bot = torch.cat([Z, _covop1(cpp)], dim=-1)
        return torch.cat([top, bot], dim=-2)

    A1 = a_mat(c1pp, c1rp)
    A2 = a_mat(c2pp, c2rp)
    c1pr = _T(c1rp)
    Brr = (
        _covop2(c1pp, c2rr)
        + _covop2(c1pr, c2rp)
        + _covop2(c1rp, _T(c2rp))
        + _covop2(c1rr, c2pp)
    )
    Brp = _covop2(c1pp, _T(c2rp)) + _covop2(c1pr, c2pp)
    Bpp = _covop2(c1pp, c2pp)
    B = torch.cat(
        [torch.cat([Brr, Brp], dim=-1), torch.cat([_T(Brp), Bpp], dim=-1)], dim=-2
    )
    return (
        cov_1_prime
        + cov_2
        + (A1 @ cov_2 + cov_2 @ _T(A1) + A2 @ cov_1_prime + cov_1_prime @ _T(A2)) / 12.0
        + B / 4.0
    )


def compound_pose(p1: Pose, p2: Pose) -> Pose:
    """T = T1 T2 with 4th-order covariance."""
    q = so3.quat_normalize(so3.quat_mul(p1.q, p2.q))
    t = so3.quat_rotate(p1.q, p2.t) + p1.t
    Ad = se3.adjoint(se3.inv_se3(pose_matrix(p2)))
    cov1p = Ad @ p1.cov @ _T(Ad)
    return Pose(q, t, _fourth_order(cov1p, p2.cov))


def compound_inv_pose(p1: Pose, p2: Pose) -> Pose:
    """T = T1^-1 T2 with 4th-order covariance."""
    q = so3.quat_normalize(so3.quat_mul(so3.quat_conj(p1.q), p2.q))
    t = so3.quat_rotate_inv(p1.q, p2.t - p1.t)
    Ad = se3.adjoint(se3.inv_se3(se3.make_se3(q, t)))
    cov1p = Ad @ p1.cov @ _T(Ad)
    return Pose(q, t, _fourth_order(cov1p, p2.cov))


_COV_SCALE = 10000.0
_MEAS_COV = 0.1
_DISTANCE_WEIGHT = 0.05


def eval_point_uncertainty(point, pose: Pose):
    """3x3 covariance of a LiDAR point given its epoch pose uncertainty
    (associate_uct.hpp:153-175)."""
    p = point * _DISTANCE_WEIGHT
    T = pose_matrix(pose)
    R = T[..., :3, :3]
    tp = (R @ p[..., None])[..., 0] + T[..., :3, 3]
    G_rot = -so3.hat(tp)
    cov_pose = pose.cov * _COV_SCALE
    cov_tt = cov_pose[..., 0:3, 0:3]
    cov_tr = cov_pose[..., 0:3, 3:6]
    cov_rr = cov_pose[..., 3:6, 3:6]
    # G_trans = I and G_meas = R (written out as in the reference form)
    I3 = so3._eye3(R)
    return (
        I3 @ cov_tt @ _T(I3)
        + I3 @ cov_tr @ _T(G_rot)
        + G_rot @ _T(cov_tr) @ _T(I3)
        + G_rot @ cov_rr @ _T(G_rot)
        + _MEAS_COV * (R @ _T(R))
    )


def point_uncertainty_trace(point, pose: Pose):
    return torch.diagonal(eval_point_uncertainty(point, pose), dim1=-2, dim2=-1).sum(-1)
