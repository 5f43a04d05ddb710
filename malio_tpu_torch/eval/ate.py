"""Trajectory evaluation: ATE/RPE + TUM-format IO (the port's copy of the
JAX package's eval/ate.py, which imports numpy only).

The reference writes `Log/trajectory.txt` as `t x y z qx qy qz qw`
(laserMapping.cpp:1070-1071) and compares against each dataset's
Groundtruth.txt with external evo-style tooling; this module provides that
tooling in-repo."""
from __future__ import annotations

import numpy as np


def write_tum(path, t, pos, quat_wxyz):
    """TUM format: t x y z qx qy qz qw."""
    with open(path, "w") as f:
        for ti, p, q in zip(t, pos, quat_wxyz):
            f.write(
                f"{ti:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )


def read_tum(path):
    data = np.loadtxt(path)
    t = data[:, 0]
    pos = data[:, 1:4]
    qxyzw = data[:, 4:8]
    quat_wxyz = np.concatenate([qxyzw[:, 3:4], qxyzw[:, :3]], axis=1)
    return t, pos, quat_wxyz


def associate(t_a, t_b, max_dt=0.02):
    """Match timestamps; returns index pairs."""
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(t_a):
        j = int(np.searchsorted(t_b, ta))
        best, bdt = None, max_dt
        for k in (j - 1, j, j + 1):
            if 0 <= k < len(t_b):
                dt = abs(t_b[k] - ta)
                if dt < bdt:
                    best, bdt = k, dt
        if best is not None:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_se3(src, dst):
    """Best-fit SE(3) (no scale) aligning src -> dst."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    S = (dst - mu_d).T @ (src - mu_s) / src.shape[0]
    U, _, Vt = np.linalg.svd(S)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    t = mu_d - R @ mu_s
    return R, t


def ate_rmse(est_pos, gt_pos, align=True):
    """Absolute trajectory error RMSE over matched positions."""
    if align:
        R, t = umeyama_se3(est_pos, gt_pos)
        est_pos = est_pos @ R.T + t
    err = est_pos - gt_pos
    return float(np.sqrt((err**2).sum(axis=1).mean()))


# ---------------------------------------------------------------------
# quaternion helpers (batched, [w, x, y, z]) — NumPy, host-side only
# ---------------------------------------------------------------------


def _quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def _quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _quat_rot(q, v):
    uv = 2.0 * np.cross(q[..., 1:], v)
    return v + q[..., :1] * uv + np.cross(q[..., 1:], uv)


def quat_angle(q):
    """Rotation angle (rad) of unit quaternion(s), sign-insensitive."""
    q = np.asarray(q, float)
    w = np.clip(np.abs(q[..., 0]) / np.maximum(np.linalg.norm(q, axis=-1), 1e-30), 0.0, 1.0)
    return 2.0 * np.arccos(w)


def _mat_to_quat(R):
    """(..., 3, 3) rotation matrices -> (..., 4) [w,x,y,z] (numerically
    safe Shepperd branch selection)."""
    R = np.asarray(R, float)
    single = R.ndim == 2
    if single:
        R = R[None]
    m00, m11, m22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    q = np.zeros(R.shape[:-2] + (4,))
    # branch by the largest of (tr, m00, m11, m22)
    choice = np.argmax(np.stack([tr, m00, m11, m22], -1), -1)
    s_tr = np.sqrt(np.maximum(tr + 1.0, 1e-30)) * 2.0
    cand0 = np.stack(
        [0.25 * s_tr, (R[:, 2, 1] - R[:, 1, 2]) / s_tr,
         (R[:, 0, 2] - R[:, 2, 0]) / s_tr, (R[:, 1, 0] - R[:, 0, 1]) / s_tr], -1)
    s0 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 1e-30)) * 2.0
    cand1 = np.stack(
        [(R[:, 2, 1] - R[:, 1, 2]) / s0, 0.25 * s0,
         (R[:, 0, 1] + R[:, 1, 0]) / s0, (R[:, 0, 2] + R[:, 2, 0]) / s0], -1)
    s1 = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, 1e-30)) * 2.0
    cand2 = np.stack(
        [(R[:, 0, 2] - R[:, 2, 0]) / s1, (R[:, 0, 1] + R[:, 1, 0]) / s1,
         0.25 * s1, (R[:, 1, 2] + R[:, 2, 1]) / s1], -1)
    s2 = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, 1e-30)) * 2.0
    cand3 = np.stack(
        [(R[:, 1, 0] - R[:, 0, 1]) / s2, (R[:, 0, 2] + R[:, 2, 0]) / s2,
         (R[:, 1, 2] + R[:, 2, 1]) / s2, 0.25 * s2], -1)
    cands = np.stack([cand0, cand1, cand2, cand3], 0)
    q = cands[choice, np.arange(len(choice))]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q[0] if single else q


# ---------------------------------------------------------------------
# SE(3) relative pose error + rotation ATE (evo-equivalent; the offline
# comparison the reference expects users to run on Log/trajectory.txt,
# laserMapping.cpp:1070-1071 / README.md:203)
# ---------------------------------------------------------------------


def se3_rpe(est_pos, est_quat, gt_pos, gt_quat, delta=10):
    """evo-equivalent SE(3) relative pose error at a fixed frame delta.

    For each i: rel(X) = X_i^-1 X_{i+delta};  E_i = rel(gt)^-1 rel(est).
    Returns dict with trans_rmse (m), rot_rmse (rad), and the per-pair
    error arrays. NaNs when the trajectory is shorter than delta."""
    n = min(len(est_pos), len(gt_pos)) - delta
    if n <= 0:
        return dict(
            trans_rmse=float("nan"), rot_rmse=float("nan"),
            trans_errors=np.zeros(0), rot_errors=np.zeros(0),
        )
    ei, ej = est_quat[:n], est_quat[delta : delta + n]
    gi, gj = gt_quat[:n], gt_quat[delta : delta + n]
    # relative translations in the frame of pose i
    t_rel_e = _quat_rot(_quat_conj(ei), est_pos[delta : delta + n] - est_pos[:n])
    t_rel_g = _quat_rot(_quat_conj(gi), gt_pos[delta : delta + n] - gt_pos[:n])
    q_rel_e = _quat_mul(_quat_conj(ei), ej)
    q_rel_g = _quat_mul(_quat_conj(gi), gj)
    # E = rel_g^-1 rel_e; rotation preserves norms, so the translation
    # part's norm is |t_rel_e - t_rel_g|
    trans_err = np.linalg.norm(t_rel_e - t_rel_g, axis=-1)
    rot_err = quat_angle(_quat_mul(_quat_conj(q_rel_g), q_rel_e))
    return dict(
        trans_rmse=float(np.sqrt((trans_err**2).mean())),
        rot_rmse=float(np.sqrt((rot_err**2).mean())),
        trans_errors=trans_err,
        rot_errors=rot_err,
    )


def rpe_rmse(est_pos, gt_pos, delta=10, est_quat=None, gt_quat=None):
    """SE(3) relative-pose translation error RMSE at a fixed frame delta.

    With quaternions this is the evo translation-part RPE (se3_rpe). The
    quaternion-less fallback measures the world-frame relative-motion
    delta |d_est - d_gt| — rotation-frame-free, still a real vector error
    (NOT the old norm-of-norms drift proxy)."""
    if est_quat is not None and gt_quat is not None:
        return se3_rpe(est_pos, est_quat, gt_pos, gt_quat, delta)["trans_rmse"]
    n = min(len(est_pos), len(gt_pos)) - delta
    if n <= 0:
        return float("nan")
    de = est_pos[delta : delta + n] - est_pos[:n]
    dg = gt_pos[delta : delta + n] - gt_pos[:n]
    err = np.linalg.norm(de - dg, axis=1)
    return float(np.sqrt((err**2).mean()))


def rot_ate_rmse(est_quat, gt_quat, est_pos=None, gt_pos=None, align=True):
    """Rotation ATE RMSE (rad): angle of gt_i^-1 * (R_align est_i).

    With positions and align=True, R_align is the Umeyama rotation of the
    position clouds (the same alignment ate_rmse applies), so rotation and
    translation ATE are reported in one common frame."""
    est_quat = np.asarray(est_quat, float)
    gt_quat = np.asarray(gt_quat, float)
    if align and est_pos is not None and gt_pos is not None:
        R, _ = umeyama_se3(np.asarray(est_pos), np.asarray(gt_pos))
        q_align = _mat_to_quat(R)
        est_quat = _quat_mul(q_align[None], est_quat)
    err = quat_angle(_quat_mul(_quat_conj(gt_quat), est_quat))
    return float(np.sqrt((err**2).mean()))
