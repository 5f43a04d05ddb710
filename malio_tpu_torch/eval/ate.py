"""Absolute trajectory error (the port's copy of the JAX package's
eval/ate.py: umeyama_se3 and ate_rmse)."""
from __future__ import annotations

import numpy as np


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
