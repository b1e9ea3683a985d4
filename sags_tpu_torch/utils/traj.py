"""Trajectory evaluation: Umeyama alignment and ATE RMSE (own copy of
`sags_tpu.utils.traj`, numpy only)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment est→gt over [N,3] positions."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    C = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = (float(np.trace(np.diag(D) @ S) / max((xe ** 2).sum() / len(est), 1e-12))
         if with_scale else 1.0)
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align: bool = True) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error RMSE (m) after optional rigid alignment."""
    p_e = est_poses[:, :3, 3]
    p_g = gt_poses[:, :3, 3]
    if align and len(p_e) >= 3:
        s, R, t = align_umeyama(p_e, p_g)
        p_a = (s * (R @ p_e.T)).T + t
    else:
        p_a = p_e
    err = np.linalg.norm(p_a - p_g, axis=-1)
    return float(np.sqrt(np.mean(err ** 2))), err
