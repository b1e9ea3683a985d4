"""Trajectory evaluation and output (own copy of `sags_tpu.utils.traj`, numpy
only): Umeyama alignment, ATE RMSE and RPE, TUM and KITTI trajectory files,
and a top-down trajectory plot."""

from __future__ import annotations

from typing import Optional, Tuple

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


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray,
        delta: int = 1) -> Tuple[float, float]:
    """Relative pose error: (trans RMSE m, rot RMSE deg) over `delta` steps."""
    terr, rerr = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(cos)))
    return (float(np.sqrt(np.mean(np.square(terr)))),
            float(np.sqrt(np.mean(np.square(rerr)))))


def save_tum_trajectory(path: str, poses: np.ndarray,
                        timestamps: Optional[np.ndarray] = None) -> None:
    """Write [N,4,4] poses as TUM lines `t tx ty tz qx qy qz qw`."""
    poses = np.asarray(poses)
    if timestamps is None:
        timestamps = np.arange(len(poses), dtype=np.float64)
    with open(path, "w") as f:
        for t, T in zip(timestamps, poses):
            q = _rotmat_to_quat_xyzw(T[:3, :3])
            tx, ty, tz = T[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def save_kitti_trajectory(path: str, poses: np.ndarray) -> None:
    """Write [N,4,4] poses as KITTI rows (12 floats = top 3x4, row-major)."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9g}" for v in T[:3, :4].reshape(-1)) + "\n")


def _rotmat_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (x, y, z, w) — Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def plot_trajectory(path: str, est_poses: np.ndarray,
                    gt_poses: Optional[np.ndarray] = None,
                    align: bool = True, axes: Tuple[int, int] = (0, 1)) -> bool:
    """Top-down trajectory plot (PNG), est against gt after alignment.
    Returns False (and writes nothing) when matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    p_e = np.asarray(est_poses)[:, :3, 3]
    fig, ax = plt.subplots(figsize=(6, 6))
    if gt_poses is not None:
        p_g = np.asarray(gt_poses)[:, :3, 3]
        if align and len(p_e) >= 3:
            s, R, t = align_umeyama(p_e, p_g)
            p_e = (s * (R @ p_e.T)).T + t
        ax.plot(p_g[:, axes[0]], p_g[:, axes[1]], "k--", lw=1, label="gt")
    ax.plot(p_e[:, axes[0]], p_e[:, axes[1]], "tab:blue", lw=1.2, label="est")
    ax.scatter([p_e[0, axes[0]]], [p_e[0, axes[1]]], c="g", s=18, zorder=3)
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_xlabel(f"axis {axes[0]} (m)")
    ax.set_ylabel(f"axis {axes[1]} (m)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True
