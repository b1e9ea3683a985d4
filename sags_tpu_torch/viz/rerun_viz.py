"""rerun.io streaming — the reference's live visualization layer (own copy
of `sags_tpu.viz.rerun_viz`; tensors are copied to the host before logging).

Mirrors the streams of `scripts/gaussian_splatting.py:247-250,838-883,
988-1011`: camera image + pose + pinhole, rendered image, gt/pred/PCA masks,
per-frame point clouds, trajectory line strips. All calls are no-ops when
`rerun` is not installed (zero-egress CI images).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

try:
    import rerun as rr

    _HAVE_RERUN = True
except Exception:  # pragma: no cover
    rr = None
    _HAVE_RERUN = False


def available() -> bool:
    return _HAVE_RERUN


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def id2rgb(ids: np.ndarray) -> np.ndarray:
    """Deterministic label → color (the reference's `id2rgb` role)."""
    ids = _host(ids).astype(np.int64)
    r = (ids * 97 + 31) % 255
    g = (ids * 57 + 11) % 255
    b = (ids * 17 + 199) % 255
    out = np.stack([r, g, b], -1).astype(np.uint8)
    out[ids == 0] = 0
    return out


def feature_to_rgb(features: np.ndarray) -> np.ndarray:
    """PCA of [O,H,W] semantic features → uint8 RGB (the reference's
    `feature_to_rgb`, `scripts/gaussian_splatting.py:445-470`)."""
    features = _host(features)
    O, H, W = features.shape
    flat = features.reshape(O, -1).T  # [HW, O]
    flat = flat - flat.mean(0)
    # top-3 principal directions via SVD of the covariance
    cov = flat.T @ flat / len(flat)
    _, vecs = np.linalg.eigh(cov)
    proj = flat @ vecs[:, -3:]
    lo, hi = proj.min(0), proj.max(0)
    proj = (proj - lo) / np.maximum(hi - lo, 1e-9)
    return (proj.reshape(H, W, 3) * 255).astype(np.uint8)


class RerunLogger:
    def __init__(self, app_id: str = "sags_tpu", spawn: bool = False):
        self.enabled = _HAVE_RERUN
        if self.enabled:
            rr.init(app_id, spawn=spawn)

    def log_frame(
        self,
        step: int,
        image: Optional[np.ndarray] = None,  # [3,H,W] float
        rendered: Optional[np.ndarray] = None,
        gt_mask: Optional[np.ndarray] = None,  # [H,W] int
        pred_mask: Optional[np.ndarray] = None,
        features: Optional[np.ndarray] = None,  # [O,H,W]
        points: Optional[np.ndarray] = None,  # [N,3]
        colors: Optional[np.ndarray] = None,
        pose: Optional[np.ndarray] = None,  # [4,4]
        intrinsics=None,  # (fx, fy, cx, cy, W, H)
    ):
        if not self.enabled:
            return
        rr.set_time_sequence("frame", step)
        to_img = lambda x: (np.clip(_host(x).transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        if image is not None:
            rr.log("camera/image", rr.Image(to_img(image)))
        if rendered is not None:
            rr.log("render/image", rr.Image(to_img(rendered)))
        if gt_mask is not None:
            rr.log("masks/gt", rr.Image(id2rgb(gt_mask)))
        if pred_mask is not None:
            rr.log("masks/pred", rr.Image(id2rgb(pred_mask)))
        if features is not None:
            rr.log("masks/pca", rr.Image(feature_to_rgb(features)))
        if points is not None:
            cols = (np.clip(_host(colors), 0, 1) * 255).astype(np.uint8) if colors is not None else None
            rr.log("world/points", rr.Points3D(_host(points), colors=cols))
        if pose is not None:
            pose = _host(pose)
            rr.log(
                "world/camera",
                rr.Transform3D(translation=pose[:3, 3], mat3x3=pose[:3, :3]),
            )
            if intrinsics is not None:
                fx, fy, cx, cy, W, H = intrinsics
                rr.log(
                    "world/camera/pinhole",
                    rr.Pinhole(
                        image_from_camera=np.array(
                            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
                        ),
                        width=W,
                        height=H,
                    ),
                )

    def log_trajectory(self, poses: np.ndarray, name: str = "world/trajectory"):
        if not self.enabled:
            return
        rr.log(name, rr.LineStrips3D([_host(poses)[:, :3, 3]]))
