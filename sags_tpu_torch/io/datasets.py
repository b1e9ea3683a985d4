"""Frames and the synthetic sequence (own copies of `sags_tpu.io.datasets`'s
`Frame` and `SyntheticDataset`). Ground-truth images are rendered with this
package's own rasterizer (classic path), on the dataset's device."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.core.config import RasterizeConfig
from sags_tpu_torch.core.transforms import LIDAR_TO_CAM, so3_exp


@dataclasses.dataclass
class Frame:
    """One synchronized (image, cloud, odom) triple."""

    image: np.ndarray  # [3,H,W] float32 in [0,1]
    points: np.ndarray  # [N,3] float32, world frame
    colors: np.ndarray  # [N,3] float32 in [0,1]
    pose: Optional[np.ndarray]  # camera-to-world; None = pose-less frame
    timestamp: float
    depth: Optional[np.ndarray] = None  # [H,W] meters
    imu: Optional[np.ndarray] = None  # [M,7] gyro, accel, dt
    scan: Optional[np.ndarray] = None  # [N,3] sensor-frame scan


GT_RASTER = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=512, chunk=64)


class SyntheticDataset:
    """Procedural LIVO-style corridor sequence with exact ground truth
    (`sags_tpu.io.datasets.SyntheticDataset`: same world, trajectory, point
    sampling and numpy RNG stream)."""

    def __init__(self, n_frames=20, width=160, height=120, n_world=4096,
                 pts_per_frame=2048, seed=0, fovx=1.2, fovy=1.0,
                 max_range=8.0, step=0.4, clutter=0.0, frame_dt=0.1,
                 pose_free=False, texture=0.0,
                 lidar_frame=False, device=None):
        self.device = resolve_device(device)
        self.pose_free = pose_free
        self.lidar_frame = lidar_frame
        self.n_frames = n_frames
        self.width, self.height = width, height
        self.fovx, self.fovy = fovx, fovy
        self.pts_per_frame = pts_per_frame
        self.max_range = max_range
        self.step = step
        self.frame_dt = frame_dt
        rng = np.random.default_rng(seed)
        length = max(20.0, n_frames * step + max_range)
        n = int(round(n_world * length / 20.0))
        wall = rng.integers(0, 3, n)
        t = rng.uniform(0, length, n)
        h = rng.uniform(-2, 2, n)
        x = np.where(wall == 0, -2.5, np.where(wall == 1, 2.5, h))
        y = np.where(wall == 2, -2.0, h * 0.8)
        self.world_xyz = np.stack([x, y, t], -1).astype(np.float32)
        self.world_xyz += rng.normal(0, 0.03, self.world_xyz.shape).astype(np.float32)
        self.world_instance = (wall + 1).astype(np.int32)
        if clutter > 0:
            n_cl = int(n * clutter)
            n_blobs = min(max(n_cl // 30, 1), 12)
            centers = np.stack([
                rng.uniform(-2, 2, n_blobs), rng.uniform(-1.6, 1.6, n_blobs),
                rng.uniform(0.5, length - 0.5, n_blobs)], -1)
            blob_id = rng.integers(0, n_blobs, n_cl)
            blob_pts = centers[blob_id] + rng.normal(0, 0.15, (n_cl, 3))
            self.world_xyz[:n_cl] = blob_pts.astype(np.float32)
            self.world_instance[:n_cl] = 4 + (blob_id % 12)
        base = rng.uniform(0.1, 1.0, (16, 3))
        self.world_rgb = np.clip(base[self.world_instance % 16]
                                 + rng.normal(0, 0.05, (n, 3)), 0.02, 1.0).astype(np.float32)
        if texture > 0.0:
            kfreq = rng.uniform(2.0, 7.0, (16, 3))
            phase = rng.uniform(0, 2 * np.pi, (16,))
            inst = self.world_instance % 16
            mod = 0.5 + 0.5 * np.sin((self.world_xyz * kfreq[inst]).sum(-1) + phase[inst])
            gain = (1.0 - texture) + 2.0 * texture * mod
            self.world_rgb = np.clip(self.world_rgb * gain[:, None].astype(np.float32),
                                     0.02, 1.0)
        self.world_scale = np.full((n, 3), 0.12, np.float32)
        self._rng = rng
        self._world_dev = None

    def _cam_pose(self, i) -> np.ndarray:
        """Smooth forward motion with gentle yaw sway (camera pose)."""
        yaw = 0.05 * np.sin(0.3 * i)
        R = so3_exp(torch.tensor([0.0, yaw, 0.0], dtype=torch.float32)).numpy()
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = R
        pose[:3, 3] = (0.3 * np.sin(0.2 * i), 0.0, self.step * i)
        return pose

    def pose(self, i) -> np.ndarray:
        pose = self._cam_pose(i)
        if self.lidar_frame:
            pose = pose.copy()
            pose[:3, :3] = pose[:3, :3] @ LIDAR_TO_CAM.T
        return pose

    def camera(self, i: int):
        pose = self._cam_pose(i)
        return make_camera(pose[:3, :3], pose[:3, 3], self.width, self.height,
                           self.fovx, self.fovy, device=self.device)

    def _world(self):
        if self._world_dev is None:
            n = len(self.world_xyz)
            quats = np.tile(np.array([[0, 0, 0, 1]], np.float32), (n, 1))
            to = lambda a: torch.as_tensor(a, device=self.device)
            self._world_dev = (to(self.world_xyz), torch.full((n,), 0.8, device=self.device),
                               to(self.world_scale), to(quats), to(self.world_rgb))
        return self._world_dev

    def render_gt(self, i: int):
        from sags_tpu_torch.ops.rasterize import rasterize

        xyz, opac, scales, quats, rgb = self._world()
        with torch.no_grad():
            out = rasterize(xyz, opac, scales, quats, self.camera(i), GT_RASTER,
                            colors=rgb, windowed=False)
        return out.color.cpu().numpy(), out.depth[0].cpu().numpy()

    def __len__(self):
        return self.n_frames

    def __iter__(self) -> Iterator[Frame]:
        for i in range(self.n_frames):
            pose = self.pose(i)
            cam_pose = self._cam_pose(i)
            img, depth = self.render_gt(i)
            rel = (self.world_xyz - cam_pose[:3, 3]) @ cam_pose[:3, :3]
            vis = (rel[:, 2] > 0.5) & (np.linalg.norm(rel, axis=-1) < self.max_range)
            idx = np.nonzero(vis)[0]
            sel = self._rng.choice(idx, min(self.pts_per_frame, len(idx)), replace=False)
            if self.lidar_frame:
                rel = rel @ LIDAR_TO_CAM.T
            yield Frame(
                image=img,
                points=(np.zeros((0, 3), np.float32) if self.pose_free
                        else self.world_xyz[sel]),
                colors=self.world_rgb[sel],
                pose=None if self.pose_free else pose,
                timestamp=i * self.frame_dt,
                depth=depth,
                scan=rel[sel].astype(np.float32),
            )
