"""Frames, the dataset readers and the synthetic sequence (own copies of
`sags_tpu.io.datasets`): TUM RGB-D, Replica, NeRF-synthetic (Blender) and
KITTI odometry, with their timestamp association and depth back-projection.
The readers stay on the host (numpy); images go through `io.images.imread`.
`SyntheticDataset` renders its ground truth with this package's own
rasterizer (classic path), on the dataset's device."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.core.config import RasterizeConfig
from sags_tpu_torch.core.transforms import LIDAR_TO_CAM, quat_to_rotmat, so3_exp, so3_log
from sags_tpu_torch.io.images import imread


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


def associate_timestamps(
    a: Sequence[float], b: Sequence[float], max_dt: float = 0.08
) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (`traj_utils.py` TUM logic)."""
    pairs = []
    j = 0
    b = list(b)
    for i, ta in enumerate(a):
        # advance j to the closest b
        while j + 1 < len(b) and abs(b[j + 1] - ta) <= abs(b[j] - ta):
            j += 1
        if b and abs(b[j] - ta) < max_dt:
            pairs.append((i, j))
    return pairs


def backproject_depth(
    depth: np.ndarray, rgb: np.ndarray, fx, fy, cx, cy, pose: np.ndarray,
    stride: int = 4, max_depth: float = 10.0,
):
    """depth [H,W] (meters) + rgb [3,H,W] → world points/colors via pose."""
    H, W = depth.shape
    v, u = np.mgrid[0:H:stride, 0:W:stride]
    z = depth[v, u]
    ok = (z > 0.05) & (z < max_depth)
    u, v, z = u[ok], v[ok], z[ok]
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts_cam = np.stack([x, y, z], -1)
    pts = pts_cam @ pose[:3, :3].T + pose[:3, 3]
    cols = rgb[:, v, u].T
    return pts.astype(np.float32), cols.astype(np.float32)


class TUMDataset:
    """TUM RGB-D: rgb.txt / depth.txt / groundtruth.txt association, depth
    PNGs at 5000 a metre."""

    depth_scale = 5000.0

    def __init__(self, root: str, intrinsics=(535.4, 539.2, 320.1, 247.6),
                 stride: int = 4, max_dt: float = 0.08):
        self.root = root
        self.fx, self.fy, self.cx, self.cy = intrinsics
        self.stride = stride

        def read_list(name):
            out = []
            with open(os.path.join(root, name)) as f:
                for line in f:
                    if line.startswith("#") or not line.strip():
                        continue
                    parts = line.split()
                    out.append((float(parts[0]), parts[1:]))
            return out

        rgb = read_list("rgb.txt")
        depth = read_list("depth.txt")
        gt = read_list("groundtruth.txt")
        rd = associate_timestamps([t for t, _ in rgb], [t for t, _ in depth], max_dt)
        self.items = []
        for i, j in rd:
            t = rgb[i][0]
            pairs = associate_timestamps([t], [g[0] for g in gt], max_dt)
            if not pairs:
                continue
            k = pairs[0][1]
            tx, ty, tz, qx, qy, qz, qw = (float(x) for x in gt[k][1][:7])
            R = quat_to_rotmat(torch.tensor([qx, qy, qz, qw], dtype=torch.float32)).numpy()
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = R
            pose[:3, 3] = (tx, ty, tz)
            self.items.append((t, rgb[i][1][0], depth[j][1][0], pose))

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[Frame]:
        for t, rgb_path, depth_path, pose in self.items:
            img = imread(os.path.join(self.root, rgb_path))
            img = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
            d = imread(os.path.join(self.root, depth_path))
            d = np.asarray(d, np.float32) / self.depth_scale
            pts, cols = backproject_depth(
                d, img, self.fx, self.fy, self.cx, self.cy, pose, self.stride
            )
            yield Frame(img, pts, cols, pose, t, depth=d)


class ReplicaDataset:
    """Replica (GS-ICP-SLAM layout): results/frame%06d.jpg (or any image
    named frame*), depth%06d.png at 6553.5 a metre, traj.txt with 16 floats
    per line."""

    depth_scale = 6553.5

    def __init__(self, root: str, intrinsics=(600.0, 600.0, 599.5, 339.5),
                 stride: int = 4):
        self.root = root
        self.fx, self.fy, self.cx, self.cy = intrinsics
        self.stride = stride
        self.poses = np.loadtxt(os.path.join(root, "traj.txt")).reshape(-1, 4, 4)
        rdir = os.path.join(root, "results")
        self.frames = sorted(
            f for f in os.listdir(rdir) if f.startswith("frame")
        )

    def __len__(self):
        return len(self.frames)

    def __iter__(self) -> Iterator[Frame]:
        for i, name in enumerate(self.frames):
            img = imread(os.path.join(self.root, "results", name))
            img = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
            dname = name.replace("frame", "depth").rsplit(".", 1)[0] + ".png"
            d = imread(os.path.join(self.root, "results", dname))
            d = np.asarray(d, np.float32) / self.depth_scale
            pose = self.poses[i].astype(np.float32)
            pts, cols = backproject_depth(
                d, img, self.fx, self.fy, self.cx, self.cy, pose, self.stride
            )
            yield Frame(img, pts, cols, pose, float(i) / 30.0, depth=d)


class BlenderDataset:
    """NeRF-synthetic (`transforms_*.json`) reader — `readNerfSyntheticInfo`
    (`scene/dataset_readers.py`). RGBA images are composited over a white or
    black background, as in the reference."""

    def __init__(self, root: str, split: str = "train", white_background: bool = False):
        self.root = root
        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        self.camera_angle_x = float(meta["camera_angle_x"])
        self.frames_meta = meta["frames"]
        self.white_background = white_background

    def __len__(self):
        return len(self.frames_meta)

    def __iter__(self) -> Iterator[Frame]:
        for i, fr in enumerate(self.frames_meta):
            path = os.path.join(self.root, fr["file_path"])
            if not os.path.splitext(path)[1]:
                path += ".png"
            img = np.asarray(imread(path), np.float32) / 255.0
            if img.shape[-1] == 4:  # alpha composite (`dataset_readers.py` NeRF path)
                bg = 1.0 if self.white_background else 0.0
                img = img[..., :3] * img[..., 3:4] + bg * (1 - img[..., 3:4])
            # Blender c2w uses OpenGL axes (y up, z back): flip to our +z-forward
            c2w = np.asarray(fr["transform_matrix"], np.float32)
            c2w[:3, 1:3] *= -1
            yield Frame(
                image=img.transpose(2, 0, 1).astype(np.float32),
                points=np.zeros((0, 3), np.float32),
                colors=np.zeros((0, 3), np.float32),
                pose=c2w,
                timestamp=float(i),
            )


def scannetpp_to_traj(transforms_json: str, out_traj: str):
    """ScanNet++ transforms → traj.txt rows of flattened 4x4 poses
    (`utils/scannetpp_pose.py` one-off converter)."""
    with open(transforms_json) as f:
        meta = json.load(f)
    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    with open(out_traj, "w") as f:
        for fr in frames:
            c2w = np.asarray(fr["transform_matrix"], np.float64)
            c2w[:3, 1:3] *= -1
            f.write(" ".join(f"{v:.9f}" for v in c2w.reshape(-1)) + "\n")


GT_RASTER = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=512, chunk=64)


class SyntheticDataset:
    """Procedural LIVO-style corridor sequence with exact ground truth
    (`sags_tpu.io.datasets.SyntheticDataset`: same world, trajectory, point
    sampling and numpy RNG stream). `imu_substeps` > 0 gives every frame but
    the first `imu_substeps` IMU samples over the interval since the last
    (`imu_between`), which draw nothing from that stream."""

    def __init__(self, n_frames=20, width=160, height=120, n_world=4096,
                 pts_per_frame=2048, seed=0, fovx=1.2, fovy=1.0,
                 max_range=8.0, step=0.4, clutter=0.0, imu_substeps=0,
                 frame_dt=0.1, pose_free=False, texture=0.0,
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
        self.imu_substeps = imu_substeps
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

    def gt_objects(self, i: int) -> np.ndarray:
        """Ground-truth instance mask [H,W] int32 (0 = background): the world
        rendered with one-hot instance features (`sags_tpu/io/datasets.py:
        435-453`), the argmax of the object channels where alpha > 0.5."""
        from sags_tpu_torch.ops.rasterize import rasterize

        xyz, opac, scales, quats, rgb = self._world()
        n = len(self.world_xyz)
        onehot = np.zeros((n, 16), np.float32)
        onehot[np.arange(n), self.world_instance % 16] = 1.0
        with torch.no_grad():
            out = rasterize(xyz, opac, scales, quats, self.camera(i), GT_RASTER,
                            colors=rgb, obj_features=torch.as_tensor(onehot, device=self.device),
                            windowed=False)
        obj = out.objects.cpu().numpy()  # [16,H,W] alpha-weighted densities
        alpha = out.alpha[0].cpu().numpy()
        labels = np.argmax(obj, axis=0).astype(np.int32)
        return np.where(alpha > 0.5, labels, 0)

    def imu_between(self, i: int) -> np.ndarray:
        """IMU samples [M, 7] (gyro, accel, dt) over (i-1, i] from the analytic
        trajectory: a constant body rate per substep, and the specific force
        f = Rᵀ(a_w − g) with a_w by central differences about the substep's
        midpoint (`sags_tpu/io/datasets.py:455-481`). Host numpy, with the
        rotation log of this package on the CPU."""
        M = self.imu_substeps
        dt = self.frame_dt / M
        g_w = np.array([0.0, 0.0, -9.81])
        out = np.zeros((M, 7), np.float32)
        for s in range(M):
            f0 = (i - 1) + s / M
            f1 = (i - 1) + (s + 1) / M
            T0, T1 = self.pose(f0), self.pose(f1)
            w = so3_log(torch.from_numpy(T0[:3, :3].T @ T1[:3, :3])).numpy() / dt
            fm = 0.5 * (f0 + f1)
            h = 0.5 / M
            p_m = self.pose(fm)[:3, 3]
            p_l = self.pose(fm - h)[:3, 3]
            p_r = self.pose(fm + h)[:3, 3]
            a_w = (p_r - 2 * p_m + p_l) / (h * self.frame_dt) ** 2
            f_body = T0[:3, :3].T @ (a_w - g_w)
            out[s, 0:3] = w
            out[s, 3:6] = f_body
            out[s, 6] = dt
        return out

    def __len__(self):
        return self.n_frames

    def __iter__(self) -> Iterator[Frame]:
        for i in range(self.n_frames):
            pose = self.pose(i)
            cam_pose = self._cam_pose(i)
            img, depth = self.render_gt(i)
            imu = self.imu_between(i) if (self.imu_substeps and i > 0) else None
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
                imu=imu,
                scan=rel[sel].astype(np.float32),
            )


class KITTIOdometryDataset:
    """KITTI odometry velodyne sequence — the `KittiLoader` of the reference
    benchmark harness (`submodules/fast_gicp/src/kitti.cpp:22-68`).

    Scans are `%06d.bin` float32 (x, y, z, intensity) files counted up from
    000000.bin, exactly like the reference loader. Points stay in the SENSOR
    frame (odometry estimates the trajectory; there is no world registration
    to undo). Optional sidecars:

    - ``times_file`` (`times.txt`): per-scan timestamps (else scan index).
    - ``poses_file`` (odometry GT, 12 floats/line = the top 3×4 of T_w_cam0):
      ground-truth poses for ATE. GT lives in the cam0 frame; when
      ``calib_file`` (with a `Tr:` velo→cam0 line) is given, poses are mapped
      into the velodyne frame as ``Tr⁻¹ · T_w_cam0 · Tr``.
    """

    def __init__(self, velodyne_dir: str, poses_file: str = "",
                 times_file: str = "", calib_file: str = "",
                 max_points: int = 0):
        self.dir = velodyne_dir
        self.max_points = max_points
        self.files: List[str] = []
        i = 0
        while True:  # reference contract: count %06d.bin from 0 until a gap
            f = os.path.join(velodyne_dir, f"{i:06d}.bin")
            if not os.path.exists(f):
                break
            self.files.append(f)
            i += 1
        if not self.files:
            raise FileNotFoundError(f"no %06d.bin scans in {velodyne_dir}")

        self.times = None
        if times_file:
            self.times = np.loadtxt(times_file, dtype=np.float64).reshape(-1)

        self.has_gt = False
        self.poses = None
        if poses_file:
            rows = np.loadtxt(poses_file, dtype=np.float64).reshape(-1, 12)
            T = np.tile(np.eye(4), (len(rows), 1, 1))
            T[:, :3, :4] = rows.reshape(-1, 3, 4)
            if calib_file:
                Tr = self._read_calib_tr(calib_file)
                T = np.linalg.inv(Tr)[None] @ T @ Tr[None]
            self.poses = T.astype(np.float32)
            self.has_gt = True

    @staticmethod
    def _read_calib_tr(calib_file: str) -> np.ndarray:
        Tr = np.eye(4)
        with open(calib_file) as f:
            for line in f:
                if line.startswith("Tr:") or line.startswith("Tr "):
                    body = line.split(":", 1)[1] if ":" in line else line[3:]
                    vals = np.array(body.split(), np.float64)
                    Tr[:3, :4] = vals.reshape(3, 4)
                    break
        return Tr

    def scan(self, i: int) -> np.ndarray:
        """[N,3] float32 sensor-frame points of scan i (intensity dropped,
        `kitti.cpp:40-65`)."""
        raw = np.fromfile(self.files[i], dtype=np.float32)
        pts = raw.reshape(-1, 4)[:, :3]
        pts = pts[np.isfinite(pts).all(axis=1)]
        if self.max_points and len(pts) > self.max_points:
            step = len(pts) / self.max_points
            pts = pts[(np.arange(self.max_points) * step).astype(np.int64)]
        return np.ascontiguousarray(pts)

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[Frame]:
        for i in range(len(self.files)):
            pts = self.scan(i)
            ts = float(self.times[i]) if self.times is not None else float(i)
            if self.poses is not None:
                # GT available: world points for map growth + raw scan for
                # tracking (the tracker must never consume GT)
                T = self.poses[i].astype(np.float32)
                world = pts @ T[:3, :3].T + T[:3, 3]
                yield Frame(
                    image=np.zeros((3, 1, 1), np.float32),  # LiDAR-only
                    points=world,
                    colors=np.zeros_like(pts),
                    pose=T,
                    timestamp=ts,
                    scan=pts,
                )
            else:
                # pose-LESS odometry stream (the reference harness's mode,
                # `python_tester/gicp_odometry2.py:126-166`)
                yield Frame(
                    image=np.zeros((3, 1, 1), np.float32),
                    points=np.zeros((0, 3), np.float32),
                    colors=np.zeros_like(pts),
                    pose=None,
                    timestamp=ts,
                    scan=pts,
                )


def resolution_policy(width: int, height: int, resolution: int = -1,
                      cap: int = 1600):
    """Training resolution (`utils/camera_utils.py:19-60`): -1 caps the long
    side at `cap` px, 0 and 1 keep it, other positive values divide."""
    if resolution in (1, 0):
        return width, height
    if resolution == -1:
        if width > cap:
            scale = width / cap
            return int(width / scale), int(height / scale)
        return width, height
    return int(width / resolution), int(height / resolution)
