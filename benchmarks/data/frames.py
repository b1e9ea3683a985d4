"""The benchmark's own inputs: a corridor world, its route and each frame's
scan and image, all made from the seed.

The geometry is a frozen copy of the port's `SyntheticDataset` (world
walls, floor and clutter blobs; the camera's forward motion with a yaw
sway; a scan of the visible world points per frame). The images come from
a plain z-buffer splat of the world points, never from the port's
rasterizer, so a change to the rasterizer cannot change what the benchmark
feeds it. Nothing here imports the port: the reference reads these inputs
too.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

FRAME_DT = 0.1  # a 10 Hz LiDAR


@dataclasses.dataclass
class StreamSpec:
    """The stream's sizes (a cell's configuration file holds them)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    n_world_per_20m: int
    pts_per_frame: int
    step: float
    clutter: float
    max_range: float = 8.0
    world_scale: float = 0.12

    @classmethod
    def from_config(cls, stream: dict, camera: dict) -> "StreamSpec":
        """`camera` is the configuration's intrinsics block; the images are
        made at `stream`'s width and height with those intrinsics scaled."""
        sx = stream["width"] / camera["width"]
        sy = stream["height"] / camera["height"]
        return cls(width=stream["width"], height=stream["height"],
                   fx=camera["fx"] * sx, fy=camera["fy"] * sy,
                   cx=camera["cx"] * sx, cy=camera["cy"] * sy,
                   n_world_per_20m=stream["world_points_per_20m"],
                   pts_per_frame=stream["scan_points"], step=stream["step_m"],
                   clutter=stream["clutter"])


@dataclasses.dataclass
class Pool:
    """`n` frames of the route, on the host: images [n,3,H,W] float32 in
    [0,1], camera-to-world poses [n,4,4], and each frame's scan as indices
    into the world (`sel` [n,S]), whose points the frame hands over in the
    world frame and, as the tracker's input, in the sensor frame."""

    world_xyz: np.ndarray  # [N,3] float32
    world_rgb: np.ndarray  # [N,3] float32
    poses: np.ndarray  # [n,4,4] float32
    images: np.ndarray  # [n,3,H,W] float32
    sel: np.ndarray  # [n,S] int64

    def __len__(self) -> int:
        return len(self.poses)

    def points(self, i: int) -> np.ndarray:
        return self.world_xyz[self.sel[i]]

    def colors(self, i: int) -> np.ndarray:
        return self.world_rgb[self.sel[i]]

    def scan(self, i: int) -> np.ndarray:
        """Frame i's points in its sensor (camera) frame."""
        T = self.poses[i]
        return ((self.points(i) - T[:3, 3]) @ T[:3, :3]).astype(np.float32)


def cam_pose(i: float, step: float) -> np.ndarray:
    """Camera-to-world pose of frame i: forward along +z with a gentle yaw
    sway and a sideways weave (`SyntheticDataset._cam_pose`)."""
    yaw = 0.05 * math.sin(0.3 * i)
    c, s = math.cos(yaw), math.sin(yaw)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)
    pose[:3, 3] = (0.3 * math.sin(0.2 * i), 0.0, step * i)
    return pose


def make_world(spec: StreamSpec, n_frames: int, rng: np.random.Generator):
    """World points, colours (`SyntheticDataset.__init__`'s geometry)."""
    length = max(20.0, n_frames * spec.step + spec.max_range)
    n = int(round(spec.n_world_per_20m * length / 20.0))
    wall = rng.integers(0, 3, n)
    t = rng.uniform(0, length, n)
    h = rng.uniform(-2, 2, n)
    x = np.where(wall == 0, -2.5, np.where(wall == 1, 2.5, h))
    y = np.where(wall == 2, -2.0, h * 0.8)
    xyz = np.stack([x, y, t], -1).astype(np.float32)
    xyz += rng.normal(0, 0.03, xyz.shape).astype(np.float32)
    inst = (wall + 1).astype(np.int32)
    if spec.clutter > 0:
        n_cl = int(n * spec.clutter)
        n_blobs = min(max(n_cl // 30, 1), 12)
        centers = np.stack([
            rng.uniform(-2, 2, n_blobs), rng.uniform(-1.6, 1.6, n_blobs),
            rng.uniform(0.5, length - 0.5, n_blobs)], -1)
        blob_id = rng.integers(0, n_blobs, n_cl)
        xyz[:n_cl] = (centers[blob_id] + rng.normal(0, 0.15, (n_cl, 3))).astype(np.float32)
        inst[:n_cl] = 4 + (blob_id % 12)
    base = rng.uniform(0.1, 1.0, (16, 3))
    rgb = np.clip(base[inst % 16] + rng.normal(0, 0.05, (n, 3)), 0.02, 1.0).astype(np.float32)
    return xyz, rgb


def sample_scans(spec: StreamSpec, xyz: np.ndarray, poses: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    """Each frame's scan: `pts_per_frame` of the world points in front of
    the sensor within `max_range`, drawn without replacement."""
    out = np.zeros((len(poses), spec.pts_per_frame), np.int64)
    for i, T in enumerate(poses):
        rel = (xyz - T[:3, 3]) @ T[:3, :3]
        vis = (rel[:, 2] > 0.5) & (np.linalg.norm(rel, axis=-1) < spec.max_range)
        idx = np.nonzero(vis)[0]
        if len(idx) < spec.pts_per_frame:
            raise ValueError(f"frame {i} sees {len(idx)} points, fewer than a scan")
        out[i] = rng.choice(idx, spec.pts_per_frame, replace=False)
    return out


def splat_images(spec: StreamSpec, xyz: np.ndarray, rgb: np.ndarray,
                 poses: np.ndarray, device, batch: int = 4,
                 radius: int = 4) -> np.ndarray:
    """Plain z-buffer splat of the world points at each pose: each point
    covers a disc of radius fx·(world_scale/2)/z pixels (1 to `radius`);
    the nearest point wins a pixel; empty pixels are black. [n,3,H,W]."""
    H, W = spec.height, spec.width
    pts = torch.as_tensor(xyz, device=device)
    cols = torch.as_tensor(rgb, device=device)
    N = pts.shape[0]
    off = torch.arange(-radius, radius + 1, device=device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)
    od = torch.sqrt((ox * ox + oy * oy).to(torch.float32))
    out = np.zeros((len(poses), 3, H, W), np.float32)
    pid = torch.arange(N, device=device, dtype=torch.int64)
    empty = torch.iinfo(torch.int64).max
    for b0 in range(0, len(poses), batch):
        T = torch.as_tensor(poses[b0:b0 + batch], device=device)  # [B,4,4]
        rel = torch.einsum("bkj,bnk->bnj", T[:, :3, :3], pts[None] - T[:, None, :3, 3])
        z = rel[..., 2]
        ok = z > 0.2
        zs = torch.where(ok, z, torch.ones_like(z))
        u = torch.round(spec.fx * rel[..., 0] / zs + spec.cx).to(torch.int64)
        v = torch.round(spec.fy * rel[..., 1] / zs + spec.cy).to(torch.int64)
        r = torch.clamp(spec.fx * (0.5 * spec.world_scale) / zs, 1.0, float(radius))
        pu = u[..., None] + ox
        pv = v[..., None] + oy
        hit = (ok[..., None] & (od <= r[..., None]) & (pu >= 0) & (pu < W)
               & (pv >= 0) & (pv < H))
        zq = torch.clamp(z * 1000.0, 0, 2 ** 30).to(torch.int64)  # millimetres
        key = (zq << 32 | pid)[..., None].expand_as(hit)
        Bn = T.shape[0]
        flat = (torch.arange(Bn, device=device)[:, None, None] * (H * W)
                + pv.clamp(0, H - 1) * W + pu.clamp(0, W - 1))
        zbuf = torch.full((Bn * H * W,), empty, dtype=torch.int64, device=device)
        zbuf.scatter_reduce_(0, flat[hit], key[hit], "amin")
        filled = zbuf != empty
        idx = torch.where(filled, zbuf & 0xFFFFFFFF, torch.zeros_like(zbuf))
        img = torch.where(filled[:, None], cols[idx], torch.zeros((), device=device))
        out[b0:b0 + Bn] = img.reshape(Bn, H, W, 3).permute(0, 3, 1, 2).cpu().numpy()
    return out


def make_pool(spec: StreamSpec, n_frames: int, seed: int, device) -> Pool:
    """The route's first `n_frames` frames, made from `seed`: the world and
    the scans on the host (numpy), the images on `device`."""
    rng = np.random.default_rng(seed)
    xyz, rgb = make_world(spec, n_frames, rng)
    poses = np.stack([cam_pose(i, spec.step) for i in range(n_frames)])
    sel = sample_scans(spec, xyz, poses, rng)
    images = splat_images(spec, xyz, rgb, poses, device)
    return Pool(world_xyz=xyz, world_rgb=rgb, poses=poses, images=images, sel=sel)


def patrol(k: int, n: int) -> int:
    """The pool index of the stream's k-th frame: along the route and back
    (0, 1, ..., n-1, n-2, ..., 0, 1, ...), as a patrol drives it."""
    period = 2 * (n - 1)
    p = k % period
    return p if p < n else period - p
