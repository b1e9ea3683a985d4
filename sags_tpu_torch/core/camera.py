"""Camera model: world→view, OpenGL-style projection, fov/focal conversions.

The same math as `sags_tpu.core.camera` (`getWorld2View_traditional`,
`getProjectionMatrix`, the rasterizer's ndc→pixel map). Matrices are in math
convention (apply as `M @ [p; 1]`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pose (R: cam→world rotation, t: camera center) → V = [Rᵀ, −Rᵀt; 0, 1]."""
    Rt = R.T
    V = torch.eye(4, dtype=R.dtype, device=R.device)
    V[:3, :3] = Rt
    V[:3, 3] = -(Rt @ t)
    return V


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """`getProjectionMatrix` (z ∈ [0,1]), as a float32 numpy array."""
    top = math.tan(fovy / 2.0) * znear
    right = math.tan(fovx / 2.0) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """NDC [-1,1] → pixel center coordinate (`auxiliary.h:41-44`)."""
    return ((v + 1.0) * size - 1.0) * 0.5


@dataclasses.dataclass
class Camera:
    """A pinhole camera: pose matrices are device tensors, sizes and fovs
    plain Python numbers."""

    width: int
    height: int
    fovx: float
    fovy: float
    world_view: torch.Tensor  # [4,4] V (math convention)
    full_proj: torch.Tensor  # [4,4] P @ V
    cam_center: torch.Tensor  # [3]
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    @property
    def focal_x(self) -> float:
        return fov2focal(self.fovx, self.width)

    @property
    def focal_y(self) -> float:
        return fov2focal(self.fovy, self.height)


def make_camera(R, t, width: int, height: int, fovx: float, fovy: float,
                znear: float = 0.01, zfar: float = 100.0, device=None) -> Camera:
    """Camera from pose (R: cam→world rotation, t: camera center). Tensor
    inputs keep their device; numpy inputs go to `device` (default: the
    card)."""
    if device is None:
        device = R.device if isinstance(R, torch.Tensor) else torch.device("cuda")
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    V = world_to_view(R, t)
    P = torch.as_tensor(projection_matrix(znear, zfar, fovx, fovy), device=device)
    return Camera(width=int(width), height=int(height), fovx=float(fovx),
                  fovy=float(fovy), world_view=V, full_proj=P @ V,
                  cam_center=t, znear=float(znear), zfar=float(zfar))
