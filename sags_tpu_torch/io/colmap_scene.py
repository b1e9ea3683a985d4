"""COLMAP → trainable offline scene assembly (an own copy of
`sags_tpu.io.colmap_scene`; the cameras are built on a given device).

The `readColmapSceneInfo` role (`scene/dataset_readers.py:28-424` in the
reference): turn a COLMAP sparse model + images folder into

  * a list of `(Camera, gt_image)` training/test views (every-`llffhold`-th
    view held out, reference default 8),
  * an initial point cloud (the points3D sparse cloud, RGB in [0,1]),
  * the NeRF++ normalization radius that seeds the scene extent /
    spatial-lr-scale (`getNerfppNorm`, `dataset_readers.py:117-137`),

ready to feed `slam.offline.train_offline_scene`. COLMAP camera conventions
(qvec is the world→cam rotation, tvec the world→cam translation — so
R_c2w = R(qvec)ᵀ and center = −R_c2w·tvec) follow `readColmapCameras`
(`dataset_readers.py:139-188`). Only undistorted PINHOLE/SIMPLE_PINHOLE
models are supported, as in the reference.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.camera import Camera, focal2fov, make_camera
from sags_tpu_torch.io.colmap import load_colmap_model, qvec2rotmat
from sags_tpu_torch.io.datasets import resolution_policy


class ColmapView(NamedTuple):
    camera: Camera
    image: Optional[np.ndarray]  # [3,H,W] float32 in [0,1]; None if missing
    name: str
    depth: Optional[np.ndarray] = None  # [H,W] float32 meters; None if missing


class ColmapScene(NamedTuple):
    train_views: List[ColmapView]
    test_views: List[ColmapView]
    points: np.ndarray  # [N,3]
    colors: np.ndarray  # [N,3] in [0,1]
    radius: float  # nerf++ normalization radius (scene extent)
    translate: np.ndarray  # [3]


def _load_image(path: str, width: int, height: int) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    if path.endswith(".npy"):  # raw-array fixtures/tests
        arr = np.load(path).astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
    else:
        try:
            from PIL import Image  # images other than .npy need pillow
        except ImportError:
            return None
        img = Image.open(path).convert("RGB").resize((width, height))
        arr = np.asarray(img, np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def read_depth_bin(path: str, normalized_const: float = 1.0) -> np.ndarray:
    """Depth maps in the reference's `.bin` format (`read_depth_normalized`,
    `scene/dataset_readers.py:28-45`): an ASCII header `W&H&C&` followed by
    raw float32 data in Fortran order [W,H,C]. Returns [H,W] float32 (the
    reference transposes to (H,W,C) and squeezes)."""
    with open(path, "rb") as fid:
        header = b""
        ampersands = 0
        while ampersands < 3:
            byte = fid.read(1)
            if not byte:
                raise ValueError(f"truncated depth .bin header in {path}")
            header += byte
            if byte == b"&":
                ampersands += 1
        width, height, channels = (int(x) for x in header.split(b"&")[:3])
        array = np.fromfile(fid, np.float32)
    array = array.reshape((width, height, channels), order="F")
    return np.ascontiguousarray(
        np.transpose(array, (1, 0, 2)).squeeze(-1) / normalized_const
    )


def write_depth_bin(path: str, depth: np.ndarray) -> None:
    """Inverse of `read_depth_bin` (fixture/export helper): [H,W] float32 →
    `W&H&1&` header + Fortran-order payload."""
    d = np.asarray(depth, np.float32)
    H, W = d.shape
    with open(path, "wb") as fid:
        fid.write(f"{W}&{H}&1&".encode())
        np.transpose(d[..., None], (1, 0, 2)).flatten(order="F").tofile(fid)


def _load_depth(depth_dir: str, image_name: str, width: int, height: int):
    """Reference lookup order: `<depth_images>/<stem>.bin` (&-header format,
    `readColmapCameras`, `dataset_readers.py:176-182`) then `<stem>.png`
    (SLAM layout, `readSLAMCameras`, `:221-227`). Missing → None, as in the
    reference's try/except."""
    stem = os.path.basename(image_name).split(".")[0]
    bin_path = os.path.join(depth_dir, stem + ".bin")
    if os.path.exists(bin_path):
        d = read_depth_bin(bin_path)
    else:
        png_path = os.path.join(depth_dir, stem + ".png")
        if not os.path.exists(png_path):
            return None
        try:
            import imageio.v2 as imageio
        except ImportError:
            return None
        d = np.asarray(imageio.imread(png_path), np.float32)
    if d.shape != (height, width):
        # nearest-neighbour resize to the policy resolution (reference
        # resizes depth with the image in `loadCam`, `camera_utils.py:43`)
        ys = (np.arange(height) * d.shape[0] / height).astype(np.int64)
        xs = (np.arange(width) * d.shape[1] / width).astype(np.int64)
        d = d[ys[:, None], xs[None, :]]
    return d.astype(np.float32)


def nerfpp_norm(centers: np.ndarray) -> Tuple[float, np.ndarray]:
    """`getNerfppNorm`: radius = 1.1 × max distance to the mean center."""
    avg = centers.mean(axis=0)
    diagonal = float(np.linalg.norm(centers - avg, axis=-1).max())
    return diagonal * 1.1, -avg


def load_colmap_scene(
    model_dir: str,
    images_dir: Optional[str] = None,
    resolution: int = -1,
    llffhold: int = 8,
    eval_split: bool = False,
    depth_dir: Optional[str] = None,
    device=None,
) -> ColmapScene:
    """Assemble the COLMAP model at `model_dir` (auto bin/text; accepts the
    standard layout `<root>/sparse/0` or a direct model dir). The cameras
    live on `device` (default: the card); images, depths and points stay
    numpy."""
    device = resolve_device(device)
    sparse = model_dir
    for cand in (os.path.join(model_dir, "sparse", "0"),
                 os.path.join(model_dir, "sparse")):
        if os.path.exists(os.path.join(cand, "cameras.bin")) or os.path.exists(
            os.path.join(cand, "cameras.txt")
        ):
            sparse = cand
            break
    if images_dir is None:
        images_dir = os.path.join(model_dir, "images")
    if depth_dir is None:
        depth_dir = os.path.join(model_dir, "depth_images")

    cams, imgs, xyz, rgb = load_colmap_model(sparse)

    views: List[ColmapView] = []
    centers = []
    for key in sorted(imgs.keys()):
        extr = imgs[key]
        intr = cams[extr.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"COLMAP camera model not handled: {intr.model} (only "
                "undistorted PINHOLE/SIMPLE_PINHOLE, as in the reference)"
            )
        W, H = resolution_policy(intr.width, intr.height, resolution)
        sx, sy = W / intr.width, H / intr.height
        R_c2w = qvec2rotmat(np.asarray(extr.qvec)).T
        center = -R_c2w @ np.asarray(extr.tvec)
        centers.append(center)
        cam = make_camera(
            R_c2w, center, W, H,
            focal2fov(fx * sx, W), focal2fov(fy * sy, H), device=device,
        )
        img = _load_image(
            os.path.join(images_dir, os.path.basename(extr.name)), W, H
        )
        depth = (
            _load_depth(depth_dir, extr.name, W, H)
            if os.path.isdir(depth_dir) else None
        )
        views.append(
            ColmapView(camera=cam, image=img, name=extr.name, depth=depth)
        )

    radius, translate = nerfpp_norm(np.stack(centers))
    if eval_split:
        train = [v for i, v in enumerate(views) if i % llffhold != 0]
        test = [v for i, v in enumerate(views) if i % llffhold == 0]
    else:
        train, test = views, []

    colors = np.asarray(rgb, np.float32)
    if colors.size and colors.max() > 1.5:
        colors = colors / 255.0
    return ColmapScene(
        train_views=train, test_views=test,
        points=np.asarray(xyz, np.float32), colors=colors,
        radius=radius, translate=translate,
    )
