"""COLMAP model readers — `scene/colmap_loader.py` equivalent (an own copy
of `sags_tpu.io.colmap`).

Parses COLMAP's public binary/text formats (cameras, images, points3D) into
plain numpy structures, plus the qvec↔rotmat helpers. Formats per the COLMAP
documentation; the reference reads the same four files
(`colmap_loader.py:43-294`).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np
import torch

from sags_tpu_torch.core.transforms import rotmat_to_quat

# COLMAP camera model ids → (name, #params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # wxyz (COLMAP order)
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP wxyz quaternion → rotation matrix (`colmap_loader.py:30-40`)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → COLMAP wxyz quaternion (float32 arithmetic, on the
    host)."""
    q = rotmat_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()  # xyzw
    return np.array([q[3], q[0], q[1], q[2]])


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            out[cid] = ColmapCamera(cid, name, w, h, params)
    return out


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cid = int(parts[0])
            out[cid] = ColmapCamera(
                cid, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, 8, "Q")
            f.read(24 * n_pts)  # xys + point3D ids, unused here
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    """Two-line-per-image parser, robust to both blank-line shapes: a
    featureless image's EMPTY points2D line still occupies its slot (the line
    immediately after a meta line is always the points line, blank or not),
    while blank lines BETWEEN records (hand-edited separator style) are
    skipped when a meta line is expected."""
    out = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#")]
    expect_points = False
    for line in lines:
        if expect_points:
            expect_points = False  # points2D line — blank is valid
            continue
        if not line.strip():
            continue  # separator blank while expecting meta
        parts = line.split()
        iid = int(parts[0])
        out[iid] = ColmapImage(
            iid,
            np.array([float(p) for p in parts[1:5]]),
            np.array([float(p) for p in parts[5:8]]),
            int(parts[8]),
            parts[9],
        )
        expect_points = True
    return out


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty(n)
        for i in range(n):
            data = _read(f, 43, "QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            p = line.split()
            xyz.append([float(x) for x in p[1:4]])
            rgb.append([float(x) for x in p[4:7]])
            err.append(float(p[7]))
    return np.array(xyz), np.array(rgb), np.array(err)


def load_colmap_model(sparse_dir: str):
    """Auto-detect binary/text model files → (cameras, images, xyz, rgb)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        xyz, rgb, _ = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        xyz, rgb, _ = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, xyz, rgb
