"""ctypes bindings for the native host runtime (`native/sags_native.cpp`),
the port's own loader (`sags_tpu.io.native` in torch).

The CPU-side ingestion primitives the reference implements natively (PCL
VoxelGrid, kd-tree kNN, PointCloud2 decode). On first use the library is
compiled with the flags of `native/Makefile` (by `$CXX`, else `g++`) into
this package's build
directory (`ops/_build.BUILD_DIR`, or `SAGS_TORCH_BUILD_DIR`), named by a
hash of the source and the flags, so an edited source is rebuilt; nothing is
written into `native/`. When no compiler or source is present, every
function takes its pure fallback: the port's `ops.registration.downsample`
and `ops.knn.knn` on `device` (default: the card), and numpy for the decode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from sags_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(_build._PKG), "native", "sags_native.cpp")
CXX_FLAGS = ["-O3", "-march=x86-64-v2", "-fPIC", "-std=c++17", "-fopenmp", "-shared"]

_state = {"lib": None, "tried": False}
build_error: Optional[str] = None  # why the library is missing, when it is
built_with: Optional[str] = None  # the compiler that built the loaded library (None: found built)


def lib_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"libsags_native-{digest.hexdigest()[:16]}.so")


def _compilers() -> list:
    """`$CXX` (as `native/Makefile` takes it), then `g++` on the PATH."""
    found = []
    for name in (os.environ.get("CXX"), "g++"):
        path = shutil.which(name) if name else None
        if path and path not in found:
            found.append(path)
    return found


def _compile() -> ctypes.CDLL:
    """The library built with the Makefile's flags by the first compiler
    that succeeds (or found built)."""
    global built_with
    path = lib_path()
    if os.path.exists(path):
        return _load(path)
    errors = []
    for cxx in _compilers():
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, path)
            built_with = cxx
            return _load(path)
        errors.append(f"{cxx} {' '.join(CXX_FLAGS)}:\n{proc.stdout}{proc.stderr}")
    raise RuntimeError("\n".join(errors) or "no C++ compiler ($CXX or g++)")


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.sags_voxel_downsample.restype = ctypes.c_int
    lib.sags_voxel_downsample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.sags_kdtree_build.restype = ctypes.c_void_p
    lib.sags_kdtree_build.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.sags_kdtree_free.argtypes = [ctypes.c_void_p]
    lib.sags_kdtree_knn.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
    ]
    lib.sags_decode_xyzrgb.restype = ctypes.c_int
    lib.sags_decode_xyzrgb.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    return lib


def _library() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on the first call; None when it cannot
    be (`build_error` says why)."""
    global build_error
    if not _state["tried"]:
        _state["tried"] = True
        try:
            _state["lib"] = _compile()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
    return _state["lib"]


def available() -> bool:
    return _library() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def voxel_downsample(points: np.ndarray, resolution: float,
                     max_out: Optional[int] = None, device=None) -> np.ndarray:
    """PCL-VoxelGrid-style centroid downsample on the host."""
    pts = np.ascontiguousarray(points, np.float32)
    cap = max_out or len(pts)
    lib = _library()
    if lib is None:
        from sags_tpu_torch.ops.registration import downsample

        return downsample(pts, resolution, device=device)[:cap]
    out = np.empty((cap, 3), np.float32)
    n = lib.sags_voxel_downsample(_fptr(pts), len(pts), resolution, _fptr(out), cap)
    return out[:n]


class KDTree:
    """Host kd-tree, the covariance-estimation search structure."""

    def __init__(self, points: np.ndarray, device=None):
        self._pts = np.ascontiguousarray(points, np.float32)
        self._device = device
        self._lib = _library()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.sags_kdtree_build(_fptr(self._pts), len(self._pts))

    def knn(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(squared distances [M,k] float32, indices [M,k] int32), ascending."""
        q = np.ascontiguousarray(queries, np.float32)
        if self._handle is None:
            import torch

            from sags_tpu_torch import resolve_device
            from sags_tpu_torch.ops.knn import knn

            dev = resolve_device(self._device)
            d2, idx = knn(torch.as_tensor(q, device=dev), torch.as_tensor(self._pts, device=dev),
                          k=k)
            return d2.cpu().numpy(), idx.cpu().numpy().astype(np.int32)
        idx = np.empty((len(q), k), np.int32)
        d2 = np.empty((len(q), k), np.float32)
        self._lib.sags_kdtree_knn(
            self._handle, _fptr(q), len(q), k,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _fptr(d2),
        )
        return d2, idx

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.sags_kdtree_free(self._handle)


def decode_xyzrgb(data: bytes, point_step: int, x_offset: int = 0,
                  rgb_offset: int = 16, max_points: Optional[int] = None):
    """PointCloud2 decode: x,y,z float32 + packed-rgb float records
    (`read_xyz_rgb_from_raw`, `scripts/gaussian_splatting.py:105-134`)."""
    n_max = max_points or (len(data) // point_step)
    lib = _library()
    if lib is None:
        arr = np.frombuffer(data, np.uint8)
        n = min(len(data) // point_step, n_max)
        rec = arr[: n * point_step].reshape(n, point_step)
        xyz = rec[:, x_offset : x_offset + 12].copy().view(np.float32).reshape(n, 3)
        packed = rec[:, rgb_offset : rgb_offset + 4].copy().view(np.uint32).reshape(n)
        rgb = np.stack(
            [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], -1
        ).astype(np.float32) / 255.0
        return xyz, rgb
    buf = np.frombuffer(data, np.uint8)
    xyz = np.empty((n_max, 3), np.float32)
    rgb = np.empty((n_max, 3), np.float32)
    n = lib.sags_decode_xyzrgb(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(data), point_step,
        x_offset, rgb_offset, _fptr(xyz), _fptr(rgb), n_max,
    )
    return xyz[:n], rgb[:n]
