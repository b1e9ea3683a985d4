"""Build and load the hand-written CUDA kernels (`sags_tpu_torch/csrc/*.cu`).

Each source is compiled by its own `nvcc` process into a shared library with
a plain C interface (no PyTorch headers: seconds, not minutes), all of them
started together, and loaded with `ctypes`. Libraries are named by a hash of
their source and flags under `build/kernels/` at the repository root, so a
rebuilt checkout never loads a stale one. Nothing is built or loaded at
import time: the first launch (or `build_all()`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_registry: List["CudaKernel"] = []
build_log: Dict[str, str] = {}  # source -> nvcc output (-Xptxas -v report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(sources: Sequence[str]) -> None:
    """Compile every source not built yet, one `nvcc` each, in parallel."""
    with _lock:
        todo = [s for s in dict.fromkeys(sources) if s not in _libs]
        if not todo:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for src in todo:
            path = _lib_path(src)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs.append((src, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, path, tmp, proc in procs:
            out, _ = proc.communicate()
            build_log[src] = out
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src in todo:
            _libs[src] = ctypes.CDLL(_lib_path(src))


def build_all() -> None:
    """Build every registered kernel (the modules under `ops/` register
    theirs when imported)."""
    build([k.source for k in _registry])


class CudaKernel:
    """One exported C entry point of a `csrc/*.cu` library.

    `launches` counts successful launches: the wrapper that owns the kernel
    calls `launch` once per kernel launch and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        _registry.append(self)

    def _resolve(self):
        if self._fn is None:
            build([self.source])
            lib = _libs[self.source]
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, self.symbol + "_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        code = self._resolve()(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.symbol} failed: {self._err(code).decode()} ({code})")
        self.launches += 1

    def function(self, symbol: str, argtypes: Sequence, restype):
        """Another C function of the same library (e.g. a size query)."""
        self._resolve()
        fn = getattr(_libs[self.source], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn


def kernels() -> List[CudaKernel]:
    return list(_registry)


def reset_launch_counts() -> None:
    for k in _registry:
        k.launches = 0


def stream_ptr(device) -> Optional[int]:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
