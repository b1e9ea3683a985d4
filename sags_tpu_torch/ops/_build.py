"""Build and load the hand-written CUDA kernels (`sags_tpu_torch/csrc/*.cu`).

Each source is compiled by its own `nvcc` process into a shared library with
a plain C interface (no PyTorch headers: seconds, not minutes), all of them
started together, and loaded with `ctypes`. Libraries are named by a hash of
their source, every header it includes from `csrc/` (`#include "..."`,
followed through headers), and the flags, so an edited source or header
never loads a stale one. They go under `build/kernels/` beside the package
directory (the repository root), or where the environment variable
`SAGS_TORCH_BUILD_DIR` says: set it when the package is installed, where
that directory is site-packages. Nothing is built or loaded at
import time: the first launch (or `build_all()`) does it. A kernel built
with extra flags (`CudaKernel(..., flags=("-DNAME=1",), register=False)`)
is a variant for measurements: its own library, outside the registry and
its launch counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = (os.environ.get("SAGS_TORCH_BUILD_DIR")
             or os.path.join(os.path.dirname(_PKG), "build", "kernels"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_registry: List["CudaKernel"] = []
build_log: Dict[str, str] = {}  # "source [flags]" -> nvcc output (-Xptxas -v report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(source: str) -> List[str]:
    """`source` and the `csrc/` headers it includes, directly or through
    other headers, in a fixed order."""
    found, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in found:
            continue
        found.append(name)
        with open(os.path.join(CSRC, name), "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                inc = inc.decode()
                if os.path.exists(os.path.join(CSRC, inc)):
                    todo.append(inc)
    return found


def _lib_path(source: str, flags: Sequence[str] = ()) -> str:
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode())
    for name in source_files(source):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(specs) -> None:
    """Compile every (source, flags) not built yet, one `nvcc` each, in
    parallel; a bare source name stands for (source, ())."""
    specs = [(s, ()) if isinstance(s, str) else (s[0], tuple(s[1])) for s in specs]
    with _lock:
        todo = [s for s in dict.fromkeys(specs) if s not in _libs]
        if not todo:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for src, flags in todo:
            path = _lib_path(src, flags)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, os.path.join(CSRC, src)]
            procs.append((" ".join((src, *flags)), path, tmp, subprocess.Popen(
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
        for spec in todo:
            _libs[spec] = ctypes.CDLL(_lib_path(*spec))


def build_all(extra: Sequence["CudaKernel"] = ()) -> None:
    """Build every registered kernel (the modules under `ops/` register
    theirs when imported) and the variants `extra`, all at once."""
    build([k.spec for k in [*_registry, *extra]])


class CudaKernel:
    """One exported C entry point of a `csrc/*.cu` library.

    `launches` counts successful launches: the wrapper that owns the kernel
    calls `launch` once per kernel launch and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 flags: Sequence[str] = (), register: bool = True):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.spec = (source, tuple(flags))
        self.launches = 0
        self._fn = None
        self._err = None
        if register:
            _registry.append(self)

    def variant(self, *flags: str) -> "CudaKernel":
        """The same entry point built with extra compiler flags, unregistered."""
        return CudaKernel(self.source, self.symbol, self.argtypes, flags, register=False)

    def _resolve(self):
        if self._fn is None:
            build([self.spec])
            lib = _libs[self.spec]
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
        fn = getattr(_libs[self.spec], symbol)
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
