"""sags_tpu_torch — the PyTorch + CUDA port of sags_tpu.

Semantic Gaussian-splatting SLAM on one NVIDIA H100: plain tensor code is
PyTorch, and the Pallas TPU kernels of the main path are hand-written CUDA
C++ for `sm_90a` (`csrc/`, built with `nvcc` on first use and loaded with
`ctypes`, see `ops/_build.py`). The package never imports JAX or `sags_tpu`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; without
a GPU they raise instead of falling back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["device_constant", "resolve_device"]

_CONSTANTS = {}


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sags_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type == "cuda":
        # float32 matmuls and convolutions stay full float32 (the JAX
        # package computes its SSIM blur, kNN distances and camera algebra
        # at Precision.HIGHEST); TF32 keeps only ~3 decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def device_constant(key, make, device) -> torch.Tensor:
    """The tensor `make()` (a host array) on `device`, uploaded once per `key`
    and device: an upload from pageable memory waits for the device, which a
    loop that reads nothing on the host cannot afford. Callers must not
    write to it."""
    full = (key, str(device))
    if full not in _CONSTANTS:
        _CONSTANTS[full] = torch.as_tensor(make(), device=device)
    return _CONSTANTS[full]
