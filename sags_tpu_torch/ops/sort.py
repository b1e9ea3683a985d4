"""Ascending sort of int32 blocks: CUDA kernel `csrc/sort_blocks.cu` and its
plain PyTorch version.

Port of `sags_tpu/ops/pallas_sort.py` (`sort_blocks`, `bitonic_sort_rl`).
Each [R, L] block of a [B, R, L] int32 batch is sorted ascending as one
row-major list of R·L keys. Callers pack a payload into the low bits of each
key (`(depth << 11) | slot` in the windowed compositor), so a values-only
sort carries the permutation and ties break by the payload. The bitonic
network itself lives in `csrc/bitonic.cuh`, which `composite_windowed_sorted`
includes too; this module is its standalone harness.
"""

from __future__ import annotations

import ctypes

import torch

from sags_tpu_torch.ops._build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("sort_blocks.cu", "sags_sort_blocks", [_P, _I, _I, _P, _P])
_MAX_N = 8192  # keys per block: 32 KB of shared memory


def sort_blocks_plain(x: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: one `torch.sort` per block."""
    B, R, L = x.shape
    return torch.sort(x.reshape(B, R * L), dim=1).values.reshape(B, R, L)


def sort_blocks(x: torch.Tensor) -> torch.Tensor:
    """Sort each [R, L] block of a [B, R, L] int32 tensor; R·L a power of
    two. CUDA tensors run the kernel, CPU tensors the plain version."""
    if x.device.type == "cpu":
        return sort_blocks_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"sort_blocks takes CUDA or CPU tensors, not {x.device.type}")
    if x.dtype != torch.int32 or x.dim() != 3:
        raise TypeError("sort_blocks takes an int32 [B, R, L] tensor")
    B, R, L = x.shape
    n = R * L
    if n & (n - 1) or not 2 <= n <= _MAX_N:
        raise ValueError(f"block size R*L = {n} must be a power of two in [2, {_MAX_N}]")
    x = x.contiguous()
    out = torch.empty_like(x)
    KERNEL.launch(x.data_ptr(), B, n, out.data_ptr(), stream_ptr(x.device))
    return out
