"""The per-tile work table fill: CUDA kernel `csrc/fill_table.cu` and its
plain PyTorch version.

Port of `sags_tpu/ops/pallas_binning.py:fill_table`. After the (tile, depth)
sort each tile's Gaussian ids form a contiguous segment of the sorted list;
row t of the table is that segment cut at `capacity`, padded with -1.
"""

from __future__ import annotations

import ctypes

import torch

from sags_tpu_torch.ops._build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("fill_table.cu", "sags_fill_table",
                    [_P, _I, _P, _I, _I, _P, _P])


def fill_table_plain(gid_sorted: torch.Tensor, starts: torch.Tensor,
                     num_tiles: int, capacity: int) -> torch.Tensor:
    """The same function in plain PyTorch (one gather)."""
    starts = starts.to(torch.int64)
    cnt = torch.clamp(starts[1:num_tiles + 1] - starts[:num_tiles], max=capacity)
    k = torch.arange(capacity, device=gid_sorted.device)
    idx = starts[:num_tiles, None] + k[None, :]
    keep = k[None, :] < cnt[:, None]
    n = gid_sorted.shape[0]
    vals = gid_sorted[torch.clamp(idx, max=max(n - 1, 0))] if n else \
        torch.zeros(idx.shape, dtype=torch.int32, device=gid_sorted.device)
    return torch.where(keep, vals, torch.full_like(vals, -1)).to(torch.int32)


def fill_table(gid_sorted: torch.Tensor, starts: torch.Tensor, num_tiles: int,
               capacity: int) -> torch.Tensor:
    """Returns the [num_tiles, capacity] int32 table, -1-padded beyond each
    tile's count. `gid_sorted` int32 [N], `starts` int32 [num_tiles+1]."""
    if gid_sorted.device.type == "cpu":
        return fill_table_plain(gid_sorted, starts, num_tiles, capacity)
    if gid_sorted.device.type != "cuda" or starts.device != gid_sorted.device:
        raise ValueError("fill_table: both inputs must be on one CUDA device")
    if gid_sorted.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("fill_table: gid_sorted and starts must be int32")
    if starts.shape != (num_tiles + 1,) or gid_sorted.dim() != 1:
        raise ValueError("fill_table: expected gid_sorted [N], starts [NT+1]")
    gid_sorted = gid_sorted.contiguous()
    starts = starts.contiguous()
    out = torch.empty((num_tiles, capacity), dtype=torch.int32,
                      device=gid_sorted.device)
    KERNEL.launch(gid_sorted.data_ptr(), gid_sorted.shape[0], starts.data_ptr(),
                  num_tiles, capacity, out.data_ptr(),
                  stream_ptr(gid_sorted.device))
    return out
