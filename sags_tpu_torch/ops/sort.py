"""Ascending sort of int32 blocks: CUDA kernel `csrc/sort_blocks.cu` and its
plain PyTorch version.

Port of `sags_tpu/ops/pallas_sort.py` (`sort_blocks`, `bitonic_sort_rl`).
Each [R, L] block of a [B, R, L] int32 batch is sorted ascending as one
row-major list of R·L keys. Callers pack a payload into the low bits of each
key (`(depth << 11) | slot` in the windowed compositor), so a values-only
sort carries the permutation and ties break by the payload. The bitonic
network itself lives in `csrc/bitonic.cuh`, which `composite_windowed_sorted`
includes too; this module is its standalone harness. `network_schedule` and
`sort_blocks_network_plain` are a plain model of where that header runs each
stage (a thread's registers, warp shuffles, transposed rounds through shared
memory), for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from sags_tpu_torch.ops._build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("sort_blocks.cu", "sags_sort_blocks", [_P, _I, _I, _P, _P])
_MAX_N = 8192  # keys per block: 32 KB of shared memory
_WARP = 32


def network_schedule(n: int, E: int = 8):
    """Where `csrc/bitonic.cuh` runs each stage of the bitonic network over n
    keys with E consecutive keys a thread: a list of (k, j, place, b). Stage
    (k, j) exchanges key i with key i ^ j, ascending where i & k is 0.
    `place` is "thread" (j < E, between a thread's registers), "shuffle"
    (E <= j < 32 E, with lane ^ (j / E)) or "round" (j >= 32 E): a transposed
    round, in which a thread holds the E keys that differ in index bits
    b .. b + log2(E) - 1 and runs log2(E) stages between them; with E = 1 a
    round is one stage through shared memory."""
    log_e = E.bit_length() - 1
    stages = []
    k = 2
    while k <= n:
        j = k >> 1
        while j >= _WARP * E:
            b = j.bit_length() - 1 - max(log_e - 1, 0)
            for _ in range(max(log_e, 1)):
                stages.append((k, j, "round", b))
                j >>= 1
        while j >= E:
            stages.append((k, j, "shuffle", 0))
            j >>= 1
        while j >= 1:
            stages.append((k, j, "thread", 0))
            j >>= 1
        k <<= 1
    return stages


def sort_blocks_network_plain(x: torch.Tensor, E: int = 8) -> torch.Tensor:
    """`sort_blocks` by the kernel's network in plain PyTorch, stage by stage
    as `network_schedule` places them and with the kernel's index arithmetic:
    register e of thread t holds key `fixed(t) | (e << b)` (b = 0 and
    `fixed = t E` outside a round) and meets register e ^ (j >> b); a shuffle
    stage keeps the minimum where (t & j / E == 0) equals (t E & k == 0)."""
    B, R, L = x.shape
    n = R * L
    if n < E:
        E = n  # the kernel sorts fewer keys than a thread holds stage by stage
    log_e = E.bit_length() - 1
    keys = x.reshape(B, n).clone()
    t = torch.arange(n // E, device=x.device)
    e = torch.arange(E, device=x.device)
    for k, j, place, b in network_schedule(n, E):
        if place == "shuffle":
            v = keys.reshape(B, n // E, E)
            lanes = j // E
            other = v[:, t ^ lanes]
            keep_min = ((t & lanes) == 0) == (((t * E) & k) == 0)
            keys = torch.where(keep_min[None, :, None], torch.minimum(v, other),
                               torch.maximum(v, other)).reshape(B, n)
            continue
        fixed = ((t >> b) << (b + log_e)) | (t & ((1 << b) - 1))
        idx = fixed[:, None] | (e[None, :] << b)  # [threads, E] key indices
        v = keys[:, idx]
        if E == 1:  # one key a thread: the partner's sits in shared memory
            other = keys[:, idx ^ j]
            low = (idx & j) == 0
        else:
            other = v[:, :, e ^ (j >> b)]
            low = ((e & (j >> b)) == 0)[None, :].expand_as(idx)
        ascending = (((fixed >> b)[:, None] | e[None, :]) & (k >> b)) == 0
        new = torch.where(low == ascending, torch.minimum(v, other), torch.maximum(v, other))
        keys = keys.clone()
        keys[:, idx] = new
    return keys.reshape(B, R, L)


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
