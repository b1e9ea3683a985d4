"""Tile-sharded multi-GPU mesh (`sags_tpu.parallel.mesh` over
`torch.distributed`).

SPMD, one process per card (`torchrun --nproc-per-node N`): every rank runs
the replicated part of a step (preprocess, binning, losses, Adam, tracking)
on the same inputs, and only the compositor's tile axis is split. A rank
composites its contiguous slice of the tile grid at a tile offset
(`tile_sharding`, `shard_tiles`), the slices are all-gathered into the whole
image (`gather_tiles`), and in backward each rank's partial gradient of a
replicated input is summed over the ranks (`replicated`): the transposed
`psum` of the JAX package's `shard_map`. The mesh is 1-D; its one axis is
`TILE_AXIS`.

The collectives are `all_reduce` and `all_gather` into a list, which NCCL
and gloo both provide for CUDA tensors. NCCL refuses two ranks on one card;
gloo stages CUDA tensors through the host and admits them.

One difference from the JAX package: there `make_mesh(n_devices)` takes the
first `n_devices` of `jax.devices()`. Under SPMD every launched rank takes
part, so `n_devices` must equal the world size.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sags_tpu_torch import resolve_device

TILE_AXIS = "tiles"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group along `TILE_AXIS`, and this rank's device."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: self.size}


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of the default process group. Without one, initialises it
    from torchrun's environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
    `MASTER_PORT`): NCCL when every rank has a card of its own, else gloo.
    Each rank's device is `devices[rank]`, by default `cuda:{LOCAL_RANK}`;
    a CUDA device becomes the current one, so `resolve_device(None)` lands
    on it."""
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        raise RuntimeError("no process group: launch the ranks with torchrun, or call "
                           "torch.distributed.init_process_group before make_mesh")
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}, but {size} ranks were launched: "
                         "under SPMD every rank takes part (one process per device)")
    if devices is None:
        device = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}")
    else:
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        device = resolve_device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        own_card = devices is None or len({str(d) for d in devices}) == size
        dist.init_process_group(
            "nccl" if device.type == "cuda" and own_card else "gloo")
    return Mesh(dist.group.WORLD, rank, size, device)


def tile_sharding(mesh: Mesh, num_tiles: int) -> Tuple[int, int, int]:
    """(NT_pad, lo, hi): the grid padded to a multiple of the ranks, and this
    rank's contiguous tiles lo..hi-1 of it (hi may pass `num_tiles`)."""
    per = -(-num_tiles // mesh.size)
    return per * mesh.size, mesh.rank * per, (mesh.rank + 1) * per


def shard_tiles(x: torch.Tensor, mesh: Optional[Mesh], fill=0) -> torch.Tensor:
    """This rank's rows of the tile-major `x` [NT, ...], padded with `fill`
    past NT (no-op without a mesh)."""
    if mesh is None:
        return x
    NT = x.shape[0]
    _, lo, hi = tile_sharding(mesh, NT)
    rows = x[min(lo, NT):min(hi, NT)]
    if rows.shape[0] == hi - lo:
        return rows
    pad = x.new_full((hi - lo - rows.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([rows, pad])


class _GatherTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, num_tiles):
        ctx.mesh, ctx.num_tiles = mesh, num_tiles
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)[:num_tiles]

    @staticmethod
    def backward(ctx, grad):
        # every rank computes the same loss from the same whole image, so the
        # cotangent is whole and alike on every rank: take this rank's rows
        return shard_tiles(grad, ctx.mesh), None, None


def gather_tiles(x: torch.Tensor, mesh: Mesh, num_tiles: int) -> torch.Tensor:
    """All-gather each rank's tile rows (`shard_tiles`'s shape) into the
    whole [num_tiles, ...] tensor on every rank. Differentiable: the
    gradient of a rank's rows is its rows of the (replicated) cotangent."""
    return _GatherTiles.apply(x, mesh, num_tiles)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.mesh.group)
        return grad, None


def replicated(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`x` as a replicated input of per-rank work: the identity forward; its
    gradient, each rank's part, summed over the ranks (no-op without a
    mesh)."""
    if mesh is None:
        return x
    return _Replicated.apply(x, mesh)
