"""Random-draw hooks. Ported functions that sample (the obj embedding of new
Gaussians, the cls3d sample, the classifier init, the split offsets of
densification) take U[0,1) or N(0,1) draws from one of these objects, so a
caller can replay numbers made elsewhere — torch cannot reproduce
`jax.random`."""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch


class TorchDraws:
    """The default: a seeded `torch.Generator` on the device."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)


class ReplayDraws:
    """Hands out given arrays in order; each must have the requested shape."""

    def __init__(self, arrays: Iterable[np.ndarray], device):
        self.device = torch.device(device)
        self.queue: List[np.ndarray] = list(arrays)

    def push(self, *arrays: np.ndarray) -> None:
        self.queue.extend(arrays)

    def _pop(self, shape) -> torch.Tensor:
        if not self.queue:
            raise RuntimeError(f"no replayed draw left for shape {tuple(shape)}")
        a = np.asarray(self.queue.pop(0), np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"replayed draw {a.shape} != requested {tuple(shape)}")
        return torch.from_numpy(a.copy()).to(self.device)

    def uniform(self, shape) -> torch.Tensor:
        return self._pop(shape)

    def normal(self, shape) -> torch.Tensor:
        return self._pop(shape)
