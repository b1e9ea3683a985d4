"""General utilities — `utils/general_utils.py` parity surface (own copy of
`sags_tpu.utils.general`).

`build_rotation` / `build_scaling_rotation` live in `core.transforms` (xyzw
convention); re-exported here so code written against the reference layout
finds them. `get_expon_lr_func` wraps `core.config.expon_lr`; `safe_state`
seeds the host RNGs and returns a seeded generator.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.config import expon_lr
from sags_tpu_torch.core.transforms import (  # noqa: F401  (re-exports)
    build_scaling_rotation,
    quat_to_rotmat as build_rotation,
)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[...,3,3] symmetric → packed upper triangle [...,6] (CUDA layout)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1
    )


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1_000_000):
    """`general_utils.py:33-66` — returns step → lr."""

    def helper(step):
        return expon_lr(step, lr_init, lr_final, lr_delay_steps, lr_delay_mult,
                        max_steps)

    return helper


def safe_state(seed: int = 0, device=None) -> torch.Generator:
    """Seed python/numpy RNGs and return a `torch.Generator` on `device`
    (default: the card) seeded the same (`general_utils.py:123-144`; the JAX
    package returns a PRNG key)."""
    random.seed(seed)
    np.random.seed(seed)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen
