"""Adam written out on tensors, with optax's `scale_by_adam` arithmetic.

`torch.optim.Adam` differs from optax in where eps enters and knows nothing of
the map's fixed-capacity slots: here the moments of every slot are updated
(inactive slots receive zero gradients, as in the JAX package) and the caller
masks the update. The count is one global host integer.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class AdamState(NamedTuple):
    count: int
    mu: tuple
    nu: tuple


def adam_init(params) -> AdamState:
    return AdamState(0, tuple(torch.zeros_like(p) for p in params),
                     tuple(torch.zeros_like(p) for p in params))


def adam_update(grads, state: AdamState, b1: float, b2: float,
                eps: float) -> Tuple[tuple, AdamState]:
    """Returns (unscaled updates m̂/(√v̂+eps), new state); callers scale by −lr."""
    count = state.count + 1
    bc1 = 1.0 - b1 ** count
    bc2 = 1.0 - b2 ** count
    mu, nu, upd = [], [], []
    for g, m, v in zip(grads, state.mu, state.nu):
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * (g ** 2) + b2 * v
        mu.append(m)
        nu.append(v)
        upd.append((m / bc1) / (torch.sqrt(v / bc2) + eps))
    return tuple(upd), AdamState(count, tuple(mu), tuple(nu))
