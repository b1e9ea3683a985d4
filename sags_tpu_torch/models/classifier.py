"""Semantic classifier head: 1×1 conv over the rendered object features
(`Conv2d(16, 100, 1)` with its own Adam(lr=5e-4) in the reference), as a
channel matmul."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ClassifierParams(NamedTuple):
    weight: torch.Tensor  # [num_classes, num_objects]
    bias: torch.Tensor  # [num_classes]


def init_classifier(draws, num_objects: int = 16,
                    num_classes: int = 100) -> ClassifierParams:
    """torch Conv2d's default init, U(±1/√fan_in), from the draw hook."""
    bound = 1.0 / math.sqrt(num_objects)
    w = draws.uniform((num_classes, num_objects))
    b = draws.uniform((num_classes,))
    return ClassifierParams(-bound + 2 * bound * w, -bound + 2 * bound * b)


def apply_classifier(params: ClassifierParams, objects: torch.Tensor) -> torch.Tensor:
    """objects [O,H,W] → logits [K,H,W]."""
    return (torch.einsum("ohw,ko->khw", objects, params.weight)
            + params.bias[:, None, None])


def apply_classifier_features(params: ClassifierParams,
                              feats: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian features [N,O] → logits [N,K]."""
    return feats @ params.weight.T + params.bias[None, :]
