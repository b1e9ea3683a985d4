"""Geometric instance segmentation, the mask generator that needs no model
weights (an own copy of `sags_tpu/semantics/geometric.py:28-130`, numpy).

Pixels are clustered by (colour, image position, inverse depth) with a few
Lloyd iterations, the clusters split into 4-connected components, and the
components painted with area-sorted unique random labels, as the reference's
`generate_grayscale_mask_torch` does. The `random.Random(seed)` and
`np.random.default_rng(seed)` streams are drawn in the JAX generator's order,
so the labels equal its labels on the same image. It runs on the host.
"""

from __future__ import annotations

import random
from typing import Optional, Set, Tuple

import numpy as np

from sags_tpu_torch.models.box_proposer import _connected_components


def grayscale_mask(masks: np.ndarray, rnd: random.Random,
                   num_classes: int) -> Tuple[np.ndarray, Set[int]]:
    """[N,H,W] bool → ([H,W] int64 labels, the labels used): the masks
    painted largest-area-first with unique random labels in
    [1, num_classes) drawn from `rnd` (the reference's
    `generate_grayscale_mask_torch`; both mask generators label so)."""
    H, W = masks.shape[1:]
    out = np.zeros((H, W), np.int64)
    order = np.argsort(-masks.sum(axis=(1, 2)))
    used: Set[int] = set()
    for idx in order[: min(len(masks), num_classes)]:
        label = rnd.randint(1, num_classes - 1)
        while label in used and len(used) < num_classes - 1:
            label = rnd.randint(1, num_classes - 1)
        used.add(label)
        out[masks[idx]] = label
    return out, used


class GeometricMaskGenerator:
    """Depth+color clustering → connected components → instance label map."""

    def __init__(
        self,
        n_clusters: int = 12,
        num_classes: int = 100,
        work_size: int = 128,
        min_area_frac: float = 0.002,
        pos_weight: float = 0.4,
        depth_weight: float = 2.0,
        seed: int = 0,
    ):
        self.n_clusters = n_clusters
        self.num_classes = num_classes
        self.work_size = work_size
        self.min_area_frac = min_area_frac
        self.pos_weight = pos_weight
        self.depth_weight = depth_weight
        self.used_labels: set = set()
        self._random = random.Random(seed)
        self._rng = np.random.default_rng(seed)

    # -- mask extraction ----------------------------------------------------
    def generate_masks(
        self, image: np.ndarray, depth: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """image [3,H,W]|[H,W,3], optional depth [H,W] → bool masks [N,H,W]."""
        img = np.asarray(image, np.float32)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = img.transpose(1, 2, 0)
        if img.max() > 1.5:
            img = img / 255.0
        H, W = img.shape[:2]
        sy = max(1, H // self.work_size)
        sx = max(1, W // self.work_size)
        small = img[::sy, ::sx]
        h, w = small.shape[:2]

        feats = [small.reshape(-1, small.shape[-1])]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        feats.append(
            self.pos_weight
            * np.stack([yy / max(h, 1), xx / max(w, 1)], -1).reshape(-1, 2)
        )
        if depth is not None:
            d = np.asarray(depth, np.float32)[::sy, ::sx]
            inv = 1.0 / np.maximum(d, 1e-3)
            feats.append(self.depth_weight * inv.reshape(-1, 1))
        flat = np.concatenate(feats, axis=-1)

        k = min(self.n_clusters, len(flat))
        centers = flat[self._rng.choice(len(flat), k, replace=False)]
        for _ in range(6):
            d2 = ((flat[:, None] - centers[None]) ** 2).sum(-1)
            assign = d2.argmin(1)
            for c in range(k):
                sel = assign == c
                if sel.any():
                    centers[c] = flat[sel].mean(0)
        comp = _connected_components(assign.reshape(h, w))

        masks = []
        min_area = self.min_area_frac * h * w
        for cid in np.unique(comp):
            m = comp == cid
            if m.sum() < min_area:
                continue
            up = np.repeat(np.repeat(m, sy, 0), sx, 1)
            full = np.zeros((H, W), bool)
            full[: up.shape[0], : up.shape[1]] = up[:H, :W]
            masks.append(full)
        if not masks:
            return np.zeros((0, H, W), bool)
        return np.stack(masks)

    # -- labeling (reference semantics) --------------------------------------
    def generate_grayscale_mask(self, masks: np.ndarray) -> np.ndarray:
        out, self.used_labels = grayscale_mask(masks, self._random, self.num_classes)
        return out

    def generate_objects(
        self, image: np.ndarray, depth: Optional[np.ndarray] = None
    ) -> np.ndarray:
        img = np.asarray(image)
        hw = img.shape[1:] if img.shape[0] in (1, 3) else img.shape[:2]
        masks = self.generate_masks(image, depth)
        if len(masks) == 0:
            return np.zeros(hw, np.int64)
        return self.generate_grayscale_mask(masks)
