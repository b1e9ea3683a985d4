"""Box proposal, the `ObjectAwareModel` slot of the mask pipeline (an own
copy of `sags_tpu/models/box_proposer.py`, which is numpy and imports no
JAX; the port imports nothing of `sags_tpu`).

  * `BoxProposer` (`:37`): the protocol,
    `model(img, ...) -> results[0].boxes.xyxy`.
  * `SegmentationBoxProposer` (`:93`): colour quantization + 4-connected
    components (`_connected_components`, `:63`) -> per-component xyxy boxes
    with a fill-ratio confidence, NMS'd by IoU (`nms_xyxy`, `:42`).
  * `GridBoxProposer` (`:153`): a tiling fallback.
  * `ObjectAwareModel` (`:173`): the name-compatible constructor.

Same numpy operations in the same order, and the same RNG stream, so the
boxes equal the JAX package's on the same image.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np


class BoxResult:
    """results[0].boxes.xyxy duck-type."""

    class _Boxes:
        def __init__(self, xyxy):
            self.xyxy = xyxy

    def __init__(self, xyxy: np.ndarray):
        self.boxes = self._Boxes(xyxy)


class BoxProposer(Protocol):
    def __call__(self, image: np.ndarray, device=None, retina_masks: bool = True,
                 imgsz: int = 256, conf: float = 0.4, iou: float = 0.9): ...


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray, iou_th: float) -> np.ndarray:
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[iou <= iou_th]
    return np.asarray(keep, np.int64)


def _connected_components(labels: np.ndarray) -> np.ndarray:
    """4-connected components of an integer label image.

    Vectorized min-label propagation: seed every pixel with its flat index
    and iteratively take the min over same-label 4-neighbors until fixpoint
    (≤ image diameter iterations, whole-array numpy ops each — replaces the
    earlier pure-Python double loop, O(HW) python-ops per frame)."""
    H, W = labels.shape
    comp = np.arange(H * W, dtype=np.int64).reshape(H, W)
    same_u = np.zeros((H, W), bool)
    same_u[1:] = labels[1:] == labels[:-1]
    same_l = np.zeros((H, W), bool)
    same_l[:, 1:] = labels[:, 1:] == labels[:, :-1]
    while True:
        nxt = comp.copy()
        # up / down
        nxt[1:][same_u[1:]] = np.minimum(nxt[1:], comp[:-1])[same_u[1:]]
        nxt[:-1][same_u[1:]] = np.minimum(nxt[:-1], comp[1:])[same_u[1:]]
        # left / right
        nxt[:, 1:][same_l[:, 1:]] = np.minimum(nxt[:, 1:], comp[:, :-1])[same_l[:, 1:]]
        nxt[:, :-1][same_l[:, 1:]] = np.minimum(nxt[:, :-1], comp[:, 1:])[same_l[:, 1:]]
        if np.array_equal(nxt, comp):
            break
        # pointer jumping (path halving): label ← label-of-label, which makes
        # convergence logarithmic instead of O(component diameter)
        f = nxt.ravel()
        comp = f[f[nxt]]
    return comp


class SegmentationBoxProposer:
    """Color-quantize → connected components → boxes."""

    def __init__(self, n_colors: int = 12, min_area_frac: float = 0.001,
                 work_size: int = 96, seed: int = 0):
        self.n_colors = n_colors
        self.min_area_frac = min_area_frac
        self.work_size = work_size
        self.rng = np.random.default_rng(seed)

    def __call__(self, image: np.ndarray, device=None, retina_masks=True,
                 imgsz: int = 256, conf: float = 0.4, iou: float = 0.9):
        img = np.asarray(image, np.float32)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = img.transpose(1, 2, 0)
        if img.max() > 1.5:
            img = img / 255.0
        H, W = img.shape[:2]
        # downscale for speed (pure numpy strided sampling)
        sy = max(1, H // self.work_size)
        sx = max(1, W // self.work_size)
        small = img[::sy, ::sx]
        h, w = small.shape[:2]
        flat = small.reshape(-1, small.shape[-1])

        # k-means-lite: sample centers, few Lloyd iterations
        k = min(self.n_colors, len(flat))
        centers = flat[self.rng.choice(len(flat), k, replace=False)]
        for _ in range(4):
            d = ((flat[:, None] - centers[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for c in range(k):
                sel = assign == c
                if sel.any():
                    centers[c] = flat[sel].mean(0)
        labels = assign.reshape(h, w)

        comp = _connected_components(labels)
        boxes, scores = [], []
        min_area = self.min_area_frac * h * w
        for cid in np.unique(comp):
            ys, xs = np.nonzero(comp == cid)
            if len(ys) < min_area:
                continue
            x1, x2 = xs.min() * sx, (xs.max() + 1) * sx
            y1, y2 = ys.min() * sy, (ys.max() + 1) * sy
            fill = len(ys) / max((xs.max() + 1 - xs.min()) * (ys.max() + 1 - ys.min()), 1)
            if fill < conf:
                continue
            boxes.append([x1, y1, min(x2, W), min(y2, H)])
            scores.append(fill * len(ys))
        if not boxes:
            boxes = [[0, 0, W, H]]
            scores = [1.0]
        boxes = np.asarray(boxes, np.float32)
        scores = np.asarray(scores, np.float32)
        keep = nms_xyxy(boxes, scores, iou)
        return [BoxResult(boxes[keep])]


class GridBoxProposer:
    """Regular grid of boxes — trivial fallback."""

    def __init__(self, rows: int = 4, cols: int = 5):
        self.rows, self.cols = rows, cols

    def __call__(self, image: np.ndarray, device=None, retina_masks=True,
                 imgsz: int = 256, conf: float = 0.4, iou: float = 0.9):
        img = np.asarray(image)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = img.transpose(1, 2, 0)
        H, W = img.shape[:2]
        boxes = []
        for r in range(self.rows):
            for c in range(self.cols):
                boxes.append([c * W / self.cols, r * H / self.rows,
                              (c + 1) * W / self.cols, (r + 1) * H / self.rows])
        return [BoxResult(np.asarray(boxes, np.float32))]


def ObjectAwareModel(pt_path: str = "", **kw) -> BoxProposer:
    """Name-compatible constructor (`create_model`, `scripts/gaussian_
    splatting.py:136-144`). Ignores the .pt path (no upstream weights exist
    in-tree) and returns the learned-weights-free proposer."""
    return SegmentationBoxProposer(**kw)
