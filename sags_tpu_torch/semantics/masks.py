"""Instance-mask generation, the `generate_objects` equivalent
(`sags_tpu/semantics/masks.py:22-97` with the port's SAM on a device).

Box proposals → SAM decoder in batches of 32 → threshold at
`mask_threshold` (0.0) → masks sorted by area (descending) → unique random
labels in [1, num_classes) painted largest-first into a grayscale label map
(`geometric.grayscale_mask`). The encoder and decoder run on `device`;
proposals and labelling are numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from sags_tpu_torch.models.box_proposer import BoxProposer, SegmentationBoxProposer
from sags_tpu_torch.models.sam import SAM, SamPredictor
from sags_tpu_torch.semantics.geometric import grayscale_mask


class MaskGenerator:
    """Box-prompted instance label maps."""

    def __init__(
        self,
        box_proposer: Optional[BoxProposer] = None,
        sam: Optional[SAM] = None,
        num_classes: int = 100,
        imgsz: int = 256,
        batch_size: int = 32,
        seed: int = 0,
        device=None,
    ):
        self.box_proposer = box_proposer or SegmentationBoxProposer()
        self.sam = sam or SAM.pretrained(device=device)
        self.predictor = SamPredictor(self.sam)
        self.num_classes = num_classes
        self.imgsz = imgsz
        self.batch_size = batch_size
        self.used_labels: set = set()
        self._random = random.Random(seed)

    def batch_iterator(self, batch_size: int, *args):
        n = len(args[0])
        n_batches = n // batch_size + int(n % batch_size != 0)
        for b in range(n_batches):
            yield [a[b * batch_size : (b + 1) * batch_size] for a in args]

    def generate_masks(self, image: np.ndarray) -> np.ndarray:
        """image [3,H,W] or [H,W,3] float → boolean masks [N,H,W]."""
        img = np.asarray(image)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = img.transpose(1, 2, 0)
        results = self.box_proposer(
            img, device=None, retina_masks=True, imgsz=self.imgsz, conf=0.4, iou=0.9
        )
        if not results:
            return np.zeros((0,) + img.shape[:2], bool)
        boxes = np.asarray(results[0].boxes.xyxy)
        self.predictor.set_image(img)
        boxes_c = self.predictor.transform.apply_boxes(boxes, self.predictor.original_size)
        masks = []
        for (b,) in self.batch_iterator(self.batch_size, boxes_c):
            low_res = self.predictor.decode_boxes(b)
            up = self.predictor.postprocess_masks(low_res)
            masks.append(up > self.sam.mask_threshold)
        return torch.cat(masks, 0).cpu().numpy()

    def generate_grayscale_mask(self, masks: np.ndarray) -> Optional[np.ndarray]:
        """[N,H,W] bool → [H,W] int labels, largest-area-first, unique random
        labels (`generate_grayscale_mask_torch`)."""
        if len(masks) == 0:
            return None
        out, self.used_labels = grayscale_mask(masks, self._random, self.num_classes)
        return out

    def generate_objects(self, image: np.ndarray) -> np.ndarray:
        """Full pipeline → [H,W] int label map (0 = background)."""
        img = np.asarray(image)
        hw = img.shape[1:] if img.shape[0] in (1, 3) else img.shape[:2]
        masks = self.generate_masks(image)
        if len(masks) == 0:
            return np.zeros(hw, np.int64)
        gm = self.generate_grayscale_mask(masks)
        return gm if gm is not None else np.zeros(hw, np.int64)
