"""Instance-mask generation, the `generate_objects` equivalent
(`sags_tpu/semantics/masks.py:22-97` with the port's SAM on a device).

Box proposals → SAM decoder in batches of 32 → threshold at
`mask_threshold` (0.0) → masks sorted by area (descending) → unique random
labels in [1, num_classes) painted largest-first into a grayscale label map
(`geometric.grayscale_mask`). The encoder and decoder run on `device`;
proposals and labelling are numpy on the host, as in the JAX package.

The model is the JAX package's SAM-style stand-in (`models/sam.py`, the
default) or MobileSAM at its published widths (`models/mobile_sam.py`),
whose encoder is TinyViT, MobileSAMv2's default EfficientViT-SAM-L2
(`models/efficientvit_sam.py`) or SAM's ViT-H (`models/sam_vit.py`), the
last two with their own spans inside `sam.encode`.
Spans (`utils/profiling.py`): `segment.boxes` (the proposals on the host,
counter `segment.boxes`), `sam.encode` (device), `sam.decode` (device, one a
batch of boxes, the upscaling to the frame included) and `segment.paint`
(the masks' one fetch to the host and the painting, counter
`segment.masks`).
"""

from __future__ import annotations

import random
from typing import Optional, Union

import numpy as np
import torch

from sags_tpu_torch.models.box_proposer import BoxProposer, SegmentationBoxProposer
from sags_tpu_torch.models.mobile_sam import MobileSAM, MobileSamPredictor
from sags_tpu_torch.models.sam import SAM, SamPredictor
from sags_tpu_torch.semantics.geometric import grayscale_mask
from sags_tpu_torch.utils.profiling import count, host_read, span


def _host_hwc(image) -> np.ndarray:
    """The image on the host as [H,W,C]."""
    if isinstance(image, torch.Tensor):
        image = host_read(torch.Tensor.cpu, image).numpy()
    img = np.asarray(image)
    return img.transpose(1, 2, 0) if img.ndim == 3 and img.shape[0] in (1, 3) else img


def _hw(image):
    shape = tuple(image.shape)
    return shape[1:] if shape[0] in (1, 3) else shape[:2]


class MaskGenerator:
    """Box-prompted instance label maps."""

    def __init__(
        self,
        box_proposer: Optional[BoxProposer] = None,
        sam: Optional[Union[SAM, MobileSAM]] = None,
        num_classes: int = 100,
        imgsz: int = 256,
        batch_size: int = 32,
        seed: int = 0,
        device=None,
    ):
        self.box_proposer = box_proposer or SegmentationBoxProposer()
        self.sam = sam or SAM.pretrained(device=device)
        self.predictor = (MobileSamPredictor if isinstance(self.sam, MobileSAM)
                          else SamPredictor)(self.sam)
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

    def _device_masks(self, image) -> Optional[torch.Tensor]:
        """image [3,H,W] or [H,W,3] (array or tensor) → boolean masks
        [N,H,W] on the model's device; None without a proposal."""
        with span("segment.boxes"):
            img = _host_hwc(image)
            results = self.box_proposer(
                img, device=None, retina_masks=True, imgsz=self.imgsz, conf=0.4, iou=0.9
            )
            boxes = np.asarray(results[0].boxes.xyxy) if results else np.zeros((0, 4))
            count("segment.boxes", len(boxes))
        if not len(boxes):
            return None
        with span("sam.encode", device=self.sam.device):
            self.predictor.set_image(img)
        boxes_c = self.predictor.transform.apply_boxes(boxes, self.predictor.original_size)
        masks = []
        for (b,) in self.batch_iterator(self.batch_size, boxes_c):
            with span("sam.decode", device=self.sam.device):
                low_res = self.predictor.decode_boxes(b)
                up = self.predictor.postprocess_masks(low_res)
                masks.append(up > self.sam.mask_threshold)
        return torch.cat(masks, 0)

    def generate_masks(self, image) -> np.ndarray:
        """image [3,H,W] or [H,W,3] float → boolean masks [N,H,W]."""
        masks = self._device_masks(image)
        if masks is None:
            return np.zeros((0,) + _hw(image), bool)
        return host_read(torch.Tensor.cpu, masks).numpy()

    def generate_grayscale_mask(self, masks: np.ndarray) -> Optional[np.ndarray]:
        """[N,H,W] bool → [H,W] int labels, largest-area-first, unique random
        labels (`generate_grayscale_mask_torch`)."""
        if len(masks) == 0:
            return None
        out, self.used_labels = grayscale_mask(masks, self._random, self.num_classes)
        return out

    def generate_objects(self, image) -> np.ndarray:
        """Full pipeline → [H,W] int label map (0 = background)."""
        masks = self._device_masks(image)
        with span("segment.paint"):
            if masks is None:
                return np.zeros(_hw(image), np.int64)
            masks = host_read(torch.Tensor.cpu, masks).numpy()
            count("segment.masks", len(masks))
            gm = self.generate_grayscale_mask(masks)
        return gm if gm is not None else np.zeros(_hw(image), np.int64)
