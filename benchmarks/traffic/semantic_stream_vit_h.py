"""Traffic `semantic_stream_vit_h`: `semantic_stream` (reused by import) with
SAM's ViT-H as the keyframe encoder, the node's `vit_h`: the
configuration's `segmenter.architecture` names `encoder: sam_vit_h`, so
`semantic_stream.make_generator` builds the program's
`MobileSAM(MobileSAMConfig(encoder="sam_vit_h", ...))` behind the shared
prompt encoder, decoder and predictor. Three things differ, each swapped in
where `semantic_stream` calls it: the weights are `reference/sam_vit_h.py
init_weights`'s (the ViT-H encoder and MobileSAM's decoder in one
`state_dict`, loaded through the program's `load_checkpoint`); the check's
reference encoder is that file's `encode` (the decoder, `postprocess` and
`associate` stay `reference/mobile_sam.py`'s); the traced stretches count
the encoder's work with `harness/sam_vit_h_work.py`. The check reads
`semantic_stream`'s eight numbers at this cell's limits; `sam_gap` reads
infinite where the program's (or the control's) logits or IoU are not
finite, which `semantic_stream`'s maximum would pass over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from benchmarks.harness import capture, sam_vit_h_work, sam_work, spec
from benchmarks.reference import mobile_sam as rms
from benchmarks.reference import sam_vit_h as rvh
from benchmarks.traffic import semantic_stream


class Session(semantic_stream.Session):
    def __init__(self, cell: spec.Cell, seed: int, device):
        with capture.Wrap(rms, "init_weights", lambda orig, a, s: rvh.init_weights(a, s)):
            super().__init__(cell, seed, device)

    def stretches(self, n: int) -> dict:
        with capture.Wrap(sam_work, "encoder_work",
                          lambda orig, a: sam_vit_h_work.encoder_work(a)), \
                capture.Wrap(sam_work, "encoder_least_s",
                             lambda orig, a: sam_vit_h_work.encoder_least_s(a)):
            return super().stretches(n)

    def _reference(self, control: bool):
        with capture.Wrap(rms, "encode", lambda orig, p, a, x: rvh.encode(p, a, x)):
            return super()._reference(control)

    def _sam_gap(self, ref, ctl) -> Optional[float]:
        gap = super()._sam_gap(ref, ctl)
        if gap is None:
            return None
        got = (zip(ctl["low_res"], ctl["iou"]) if ctl is not None
               else ((m, iou) for _, m, iou in self.sam_rec["batches"]))
        finite = all(bool(torch.isfinite(m).all() and torch.isfinite(iou).all()) for m, iou in got)
        return gap if finite else math.inf


def setup(cell: spec.Cell, seed: int, device) -> Session:
    return Session(cell, seed, device)
