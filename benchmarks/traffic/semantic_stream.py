"""Traffic `semantic_stream`: `stream`'s closed loop (`traffic/stream.py`,
reused as it is) with the reference node's segmenter on every keyframe:
`SLAMPipeline(cfg, mask_generator=...)` with `semantics.masks.MaskGenerator`
over MobileSAM (`models/mobile_sam.py`) built from the configuration's
`segmenter` block. Its weights are the reference's (`reference/mobile_sam.py`,
`init_weights`, drawn from `--seed` in MobileSAM's checkpoint layout), loaded
through the program's `load_checkpoint`. A keyframe then goes
track and add, box proposal, the encoder, the decoder in batches of boxes,
the masks' fetch and painting, the device association, and one training
step on the labels; every replayed keyframe trains on its labels too.

The check adds three numbers to `stream`'s five, from the keyframe that
opens the frames after the window (each `run` call starts with one):
`sam_gap`, that keyframe's low-res mask logits and IoU predictions against
`reference/mobile_sam.py` on the same frame, canvas boxes and weights (the
largest absolute difference over the largest absolute reference logit);
`mask_gap`, its logits at the frame's size (`postprocess_masks`) against
the reference's `postprocess` of the reference's logits, and its masks
thresholded at `mask_threshold` (the larger of the largest logit difference
and the largest reference logit where a mask pixel disagrees in sign, over
the largest absolute reference logit); and `assoc_gap`, its associated
label map and slot labels against the reference association given the
program's own label map before association and its slots' previous labels
(the share of pixels, or of active slots, that differ, whichever is
larger).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmarks.harness import capture, sam_work, spec, trace, work
from benchmarks.reference import mobile_sam as rms
from benchmarks.traffic import stream


def make_generator(seg: dict, num_classes: int, seed: int, device, weights: dict):
    """The mask generator over MobileSAM at the block's `architecture`, with
    `weights` (a `state_dict` in MobileSAM's layout) loaded."""
    from sags_tpu_torch.models.box_proposer import SegmentationBoxProposer
    from sags_tpu_torch.models.mobile_sam import MobileSAM, MobileSAMConfig, load_checkpoint
    from sags_tpu_torch.semantics.masks import MaskGenerator

    p = seg["proposer"]
    # the port's MaskGenerator proposes at these; the file states them
    if (p["kind"], p["conf"], p["iou"], seg["mask_threshold"], seg["multimask_output"]) != (
            "SegmentationBoxProposer", 0.4, 0.9, 0.0, False):
        raise ValueError(f"the port's MaskGenerator cannot run segmenter {seg}")
    arch = {k: tuple(v) if isinstance(v, list) else v for k, v in seg["architecture"].items()}
    model = load_checkpoint(MobileSAM(MobileSAMConfig(**arch), seed=seed, device=device), weights)
    return MaskGenerator(box_proposer=SegmentationBoxProposer(seed=seed), sam=model,
                         num_classes=num_classes, imgsz=p["imgsz"],
                         batch_size=seg["decoder_batch"], seed=seed)


class Session(stream.Session):
    def __init__(self, cell: spec.Cell, seed: int, device):
        from sags_tpu_torch.slam import pipeline as pl

        self.seg = cell.config["segmenter"]
        self.arch = self.seg["architecture"]
        sem = cell.config["slam"]["semantics"]
        self.weights = rms.init_weights(self.arch, seed)
        self.generator = make_generator(self.seg, sem["num_classes"], seed, torch.device(device),
                                        self.weights)
        self.sam_rec: Dict[str, object] = {}
        self.assoc_rec: Dict[str, object] = {}
        # `stream.Session` builds the pipeline; hand it the mask generator
        with capture.Wrap(pl, "SLAMPipeline", lambda orig, cfg, **kw: orig(
                cfg, mask_generator=self.generator, **kw)):
            super().__init__(cell, seed, device)

    def stretches(self, n: int) -> dict:
        """`stream`'s two stretches, with the encodes and boxes of each
        counted (`harness/sam_work.py`)."""
        from sags_tpu_torch.models import mobile_sam as ms

        tally = {}

        def counting(name):
            def fn(orig, run_units, device):
                seen = {"encodes": 0, "boxes": 0}

                def enc(o, model, canvas):
                    seen["encodes"] += canvas.shape[0]
                    return o(model, canvas)

                def dec(o, model, features, boxes, *a, **k):
                    seen["boxes"] += boxes.shape[0]
                    return o(model, features, boxes, *a, **k)

                with capture.Wrap(ms.MobileSAM, "encode", enc), \
                        capture.Wrap(ms.MobileSAM, "decode", dec):
                    out = orig(run_units, device)
                tally[name] = seen
                return out
            return fn

        with capture.Wrap(trace, "profiled", counting("profiled")), \
                capture.Wrap(trace, "counted", counting("counted")):
            rec = super().stretches(n)
        enc = sam_work.encoder_work(self.arch)["fp"]
        for name, t in tally.items():
            rec[name].work["sam_ops_s"] = (t["encodes"] * enc + sam_work.decoder_flops(
                self.arch, t["boxes"])) / work.PEAK_FP32
        rec["sam_encode_least_s"] = sam_work.encoder_least_s(self.arch)
        return rec

    def after_window(self) -> None:
        """`stream`'s frames after the window, copying what the first
        keyframe's segmentation and association computed."""
        from sags_tpu_torch.models import mobile_sam as ms
        from sags_tpu_torch.semantics import association
        from sags_tpu_torch.semantics import masks as masks_mod

        seg, asc = self.sam_rec, self.assoc_rec
        seg["batches"], seg["frame_logits"] = [], []

        def set_image(orig, pred, image):
            if "image" not in seg:  # the frame as the generator hands it over, [H,W,3]
                x = torch.as_tensor(image).to(pred.model.device, copy=True)
                seg["image"] = x.permute(2, 0, 1) if x.shape[0] not in (1, 3) else x
            return orig(pred, image)

        def decode(orig, model, features, boxes, *a, **k):
            masks, iou = orig(model, features, boxes, *a, **k)
            if not asc:
                seg["batches"].append((boxes.clone(), masks.clone(), iou.clone()))
            return masks, iou

        def postprocess(orig, pred, low_res):
            up = orig(pred, low_res)
            if not asc:
                seg["frame_logits"].append(up.clone())
            return up

        def device_masks(orig, gen, image):
            out = orig(gen, image)
            if not asc and "masks" not in seg and out is not None:
                seg["masks"] = out.clone()
            return out

        def associate(orig, a, xyz, active, mask, pose, intrinsics, used_labels=None):
            first = not asc
            if first:
                prev = a._prev_labels
                asc.update(xyz=xyz.clone(), active=active.clone(), mask=mask.clone(),
                           pose=torch.as_tensor(pose).clone(), intrinsics=tuple(intrinsics),
                           prev=None if prev is None else prev.clone(),
                           threshold=a.threshold, lidar_axes=a.lidar_axes, L=a.L)
            out = orig(a, xyz, active, mask, pose, intrinsics, used_labels)
            if first:
                asc.update(out=out.clone(), labels=a._prev_labels.clone())
            return out

        with capture.Wrap(ms.MobileSamPredictor, "set_image", set_image), \
                capture.Wrap(ms.MobileSAM, "decode", decode), \
                capture.Wrap(ms.MobileSamPredictor, "postprocess_masks", postprocess), \
                capture.Wrap(masks_mod.MaskGenerator, "_device_masks", device_masks), \
                capture.Wrap(association.DeviceInstanceAssociator, "associate", associate):
            super().after_window()

    # -- the check ----------------------------------------------------------
    def check(self, control: bool = False) -> Dict[str, float]:
        """`stream`'s five numbers, `sam_gap`, `mask_gap` and `assoc_gap`.
        `control` puts the reference computed with TF32 in the program's
        place (the association has no matrix product: its control reads 0)."""
        out = super().check(control)
        ref, ctl = self._reference(control)
        out["sam_gap"] = self._sam_gap(ref, ctl)
        out["mask_gap"] = self._mask_gap(ref, ctl)
        out["assoc_gap"] = self._assoc_gap(control=control)
        return out

    def fault_readings(self) -> Dict[str, float]:
        """`stream`'s, what skipping the association (the identity
        mapping) would read, the upper reading of `assoc_gap`, and what
        `mask_gap` would read were `postprocess_masks` to skip its crop."""
        out = super().fault_readings()
        out["assoc_gap.identity"] = self._assoc_gap(identity=True)
        ref, _ = self._reference(False)
        if ref is not None:
            hw = tuple(ref["frame_logits"].shape[1:])
            no_crop = torch.cat([rms.postprocess(r, hw, self.arch["img_size"], crop=False)
                                 for r in ref["low_res"]])
            out["mask_gap.no_crop"] = _mask_reading(no_crop, no_crop > 0, ref["frame_logits"])
        return out

    def _reference(self, control: bool):
        """The reference's answers for the copied keyframe on its frame, its
        canvas boxes and the weights: each batch's low-res logits and IoU,
        and the logits at the frame's size; with `control`, the same
        computed with TF32 (None, None without a segmented keyframe)."""
        seg = self.sam_rec
        if not seg.get("batches"):
            return None, None
        dev = seg["image"].device
        p, a = {k: v.to(dev) for k, v in self.weights.items()}, self.arch
        hw = tuple(seg["image"].shape[1:])

        def answers():
            feats = rms.encode(p, a, rms.preprocess(seg["image"], a["img_size"]))
            out = {"low_res": [], "iou": []}
            for boxes, _, _ in seg["batches"]:
                m, iou = rms.decode(p, a, feats, boxes)
                out["low_res"].append(m)
                out["iou"].append(iou)
            out["frame_logits"] = torch.cat([rms.postprocess(m, hw, a["img_size"])
                                             for m in out["low_res"]])
            return out

        ref = answers()
        if not control:
            return ref, None
        with rms.tf32():
            return ref, answers()

    def _sam_gap(self, ref, ctl) -> Optional[float]:
        if ref is None:
            return None
        diff, top = 0.0, 0.0
        for i, (_, masks, iou) in enumerate(self.sam_rec["batches"]):
            if ctl is not None:
                masks, iou = ctl["low_res"][i], ctl["iou"][i]
            r_masks, r_iou = ref["low_res"][i], ref["iou"][i]
            diff = max(diff, float((masks - r_masks).abs().max()),
                       float((iou - r_iou).abs().max()))
            top = max(top, float(r_masks.abs().max()))
        return diff / top if top > 0 else None

    def _mask_gap(self, ref, ctl) -> Optional[float]:
        seg = self.sam_rec
        if ref is None or "masks" not in seg:
            return None
        if ctl is not None:
            up = ctl["frame_logits"]
            return _mask_reading(up, up > self.seg["mask_threshold"], ref["frame_logits"])
        return _mask_reading(torch.cat(seg["frame_logits"]), seg["masks"], ref["frame_logits"])

    def _assoc_gap(self, control: bool = False, identity: bool = False) -> Optional[float]:
        r = self.assoc_rec
        if "out" not in r:
            return None
        args = (r["xyz"], r["active"], r["mask"], r["prev"], r["pose"], r["intrinsics"],
                r["L"], r["threshold"], r["lidar_axes"])
        ref_mask, ref_labels = rms.associate(*args)
        if identity:
            mask, labels = rms.associate(*args, identity=True)
        elif control:  # no matrix product: the TF32 reference is the reference
            mask, labels = ref_mask, ref_labels
        else:
            mask, labels = r["out"], r["labels"]
        act = r["active"]
        pix = float((mask.long() != ref_mask).float().mean())
        slots = float((labels.long()[act] != ref_labels[act]).float().mean()) if act.any() else 0.0
        return max(pix, slots)


def _mask_reading(logits, masks, ref_logits) -> Optional[float]:
    """The larger of the largest logit difference and the largest reference
    logit at a pixel whose mask disagrees with the reference's sign, over
    the largest absolute reference logit. Masks thresholded at 0 from the
    logits read no more than the logits do."""
    if logits.shape != ref_logits.shape or masks.shape != ref_logits.shape:
        return float("inf")
    top = float(ref_logits.abs().max())
    diff = float((logits - ref_logits).abs().max())
    wrong = masks != (ref_logits > 0)
    if wrong.any():
        diff = max(diff, float(ref_logits.abs()[wrong].max()))
    return diff / top if top > 0 else None


def setup(cell: spec.Cell, seed: int, device) -> Session:
    return Session(cell, seed, device)
