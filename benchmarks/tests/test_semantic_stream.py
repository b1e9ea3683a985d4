"""`fast_livo2_semantic.stream` at a tiny size on the CPU, with MobileSAM at
a quarter of its widths on a 256 canvas: a sound run comes out correct and
reports its host-side readers; the TF32 control and a segmenter, a mask
stage or an association broken underneath do not; the identity
association's and the uncropped masks' readings lie far above their
limits."""

import time

import pytest
import torch

from benchmarks import run as bench_run
from benchmarks.harness import program_spans as ps
from benchmarks.harness import spec

CPU = torch.device("cpu")
NAME = "fast_livo2_semantic.stream"


@pytest.fixture
def cell(tiny_cell):
    c = tiny_cell(NAME)
    c.params.update(pool_frames=24, warm_frames=8, stretch_units=5)
    c.config["segmenter"]["architecture"].update(
        img_size=256, embed_dims=[16, 32, 40, 80], prompt_embed_dim=32, decoder_mlp_dim=64,
        iou_head_hidden_dim=32)
    return c


def _run(cell, traced=False):
    return bench_run.run(cell, 2 ** 31 + 41, 1.0, traced, CPU, time.perf_counter())


def test_sound_run_is_correct(cell):
    out = _run(cell, traced=True)
    assert out["correct"], out["checks"]
    assert {"sam_gap", "mask_gap", "assoc_gap", "loss_gap"} <= set(out["checks"])
    m = out["metrics"]
    # a CPU run has no CUDA events or device trace: the host-side readers report
    assert m["segment_ms.semantic"]["value"] > 0 and m["mfu.semantic"]["value"] > 0
    assert m["segment_syncs_per_keyframe.semantic"]["value"] >= 4
    assert "sam_device_ms.semantic" not in m and "sam_encode_roofline.semantic" not in m
    r = ps.records()
    assert r.count("segment") == r.count("sam.encode") == 1  # frame 0 of 5
    assert r.counter("segment.boxes") == r.counter("segment.masks") > 0


def _perturbed_decode(orig, model, features, boxes, *a, **k):
    masks, iou = orig(model, features, boxes, *a, **k)
    return masks * 1.001, iou


def _no_association(orig, self, xyz, active, mask, *a, **k):
    orig(self, xyz, active, mask, *a, **k)
    return mask


def _swapped_crop(orig, pred, low_res):
    """`postprocess_masks` with the crop's rows and columns swapped."""
    S = pred.model.img_size
    m = torch.nn.functional.interpolate(low_res[:, None], (S, S), mode="bilinear",
                                        align_corners=False)
    m = m[..., : pred.input_size[1], : pred.input_size[0]]
    return torch.nn.functional.interpolate(m, pred.original_size, mode="bilinear",
                                           align_corners=False)[:, 0]


@pytest.mark.parametrize("fault", ["decode", "crop", "threshold", "associate"])
def test_a_broken_segmenter_is_not_correct(cell, monkeypatch, fault):
    from sags_tpu_torch.models import mobile_sam as ms
    from sags_tpu_torch.semantics import association

    if fault == "threshold":  # masks cut at 0.5 where SAM cuts at 0.0
        monkeypatch.setattr(ms.MobileSAM, "mask_threshold", 0.5)
    else:
        owner, attr, fn = {"decode": (ms.MobileSAM, "decode", _perturbed_decode),
                           "crop": (ms.MobileSamPredictor, "postprocess_masks", _swapped_crop),
                           "associate": (association.DeviceInstanceAssociator, "associate",
                                         _no_association)}[fault]
        orig = getattr(owner, attr)
        monkeypatch.setattr(owner, attr, lambda *a, **k: fn(orig, *a, **k))
    out = _run(cell)
    assert not out["correct"]
    bad = [k for k, t in out["checks"].items() if t["value"] is None or t["value"] > t["limit"]]
    assert bad == {"decode": ["sam_gap", "mask_gap"], "crop": ["mask_gap"],
                   "threshold": ["mask_gap"], "associate": ["assoc_gap"]}[fault], out["checks"]


def test_the_control_is_not_correct_and_the_identity_reads_high(cell):
    from benchmarks import control

    out = control.readings(cell, 2 ** 31 + 43, 1.0, CPU)
    assert out["program"]["correct"], out["program"]
    assert not out["control"]["correct"], out["control"]
    assert out["control"]["checks"]["sam_gap"]["value"] > cell.limits["sam_gap"]
    assert out["control"]["checks"]["mask_gap"]["value"] > cell.limits["mask_gap"]
    assert out["faults"]["assoc_gap.identity"] > 10 * cell.limits["assoc_gap"]
    assert out["faults"]["mask_gap.no_crop"] > 10 * cell.limits["mask_gap"]


def test_the_cell_is_in_the_benchmark():
    bench = spec.benchmark()
    w = {x["name"]: x for x in bench["workloads"]}[NAME]
    assert (w["config"], w["traffic"], w["chips"]) == ("fast_livo2_semantic",
                                                       "semantic_stream", 1)
    ends = [m["name"] for m in spec.metrics_of(bench, NAME, "end_to_end")]
    assert ends == ["frame_ms", "setup_s"]
    layers = {m["name"] for m in spec.metrics_of(bench, NAME, "per_layer")}
    assert layers == {"segment_ms.semantic", "sam_device_ms.semantic",
                      "sam_encode_roofline.semantic", "segment_syncs_per_keyframe.semantic",
                      "mfu.semantic"}
