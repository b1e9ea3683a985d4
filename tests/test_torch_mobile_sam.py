"""MobileSAM in the port (`models/mobile_sam.py`) against the benchmark's
plain reference (`benchmarks/reference/mobile_sam.py`) on weights the
reference draws from a seed in MobileSAM's checkpoint layout and the port
loads through `load_checkpoint`: the encoder at the published widths, the
whole predictor at reduced widths with `postprocess_masks` and the
threshold, the decoder at its published widths, the device
association on a planted label map, the SLAM pipeline with a MobileSAM mask
generator under the profiler (spans and counters), the CLI's `mobile_sam`
backend and the checkpoint loader. CPU only, no JAX.

Bars: the port folds each BatchNorm into its convolution and reduces in
other orders than the reference, float32 rounding that reads ~1e-6 of the
largest logit here; `REL` leaves ten times that. The reference with its
matrix products' inputs rounded to TF32 reads ~2e-3, and each comparison
checks that it fails the bar, so the bar could tell float32 from TF32."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.reference import mobile_sam as ref
from sags_tpu_torch.cli import main as cli
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.models import mobile_sam as ms
from sags_tpu_torch.semantics.association import DeviceInstanceAssociator
from sags_tpu_torch.semantics.masks import MaskGenerator
from sags_tpu_torch.slam.pipeline import SLAMPipeline
from sags_tpu_torch.utils import profiling

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

REL = 2e-5
# the published block structure (depths, heads' split, windows, strides) at
# a quarter of the widths, on a 256 canvas
REDUCED = ms.MobileSAMConfig(img_size=256, embed_dims=(16, 32, 40, 80), prompt_embed_dim=32,
                             decoder_mlp_dim=64, iou_head_hidden_dim=32)


def _arch(c: ms.MobileSAMConfig) -> dict:
    return dataclasses.asdict(c)


def _model(c: ms.MobileSAMConfig, seed: int):
    """(the port's model with the reference's weights, those weights)."""
    p = ref.init_weights(_arch(c), seed)
    return ms.load_checkpoint(ms.MobileSAM(c, device="cpu"), p), p


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _boxes(S: int) -> torch.Tensor:
    return torch.tensor([[0.0, 0.0, S, S], [10.0, 20.0, 0.4 * S, 0.6 * S],
                         [0.5 * S, 0.25 * S, S - 3.0, S - 7.0]])


def test_encoder_at_published_widths():
    """TinyViT [64,128,160,320] / [2,2,6,2] / heads [2,4,5,10] / windows
    [7,7,14,7] and the neck on a 224 canvas: windows padded at every stage
    (56, 28 and 14 tokens a side) and the stride-1 merging into the last."""
    c = ms.MobileSAMConfig(img_size=224)
    m, p = _model(c, 11)
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    got = m.encode(x)
    want = ref.encode(p, _arch(c), x)
    assert got.shape == (1, 256, 14, 14)
    assert _gap(got, want) < REL
    with ref.tf32():
        assert _gap(ref.encode(p, _arch(c), x), want) > 10 * REL


def test_decoder_at_published_widths():
    """The two-way transformer (256 wide, 8 heads, mlp 2048, cross-attention
    at 128), the upscaling and the hypernetworks: mask 0's logits and IoU 0
    for boxes on a 16x16 embedding."""
    c = ms.MobileSAMConfig(img_size=256)
    m, p = _model(c, 12)
    feats = torch.randn(1, 256, 16, 16, generator=torch.Generator().manual_seed(2))
    boxes = _boxes(256)
    masks, iou = m.decode(feats, boxes)
    r_masks, r_iou = ref.decode(p, _arch(c), feats, boxes)
    assert masks.shape == (3, 1, 64, 64) and iou.shape == (3, 1)
    assert _gap(masks, r_masks) < REL and _gap(iou, r_iou) < REL
    with ref.tf32():
        assert _gap(ref.decode(p, _arch(c), feats, boxes)[0], r_masks) > 10 * REL


def test_predictor_at_reduced_widths():
    """The whole path from a [3,H,W] frame in [0, 1]: pixel normalisation,
    the longest side to the canvas, padding, the encoder, canvas boxes, the
    decoder; then `postprocess_masks` to the frame's size and the threshold
    at 0: the logits against the reference's `postprocess`, and every mask
    pixel on the reference's side of 0 where the logits lie apart by more
    than the bar."""
    m, p = _model(REDUCED, 13)
    img = torch.rand(3, 48, 64, generator=torch.Generator().manual_seed(3))
    pred = ms.MobileSamPredictor(m).set_image(img)
    assert pred.original_size == (48, 64) and pred.input_size == (192, 256)
    boxes = pred.transform.apply_boxes(np.array([[0, 0, 64, 48], [5, 4, 30, 40]], np.float32),
                                       pred.original_size)
    np.testing.assert_allclose(boxes[1], [20, 16, 120, 160])
    low = pred.decode_boxes(boxes)
    r_masks, r_iou = ref.predict(p, _arch(REDUCED), img, torch.as_tensor(boxes))
    assert _gap(low, r_masks[:, 0]) < REL
    assert _gap(m.decode(pred.features, torch.as_tensor(boxes))[1], r_iou) < REL
    up, r_up = pred.postprocess_masks(low), ref.postprocess(r_masks, (48, 64), 256)
    assert up.shape == r_up.shape == (2, 48, 64)
    assert _gap(up, r_up) < REL
    far = r_up.abs() > REL * r_up.abs().max()
    assert torch.equal((up > m.mask_threshold)[far], (r_up > 0)[far])
    assert 0 < int((r_up > 0).sum()) < r_up.numel()  # both signs occur
    # the crop matters here: the canvas holds the frame in rows 0-191 of 256
    assert _gap(ref.postprocess(r_masks, (48, 64), 256, crop=False), r_up) > 100 * REL
    # the HWC layout of an array gives the same features
    hwc = ms.MobileSamPredictor(m).set_image(img.permute(1, 2, 0).numpy())
    assert torch.equal(hwc.features, pred.features)


@pytest.mark.parametrize("window,n_offsets", [(7, 49), (14, 196)])
def test_bias_table(window, n_offsets):
    """One learned bias per distinct (|dx|,|dy|), numbered as TinyViT numbers
    them (the checkpoint's `attention_biases` columns)."""
    n, idx = ms.bias_index(window)
    assert n == n_offsets and idx.shape == (window ** 2, window ** 2)
    assert torch.equal(idx, ref._offsets(window))
    assert idx[0, 0] == 0 and int(idx.max()) == n - 1


def test_association_on_a_planted_label_map():
    """Slots labelled 3 and 5 at the last keyframe now fall in regions the
    generator labelled 7 and 9: 7 and 9 take 3 and 5 back; a fresh label
    with no previous owner keeps its value; inactive slots stay -1. The
    port's device associator equals the reference, and the identity
    mapping does not."""
    H, W, L = 24, 32, 12
    g = torch.Generator().manual_seed(4)
    u = torch.randint(0, W, (400,), generator=g).float()
    v = torch.randint(0, H, (400,), generator=g).float()
    fx = fy = 20.0
    cx, cy = W / 2, H / 2
    z = 2.0 + torch.rand(400, generator=g)
    xyz = torch.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], 1)
    active = torch.ones(400, dtype=torch.bool)
    active[-20:] = False
    mask = torch.zeros(H, W, dtype=torch.int32)
    mask[:, : W // 2] = 7
    mask[:, W // 2:] = 9
    mask[: H // 4, :] = 4
    prev = torch.where(u < W / 2, 3, 5).to(torch.int32)
    prev[-40:] = -1  # slots added since the last keyframe abstain
    pose = torch.eye(4)
    assoc = DeviceInstanceAssociator(0.5, num_classes=L)
    assoc._prev_labels = prev.clone()
    used = {4, 7, 9}
    got = assoc.associate(xyz, active, mask, pose, (fx, fy, cx, cy), used_labels=used)
    want, want_labels = ref.associate(xyz, active, mask, prev, pose, (fx, fy, cx, cy), L)
    assert torch.equal(got.long(), want) and torch.equal(assoc._prev_labels.long(), want_labels)
    assert set(torch.unique(got).tolist()) == {3, 4, 5} and used == {4}
    assert (want_labels[~active] == -1).all()
    ident, _ = ref.associate(xyz, active, mask, prev, pose, (fx, fy, cx, cy), L, identity=True)
    assert torch.equal(ident, mask.long())


def _cfg():
    return tconf.SLAMConfig(
        raster=tconf.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32),
        map=tconf.MapConfig(initial_capacity=4096, initial_scale=0.08),
        semantics=tconf.SemanticsConfig(cls3d_sample=32, num_classes=24),
        keyframes=tconf.KeyframeConfig(keyframe_freq=4, window=8),
        tracking=tconf.TrackingConfig(backend="gicp", max_points=512),
        gicp=tconf.GICPConfig(max_iterations=24, knn_max_distance=2.0),
        post_train_iters=0, metrics_interval=2)


def test_pipeline_with_mobile_sam_records_its_spans():
    """12 frames through `SLAMPipeline` with a reduced-width MobileSAM mask
    generator under the profiler: keyframes 0, 4 and 8 carry labels, each
    segmented in a `segment` span holding the generator's spans and
    `associate`, with its boxes and masks counted."""
    cfg = _cfg()
    frames = list(SyntheticDataset(n_frames=12, width=64, height=48, n_world=4096,
                                   pts_per_frame=512, step=0.1, clutter=0.3, device="cpu"))
    gen = MaskGenerator(sam=ms.MobileSAM(REDUCED, seed=5, device="cpu"),
                        num_classes=cfg.semantics.num_classes, seed=0)
    pipe = SLAMPipeline(cfg, mask_generator=gen, point_budget=512, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        res = pipe.run(frames, post_train=0)
    rec = profiling.records()
    assert res.n_keyframes == 3 and len(res.losses) == 12 and np.isfinite(res.losses).all()
    assert all(int(k.objects.max()) > 0 for k in pipe.keyframes)
    assert rec.count("segment") == rec.count("associate") == rec.count("sam.encode") == 3
    assert rec.count("segment.boxes") == rec.count("segment.paint") == 3
    assert rec.count("sam.decode") >= 3
    inside = {r.name for r in rec.within("segment")}
    assert inside == {"segment", "segment.boxes", "sam.encode", "sam.decode", "segment.paint",
                      "associate"}
    boxes, n_masks = rec.counter("segment.boxes"), rec.counter("segment.masks")
    assert boxes >= 3 and n_masks == boxes
    assert rec.syncs_within("segment") >= 3 * 4  # image, masks, label map, vote table
    assert rec.summary()["segment.boxes"]["counters"] == {"segment.boxes": boxes}


def test_cli_builds_the_mobile_sam_backend(monkeypatch):
    """`run-slam --semantics --mask-backend mobile_sam` builds MobileSAM at
    the published widths behind the mask generator (no frame is run)."""
    built = []
    monkeypatch.setattr(cli, "cmd_run_slam", lambda args: built.append(
        cli.mask_generator(args, tconf.SLAMConfig(), "cpu")))
    cli.main(["run-slam", "--semantics", "--mask-backend", "mobile_sam", "--device", "cpu"])
    gen = built[0]
    assert isinstance(gen, MaskGenerator) and isinstance(gen.predictor, ms.MobileSamPredictor)
    assert gen.sam.config == ms.MobileSAMConfig() and gen.sam.img_size == 1024
    assert gen.batch_size == 32 and gen.imgsz == 256


def test_checkpoint_layout_loads():
    """MobileSAM's `state_dict` at the published widths as the reference
    writes its layout, with the keys box prompts never use, loads: every
    tensor the port holds comes from it; a missing key does not load."""
    sd = ref.init_weights(_arch(ms.MobileSAMConfig()), 6)
    assert "image_encoder.head.weight" in sd and "prompt_encoder.mask_downscaling.0.weight" in sd
    dst = ms.load_checkpoint(ms.MobileSAM(seed=7, device="cpu"), sd)
    got = dst.state_dict()
    assert set(got) == {k for k in sd if not k.startswith(ms.UNUSED_PREFIXES)}
    assert all(torch.equal(v, sd[k]) for k, v in got.items())
    assert sum(v.numel() for v in got.values()) == 9_813_651
    del sd["mask_decoder.iou_token.weight"]
    with pytest.raises(RuntimeError, match="iou_token"):
        ms.load_checkpoint(dst, sd)
