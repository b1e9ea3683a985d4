"""EfficientViT-SAM-L2 in the port (`models/efficientvit_sam.py`, selected by
`MobileSAMConfig(encoder="efficientvit_l2")`) against the benchmark's plain
reference (`benchmarks/reference/efficientvit_sam.py`) on weights the
reference draws from a seed in the published `state_dict` layout and the
port loads through `mobile_sam.load_checkpoint`: LiteMLA alone (and its
normalisation where a query's ReLU is all zero), each block kind, the
encoder at its published widths, the encoder with the shared decoder
through `MobileSamPredictor`, the checkpoint layout, the SLAM pipeline with
an L2 mask generator under the profiler (its spans and counter) and the
CLI's `efficientvit_l2` backend. CPU only, no JAX.

Bars: the port folds each BatchNorm into its convolution and computes GELU
and the reductions in other orders than the reference, float32 rounding
that reads ~1e-6 of the largest output here; `REL` leaves about twenty
times that. The reference with its convolutions' and matrix products'
inputs rounded to TF32 reads ~1e-3, and each comparison checks that it
fails the bar by ten times, so the bar could tell float32 from TF32."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.harness import efficientvit_work
from benchmarks.reference import efficientvit_sam as ref
from benchmarks.reference import mobile_sam as rms
from sags_tpu_torch.cli import main as cli
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.models import efficientvit_sam as evs
from sags_tpu_torch.models import mobile_sam as ms
from sags_tpu_torch.semantics.masks import MaskGenerator
from sags_tpu_torch.slam.pipeline import SLAMPipeline
from sags_tpu_torch.utils import profiling

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

REL = 2e-5
L2 = ms.MobileSAMConfig(encoder="efficientvit_l2")
# the published widths, depths and heads on a 256 canvas (a 16x16 embedding)
L2_256 = dataclasses.replace(L2, img_size=256)
# every depth, the head dim and the scales as published, at a quarter of the
# widths (4 heads in the last stage)
REDUCED = dataclasses.replace(L2_256, width_list=(8, 16, 32, 64, 128), neck_width=64,
                              prompt_embed_dim=32, decoder_mlp_dim=64, iou_head_hidden_dim=32)


def _arch(c: ms.MobileSAMConfig) -> dict:
    return dataclasses.asdict(c)


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _x(shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def l2():
    """(the port's L2 model at the published widths on a 256 canvas with the
    reference's weights, those weights)."""
    p = ref.init_weights(_arch(L2_256), 21)
    return ms.load_checkpoint(ms.MobileSAM(L2_256, device="cpu"), p), p


@torch.no_grad()
def _compare(fn_port, fn_ref, x):
    got, want = fn_port(x), fn_ref(x)
    assert got.shape == want.shape
    assert _gap(got, want) < REL
    with rms.tf32():
        assert _gap(fn_ref(x), want) > 10 * REL
    return want


def test_lite_mla_at_published_head_dim_and_scales(l2):
    """The last stage's first LiteMLA (512 channels: 16 heads of 32, the 5x5
    aggregate to 32 heads) on an 8x8 grid, with its `proj` and BatchNorm."""
    m, p = l2
    name = "image_encoder.backbone.stages.4.op_list.1.context_module.main"
    mla = m.image_encoder.backbone.stages[4].op_list[1].context_module.main
    want = _compare(mla, lambda x: ref.lite_mla(x, p, name, _arch(L2_256)), _x((1, 512, 8, 8), 1))
    assert want.shape == (1, 512, 8, 8)


def test_relu_linear_attention_where_a_query_is_all_negative():
    """32 heads of [q|k|v] x 32 on a 6x6 grid, with head 3's query at cell
    10 all negative: ReLU makes it zero, so its ones row sums to 0 and the
    division meets only the 1e-15, giving 0, in the port as in the
    reference; every other cell normalises."""
    qkv = _x((2, 32 * 96, 6, 6), 2)
    q = qkv.view(2, 32, 96, 36)[:, 3, :32, 10]
    q.copy_(-q.abs() - 0.1)
    got = evs.relu_linear_attention(qkv, 32)
    want = _compare(lambda x: evs.relu_linear_attention(x, 32),
                    lambda x: ref.relu_linear_att(x, 32), qkv)
    cell = got.view(2, 32, 32, 36)[:, 3, :, 10]
    assert torch.equal(cell, torch.zeros_like(cell))
    assert torch.equal(want.view(2, 32, 32, 36)[:, 3, :, 10], cell)
    assert float(want.abs().min(dim=1).values.max()) > 0  # elsewhere the rows normalise


# kind: (module path under the backbone, the reference's block, input channels, stride)
BLOCKS = {
    "stem": ("stages.0", None, 3, 2),
    "res": ("stages.0.op_list.1", "res", 32, 1),
    "fmb_down": ("stages.1.op_list.0", "fmb", 32, 2),
    "fmb": ("stages.2.op_list.1", "fmb", 128, 1),
    "mb_down": ("stages.3.op_list.0", "mb", 128, 2),
    "mb": ("stages.3.op_list.1", "mb", 256, 1),
    "efficientvit": ("stages.4.op_list.2", "att", 512, 1),
}


def _res(x, p, b):
    return ref.conv_layer(ref.conv_layer(x, p, b + ".conv1", act=True), p, b + ".conv2") + x


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_each_block_kind(l2, kind):
    """Each kind of block at its stage's published widths, with its residual
    or none, on a grid that halves where it strides."""
    m, p = l2
    path, fn, c_in, stride = BLOCKS[kind]
    mod = m.image_encoder.backbone.get_submodule(path)
    name = "image_encoder.backbone." + path
    a = _arch(L2_256)

    def want(x):
        if fn is None:  # the stem: its conv and its ResBlock
            y = ref.conv_layer(x, p, name + ".op_list.0", 2, act=True)
            b = name + ".op_list.1.main"
            return _res(y, p, b)
        if fn == "res":
            return _res(x, p, name + ".main")
        if fn == "att":
            y = ref.lite_mla(x, p, name + ".context_module.main", a) + x
            return ref.mbconv(y, p, name + ".local_module.main") + y
        block = ref.fused_mbconv if fn == "fmb" else ref.mbconv
        y = block(x, p, name + ".main", stride)
        return y if stride == 2 else y + x

    side = 16 if fn != "att" else 8
    out = _compare(mod, want, _x((1, c_in, side, side), 3))
    assert out.shape[-1] == side // stride


def test_encoder_at_published_widths(l2):
    """The backbone [32,64,128,256,512] / [1,2,2,8,8] and the 12-block neck
    on a 256 canvas: stage grids 128 to 8, the neck on 16x16 (stage 2
    resized down, stage 3 kept, stage 4 resized up)."""
    m, p = l2
    x = _x((1, 3, 256, 256), 4)
    want = _compare(m.encode, lambda t: ref.encode(p, _arch(L2_256), t), x)
    assert want.shape == (1, 256, 16, 16)
    stages = ref.backbone(p, _arch(L2_256), x)
    assert [s.shape[-1] for s in stages] == [128, 64, 32, 16, 8]


def test_predictor_with_the_shared_decoder(l2):
    """A [3,H,W] frame in [0, 1] through `MobileSamPredictor`: the L2
    encoder, canvas boxes, SAM's decoder, `postprocess_masks` and the
    threshold at 0, against the reference's `predict` and `postprocess`."""
    m, p = l2
    img = torch.rand(3, 48, 64, generator=torch.Generator().manual_seed(5))
    pred = ms.MobileSamPredictor(m).set_image(img)
    boxes = pred.transform.apply_boxes(np.array([[0, 0, 64, 48], [5, 4, 30, 40]], np.float32),
                                       pred.original_size)
    low = pred.decode_boxes(boxes)
    r_masks, r_iou = ref.predict(p, _arch(L2_256), img, torch.as_tensor(boxes))
    assert low.shape == (2, 64, 64)
    assert _gap(low, r_masks[:, 0]) < REL
    assert _gap(m.decode(pred.features, torch.as_tensor(boxes))[1], r_iou) < REL
    up, r_up = pred.postprocess_masks(low), rms.postprocess(r_masks, (48, 64), 256)
    assert _gap(up, r_up) < REL
    far = r_up.abs() > REL * r_up.abs().max()
    assert torch.equal((up > m.mask_threshold)[far], (r_up > 0)[far])
    with rms.tf32():
        assert _gap(ref.predict(p, _arch(L2_256), img, torch.as_tensor(boxes))[0], r_masks) \
            > 10 * REL


def test_checkpoint_layout_loads():
    """The whole model's `state_dict` at the published widths as the
    reference lays it out (the L2 encoder under `image_encoder.`, SAM's
    prompt encoder and decoder) loads with every key the port holds
    matched; the encoder holds the floats `harness/efficientvit_work.py`
    counts; a missing key does not load."""
    sd = ref.init_weights(_arch(L2), 6)
    dst = ms.load_checkpoint(ms.MobileSAM(L2, seed=7, device="cpu"), sd)
    got = dst.state_dict()
    assert set(got) == {k for k in sd if not k.startswith(ms.UNUSED_PREFIXES)}
    assert all(torch.equal(v, sd[k]) for k, v in got.items())
    enc = sum(v.numel() for k, v in got.items()
              if k.startswith("image_encoder.") and v.is_floating_point())
    assert enc == efficientvit_work.n_floats(_arch(L2)) == 57_307_360
    assert sum(v.numel() for v in got.values()) == 61_367_304
    del sd["image_encoder.backbone.stages.4.op_list.8.context_module.main.aggreg.0.1.weight"]
    with pytest.raises(RuntimeError, match="aggreg"):
        ms.load_checkpoint(dst, sd)


def _cfg():
    return tconf.SLAMConfig(
        raster=tconf.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32),
        map=tconf.MapConfig(initial_capacity=4096, initial_scale=0.08),
        semantics=tconf.SemanticsConfig(cls3d_sample=32, num_classes=24),
        keyframes=tconf.KeyframeConfig(keyframe_freq=4, window=8),
        tracking=tconf.TrackingConfig(backend="gicp", max_points=512),
        gicp=tconf.GICPConfig(max_iterations=24, knn_max_distance=2.0),
        post_train_iters=0, metrics_interval=2)


def test_pipeline_with_l2_records_its_spans():
    """8 frames through `SLAMPipeline` with a reduced-width L2 mask
    generator under the profiler: keyframes 0 and 4 are segmented; each
    encode holds one `sam.encode.backbone` and one `sam.encode.neck`, the
    backbone 8 `sam.encode.mla`, each counting the 8x8 grid it attends
    over."""
    cfg = _cfg()
    frames = list(SyntheticDataset(n_frames=8, width=64, height=48, n_world=4096,
                                   pts_per_frame=512, step=0.1, clutter=0.3, device="cpu"))
    gen = MaskGenerator(sam=ms.MobileSAM(REDUCED, seed=5, device="cpu"),
                        num_classes=cfg.semantics.num_classes, seed=0)
    pipe = SLAMPipeline(cfg, mask_generator=gen, point_budget=512, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        res = pipe.run(frames, post_train=0)
    rec = profiling.records()
    assert res.n_keyframes == 2 and np.isfinite(res.losses).all()
    assert all(int(k.objects.max()) > 0 for k in pipe.keyframes)
    n = rec.count("sam.encode")
    assert n == 2 and rec.count("sam.encode.backbone") == rec.count("sam.encode.neck") == n
    assert rec.count("sam.encode.mla") == 8 * n
    assert rec.counter("sam.mla.tokens") == 8 * n * 8 * 8
    parent = {r.id: r.name for r in rec.spans}
    assert {parent[r.parent] for r in rec.named("sam.encode.backbone")} == {"sam.encode"}
    assert {parent[r.parent] for r in rec.named("sam.encode.neck")} == {"sam.encode"}
    assert {parent[r.parent] for r in rec.named("sam.encode.mla")} == {"sam.encode.backbone"}
    assert rec.summary()["sam.encode.mla"]["counters"] == {"sam.mla.tokens": 8 * n * 64}


def test_cli_builds_the_efficientvit_l2_backend(monkeypatch):
    """`run-slam --semantics --mask-backend efficientvit_l2` builds L2 at
    the published widths on the 1024 canvas behind the mask generator and
    the shared predictor (no frame is run)."""
    built = []
    monkeypatch.setattr(cli, "cmd_run_slam", lambda args: built.append(
        cli.mask_generator(args, tconf.SLAMConfig(), "cpu")))
    cli.main(["run-slam", "--semantics", "--mask-backend", "efficientvit_l2", "--device", "cpu"])
    gen = built[0]
    assert isinstance(gen, MaskGenerator) and isinstance(gen.predictor, ms.MobileSamPredictor)
    assert gen.sam.config == L2 and gen.sam.img_size == 1024
    assert isinstance(gen.sam.image_encoder, evs.EfficientViTSamImageEncoder)
    assert gen.batch_size == 32 and gen.imgsz == 256
