"""SAM ViT-H in the port (`models/sam_vit.py`, selected by
`MobileSAMConfig(encoder="sam_vit_h")`) against the benchmark's plain
reference (`benchmarks/reference/sam_vit_h.py`) on weights the reference
draws from a seed in the published `state_dict` layout and the port loads
through `mobile_sam.load_checkpoint`: `get_rel_pos` and the decomposed
relative-position add against direct loops, one windowed and one global
block at the published widths, the encoder at reduced widths on a grid that
pads and one that does not, the encoder with the shared decoder through
`MobileSamPredictor`, the checkpoint layout at the published widths (TinyViT's
and L2's unchanged), the SLAM pipeline with a ViT-H mask generator under the
profiler (its spans and counters) and the CLI's `sam_vit_h` backend. CPU
only, no JAX.

Bars: the port adds the relative-position terms in place and reduces
LayerNorm, GELU and the products in other orders than the reference,
float32 rounding that reads ~1e-6 of the largest output here; `REL` leaves
about twenty times that. The reference with its convolutions', matrix
products' and einsums' inputs rounded to TF32 reads ~1e-3, and each
comparison checks that it fails the bar by ten times, so the bar could tell
float32 from TF32."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.harness import efficientvit_work, sam_vit_h_work
from benchmarks.reference import efficientvit_sam as rev
from benchmarks.reference import mobile_sam as rms
from benchmarks.reference import sam_vit_h as ref
from sags_tpu_torch.cli import main as cli
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.models import efficientvit_sam as evs
from sags_tpu_torch.models import mobile_sam as ms
from sags_tpu_torch.models import sam_vit as sv
from sags_tpu_torch.semantics.masks import MaskGenerator
from sags_tpu_torch.slam.pipeline import SLAMPipeline
from sags_tpu_torch.utils import profiling

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

REL = 2e-5
VIT_H = ms.MobileSAMConfig(encoder="sam_vit_h")
# ViT-H's structure at a twentieth of its width (4 heads of 16), 4 blocks
# with two global, windows of 4, the decoder at reduced widths
REDUCED = dataclasses.replace(VIT_H, vit_embed_dim=64, vit_depth=4, vit_num_heads=4,
                              vit_global_attn_indexes=(1, 3), vit_window_size=4,
                              prompt_embed_dim=32, decoder_mlp_dim=64, iou_head_hidden_dim=32)
# a 10x10 grid, padded to 12x12 by the windows; an 8x8 grid, not padded
PADS, EXACT = dataclasses.replace(REDUCED, img_size=160), dataclasses.replace(REDUCED, img_size=128)


def _arch(c: ms.MobileSAMConfig) -> dict:
    return dataclasses.asdict(c)


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _x(shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def _compare(fn_port, fn_ref, x):
    got, want = fn_port(x), fn_ref(x)
    assert got.shape == want.shape
    assert _gap(got, want) < REL
    with rms.tf32():
        assert _gap(fn_ref(x), want) > 10 * REL
    return want


def test_get_rel_pos_against_a_direct_loop():
    """Each (query, key) offset of a 7-wide axis reads the table's row
    `q − k + 6`, as the reference's published `get_rel_pos` does; a table of
    another length does not load."""
    t = _x((2 * 7 - 1, 5), 1)
    R = t[sv.rel_pos_index(7)]
    assert R.shape == (7, 7, 5)
    for i in range(7):
        for j in range(7):
            assert torch.equal(R[i, j], t[i - j + 6])
    assert torch.equal(R, ref.get_rel_pos(7, 7, t))
    attn = sv.ViTAttention(10, 2, 7)
    with pytest.raises(RuntimeError, match="rel_pos_h"):
        attn.load_state_dict(dict(attn.state_dict(), rel_pos_h=_x((2 * 6 - 1, 5), 2)))


def test_decomposed_add_against_a_direct_loop():
    """The in-place add on a 3x4 grid: logit (i·4+j, k·4+l) gains q·Rh[i,k]
    and q·Rw[j,l], the same as the reference's broadcast sum."""
    B, qh, qw, d = 2, 3, 4, 6
    q, attn = _x((B, qh * qw, d), 2), _x((B, qh * qw, qh * qw), 3)
    Rh, Rw = _x((qh, qh, d), 4), _x((qw, qw, d), 5)
    want = attn.clone()
    for b in range(B):
        for i in range(qh):
            for j in range(qw):
                for k in range(qh):
                    for m in range(qw):
                        qv = q[b, i * qw + j]
                        want[b, i * qw + j, k * qw + m] += qv @ Rh[i, k] + qv @ Rw[j, m]
    got = sv.add_decomposed_rel_pos_(attn.clone(), q, Rh, Rw, (qh, qw))
    assert torch.allclose(got, want, rtol=0, atol=1e-5)  # float32 sums of 6 terms in two orders
    ph, pw = _x((2 * qh - 1, d), 6), _x((2 * qw - 1, d), 7)
    r = ref.add_decomposed_rel_pos(attn, q, ph, pw, (qh, qw), (qh, qw))
    p = sv.add_decomposed_rel_pos_(attn.clone(), q, ph[sv.rel_pos_index(qh)],
                                   pw[sv.rel_pos_index(qw)], (qh, qw))
    assert torch.equal(p, r)  # the same two additions in the same order


@pytest.fixture(scope="module")
def one_block():
    """(the published widths with one block, windowed or global, on a
    256 canvas: its weights) for each kind."""
    out = {}
    for kind, glob in (("window", ()), ("global", (0,))):
        c = dataclasses.replace(VIT_H, img_size=256, vit_depth=1, vit_global_attn_indexes=glob)
        out[kind] = c, ref.init_weights(_arch(c), 11)
    return out


@pytest.mark.parametrize("kind", ["window", "global"])
def test_one_block_at_published_widths(one_block, kind):
    """A block of width 1280, 16 heads of 80, MLP 5120, on the 16x16 grid:
    windowed, 14x14 windows over the grid padded to 28x28 (tables of 27
    rows); or global over its 256 tokens (tables of 31 rows)."""
    c, p = one_block[kind]
    window = c.vit_window_size if kind == "window" else 0
    blk = sv.ViTBlock(c, window)
    pre = "image_encoder.blocks.0."
    blk.load_state_dict({k[len(pre):]: v for k, v in p.items() if k.startswith(pre)})
    assert blk.attn.rel_pos_h.shape == ((27 if window else 31), 80)
    want = _compare(blk, lambda x: ref.block(x, p, pre[:-1], _arch(c), window),
                    _x((1, 16, 16, 1280), 8))
    assert want.shape == (1, 16, 16, 1280)


@pytest.mark.parametrize("c", [PADS, EXACT], ids=["pads", "exact"])
def test_encoder_at_reduced_widths(c):
    """Every kind of step of the encoder (patch embedding, position
    embedding, windowed and global blocks, the neck) on a 10x10 grid that
    the windows pad to 12x12 and on an 8x8 grid they do not."""
    p = ref.init_weights(_arch(c), 12)
    m = ms.load_checkpoint(ms.MobileSAM(c, device="cpu"), p)
    want = _compare(m.encode, lambda t: ref.encode(p, _arch(c), t), _x((1, 3, c.img_size,
                                                                          c.img_size), 9))
    assert want.shape == (1, 32, c.grid, c.grid)


def test_predictor_with_the_shared_decoder():
    """A [3,H,W] frame in [0, 1] through `MobileSamPredictor`: the ViT-H
    encoder, canvas boxes, SAM's decoder, `postprocess_masks` and the
    threshold at 0, against the reference's `predict` and `postprocess`."""
    p = ref.init_weights(_arch(PADS), 13)
    m = ms.load_checkpoint(ms.MobileSAM(PADS, device="cpu"), p)
    img = torch.rand(3, 48, 64, generator=torch.Generator().manual_seed(5))
    pred = ms.MobileSamPredictor(m).set_image(img)
    boxes = pred.transform.apply_boxes(np.array([[0, 0, 64, 48], [5, 4, 30, 40]], np.float32),
                                       pred.original_size)
    low = pred.decode_boxes(boxes)
    r_masks, r_iou = ref.predict(p, _arch(PADS), img, torch.as_tensor(boxes))
    assert low.shape == (2, 40, 40)
    assert _gap(low, r_masks[:, 0]) < REL
    assert _gap(m.decode(pred.features, torch.as_tensor(boxes))[1], r_iou) < REL
    up, r_up = pred.postprocess_masks(low), rms.postprocess(r_masks, (48, 64), 160)
    assert _gap(up, r_up) < REL
    far = r_up.abs() > REL * r_up.abs().max()
    assert torch.equal((up > m.mask_threshold)[far], (r_up > 0)[far])
    with rms.tf32():
        assert _gap(ref.predict(p, _arch(PADS), img, torch.as_tensor(boxes))[0], r_masks) \
            > 10 * REL


def _meta_keys(module, prefix="image_encoder."):
    return {prefix + k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_checkpoint_layout():
    """At the published widths (built on the meta device: shapes alone) the
    encoder's `state_dict` is the reference's layout, key for key and shape
    for shape, and holds the floats `harness/sam_vit_h_work.py` counts;
    TinyViT's and L2's encoders keep theirs. At reduced widths the whole
    model's `state_dict` loads with every key matched and a missing table
    does not load."""
    with torch.device("meta"):
        enc = sv.ImageEncoderViT(VIT_H)
        tiny, l2 = ms.TinyViT(ms.MobileSAMConfig()), evs.EfficientViTSamImageEncoder(
            ms.MobileSAMConfig(encoder="efficientvit_l2"))
    a = _arch(VIT_H)
    assert _meta_keys(enc) == {n: s for n, s, _ in ref._encoder_shapes(a)}
    assert sum(v.numel() for v in enc.state_dict().values()) == sam_vit_h_work.n_floats(a) \
        == 637_026_048
    want_tiny = {n: s for n, s, _ in rms._shapes(_arch(ms.MobileSAMConfig()))
                 if n.startswith("image_encoder.") and not n.startswith(ms.UNUSED_PREFIXES)}
    assert _meta_keys(tiny) == want_tiny
    l2_arch = _arch(ms.MobileSAMConfig(encoder="efficientvit_l2"))
    assert _meta_keys(l2) == {n: s for n, s, _ in rev._encoder_shapes(l2_arch)}
    assert sum(v.numel() for k, v in l2.state_dict().items()
               if not k.endswith("num_batches_tracked")) == efficientvit_work.n_floats(l2_arch)
    sd = ref.init_weights(_arch(PADS), 6)
    dst = ms.load_checkpoint(ms.MobileSAM(PADS, seed=7, device="cpu"), sd)
    got = dst.state_dict()
    assert set(got) == {k for k in sd if not k.startswith(ms.UNUSED_PREFIXES)}
    assert all(torch.equal(v, sd[k]) for k, v in got.items())
    del sd["image_encoder.blocks.3.attn.rel_pos_w"]
    with pytest.raises(RuntimeError, match="rel_pos_w"):
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


def test_pipeline_with_vit_h_records_its_spans():
    """8 frames through `SLAMPipeline` with a reduced-width ViT-H mask
    generator on the 10x10 grid under the profiler: keyframes 0 and 4 are
    segmented; each encode holds 2 `sam.encode.global_attn` (100 tokens
    each), 2 `sam.encode.window_attn` (44 padded tokens each: 12² − 10²)
    and one `sam.encode.neck`."""
    cfg = _cfg()
    frames = list(SyntheticDataset(n_frames=8, width=64, height=48, n_world=4096,
                                   pts_per_frame=512, step=0.1, clutter=0.3, device="cpu"))
    gen = MaskGenerator(sam=ms.MobileSAM(PADS, seed=5, device="cpu"),
                        num_classes=cfg.semantics.num_classes, seed=0)
    pipe = SLAMPipeline(cfg, mask_generator=gen, point_budget=512, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        res = pipe.run(frames, post_train=0)
    rec = profiling.records()
    assert res.n_keyframes == 2 and np.isfinite(res.losses).all()
    assert all(int(k.objects.max()) > 0 for k in pipe.keyframes)
    n = rec.count("sam.encode")
    assert n == 2 and rec.count("sam.encode.neck") == n
    assert rec.count("sam.encode.global_attn") == rec.count("sam.encode.window_attn") == 2 * n
    assert rec.counter("sam.attn.global_tokens") == 2 * n * 100
    assert rec.counter("sam.attn.pad_tokens") == 2 * n * 44
    parent = {r.id: r.name for r in rec.spans}
    for name in ("sam.encode.global_attn", "sam.encode.window_attn", "sam.encode.neck"):
        assert {parent[r.parent] for r in rec.named(name)} == {"sam.encode"}
    s = rec.summary()
    assert s["sam.encode.global_attn"]["counters"] == {"sam.attn.global_tokens": 2 * n * 100}
    assert s["sam.encode.window_attn"]["counters"] == {"sam.attn.pad_tokens": 2 * n * 44}


def test_cli_builds_the_sam_vit_h_backend(monkeypatch):
    """`run-slam --semantics --mask-backend sam_vit_h` asks for ViT-H at the
    published widths on the 1024 canvas behind the mask generator and the
    shared predictor (no frame is run; the model is built at reduced widths
    from the config the CLI asks for, so the CPU does not hold 2.5 GB)."""
    asked, built, build = [], [], ms.MobileSAM

    def small(config, seed=0, device=None):
        asked.append(config)
        return build(dataclasses.replace(config, **{
            f.name: getattr(PADS, f.name) for f in dataclasses.fields(PADS)
            if f.name.startswith("vit_") or f.name in ("img_size", "prompt_embed_dim",
                                                       "decoder_mlp_dim",
                                                       "iou_head_hidden_dim")}),
            seed=seed, device=device)

    monkeypatch.setattr(ms, "MobileSAM", small)
    monkeypatch.setattr(cli, "cmd_run_slam", lambda args: built.append(
        cli.mask_generator(args, tconf.SLAMConfig(), "cpu")))
    cli.main(["run-slam", "--semantics", "--mask-backend", "sam_vit_h", "--device", "cpu"])
    gen = built[0]
    assert asked == [VIT_H]
    c = asked[0]
    assert (c.img_size, c.grid, c.vit_embed_dim, c.vit_depth, c.vit_num_heads,
            c.vit_global_attn_indexes, c.vit_window_size, c.vit_patch_size, c.vit_mlp_ratio) == (
        1024, 64, 1280, 32, 16, (7, 15, 23, 31), 14, 16, 4.0)
    assert isinstance(gen, MaskGenerator) and isinstance(gen.predictor, ms.MobileSamPredictor)
    assert isinstance(gen.sam.image_encoder, sv.ImageEncoderViT)
    assert gen.batch_size == 32 and gen.imgsz == 256
