"""Port parity: the semantic loop of `sags_tpu_torch` against `sags_tpu` on
the CPU. Box proposers, the geometric mask generator, ID association (host
and device), the synthetic ground-truth instances, SAM (weights, encoder,
prompt encoder, decoder, resizes, the mask generator) and a short
`SLAMPipeline.run` with a mask generator. Inputs are made from seeds with
numpy and handed to both packages."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core import config as jax_config
from sags_tpu.io.datasets import SyntheticDataset as JaxSynthetic
from sags_tpu.models import box_proposer as jbp
from sags_tpu.models.sam import SAM as JaxSAM
from sags_tpu.models.sam import PromptEncoder as JaxPromptEncoder
from sags_tpu.models.sam import ResizeLongestSide as JaxResize
from sags_tpu.models.sam_train import load_pretrained as jax_load_pretrained
from sags_tpu.semantics import association as jas
from sags_tpu.semantics.geometric import GeometricMaskGenerator as JaxGeometric
from sags_tpu.semantics.masks import MaskGenerator as JaxMaskGenerator
from sags_tpu.slam.pipeline import SLAMPipeline as JaxPipeline
from sags_tpu_torch import interop
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.io.datasets import Frame as TorchFrame
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.models import box_proposer as tbp
from sags_tpu_torch.models import sam as tsam
from sags_tpu_torch.semantics import association as tas
from sags_tpu_torch.semantics.geometric import GeometricMaskGenerator
from sags_tpu_torch.semantics.masks import MaskGenerator
from sags_tpu_torch.slam import fused as fused_mod
from sags_tpu_torch.slam.pipeline import SLAMPipeline
from sags_tpu_torch.utils.draws import ReplayDraws
from test_torch_pipeline import N_FRAMES, W, H, _cfg, _jax_draws

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

# SAM in float32 against flax with the same weights: measured 1.9e-6 on the
# encoder's features (magnitude 4.4) and 1.7e-5 on the decoder's logits
# (magnitude 32); the sums run in another order
SAM_ATOL = 1e-4


def _blocky_image(rng, h, w, n_colors=5, block=8):
    """A label-like image: random colour blocks with a little noise."""
    pal = rng.uniform(0.05, 0.95, (n_colors, 3))
    lab = rng.integers(0, n_colors, (-(-h // block), -(-w // block)))
    lab = np.repeat(np.repeat(lab, block, 0), block, 1)[:h, :w]
    return np.clip(pal[lab] + rng.normal(0, 0.02, (h, w, 3)), 0, 1).astype(np.float32)


# -- box proposers ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_proposers_match_jax(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, (30, 41))
    np.testing.assert_array_equal(tbp._connected_components(labels),
                                  jbp._connected_components(labels))
    boxes = np.sort(rng.uniform(0, 100, (40, 2, 2)), axis=1).reshape(40, 4).astype(np.float32)
    boxes = boxes[:, [0, 2, 1, 3]]
    scores = rng.uniform(size=40).astype(np.float32)
    np.testing.assert_array_equal(tbp.nms_xyxy(boxes, scores, 0.5),
                                  jbp.nms_xyxy(boxes, scores, 0.5))
    img = _blocky_image(rng, 96, 128)
    for chw in (False, True):
        im = img.transpose(2, 0, 1) if chw else img * 255.0
        got = tbp.ObjectAwareModel(seed=seed)(im)[0].boxes.xyxy
        want = jbp.ObjectAwareModel(seed=seed)(im)[0].boxes.xyxy
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tbp.GridBoxProposer(3, 4)(im)[0].boxes.xyxy,
                                      jbp.GridBoxProposer(3, 4)(im)[0].boxes.xyxy)


# -- the geometric mask generator ----------------------------------------------


@pytest.fixture(scope="module")
def quality_frames():
    """The port's dataset at `tests/test_semantics_quality.py`'s operating
    point, and its first two frames."""
    ds = SyntheticDataset(n_frames=2, width=160, height=120, n_world=8192,
                          pts_per_frame=1024, clutter=0.4, seed=2, device="cpu")
    frames = list(ds)
    return ds, frames


def test_geometric_generator_matches_jax(quality_frames):
    _, frames = quality_frames
    for depth in (False, True):
        t_gen = GeometricMaskGenerator(n_clusters=12, work_size=120, seed=0)
        j_gen = JaxGeometric(n_clusters=12, work_size=120, seed=0)
        for f in frames:
            d = f.depth if depth else None
            got = t_gen.generate_objects(f.image, d)
            want = j_gen.generate_objects(f.image, d)
            np.testing.assert_array_equal(got, want)
            assert t_gen.used_labels == j_gen.used_labels
            assert len(np.unique(got)) > 2


def test_gt_objects_match_jax(quality_frames):
    """The port's ground-truth instances (its own classic rasterizer)
    against the JAX package's on the same world and camera."""
    ds, _ = quality_frames
    jds = JaxSynthetic(n_frames=2, width=160, height=120, n_world=8192,
                       pts_per_frame=1024, clutter=0.4, seed=2)
    for i in range(2):
        got, want = ds.gt_objects(i), jds.gt_objects(i)
        assert got.dtype == np.int32 and got.shape == (120, 160)
        assert (got == want).mean() >= 0.999, (got != want).sum()
        assert len(np.unique(want)) > 3


# -- association ---------------------------------------------------------------


def test_host_association_matches_jax():
    """`tests/test_io_semantics.py`'s fixtures through both packages."""
    pts = np.array([[0.0, 0.0, 2.0], [1.0, 0.5, 2.0]], np.float32)
    for lidar in (False, True):
        got = tas.project_points_pinhole(pts, np.eye(4), 100, 100, 32, 24, 64, 48, lidar)
        want = jas.project_points_pinhole(pts, np.eye(4), 100, 100, 32, 24, 64, 48, lidar)
        np.testing.assert_array_equal(got, want)
    prev = np.array([1, 1, 1, 1, 2, 2, 0, 0])
    curr = np.array([7, 7, 7, 3, 9, 9, 0, 0])
    mapping = tas.build_label_mapping(prev, curr, 0.5)
    assert mapping == jas.build_label_mapping(prev, curr, 0.5)
    mask = np.array([[7, 3], [9, 0]])
    used_t, used_j = {3, 7, 9}, {3, 7, 9}
    np.testing.assert_array_equal(tas.apply_label_mapping(mask, mapping, used_t),
                                  jas.apply_label_mapping(mask, mapping, used_j))
    assert used_t == used_j
    votes = np.random.default_rng(0).integers(0, 5, (12, 12))
    assert tas.mapping_from_votes(votes, 0.3) == jas.mapping_from_votes(votes, 0.3)

    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal([-0.5, 0, 2], 0.05, (50, 3)),
                          rng.normal([0.5, 0, 2], 0.05, (50, 3))]).astype(np.float32)
    m1 = np.zeros((48, 64), np.int64)
    m1[:, :32], m1[:, 32:] = 5, 9
    m2 = np.zeros((48, 64), np.int64)
    m2[:, :32], m2[:, 32:] = 77, 31
    intr = (60.0, 60.0, 32.0, 24.0)
    t_assoc, j_assoc = tas.InstanceAssociator(0.5), jas.InstanceAssociator(0.5)
    for m in (m1, m2):
        np.testing.assert_array_equal(
            t_assoc.associate(pts, m, np.eye(4, dtype=np.float32), intr),
            j_assoc.associate(pts, m, np.eye(4, dtype=np.float32), intr))


def _safe_cloud(rng, n, poses, intr, margin=1e-3):
    """n points in front of every pose whose projections (float64) lie at
    least `margin` px from a rounding boundary in every pose, so a float32
    product in another order cannot move a pixel."""
    fx, fy, cx, cy = intr
    out = []
    while sum(len(o) for o in out) < n:
        p = np.stack([rng.uniform(-2.5, 2.5, 4 * n), rng.uniform(-2, 2, 4 * n),
                      rng.uniform(2, 8, 4 * n)], -1).astype(np.float32)
        ok = np.ones(len(p), bool)
        for pose in poses:
            pc = (p.astype(np.float64) - pose[:3, 3]) @ pose[:3, :3].astype(np.float64)
            for val in (fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy):
                frac = val - np.floor(val)
                ok &= np.abs(frac - 0.5) > margin
        out.append(p[ok])
    return np.concatenate(out)[:n]


def _label_map(rng, h, w, labels, block=8):
    lab = rng.choice(labels, (-(-h // block), -(-w // block)))
    return np.repeat(np.repeat(lab, block, 0), block, 1)[:h, :w].astype(np.int32)


def test_device_associator_matches_jax():
    """Three keyframes of a 4096-slot cloud, the second after a capacity
    growth from 2048: votes, remapped masks, label memory and the freed
    labels equal to the JAX package's."""
    rng = np.random.default_rng(3)
    H_, W_, L = 48, 64, 24
    intr = (50.0, 52.0, 31.5, 23.75)
    poses = []
    for k in range(3):
        P = np.eye(4, dtype=np.float32)
        c, s = np.cos(0.05 * k), np.sin(0.05 * k)
        P[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        P[:3, 3] = (0.1 * k, 0.0, 0.2 * k)
        poses.append(P)
    xyz = _safe_cloud(rng, 4096, poses, intr)
    # a few slots the camera sees from behind or at the image border: clipped
    xyz[:16] *= np.array([1, 1, -1], np.float32)
    t_assoc = tas.DeviceInstanceAssociator(0.5, num_classes=L)
    j_assoc = jas.DeviceInstanceAssociator(0.5, num_classes=L)
    for k, (cap, n_act) in enumerate([(2048, 1500), (4096, 2600), (4096, 4000)]):
        active = np.arange(cap) < n_act
        x = xyz[:cap]
        labels = rng.permutation(np.arange(1, L))[:8]
        mask = _label_map(rng, H_, W_, np.concatenate([[0], labels]))
        used_t, used_j = set(labels.tolist()), set(labels.tolist())
        got = t_assoc.associate(torch.as_tensor(x), torch.as_tensor(active),
                                torch.as_tensor(mask), torch.as_tensor(poses[k]), intr,
                                used_labels=used_t)
        want = j_assoc.associate(jnp.asarray(x), jnp.asarray(active), jnp.asarray(mask),
                                 jnp.asarray(poses[k]), intr, used_labels=used_j)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(t_assoc._prev_labels.numpy(),
                                      np.asarray(j_assoc._prev_labels))
        assert used_t == used_j
    # the votes themselves, on the last keyframe's state
    prev = t_assoc._prev_labels
    args = (xyz, np.ones(4096, bool), prev.numpy(), mask)
    vt, ct = tas._project_vote(*map(torch.as_tensor, args), torch.as_tensor(poses[2][:3, :3]),
                               torch.as_tensor(poses[2][:3, 3]), *intr, L, False, W_, H_)
    vj, cj = jas._project_vote(*map(jnp.asarray, args), jnp.asarray(poses[2][:3, :3]),
                               jnp.asarray(poses[2][:3, 3]), *intr, L, False, W_, H_)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(vt.sum()) > 1000 and len(tas.mapping_from_votes(vt.numpy(), 0.5)) > 3


# -- SAM -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sams():
    """(the JAX package's SAM with the shipped weights, the port's)."""
    js = JaxSAM()
    assert jax_load_pretrained(js)
    return js, tsam.SAM.pretrained(device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_sam_weights_match_jax(sams):
    js, ts = sams
    params = tsam.read_params(tsam.WEIGHTS_PATH)
    for mine, theirs in zip(params, js.params):
        a, b = dict(_leaves(mine)), dict(_leaves(theirs))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sd = interop.sam_params_from_numpy(jax.tree.map(np.asarray, js.params))
    own = ts.state_dict()
    assert sd.keys() == own.keys()
    for k in sd:
        np.testing.assert_array_equal(own[k].numpy(), sd[k], err_msg=k)


def test_sam_modules_match_flax(sams):
    js, ts = sams
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, 256, 256, 3)).astype(np.float32)
    emb_j = np.array(js.encoder.apply(js.params.encoder, jnp.asarray(imgs)))
    with torch.no_grad():
        emb_t = ts.encoder(torch.as_tensor(imgs)).numpy()
    np.testing.assert_allclose(emb_t, emb_j, atol=SAM_ATOL, rtol=0)
    pe_j = np.array(js.prompt_encoder.apply(js.params.prompt,
                                            method=JaxPromptEncoder.get_dense_pe))
    boxes = np.sort(rng.uniform(0, 256, (5, 2, 2)), axis=1)
    boxes = boxes.transpose(0, 2, 1).reshape(5, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    sp_j = np.array(js.prompt_encoder.apply(js.params.prompt, jnp.asarray(boxes)))
    emb = np.repeat(emb_j[:1], 5, 0)
    dec_j = np.array(js.mask_decoder.apply(js.params.decoder, jnp.asarray(emb),
                                           jnp.asarray(pe_j), jnp.asarray(sp_j)))
    with torch.no_grad():
        pe_t = ts.prompt_encoder.get_dense_pe().numpy()
        sp_t = ts.prompt_encoder(torch.as_tensor(boxes)).numpy()
        dec_t = ts.mask_decoder(torch.as_tensor(emb), torch.as_tensor(pe_j),
                                torch.as_tensor(sp_j)).numpy()
    np.testing.assert_allclose(pe_t, pe_j, atol=SAM_ATOL, rtol=0)
    np.testing.assert_allclose(sp_t, sp_j, atol=SAM_ATOL, rtol=0)
    assert dec_t.shape == (5, 1, 64, 64)
    np.testing.assert_allclose(dec_t, dec_j, atol=SAM_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(48, 64), (120, 160), (600, 400), (300, 200)])
def test_sam_resizes_match_jax(shape):
    """`apply_image` (up to the canvas from the small images, down from the
    large ones) and the two resizes of `postprocess_masks` (up to the
    canvas, then to the image: down for the small ones)."""
    rng = np.random.default_rng(shape[0])
    img = rng.uniform(size=shape + (3,)).astype(np.float32)
    want = JaxResize(256).apply_image(img)
    got = tsam.ResizeLongestSide(256).apply_image(img).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    low = rng.normal(size=(3, 64, 64)).astype(np.float32)
    for size in ((256, 256), shape):
        want = np.asarray(jax.image.resize(jnp.asarray(low), (3,) + size, method="bilinear"))
        got = tsam.resize_bilinear(torch.as_tensor(low)[:, None], size)[:, 0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_conv_transpose_matches_flax():
    """A random-weight 2x2 stride-2 `ConvTranspose` carried across into the
    port's `ConvTranspose2x2` (a matmul over channels and a pixel shuffle):
    the kernel's spatial axes flip."""
    x = np.random.default_rng(0).normal(size=(2, 5, 6, 12)).astype(np.float32)
    mod = nn.ConvTranspose(8, (2, 2), strides=(2, 2))
    p = mod.init(jax.random.key(7), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.key(8), a.shape), p)
    want = np.asarray(mod.apply(p, jnp.asarray(x)))
    sd = interop._conv_transpose(jax.tree.map(np.array, p["params"]), "c")
    sd = {"weight": torch.as_tensor(sd["c.weight"]), "bias": torch.as_tensor(sd["c.bias"])}
    up = tsam.ConvTranspose2x2(12, 8)
    up.load_state_dict(sd)
    with torch.no_grad():
        got = up(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sam_mask_generator_matches_jax(sams, quality_frames):
    js, ts = sams
    _, frames = quality_frames
    img = frames[1].image
    got = MaskGenerator(sam=ts, num_classes=100, seed=0).generate_objects(img)
    want = JaxMaskGenerator(sam=js, num_classes=100, seed=0).generate_objects(img)
    assert got.shape == want.shape == (120, 160)
    assert (got == want).mean() >= 0.999, (got != want).sum()
    assert len(np.unique(want)) > 2


# -- the pipeline --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_frames():
    return list(JaxSynthetic(n_frames=N_FRAMES, width=W, height=H, n_world=4096,
                             pts_per_frame=512, step=0.1, clutter=0.3))


def test_semantic_pipeline_matches_jax(jax_frames, monkeypatch):
    """`tests/test_torch_pipeline.py`'s run with a geometric mask generator
    in both packages: keyframes go track_add(write_row=False) → objects →
    train_only, and the JAX package's key chain is the same as without
    one."""
    jcfg, tcfg = _cfg(jax_config), _cfg(tconf)
    ncls = jcfg.semantics.num_classes
    jp = JaxPipeline(jcfg, mask_generator=JaxGeometric(num_classes=ncls, seed=0),
                     point_budget=512, rng_seed=0)
    jr = jp.run(jax_frames, post_train=0)
    draws = ReplayDraws(_jax_draws(jcfg, N_FRAMES, 512), "cpu")
    tp = SLAMPipeline(tcfg, mask_generator=GeometricMaskGenerator(num_classes=ncls, seed=0),
                      point_budget=512, rng_seed=0, device="cpu", draws=draws)
    calls = []
    for name in ("track_add", "train_only", "track_add_train_self"):
        orig = getattr(fused_mod.FusedFrontend, name)

        def spy(self, *a, _orig=orig, _name=name, **kw):
            calls.append((_name, kw.get("write_row")))
            return _orig(self, *a, **kw)

        monkeypatch.setattr(fused_mod.FusedFrontend, name, spy)
    tr = tp.run([TorchFrame(**vars(f)) for f in jax_frames], post_train=0)
    assert not draws.queue  # every replayed draw was consumed, in the JAX order
    # frames 0, 2, 4 are keyframes; the others replay one
    assert calls == [("track_add", False), ("train_only", None)] * 3

    # one metrics row a frame: one loss a frame, none twice
    assert tr.train_iters == jr.train_iters == len(tr.losses) == len(jr.losses) == N_FRAMES
    assert tr.n_keyframes == jr.n_keyframes == 3
    np.testing.assert_allclose(tr.poses_est, jr.poses_est, atol=5e-4)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-3)
    for kt, kj in zip(tp.keyframes, jp.keyframes):
        got, want = kt.objects.numpy(), np.asarray(kj.objects)
        assert got.dtype == np.int32
        assert (got == want).mean() >= 0.995, (got != want).sum()
        assert len(np.unique(want)) > 2
    np.testing.assert_array_equal(tp.associator._prev_labels.numpy() >= 0,
                                  np.asarray(jp.associator._prev_labels) >= 0)


def test_semantic_pipeline_with_sam_runs(sams, jax_frames):
    """Four frames with the port's SAM mask generator on the CPU: finite
    losses, one metrics row a frame, labelled keyframes."""
    _, ts = sams
    cfg = _cfg(tconf)
    gen = MaskGenerator(sam=ts, num_classes=cfg.semantics.num_classes, seed=0)
    tp = SLAMPipeline(cfg, mask_generator=gen, point_budget=512, rng_seed=0, device="cpu")
    tr = tp.run([TorchFrame(**vars(f)) for f in jax_frames[:4]], post_train=0)
    assert len(tr.losses) == tr.train_iters == 4
    assert np.isfinite(tr.losses).all()
    assert tr.n_keyframes == 2
    assert all(int(k.objects.max()) > 0 for k in tp.keyframes)
