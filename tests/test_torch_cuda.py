"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes, the port's device code on the card against the CPU, and
the kernel launches and host syncs of the SLAM loop and the offline trainer
on the card. A CUDA kernel has no CPU mode, so every kernel test here needs
an NVIDIA GPU with `nvcc` and skips elsewhere (the library-hash test runs
anywhere). This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

`chip_smoke.py` holds the same kernels at the full slice shapes.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.core.config import RasterizeConfig
from sags_tpu_torch.ops import _build, binning, composite
from sags_tpu_torch.ops import rasterize as rz
from sags_tpu_torch.ops import sort, windowed
from sags_tpu_torch.semantics import association as assoc_mod

pytestmark = pytest.mark.cuda

W, H = 64, 48
TILES_X, TILES_Y = 4, 3


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _scene(seed, n=384):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(2, 5, n)], -1).astype(np.float32)
    scales = rng.uniform(0.03, 0.2, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.97, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    objs = rng.normal(size=(n, 16)).astype(np.float32)
    return [torch.as_tensor(a) for a in (means, opac, scales, quats, colors, objs)]


def _binned(device, K, chunk, seed=0):
    means, opac, scales, quats, colors, objs = (t.to(device) for t in _scene(seed))
    cfg = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=K, chunk=chunk)
    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                      W, H, 1.2, 0.9)
    pre = rz.preprocess(means, opac, scales, quats, cam, cfg, colors=colors)
    gid_s, starts, _ = rz.sort_pairs(pre, TILES_X, TILES_Y, cfg)
    G = rz._pack_gaussians(pre, objs).contiguous()
    return gid_s, starts, G


@pytest.mark.parametrize("K", [16, 128])
def test_fill_table_kernel_matches_plain(device, K):
    """Exactly equal (K=16 cuts overflowing tiles)."""
    gid_s, starts, _ = _binned(device, K, 16)
    got = binning.fill_table(gid_s, starts, TILES_X * TILES_Y, K)
    want = binning.fill_table_plain(gid_s, starts, TILES_X * TILES_Y, K)
    assert torch.equal(got, want)
    assert binning.KERNEL.launches > 0


@pytest.mark.parametrize("K", [16, 512, 1024])
def test_fill_table_kernel_edge_cases(device, K):
    """Exactly equal on counts of 0, 1-3, 5-7, K and above K, starts at
    every residue mod 4, and a last segment ending at n_sorted."""
    rng = np.random.default_rng(K)
    counts = [0, 1, 2, 3, 5, 6, 7, K, K + 37, 0, 4 * K, 9]
    counts += list(rng.integers(0, 2 * K, 12))
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    gid = rng.permutation(int(starts[-1]) + 11)[:int(starts[-1])].astype(np.int32)
    gid_t, starts_t = torch.as_tensor(gid, device=device), torch.as_tensor(starts, device=device)
    got = binning.fill_table(gid_t, starts_t, len(counts), K)
    want = binning.fill_table_plain(gid_t, starts_t, len(counts), K)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        binning.fill_table(gid_t, starts_t, len(counts), K + 2)


def _sorted_live(keys, n_live):
    """The kernel's live prefix in key order (its order is not set)."""
    return torch.sort(keys[:int(n_live)]).values


def _bin_both(pre, cfg, TX, TY, monkeypatch):
    """(sort_pairs, bin_gaussians) through the kernel, then through the plain
    expansion; one kernel launch a `bin_gaussians`, none on the plain side."""
    sorted_k = rz.sort_pairs(pre, TX, TY, cfg)
    n = binning.EXPAND.launches
    binned = rz.bin_gaussians(pre, TX, TY, cfg)
    assert binning.EXPAND.launches == n + 1
    with monkeypatch.context() as mp:
        mp.setattr(rz, "expand_pairs", binning.expand_pairs_plain)
        sorted_p = rz.sort_pairs(pre, TX, TY, cfg)
        binned_p = rz.bin_gaussians(pre, TX, TY, cfg)
    assert binning.EXPAND.launches == n + 1
    return (*sorted_k, *binned), (*sorted_p, *binned_p)


@pytest.mark.parametrize("max_tiles", [16, 36, 64])
def test_expand_pairs_kernel_matches_plain(device, max_tiles, monkeypatch):
    """The live count exactly, the live keys bit for bit once sorted (the
    kernel's order is not set), the overflow, and through the sort every
    output of `sort_pairs` (gid_s the live prefix) and `bin_gaussians`, on a
    scene with invalid and inactive slots, rects clipped at the image's
    edges, rects wider than R, opacities at alpha_min, and P not a multiple
    of the block. One launch a `bin_gaussians`."""
    from test_torch_expand_pairs import TILES_X as TX, TILES_Y as TY, pair_scene, scene_cases

    pre, cfg = pair_scene(max_tiles, device, max_tiles)
    dq = rz._depth_quant(pre)
    before = binning.EXPAND.launches
    got, n_live, ov = binning.expand_pairs(pre, dq, TX, TY, cfg)
    assert binning.EXPAND.launches == before + 1
    assert got.shape == (max_tiles * pre.mx.shape[0],)
    want, want_n, want_ov = binning.expand_pairs_plain(pre, dq, TX, TY, cfg)
    assert torch.equal(n_live, want_n) and torch.equal(ov, want_ov)
    assert torch.equal(_sorted_live(got, n_live), torch.sort(want).values)
    cases = scene_cases(pre, cfg, want)
    assert all(v > 0 for v in cases.values()) and int(ov) > 0, cases

    ours, plain = _bin_both(pre, cfg, TX, TY, monkeypatch)
    assert ours[0].shape == (int(n_live),)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("max_tiles", [16, 64])
@pytest.mark.parametrize("kind", ["none", "full"])
def test_expand_pairs_kernel_at_the_edges(device, kind, max_tiles, monkeypatch):
    """No live pair (n_live 0, an empty gid_s, an all -1 table) and every
    slot live at every offset (n_live = MT·P), as the plain expansion gives
    them, through `sort_pairs` and `bin_gaussians` too."""
    from test_torch_expand_pairs import TILES_X as TX, TILES_Y as TY, edge_scene

    pre, cfg = edge_scene(kind, device, max_tiles)
    dq = rz._depth_quant(pre)
    got, n_live, ov = binning.expand_pairs(pre, dq, TX, TY, cfg)
    want, want_n, want_ov = binning.expand_pairs_plain(pre, dq, TX, TY, cfg)
    assert torch.equal(n_live, want_n) and torch.equal(ov, want_ov)
    assert int(n_live) == (0 if kind == "none" else max_tiles * pre.mx.shape[0])
    assert torch.equal(_sorted_live(got, n_live), torch.sort(want).values)
    ours, plain = _bin_both(pre, cfg, TX, TY, monkeypatch)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
    if kind == "none":
        table = ours[3]
        assert ours[0].numel() == 0 and torch.equal(table, torch.full_like(table, -1))


def test_expand_pairs_kernel_is_repeatable(device):
    """Five launches on one input: the same live count and, once sorted, the
    same keys bit for bit, whatever order the warps' atomics gave them."""
    from test_torch_expand_pairs import TILES_X as TX, TILES_Y as TY, pair_scene

    pre, cfg = pair_scene(5, device, 36, n=20000)
    dq = rz._depth_quant(pre)
    first, n0, ov0 = binning.expand_pairs(pre, dq, TX, TY, cfg)
    ref = _sorted_live(first, n0)
    assert int(n0) > 0
    for _ in range(4):
        keys, n, ov = binning.expand_pairs(pre, dq, TX, TY, cfg)
        assert torch.equal(n, n0) and torch.equal(ov, ov0)
        assert torch.equal(_sorted_live(keys, n), ref)


def _leaf_grads(out, leaves, up, mask):
    """Gradients of Σ out.k · up_k · mask over the differentiable outputs
    (`mask` [P] picks the slots whose upstream gradients count); zeros
    where a leaf takes none."""
    from test_torch_preprocess import DIFF

    loss = sum((getattr(out, k) * up[k] * mask.view(-1, *[1] * (up[k].dim() - 1))).sum()
               for k in DIFF)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True, retain_graph=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, leaves)]


PRE_VARIANTS = {"default": RasterizeConfig(),
                "no_low_pass": RasterizeConfig(low_pass=0.0, scale_modifier=0.7,
                                               tight_rect=False)}


@pytest.mark.parametrize("colour", ["sh", "sh4", "colors", "sh1", "none"])
@pytest.mark.parametrize("variant", list(PRE_VARIANTS))
def test_preprocess_kernel_matches_plain(device, variant, colour):
    """`project` on the card (the kernel pair: one launch of each a forward
    and a backward, whatever the colour input: SH degree 1 and no colour are
    made beside it) against the plain `preprocess` on the same tensors, on
    `test_torch_preprocess.preprocess_scene` (every branch; "no_low_pass"
    gives its zero-scale slots det 0, at scale_modifier 0.7 with the rect by
    radius): every output bit for bit, twice the same; every input gradient
    within 1e-6 of the leaf's norm of autograd's through the plain version,
    twice the same bits. The depth-0 slot's gradients (~1e16) are held on
    their own: the bulk's upstream gradients leave it out."""
    from test_torch_preprocess import DIFF, P, SAFE_Z_SLOT, preprocess_scene, run_project

    cfg = PRE_VARIANTS[variant]
    cam, leaves, active = preprocess_scene(5, device, colour)
    L = list(leaves.values())
    f0, b0 = rz.PREPROCESS.launches, rz.PREPROCESS_BWD.launches
    got = run_project(rz.project, cam, leaves, active, cfg, colour)
    again = run_project(rz.project, cam, leaves, active, cfg, colour)
    assert rz.PREPROCESS.launches == f0 + 2
    want = run_project(rz.preprocess, cam, leaves, active, cfg, colour)
    torch.cuda.synchronize()
    for name in rz.Preprocessed._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))
        assert torch.equal(a, getattr(again, name)), name
    v = want.valid
    assert v.any() and not v[~active].any() and not v[30:40].any()
    assert bool(want.clamped.any()) == (colour not in ("colors", "none"))
    if variant == "no_low_pass":
        assert not v[50:53].any() and not want.ca[50:53].any()
    gen = torch.Generator(device="cpu").manual_seed(7)
    up = {k: torch.randn(getattr(want, k).shape, generator=gen).to(device) for k in DIFF}
    bulk = torch.ones(P, device=device)
    bulk[SAFE_Z_SLOT] = 0.0
    for mask in (bulk, 1.0 - bulk):
        gk, gk2, gp = (_leaf_grads(o, L, up, mask) for o in (got, again, want))
        for name, a, a2, b in zip(leaves, gk, gk2, gp):
            assert torch.equal(a, a2), name
            gap = float((a - b).abs().max())
            assert gap <= 1e-6 * float(b.norm()), (name, gap, float(b.norm()))
    assert rz.PREPROCESS_BWD.launches == b0 + 4


def test_preprocess_kernel_matches_the_jax_package(device):
    """`project` on the card against the JAX package's `preprocess` and its
    gradients on the CPU, stored in `tests/data/preprocess_jax.npz` (this
    file imports no JAX; `test_torch_kernels.py` checks the file against the
    JAX package): integers and flags exactly, floats and gradients within
    `assert_near_reference`'s tolerances."""
    import test_torch_preprocess as tp

    ref = np.load(tp.REFERENCE)
    cam, leaves, active = tp.preprocess_scene(tp.REF_SEED, device, "sh", n=tp.REF_N)
    for k, v in tp.reference_inputs(cam, leaves, active).items():
        assert np.array_equal(v, ref[k]), k  # the same scene as the reference's
    cam = dataclasses.replace(cam, world_view=torch.as_tensor(ref["world_view"], device=device),
                              full_proj=torch.as_tensor(ref["full_proj"], device=device))
    f0, b0 = rz.PREPROCESS.launches, rz.PREPROCESS_BWD.launches
    pre = tp.run_project(rz.project, cam, leaves, active, RasterizeConfig())
    tp.assert_near_reference(pre, tp.reference_grads(pre, leaves, ref), ref)
    assert (rz.PREPROCESS.launches, rz.PREPROCESS_BWD.launches) == (f0 + 1, b0 + 1)


def test_windowed_occupancy_on_the_card_launches_the_preprocess_kernel(device, monkeypatch):
    """`windowed_occupancy` (the occupancy probe that sizes the windowed
    path's buffers; it passes no colour) on the card launches the forward
    kernel once and no backward, and counts what it counts over the plain
    `preprocess`'s outputs on the card, bit for bit."""
    from test_torch_preprocess import preprocess_scene

    cam, leaves, active = preprocess_scene(7, device, "none")
    L = {k: v.detach() for k, v in leaves.items()}
    args = (L["means3d"], L["opacities"], L["scales"], L["quats"], cam, WIN_CFG)
    f0, b0 = rz.PREPROCESS.launches, rz.PREPROCESS_BWD.launches
    got = rz.windowed_occupancy(*args, active_mask=active)
    assert (rz.PREPROCESS.launches, rz.PREPROCESS_BWD.launches) == (f0 + 1, b0)
    monkeypatch.setattr(rz, "project", rz.preprocess)
    want = rz.windowed_occupancy(*args, active_mask=active)
    assert rz.PREPROCESS.launches == f0 + 1 and sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(want["live_parents"]) > 0


def test_preprocess_kernel_gradients_on_thin_splats(device):
    """Needle-thin splats (scales 0.002-0.3, up to 150:1) without the
    low-pass, where float32 gradients depend on the order of their
    operations: the kernel's gradients are held to the float64 plain
    version's, as close as autograd's float32 ones through the plain version
    are (within twice their gap, plus 1e-7, of the leaf's norm)."""
    from test_torch_preprocess import DIFF, P, SAFE_Z_SLOT, preprocess_scene, run_project

    cfg = PRE_VARIANTS["no_low_pass"]
    cam, leaves, active = preprocess_scene(6, device, "sh", scales=(0.002, 0.3))
    L = list(leaves.values())
    leaves64 = {k: x.detach().double().requires_grad_(True) for k, x in leaves.items()}
    cam64 = dataclasses.replace(cam, world_view=cam.world_view.double(),
                                full_proj=cam.full_proj.double())
    outs = [run_project(fn, c, lv, active, cfg) for fn, c, lv in (
        (rz.project, cam, leaves), (rz.preprocess, cam, leaves), (rz.preprocess, cam64, leaves64))]
    gen = torch.Generator(device="cpu").manual_seed(8)
    up = {k: torch.randn(getattr(outs[1], k).shape, generator=gen).to(device) for k in DIFF}
    bulk = torch.ones(P, device=device)
    bulk[SAFE_Z_SLOT] = 0.0
    gk, gp = (_leaf_grads(o, L, up, bulk) for o in outs[:2])
    g64 = _leaf_grads(outs[2], list(leaves64.values()),
                      {k: u.double() for k, u in up.items()}, bulk.double())
    for name, a, b, t in zip(leaves, gk, gp, g64):
        norm = float(t.norm())
        if norm == 0.0:  # opacities: no output here takes their gradient
            assert not a.any() and not b.any(), name
            continue
        ours, theirs = (float((x.double() - t).abs().max()) / norm for x in (a, b))
        assert ours <= 2.0 * theirs + 1e-7, (name, ours, theirs)


def test_traced_offline_step_opens_preprocess_bwd_under_step_backward(device):
    """One offline training step on the card under the profiler: the
    preprocess backward kernel's range `raster.preprocess_bwd` lies inside
    `step.backward`, once, on autograd's thread, with its device events."""
    from torch.profiler import ProfilerActivity, profile

    from sags_tpu_torch.io.datasets import SyntheticDataset
    from sags_tpu_torch.slam import offline
    from sags_tpu_torch.slam.pipeline import camera_for
    from sags_tpu_torch.utils import profiling
    from test_torch_tracing import _cfg, _inside, _ranges

    f = next(iter(SyntheticDataset(n_frames=1, width=64, height=48, n_world=4096,
                                   pts_per_frame=512, step=0.1, clutter=0.3, device=device)))
    cfg = _cfg()
    st = offline.init_from_points(f.points, f.colors, cfg, device=device)
    cam = camera_for(cfg, f, f.pose, device)
    img = torch.as_tensor(np.asarray(f.image), device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st, _ = offline.train_step(st, cam, img, cfg)
    ranges, rec = _ranges(prof), profiling.records()
    assert _inside(ranges, "raster.preprocess_bwd", "step.backward")
    spans = rec.named("raster.preprocess_bwd")
    assert len(spans) == 1 and spans[0].thread == "autograd"
    assert spans[0].device_ms is not None


@pytest.mark.parametrize("chunk", [32, 64])
def test_composite_kernels_match_plain(device, chunk):
    """Forward to 1e-5 absolute (the same float32 arithmetic summed in another
    order), the backward to 2e-4 relative per output row (the JAX package's
    bar for its fused backward), and the scattered dG bitwise reproducible."""
    K = 128
    gid_s, starts, G = _binned(device, K, chunk)
    NT = TILES_X * TILES_Y
    table = binning.fill_table(gid_s, starts, NT, K)
    counts = torch.clamp(starts[1:] - starts[:-1], max=K).to(torch.int32)
    kw = dict(chunk=chunk, tile_offset=0)
    acc, T = composite.composite_fused(G, table, counts, 16, TILES_X, **kw)
    acc_p, T_p = composite.composite_fused_plain(G, table, counts, 16, TILES_X, **kw)
    torch.testing.assert_close(acc, acc_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(T, T_p, atol=1e-5, rtol=0)

    g = torch.Generator(device=device).manual_seed(3)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G, table, counts, d_acc, d_T, T, 16, TILES_X)
    dgt = composite.composite_fused_bwd(*bargs, **kw)
    dgt_p = composite.composite_fused_bwd_plain(*bargs, **kw)
    scale = dgt_p.abs().amax(dim=(0, 2))
    live = scale > 0
    rel = (dgt - dgt_p).abs().amax(dim=(0, 2))[live] / scale[live]
    assert float(rel.max()) <= 2e-4, rel
    assert torch.equal(dgt[:, ~live], torch.zeros_like(dgt[:, ~live]))
    dG = composite.scatter_rows(composite.composite_fused_bwd(*bargs, **kw), table, G.shape[0])
    assert torch.equal(dG, composite.scatter_rows(dgt, table, G.shape[0]))


def test_rasterize_on_the_card_matches_the_cpu(device):
    """The whole classic rasterizer, forward and the gradients of all inputs,
    on the card (kernels) and on the CPU (plain versions): 1e-4 absolute on
    the images, 2e-4 relative per gradient tensor."""
    cfg = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32)
    outs = {}
    for dev in (torch.device("cpu"), device):
        leaves = [t.to(dev).requires_grad_(True) for t in _scene(1)]
        means, opac, scales, quats, colors, objs = leaves
        cam = make_camera(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                          W, H, 1.2, 0.9)
        out = rz.rasterize(means, opac, scales, quats, cam, cfg, colors=colors,
                           obj_features=objs, windowed=False)
        loss = (out.color.square().sum() + out.depth.sum() + out.objects.sum()
                + out.alpha.sum())
        grads = torch.autograd.grad(loss, leaves)
        outs[dev.type] = ([out.color, out.depth, out.objects, out.alpha, out.final_T],
                          grads, int(out.n_binned), int(out.overflow_tile))
    imgs_c, grads_c, nb_c, ov_c = outs["cpu"]
    imgs_g, grads_g, nb_g, ov_g = outs["cuda"]
    assert (nb_c, ov_c) == (nb_g, ov_g)
    for a, b in zip(imgs_g, imgs_c):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    for a, b in zip(grads_g, grads_c):
        rel = float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-12))
        assert rel <= 2e-4, rel


def test_wrappers_check_their_inputs(device):
    """A CUDA tensor of the wrong type or layout raises; nothing falls back."""
    gid = torch.zeros(8, dtype=torch.int64, device=device)
    starts = torch.zeros(3, dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        binning.fill_table(gid, starts, 2, 16)
    G = torch.zeros((4, 40), device=device)
    table = torch.zeros((2, 16), dtype=torch.int32, device=device)
    counts = torch.zeros(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        composite.composite_fused(G, table, counts, 16, 2)
    from test_torch_expand_pairs import TILES_X as TX, TILES_Y as TY, pair_scene

    pre, cfg = pair_scene(0, device, n=300)
    with pytest.raises(TypeError):
        binning.expand_pairs(pre._replace(opacity=pre.opacity.double()),
                             rz._depth_quant(pre), TX, TY, cfg)
    with pytest.raises(ValueError):
        binning.expand_pairs(pre, rz._depth_quant(pre).cpu(), TX, TY, cfg)


def test_composite_bwd_kernel_ragged_empty_and_full_tiles(device):
    """`composite_fused_bwd` where its groups of 32 pairs end unevenly: a
    tile with no pair, tiles whose last group is ragged (1, 33 and 45 pairs),
    and tiles whose count exceeds the capacity (the kernel cuts it at K):
    2e-4 relative per row of the plain version, exact zeros past every
    tile's pairs, and bitwise equal over two launches."""
    K = 64
    gid_s, starts, G = _binned(device, K, 32)
    NT = TILES_X * TILES_Y
    table = binning.fill_table(gid_s, starts, NT, K)
    counts = (starts[1:] - starts[:-1]).to(torch.int32)  # not cut at K
    assert int(counts.max()) > K
    for t, c in ((1, 0), (3, 1), (5, 33), (7, 45)):
        counts[t] = min(c, int(counts[t]))
        table[t, int(counts[t]):] = -1
    kw = dict(chunk=32, tile_offset=0)
    _, T = composite.composite_fused(G, table, torch.clamp(counts, max=K), 16, TILES_X, **kw)
    g = torch.Generator(device=device).manual_seed(5)
    d_acc = torch.randn((NT, 256, 24), generator=g, device=device)
    d_T = torch.randn((NT, 256), generator=g, device=device)
    bargs = (G, table, counts, d_acc, d_T, T, 16, TILES_X)
    before = composite.BWD.launches
    dgt = composite.composite_fused_bwd(*bargs, **kw)
    assert composite.BWD.launches == before + 1
    dgt_p = composite.composite_fused_bwd_plain(*bargs, **kw)
    scale = dgt_p.abs().amax(dim=(0, 2))
    live = scale > 0
    rel = (dgt - dgt_p).abs().amax(dim=(0, 2))[live] / scale[live]
    assert float(rel.max()) <= 2e-4, rel
    past = torch.arange(K, device=device)[None, :] >= counts[:, None]
    assert not bool(dgt.permute(0, 2, 1)[past].any())
    assert not bool(dgt[1].any())
    assert torch.equal(dgt, composite.composite_fused_bwd(*bargs, **kw))


@pytest.mark.parametrize("toff", [0, 3])
@pytest.mark.parametrize("chunk", [32, 64, 48])
def test_composite_fwd_kernel_counts_chunks_and_offset(device, chunk, toff):
    """`composite_fused` where its groups of 32 pairs and its strip cull meet
    the table's edges: tiles with 0, 1 and 33 pairs and a full one, an empty
    slot below a tile's count, chunks of 32, 64 and 48 pairs (the last no
    multiple of the group) and a tile offset: 1e-5 absolute on acc and T of
    the plain version, bitwise equal over two launches, and no gated
    (pixel, pair) in a strip that `strip_live` drops."""
    K = 192
    gid_s, starts, G = _binned(device, K, chunk)
    table = binning.fill_table(gid_s, starts, TILES_X * TILES_Y, K)[toff:].contiguous()
    counts = torch.clamp(starts[1:] - starts[:-1], max=K).to(torch.int32)[toff:].contiguous()
    for t, c in ((1, 0), (2, 1), (4, 33)):
        counts[t] = min(c, int(counts[t]))
        table[t, int(counts[t]):] = -1
    full = table[0, :int(counts[0])]
    assert full.numel() > 0
    table[0] = full.repeat(-(-K // full.numel()))[:K]  # a full tile: its pairs repeated
    counts[0] = K
    table[3, 2] = -1
    kw = dict(chunk=chunk, tile_offset=toff)
    before = composite.FWD.launches
    acc, T = composite.composite_fused(G, table, counts, 16, TILES_X, **kw)
    assert composite.FWD.launches == before + 1
    acc_p, T_p = composite.composite_fused_plain(G, table, counts, 16, TILES_X, **kw)
    torch.testing.assert_close(acc, acc_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(T, T_p, atol=1e-5, rtol=0)
    assert not bool(acc[1].any()) and bool((T[1] == 1).all())
    acc_2, T_2 = composite.composite_fused(G, table, counts, 16, TILES_X, **kw)
    assert torch.equal(acc, acc_2) and torch.equal(T, T_2)
    live = composite.strip_live(G, table, counts, TILES_X, toff)
    gated = composite.strip_gated(G, table, counts, TILES_X, toff)
    assert not bool((gated & ~live).any())
    assert not bool(live.all())


def _row_rel_err(got, want):
    scale = want.abs().amax(dim=(0, 2))
    live = scale > 0
    return float(((got - want).abs().amax(dim=(0, 2))[live] / scale[live]).max())


@pytest.mark.parametrize("toff", [3, 7])
def test_composite_bwd_kernel_at_a_tile_offset(device, toff):
    """`composite_fused_bwd` on the tiles toff.. of the grid (a rank's slice
    under a mesh) at that tile offset: 2e-4 relative per output row of the
    plain version at the same offset, and different from the launch at
    offset 0 (the offset moves the pixels)."""
    K, chunk = 128, 32
    gid_s, starts, G = _binned(device, K, chunk)
    NT = TILES_X * TILES_Y
    table = binning.fill_table(gid_s, starts, NT, K)[toff:].contiguous()
    counts = torch.clamp(starts[1:] - starts[:-1], max=K).to(torch.int32)[toff:].contiguous()
    kw = dict(chunk=chunk, tile_offset=toff)
    acc, T = composite.composite_fused(G, table, counts, 16, TILES_X, **kw)
    g = torch.Generator(device=device).manual_seed(5)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G, table, counts, d_acc, d_T, T, 16, TILES_X)
    before = composite.BWD.launches
    dgt = composite.composite_fused_bwd(*bargs, **kw)
    assert composite.BWD.launches == before + 1
    assert _row_rel_err(dgt, composite.composite_fused_bwd_plain(*bargs, **kw)) <= 2e-4
    assert not torch.equal(dgt, composite.composite_fused_bwd(*bargs, chunk=chunk))


@pytest.mark.parametrize("toff", [3, 7])
def test_windowed_kernels_at_a_tile_offset(device, toff):
    """`composite_windowed` and `composite_windowed_bwd` on the tiles toff..
    of the grid (work list and span plan cut as a mesh cuts them) at that
    tile offset: the forward bitwise equal to its plain version at the same
    offset, the backward to 2e-4 relative per output row, and the forward
    different from the launch at offset 0."""
    kw = dict(alpha_min=WIN_CFG.alpha_min, t_min=WIN_CFG.transmittance_min, chunk=128,
              n_span=4)
    G_s, _, tl, counts, bases, dests, nblks, *_ = _prepared(device, True)
    NT = TILES_X * TILES_Y
    tl, counts = tl[toff:].contiguous(), counts[toff:].contiguous()
    b, d, n = (x.reshape(NT, 4)[toff:].reshape(-1).contiguous() for x in (bases, dests, nblks))
    fargs = (G_s, tl, counts, b, d, n, 16, TILES_X)
    before = windowed.WINDOWED.launches
    acc, T = windowed.composite_windowed(*fargs, tile_offset=toff, **kw)
    assert windowed.WINDOWED.launches == before + 1
    acc_p, T_p = windowed.composite_windowed_plain(*fargs, tile_offset=toff, **kw)
    assert torch.equal(acc, acc_p) and torch.equal(T, T_p)
    assert not torch.equal(acc, windowed.composite_windowed(*fargs, **kw)[0])
    g = torch.Generator(device=device).manual_seed(5)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G_s, tl, counts, b, d, n, d_acc, d_T, T, 16, TILES_X)
    before = windowed.BWD.launches
    dgt = windowed.composite_windowed_bwd(*bargs, tile_offset=toff, **kw)
    assert windowed.BWD.launches == before + 1
    dgt_p = windowed.composite_windowed_bwd_plain(*bargs, tile_offset=toff, **kw)
    assert _row_rel_err(dgt, dgt_p) <= 2e-4


@pytest.mark.parametrize("shape", [(4, 16, 128), (3, 1, 128), (2, 8, 256), (5, 1, 2),
                                   (5, 1, 4), (3, 1, 8), (3, 1, 64), (3, 2, 128),
                                   (2, 4, 128), (2, 8, 128), (2, 32, 128), (2, 64, 128)])
def test_sort_blocks_kernel_matches_torch_sort(device, shape):
    """Exactly `torch.sort` of each flattened block, from 2 keys to 8192
    (fewer keys than a thread holds, less than a warp of threads, one to five
    transposed rounds): random keys over the whole int32 range, and heavy
    ties."""
    g = torch.Generator(device="cpu").manual_seed(shape[0])
    for hi in (2 ** 31, 8):
        x = torch.randint(-hi, hi, shape, generator=g, dtype=torch.int64)
        x = x.to(torch.int32).to(device)
        before = sort.KERNEL.launches
        assert torch.equal(sort.sort_blocks(x), sort.sort_blocks_plain(x))
        assert sort.KERNEL.launches == before + 1


WIN_CFG = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=256, window_blocks=16,
                          windowed_mid_frac=1.0, windowed_big_frac=1.0,
                          windowed_big_capacity=64, windowed_chunk=128)


def _prepared(device, build_table, seed=0, cfg=WIN_CFG):
    means, opac, scales, quats, colors, objs = (t.to(device) for t in _scene(seed))
    scales[:12] *= 6.0  # a few wide splats for the slice store
    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                      W, H, 1.2, 0.9)
    pre = rz.preprocess(means, opac, scales, quats, cam, cfg, colors=colors)
    return rz._prepare_windowed(pre, objs, TILES_X, TILES_Y, cfg,
                                 build_table=build_table)


def test_windowed_kernels_match_plain(device):
    """`composite_windowed` and `composite_windowed_sorted` against their
    plain versions on the same prepared inputs: acc and T bitwise equal (the
    plain version takes the kernel's float32 operations in its order), nv
    exact."""
    kw = dict(alpha_min=WIN_CFG.alpha_min, t_min=WIN_CFG.transmittance_min, chunk=128,
              n_span=4)
    G_s, _, tl, counts, bases, dests, nblks, *_ = _prepared(device, True)
    before = windowed.WINDOWED.launches
    acc, T = windowed.composite_windowed(G_s, tl, counts, bases, dests, nblks, 16,
                                         TILES_X, **kw)
    acc_p, T_p = windowed.composite_windowed_plain(G_s, tl, counts, bases, dests, nblks,
                                                   16, TILES_X, **kw)
    assert windowed.WINDOWED.launches == before + 1
    assert torch.equal(acc, acc_p) and torch.equal(T, T_p)

    G_s, bases, dests, nblks, ss, se, *_ = _prepared(device, False)
    skw = dict(kw, w_blocks=WIN_CFG.window_blocks, k_tile=WIN_CFG.tile_capacity)
    acc, T, nv = windowed.composite_windowed_sorted(G_s, bases, dests, nblks, ss, se, 16,
                                                    TILES_X, **skw)
    acc_p, T_p, nv_p = windowed.composite_windowed_sorted_plain(
        G_s, bases, dests, nblks, ss, se, 16, TILES_X, **skw)
    assert torch.equal(nv, nv_p) and int(nv.sum()) > 0
    assert torch.equal(acc, acc_p) and torch.equal(T, T_p)


def test_windowed_bwd_kernel_matches_plain(device):
    """`composite_windowed_bwd` against its plain version: 2e-4 relative per
    output row (the bar of the fused backward), zero where the plain version
    is zero, and the scattered dG_s bitwise reproducible."""
    kw = dict(alpha_min=WIN_CFG.alpha_min, t_min=WIN_CFG.transmittance_min, chunk=128,
              n_span=4)
    G_s, table, tl, counts, bases, dests, nblks, *_ = _prepared(device, True)
    acc, T = windowed.composite_windowed(G_s, tl, counts, bases, dests, nblks, 16,
                                         TILES_X, **kw)
    g = torch.Generator(device=device).manual_seed(3)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G_s, tl, counts, bases, dests, nblks, d_acc, d_T, T, 16, TILES_X)
    before = windowed.BWD.launches
    dgt = windowed.composite_windowed_bwd(*bargs, **kw)
    assert windowed.BWD.launches == before + 1
    dgt_p = windowed.composite_windowed_bwd_plain(*bargs, **kw)
    scale = dgt_p.abs().amax(dim=(0, 2))
    live = scale > 0
    rel = (dgt - dgt_p).abs().amax(dim=(0, 2))[live] / scale[live]
    assert float(rel.max()) <= 2e-4, rel
    assert torch.equal(dgt[:, ~live], torch.zeros_like(dgt[:, ~live]))
    P_all = G_s.shape[0]
    dG = composite.scatter_rows(windowed.composite_windowed_bwd(*bargs, **kw), table, P_all)
    assert torch.equal(dG, composite.scatter_rows(dgt, table, P_all))


@pytest.mark.parametrize("chunk", [32, 512])
def test_windowed_bwd_kernel_ragged_empty_and_full_tiles(device, chunk):
    """`composite_windowed_bwd` where its groups of 32 entries end unevenly:
    a tile with no entry, tiles whose last group is ragged (1, 33 and 45
    entries) and a full one, with a chunk of one group and a chunk longer
    than the list: 2e-4 relative per row of the plain version, exact zeros
    past every tile's entries, and bitwise equal over two launches."""
    kw = dict(alpha_min=WIN_CFG.alpha_min, t_min=WIN_CFG.transmittance_min, chunk=chunk,
              n_span=4)
    G_s, _, tl, counts, bases, dests, nblks, *_ = _prepared(device, True)
    NT = TILES_X * TILES_Y
    K = tl.numel() // NT
    tl, counts = tl.reshape(NT, K).clone(), counts.clone()
    full = tl[0, :int(counts[0])]
    assert full.numel() > 0
    tl[0] = full.repeat(-(-K // full.numel()))[:K]  # a full tile: its entries repeated
    counts[0] = K
    for t, c in ((1, 0), (3, 1), (5, 33), (7, 45)):
        counts[t] = min(c, int(counts[t]))
        tl[t, int(counts[t]):] = -1
    tl = tl.reshape(NT, K // 128, 128)
    acc, T = windowed.composite_windowed(G_s, tl, counts, bases, dests, nblks, 16,
                                         TILES_X, **kw)
    g = torch.Generator(device=device).manual_seed(5)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G_s, tl, counts, bases, dests, nblks, d_acc, d_T, T, 16, TILES_X)
    before = windowed.BWD.launches
    dgt = windowed.composite_windowed_bwd(*bargs, **kw)
    assert windowed.BWD.launches == before + 1
    dgt_p = windowed.composite_windowed_bwd_plain(*bargs, **kw)
    scale = dgt_p.abs().amax(dim=(0, 2))
    live = scale > 0
    rel = (dgt - dgt_p).abs().amax(dim=(0, 2))[live] / scale[live]
    assert float(rel.max()) <= 2e-4, rel
    past = torch.arange(K, device=device)[None, :] >= counts[:, None]
    assert not bool(dgt.permute(0, 2, 1)[past].any())
    assert not bool(dgt[1].any())
    assert torch.equal(dgt, windowed.composite_windowed_bwd(*bargs, **kw))


@pytest.mark.parametrize("ewa,prec,bf16", [("quad", "highest", False),
                                           ("vpu", "high", False),
                                           ("vpu", "default", False),
                                           ("vpu", "highest", True),
                                           ("quad", "default", True)])
def test_windowed_variants_match_plain(device, ewa, prec, bf16):
    """Each forward variant of both windowed compositors against its plain
    version: acc and T bitwise equal, nv exact (the plain version takes the
    kernel's float32 operations in its order, so a weight rounds to bf16
    alike in both); and not equal to the float32 longhand render where the
    option changes it (rgb, or the obj channels under `windowed_bf16`), so
    a kernel that ignored the option fails."""
    cfg = dataclasses.replace(WIN_CFG, windowed_bf16=bf16)
    base = dict(alpha_min=cfg.alpha_min, t_min=cfg.transmittance_min, chunk=128, n_span=4)
    kw = dict(base, ewa_impl=ewa, feat_prec=prec)
    changed = slice(3, 19) if (bf16 and ewa == "vpu" and prec == "highest") else slice(0, 3)
    G_s, _, tl, counts, bases, dests, nblks, *_ = _prepared(device, True, cfg=cfg)
    args = (G_s, tl, counts, bases, dests, nblks, 16, TILES_X)
    acc, T = windowed.composite_windowed(*args, bf16_obj=bf16, **kw)
    acc_p, T_p = windowed.composite_windowed_plain(*args, bf16_obj=bf16, **kw)
    assert torch.equal(acc, acc_p) and torch.equal(T, T_p)
    acc_f, _ = windowed.composite_windowed(*args, **base)
    assert not torch.equal(acc[..., changed], acc_f[..., changed])
    if bf16:
        return  # the in-kernel sort never takes the bf16 rows
    G_s, bases, dests, nblks, ss, se, *_ = _prepared(device, False)
    skw = dict(kw, w_blocks=WIN_CFG.window_blocks, k_tile=WIN_CFG.tile_capacity)
    sargs = (G_s, bases, dests, nblks, ss, se, 16, TILES_X)
    acc, T, nv = windowed.composite_windowed_sorted(*sargs, **skw)
    acc_p, T_p, nv_p = windowed.composite_windowed_sorted_plain(*sargs, **skw)
    assert torch.equal(nv, nv_p)
    assert torch.equal(acc, acc_p) and torch.equal(T, T_p)
    acc_f, _, _ = windowed.composite_windowed_sorted(
        *sargs, **dict(base, w_blocks=WIN_CFG.window_blocks, k_tile=WIN_CFG.tile_capacity))
    assert not torch.equal(acc[..., changed], acc_f[..., changed])


@pytest.mark.parametrize("aspect", [(4.0, 8.0), (20.0, 60.0)])
def test_windowed_kernels_on_thin_splats(device, aspect):
    """Both windowed compositors where their strip cull is hardest: long
    thin splats that cross the image from centres outside it, in both EWA
    forms and the three feature tiers: acc and T bitwise equal to the plain
    versions, nv exact; and `windowed.strip_live` dropping no strip in
    which a pixel passes the loop's gate."""
    import chip_smoke

    K = 256
    G, table, counts, _ = chip_smoke.thin_scene(device, aspect, n=1024, K=K, width=W,
                                                height=H)
    host, ksort = chip_smoke.thin_windowed(G, table, TILES_X, TILES_Y, span_blocks=2)
    host = (host[0], host[1], counts, *host[2:])
    assert int(counts.sum()) > 0
    hkw = dict(alpha_min=1.0 / 255.0, t_min=1e-4, chunk=128)
    for ewa in ("vpu", "quad"):
        for prec in ("highest", "high", "default"):
            kw = dict(hkw, ewa_impl=ewa, feat_prec=prec)
            acc, T = windowed.composite_windowed(*host, 16, TILES_X, n_span=1, **kw)
            acc_p, T_p = windowed.composite_windowed_plain(*host, 16, TILES_X, n_span=1, **kw)
            assert torch.equal(acc, acc_p) and torch.equal(T, T_p), (ewa, prec)
            skw = dict(kw, n_span=4, w_blocks=8, k_tile=K)
            acc, T, nv = windowed.composite_windowed_sorted(*ksort, 16, TILES_X, **skw)
            acc_p, T_p, nv_p = windowed.composite_windowed_sorted_plain(*ksort, 16, TILES_X,
                                                                        **skw)
            assert torch.equal(nv, nv_p) and int(nv.sum()) > 0, (ewa, prec)
            assert torch.equal(acc, acc_p) and torch.equal(T, T_p), (ewa, prec)
        live = windowed.strip_live(host[0], table.long(), counts, TILES_X, 0, 1.0 / 255.0, ewa)
        gated = windowed.strip_gated(host[0], table.long(), counts, TILES_X, 0, 1.0 / 255.0,
                                     ewa)
        assert not bool((gated & ~live).any())


@pytest.mark.parametrize("bf16", [False, True])
def test_windowed_gradients_on_the_card_match_the_cpu(device, bf16):
    """The windowed rasterizer's gradients of all six inputs (slice store
    on), on the card (kernels) and on the CPU (plain versions): 2e-4
    relative per gradient tensor; under `windowed_bf16` through the classic
    recompute."""
    cfg = dataclasses.replace(WIN_CFG, windowed_bf16=bf16, chunk=32)
    grads = {}
    for dev in (torch.device("cpu"), device):
        leaves = [t.to(dev).requires_grad_(True) for t in _scene(4)]
        means, opac, scales, quats, colors, objs = leaves
        cam = make_camera(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                          W, H, 1.2, 0.9)
        out = rz.rasterize(means, opac, scales * 1.5, quats, cam, cfg, colors=colors,
                           obj_features=objs)
        loss = (out.color.square().sum() + out.depth.sum() + out.objects.sum()
                + out.final_T.sum())
        grads[dev.type] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        rel = float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-12))
        assert rel <= 2e-4, rel


def test_windowed_render_on_the_card(device):
    """`rasterize` with the default windowed path on the card: the kernel
    sort and the host table give the same bits (no window overflow), and
    both agree with the CPU's plain versions to 1e-4 absolute with the same
    counters."""
    outs = {}
    for dev in (torch.device("cpu"), device):
        means, opac, scales, quats, colors, objs = (t.to(dev) for t in _scene(2))
        cam = make_camera(torch.eye(3, device=dev), torch.zeros(3, device=dev),
                          W, H, 1.2, 0.9)
        for mode in ("host", "kernel"):
            cfg = dataclasses.replace(WIN_CFG, windowed_sort=mode)
            with torch.no_grad():
                outs[dev.type, mode] = rz.rasterize(means, opac, scales, quats, cam, cfg,
                                                    colors=colors, obj_features=objs)
    h, k = outs["cuda", "host"], outs["cuda", "kernel"]
    assert int(h.overflow_window) == 0 and int(k.overflow_window) == 0
    for f in ("color", "depth", "objects", "final_T"):
        assert torch.equal(getattr(h, f), getattr(k, f)), f
    for mode in ("host", "kernel"):
        c, g = outs["cpu", mode], outs["cuda", mode]
        for f in ("color", "depth", "objects", "alpha", "final_T"):
            torch.testing.assert_close(getattr(g, f).cpu(), getattr(c, f), atol=1e-4,
                                       rtol=0)
        for f in ("n_binned", "overflow_tile", "overflow_rect", "tile_peak"):
            assert int(getattr(g, f)) == int(getattr(c, f)), f


def test_device_associator_on_the_card_matches_the_cpu(device):
    """`DeviceInstanceAssociator` over three keyframes of a 4096-slot cloud
    (the second after a capacity growth from 2048), on the card and on the
    CPU: the votes, the remapped masks, the label memory and the freed
    labels bitwise equal (elementwise float32 projection in a fixed order,
    integer votes)."""
    rng = np.random.default_rng(4)
    L, h, w = 24, 48, 64
    intr = (50.0, 52.0, 31.5, 23.75)
    xyz = np.stack([rng.uniform(-2.5, 2.5, 4096), rng.uniform(-2, 2, 4096),
                    rng.uniform(-1, 8, 4096)], -1).astype(np.float32)
    steps = []
    for k, (cap, n_act) in enumerate([(2048, 1500), (4096, 2600), (4096, 4000)]):
        pose = np.eye(4, dtype=np.float32)
        c, s = np.cos(0.05 * k), np.sin(0.05 * k)
        pose[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        pose[:3, 3] = (0.1 * k, 0.0, 0.2 * k)
        lab = rng.choice(np.concatenate([[0], rng.permutation(np.arange(1, L))[:8]]), (6, 8))
        mask = np.repeat(np.repeat(lab, 8, 0), 8, 1).astype(np.int32)
        steps.append((xyz[:cap], np.arange(cap) < n_act, mask, pose))
    runs = {}
    for dev in (torch.device("cpu"), device):
        assoc = assoc_mod.DeviceInstanceAssociator(0.5, num_classes=L)
        outs = []
        for x, act, mask, pose in steps:
            used = set(range(1, L))
            t = lambda a: torch.as_tensor(a, device=dev)
            prev = assoc._prev_labels
            got = assoc.associate(t(x), t(act), t(mask), t(pose), intr, used_labels=used)
            votes = None
            if prev is not None and prev.shape[0] == x.shape[0]:
                votes, _ = assoc_mod._project_vote(t(x), t(act), prev, t(mask), t(pose[:3, :3]),
                                                   t(pose[:3, 3]), *intr, L, False, w, h)
                votes = votes.cpu()
            outs.append((got.cpu(), assoc._prev_labels.cpu(), used, votes))
        runs[dev.type] = outs
    for (m_c, p_c, u_c, v_c), (m_g, p_g, u_g, v_g) in zip(runs["cpu"], runs["cuda"]):
        assert torch.equal(m_c, m_g) and torch.equal(p_c, p_g) and u_c == u_g
        assert (v_c is None) == (v_g is None) and (v_c is None or torch.equal(v_c, v_g))
    assert int(runs["cuda"][-1][3].sum()) > 1000


def test_sam_encoder_on_the_card_matches_the_cpu(device):
    """SAM with the shipped weights: the encoder's features and the
    decoder's low-res logits on the card against the CPU (float32, TF32
    off), 1e-4 and 1e-3 absolute."""
    from sags_tpu_torch.models import sam

    rng = np.random.default_rng(0)
    img = rng.uniform(size=(120, 160, 3)).astype(np.float32)
    boxes = np.array([[0, 0, 100, 80], [30, 20, 160, 120], [5, 60, 90, 119]], np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        pred = sam.SamPredictor(sam.SAM.pretrained(device=dev)).set_image(img)
        low = pred.decode_boxes(pred.transform.apply_boxes(boxes, pred.original_size))
        outs[dev] = (pred.features.cpu(), low.cpu())
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=1e-4, rtol=0)
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], atol=1e-3, rtol=0)


def _registration_pair(seed=2, n=1500):
    """Two noisy planes and a blob (a well-conditioned pair), and the same
    points moved by a few degrees and centimetres."""
    from sags_tpu_torch.core.transforms import so3_exp

    rng = np.random.default_rng(seed)
    a = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                  3.0 + 0.01 * rng.normal(size=n)], -1)
    b = np.stack([-1.5 + 0.01 * rng.normal(size=n), rng.uniform(-1, 1, n),
                  rng.uniform(1, 5, n)], -1)
    c = rng.normal(size=(n // 2, 3)) * 0.2 + np.array([0.5, 0.2, 2.0])
    tgt = np.concatenate([a, b, c]).astype(np.float32)
    R = so3_exp(torch.tensor([0.02, -0.03, 0.015])).numpy()
    src = ((tgt - np.array([0.05, -0.02, 0.08], np.float32)) @ R).astype(np.float32)
    return src, tgt


def test_voxel_map_on_the_card_is_repeatable_and_matches_the_cpu(device):
    """`build_voxel_map` (additive and multiplicative) twice on the card:
    bitwise equal (each voxel's points summed in order by `segment_reduce`,
    no atomics); keys and counts equal to the CPU's, means and covariances
    to 1e-5 relative, from the same inputs."""
    from sags_tpu_torch.ops import gicp

    _, tgt = _registration_pair()
    pts = torch.as_tensor(tgt)
    mask = torch.ones(len(tgt), dtype=torch.bool)
    covs = gicp.estimate_covariances(pts, mask, 10, 2.0).covs
    maps = {}
    for dev in (torch.device("cpu"), device):
        pts, mask, covs = pts.to(dev), mask.to(dev), covs.to(dev)
        maps[dev.type] = {mode: [gicp.build_voxel_map(pts, covs, mask, 0.5, 4096, mode=mode)
                                 for _ in range(2)]
                          for mode in ("additive", "multiplicative")}
    fields = ("keys", "means", "covs", "num_points", "n_voxels", "overflow")
    for mode, (a, b) in maps["cuda"].items():
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields), mode
        c = maps["cpu"][mode][0]
        for f in ("keys", "num_points", "n_voxels", "overflow"):
            assert torch.equal(getattr(a, f).cpu(), getattr(c, f)), (mode, f)
        for f in ("means", "covs"):
            want = getattr(c, f)
            torch.testing.assert_close(getattr(a, f).cpu(), want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("align", ["vgicp_align", "gicp_align_st", "ndt_align"])
def test_registration_on_the_card_matches_the_cpu(device, align):
    """`vgicp_align`, `gicp_align_st` and `ndt_align` (P2D) on the card
    against the CPU: the same iteration counts and convergence, the pose
    within 1e-5."""
    from sags_tpu_torch.core.config import GICPConfig
    from sags_tpu_torch.ops import gicp, ndt

    src, tgt = _registration_pair()
    cfg = GICPConfig(knn_max_distance=2.0, voxel_resolution=0.5)
    res = {}
    for dev in (torch.device("cpu"), device):
        t = lambda a: torch.as_tensor(a, device=dev)
        mask = torch.ones(len(src), dtype=torch.bool, device=dev)
        res[dev.type] = getattr(ndt if align == "ndt_align" else gicp, align)(
            t(src), t(tgt), mask, mask, torch.eye(4, device=dev), cfg)
    g, c = res["cuda"], res["cpu"]
    assert (g.iterations, g.converged) == (c.iterations, c.converged)
    torch.testing.assert_close(g.T.cpu(), c.T, atol=1e-5, rtol=0)


def _room(rng, n):
    """Floor and two walls of a 5 m room (`tests/test_esikf.py`'s `make_room`)."""
    n3 = n // 3
    u = [rng.uniform(0, 5, (n3, 2)), rng.uniform(0, 5, (n3, 2)),
         rng.uniform(0, 5, (n - 2 * n3, 2))]
    z = lambda k: np.zeros(k)
    return np.concatenate([np.stack([u[0][:, 0], u[0][:, 1], z(n3)], -1),
                           np.stack([u[1][:, 0], z(n3), u[1][:, 1]], -1),
                           np.stack([z(n - 2 * n3), u[2][:, 0], u[2][:, 1]], -1)]
                          ).astype(np.float32)


def test_surfel_fold_on_the_card_is_repeatable_and_matches_the_cpu(device):
    """`esikf.surfel_map_update` of two scans (with intensities) twice on the
    card: bitwise equal (each voxel's run summed in order, no atomics);
    keys, counts and overflow equal to the CPU's, moments to 1e-5 relative."""
    from sags_tpu_torch.ops import esikf

    rng = np.random.default_rng(0)
    scans = [_room(rng, 3000) + rng.normal(0, 0.01, (3000, 3)).astype(np.float32)
             for _ in range(2)]
    its = [rng.uniform(0, 1, 3000).astype(np.float32) for _ in range(2)]
    maps = {}
    for dev in (torch.device("cpu"), device, device):
        sm = esikf.surfel_map_init(resolution=0.3, capacity=2048, device=dev)
        for pts, it in zip(scans, its):
            sm = esikf.surfel_map_update(sm, torch.as_tensor(pts, device=dev),
                                         torch.ones(len(pts), dtype=torch.bool, device=dev),
                                         intensity=torch.as_tensor(it, device=dev))
        maps.setdefault(dev.type, []).append(sm)
    (a, b), c = maps["cuda"], maps["cpu"][0]
    fields = ("keys", "n", "sum_p", "sum_pp", "sum_i", "overflow")
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
    for f in ("keys", "n", "overflow"):
        assert torch.equal(getattr(a, f).cpu(), getattr(c, f)), f
    for f in ("sum_p", "sum_pp", "sum_i"):
        want = getattr(c, f)
        torch.testing.assert_close(getattr(a, f).cpu(), want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_scan_update_on_the_card_matches_the_cpu(device):
    """One `esikf.scan_update` (10 iterations) against a surfel map of a
    room, from a perturbed prior, on the card and on the CPU: the state to
    1e-5 (P to 1e-5 relative), `n_matched` equal."""
    from sags_tpu_torch.core.transforms import so3_exp
    from sags_tpu_torch.ops import esikf

    rng = np.random.default_rng(1)
    world = _room(rng, 4000)
    R = so3_exp(torch.tensor([0.01, -0.02, 0.03])).numpy()
    t = np.array([0.05, 0.08, -0.06], np.float32)
    scan = ((_room(rng, 2000) - t) @ R).astype(np.float32)
    res = {}
    for dev in (torch.device("cpu"), device):
        sm = esikf.surfel_map_init(resolution=0.3, capacity=4096, device=dev)
        sm = esikf.surfel_map_update(sm, torch.as_tensor(world, device=dev),
                                     torch.ones(len(world), dtype=torch.bool, device=dev))
        st = esikf.init_state(device=dev)
        P = st.P.clone()
        P[:6, :6] = torch.eye(6, device=dev) * 0.05
        res[dev.type] = esikf.scan_update(
            st._replace(P=P), torch.as_tensor(scan, device=dev),
            torch.ones(len(scan), dtype=torch.bool, device=dev), esikf.surfel_map_voxels(sm),
            num_iters=10, min_planarity=0.1)
    g, c = res["cuda"], res["cpu"]
    assert int(g.n_matched) == int(c.n_matched) > 500
    for f in ("R", "p", "v", "bg", "ba", "g"):
        torch.testing.assert_close(getattr(g.state, f).cpu(), getattr(c.state, f),
                                   atol=1e-5, rtol=0)
    torch.testing.assert_close(g.state.P.cpu(), c.state.P, rtol=0,
                               atol=1e-5 * float(c.state.P.abs().max()))


def test_checkpoint_on_the_card_is_bitwise(device, tmp_path):
    """A stepped state written on the card reads back bitwise (tensors, host
    counters, the generator state); one `slam_step` from each gives bitwise
    equal states; read on the CPU, the tensors are the same numbers."""
    from torch_support import assert_states_bitwise
    from sags_tpu_torch.core.config import MapConfig, SemanticsConfig, SLAMConfig
    from sags_tpu_torch.slam import checkpoint
    from sags_tpu_torch.slam import step as slam_step

    cfg = SLAMConfig(raster=RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128,
                                            chunk=16),
                     map=MapConfig(initial_capacity=512, initial_scale=0.06),
                     semantics=SemanticsConfig(cls3d_sample=16, num_classes=20,
                                               cls3d_interval=1))
    means, _, _, _, colors, _ = (t.to(device) for t in _scene(4, n=300))
    s = slam_step.init_state(cfg, seed=3, device=device)
    s, _ = slam_step.add_frame_points(s, means, colors, torch.ones(300, dtype=torch.bool,
                                                                    device=device), cfg)
    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device), W, H,
                      1.2, 0.9)
    img = torch.rand((3, H, W), device=device, generator=torch.Generator(device).manual_seed(1))
    objs = torch.zeros((H, W), dtype=torch.int32, device=device)
    s, _ = slam_step.slam_step(s, cam, img, objs, cfg)
    checkpoint.save_state(str(tmp_path), s, cfg)
    back, cfg2 = checkpoint.load_state(str(tmp_path), device=device)
    on_cpu, _ = checkpoint.load_state(str(tmp_path), device="cpu")
    assert cfg2 == cfg

    assert_states_bitwise(s, back)
    assert_states_bitwise(s, on_cpu, generator=False)
    s1, m1 = slam_step.slam_step(s, cam, img, objs, cfg)
    s2, m2 = slam_step.slam_step(back, cam, img, objs, cfg)
    assert float(m1.loss_obj_3d) > 0 and torch.equal(m1.loss, m2.loss)
    assert_states_bitwise(s1, s2)


def test_sam_gradients_on_the_card_are_bitwise(device):
    """Two backward passes of one SAM training batch give bitwise equal
    gradients in every parameter, the upscaling's included."""
    from sags_tpu_torch.models import sam_train
    from sags_tpu_torch.models.sam import SAM

    sam = SAM(device=device, seed=0)
    g = torch.Generator(device).manual_seed(0)
    imgs = torch.rand((4, 256, 256, 3), device=device, generator=g)
    boxes = torch.tensor([[20.0, 30.0, 120.0, 140.0]] * 4, device=device)
    masks = torch.zeros((4, 64, 64), device=device)  # the decoder's resolution
    masks[:, 8:35, 5:30] = 1.0
    params = list(sam.parameters())

    def grads():
        with torch.enable_grad():
            return torch.autograd.grad(sam_train._loss_fn(sam, imgs, boxes, masks), params)

    g1, g2 = grads(), grads()
    for (name, _), a, b in zip(sam.named_parameters(), g1, g2):
        assert torch.equal(a, b), name
    ups = [float(a.abs().max()) for (n, _), a in zip(sam.named_parameters(), g1)
           if ".up1." in n or ".up2." in n]
    assert len(ups) == 4 and min(ups) > 0


def test_robust_inv3_on_the_card_matches_the_cpu(device):
    """The pseudo-inverse fallback over a batch past cuSOLVER's batched
    eigensolver limit (chunked): the card's result within 1e-4 relative of
    the CPU's, the singular matrices included."""
    from sags_tpu_torch.ops.gicp import robust_inv3

    g = torch.Generator().manual_seed(0)
    A = torch.randn((65536, 3, 3), generator=g)
    A = A @ A.transpose(-1, -2) + 0.1 * torch.eye(3)
    A[::7] = 0.0
    want = robust_inv3(A)
    got = robust_inv3(A.to(device)).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_native_library_against_its_fallback_on_the_card(device, monkeypatch):
    """The native host library (built into the port's build directory)
    against its fallbacks run on the card: the same voxel centroids within
    1e-5, kNN distances within 1e-5 plus the float32 rounding of the
    fallback's |q|^2 + |p|^2 - 2 q.p (`torch_support.knn_bar`) and the same
    neighbours, the decode bitwise."""
    from sags_tpu_torch.io import native
    from torch_support import knn_bar

    assert native.available(), native.build_error
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(1024, 3)) * 3).astype(np.float32)
    ds_n = native.voxel_downsample(pts, 0.5)
    d2_n, idx_n = native.KDTree(pts).knn(pts[:128], 6)
    raw = np.zeros((64, 8), "<f4")
    raw[:, :3] = pts[:64]
    raw[:, 4] = rng.integers(0, 1 << 24, 64).astype(np.uint32).view(np.float32)
    dec_n = native.decode_xyzrgb(raw.tobytes(), 32)
    monkeypatch.setattr(native, "_library", lambda: None)
    ds_f = native.voxel_downsample(pts, 0.5, device=device)
    d2_f, idx_f = native.KDTree(pts, device=device).knn(pts[:128], 6)
    dec_f = native.decode_xyzrgb(raw.tobytes(), 32)
    order = lambda a: a[np.lexsort(np.floor(a / 0.5).T)]
    assert len(ds_n) == len(ds_f)
    np.testing.assert_allclose(order(ds_n), order(ds_f), atol=1e-5, rtol=0)
    assert (np.abs(d2_n - d2_f) <= knn_bar(pts[:128], d2_n)).all()
    assert np.array_equal(idx_n, idx_f)
    assert all(np.array_equal(a, b) for a, b in zip(dec_n, dec_f))


def test_viewer_request_on_the_card_is_render_map(device):
    """One SIBR request served by the CLI's viewer loop on the card: the
    reply is bitwise the uint8 image of `render_map` at the request's
    camera, rendered on the windowed host-table path (one `fill_table` and
    one `composite_windowed` launch)."""
    import threading

    from sags_tpu_torch.cli.main import serve_viewer
    from sags_tpu_torch.core.config import MapConfig, SLAMConfig
    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.slam.step import render_map
    from sags_tpu_torch.utils.draws import TorchDraws
    from sags_tpu_torch.viz.network_gui import MiniCam, NetworkGUI
    from torch_support import launch_counts, sibr_request, unflip, viewer_client

    means, _, _, _, colors, _ = (t.to(device) for t in _scene(6, n=300))
    m = gm.init_map(512, MapConfig(initial_scale=0.08), device)
    m, _ = gm.add_points(m, means, colors, torch.ones(300, dtype=torch.bool, device=device),
                         TorchDraws(0, device), initial_scale=0.08, initial_opacity=0.6)
    cfg = SLAMConfig()
    msg = sibr_request(make_camera(np.eye(3), np.array([0.1, 0.0, -0.2]), W, H, 1.2, 0.9,
                                   device=device))
    gui = NetworkGUI(port=0, device=device)
    out, served = {}, []
    # the loop in a thread, the client here: a failing client raises
    server = threading.Thread(target=lambda: served.append(serve_viewer(gui, m, cfg, requests=1)),
                              daemon=True)
    _build.reset_launch_counts()
    server.start()
    try:
        viewer_client(gui.listener.getsockname()[1], [msg], out)
        server.join(60.0)
    finally:
        gui.close()
    assert served == [1]
    counts = launch_counts()
    assert counts["sags_fill_table"] == 1 and counts["sags_composite_windowed"] == 1
    assert counts["sags_composite_fused"] == 0
    cam = MiniCam(W, H, msg["fov_y"], msg["fov_x"], msg["z_near"], msg["z_far"],
                  *unflip(msg), device=device).camera
    with torch.no_grad():
        color = render_map(m, cam, cfg).color.cpu().numpy()
    want = np.clip(color * 255, 0, 255).astype(np.uint8).transpose(1, 2, 0)
    (img, verify), = out["replies"]
    assert verify == "ok" and img == np.ascontiguousarray(want).tobytes() and want.max() > 0


def _loop(device, n_frames=6, imu_substeps=0, **kw):
    """A tiny SLAM loop on `device`: its `SLAMConfig` (64x48 frames,
    512-point scans, a 4096-slot map, a keyframe every 2nd frame and replay
    between, so every frame trains; `kw` over its fields) and its frames."""
    from sags_tpu_torch.core.config import (GICPConfig, KeyframeConfig, MapConfig,
                                            SemanticsConfig, SLAMConfig, TrackingConfig)
    from sags_tpu_torch.io.datasets import SyntheticDataset

    cfg = SLAMConfig(
        raster=RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32),
        map=MapConfig(initial_capacity=4096, initial_scale=0.08),
        semantics=SemanticsConfig(cls3d_sample=32, num_classes=24),
        keyframes=KeyframeConfig(keyframe_freq=2, window=8),
        tracking=TrackingConfig(backend="gicp", max_points=512),
        gicp=GICPConfig(max_iterations=24, knn_max_distance=2.0),
        post_train_iters=0, metrics_interval=2).replace(**kw)
    frames = list(SyntheticDataset(n_frames=n_frames, width=W, height=H, n_world=4096,
                                   pts_per_frame=512, step=0.1, clutter=0.3,
                                   imu_substeps=imu_substeps, device=device))
    return cfg, frames


# the kernels a training step launches once on each render path
STEP_KERNELS = {"classic": ("sags_preprocess", "sags_preprocess_bwd", "sags_expand_pairs",
                            "sags_fill_table", "sags_composite_fused",
                            "sags_composite_fused_bwd"),
                "windowed": ("sags_preprocess", "sags_preprocess_bwd",
                             "sags_composite_windowed", "sags_composite_windowed_bwd")}


@pytest.mark.parametrize("frontend,path", [("fused", "classic"), ("modules", "classic"),
                                           ("fused", "windowed")])
def test_slam_loop_on_the_card_launches_each_kernel_once_a_step(device, frontend, path):
    """`SLAMPipeline.run` over six frames on the card: one finite loss a
    frame, read from the fused front-end's metrics ring or the per-module
    front-end's host row, and each kernel of the render path launched once
    a training step; the windowed path never launches the classic
    compositors. The "gicp" tracker's align kernel launches once a tracked
    frame (every frame but the first), in either front-end, and the
    covariance kernel once a frame for each `estimate_covariances` call:
    twice in the fused front-end with `surfel_init` (tracking and the new
    points' surfels), once in the per-module front-end (tracking)."""
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from torch_support import launch_counts

    cfg, frames = _loop(device, fused_frontend=frontend == "fused")
    if path == "windowed":
        cfg = cfg.replace(raster=dataclasses.replace(cfg.raster, chunk=16, train_windowed=True,
                                                     windowed_big_capacity=64))
    pipe = SLAMPipeline(cfg, point_budget=512, rng_seed=0, device=device)
    _build.reset_launch_counts()
    res = pipe.run(frames, post_train=0)
    counts = launch_counts()
    assert res.train_iters == len(res.losses) == len(frames)
    assert np.isfinite(res.losses).all()
    for sym in STEP_KERNELS[path]:
        assert counts[sym] == res.train_iters, (sym, counts)
    if path == "windowed":
        assert counts["sags_composite_fused"] == counts["sags_composite_fused_bwd"] == 0
    assert counts["sags_gicp_align"] == len(frames) - 1 == len(pipe.lm_log), counts
    assert cfg.map.surfel_init
    calls = 2 if frontend == "fused" else 1
    assert counts["sags_covariances"] == calls * len(frames), counts


# the functions a sync is charged to: the innermost of these on its stack
SYNC_STAGES = ("_track_esikf", "_track", "slam_step", "_train_once", "add_frame_points",
               "_maybe_grow_map")


@pytest.mark.parametrize("backend", ["esikf", "gicp"])
def test_per_module_frame_on_the_card_syncs_once_a_step(device, backend, monkeypatch):
    """The per-module front-end on the card under
    `torch.cuda.set_sync_debug_mode("warn")`, every sync charged to the
    innermost of `SYNC_STAGES` on its stack: each frame's training step
    reads its scalars in one fetch (`_train_once`, one host row), the
    ESIKF tracker reads nothing once its surfel map is live and its
    bootstrap done (frame 2 on), and the "gicp" tracker nothing from its
    first align on (frame 1: one launch of the align kernel a frame)."""
    import traceback
    import warnings

    from sags_tpu_torch.slam.pipeline import SLAMPipeline

    cfg, frames = _loop(device, imu_substeps=5, fused_frontend=False)
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, backend=backend))
    pipe = SLAMPipeline(cfg, point_budget=512, rng_seed=0, device=device)
    per_frame = []
    frame_modules = pipe._frame_modules

    def counted_frame(*a, **k):
        per_frame.append({})
        return frame_modules(*a, **k)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message) and per_frame:
            names = [f.name for f in traceback.extract_stack()[:-1]]
            stage = next((n for n in reversed(names) if n in SYNC_STAGES), "other")
            per_frame[-1][stage] = per_frame[-1].get(stage, 0) + 1

    monkeypatch.setattr(pipe, "_frame_modules", counted_frame)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        monkeypatch.setattr(warnings, "showwarning", show)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = pipe.run(frames, post_train=0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert len(per_frame) == res.train_iters == len(frames)
    assert np.isfinite(res.losses).all()
    assert [c.get("_train_once", 0) for c in per_frame] == [1] * len(frames), per_frame
    if backend == "esikf":
        assert all(c.get("_track_esikf", 0) == 0 for c in per_frame[2:]), per_frame
    else:
        assert all(c.get("_track", 0) == 0 for c in per_frame[1:]), per_frame


def test_offline_trainer_on_the_card_launches_each_kernel_once_an_iteration(device):
    """`train_offline` on the card over three frames for 8 iterations, with
    densification at 4 and 8 and the opacity reset at 8: finite losses,
    each classic kernel launched once an iteration and no other kernel."""
    from sags_tpu_torch.core.config import MapConfig, OptimizationConfig, SLAMConfig
    from sags_tpu_torch.io.datasets import SyntheticDataset
    from sags_tpu_torch.slam import offline
    from torch_support import launch_counts

    cfg = SLAMConfig(
        raster=RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32),
        map=MapConfig(initial_capacity=8192),
        opt=OptimizationConfig(feature_lr=0.05, opacity_lr=0.1, scaling_lr=0.02,
                               densify_grad_threshold=1e-4, densify_from_iter=4,
                               densification_interval=4, opacity_reset_interval=8))
    frames = list(SyntheticDataset(n_frames=3, width=96, height=64, n_world=1500,
                                   pts_per_frame=600, step=0.2, device=device))
    iterations = 8
    _build.reset_launch_counts()
    _, losses = offline.train_offline(frames, cfg, iterations, capacity=4096, seed=0,
                                      device=device)
    counts = launch_counts()
    assert len(losses) == iterations and np.isfinite(losses).all()
    assert {s: n for s, n in counts.items() if n} == dict.fromkeys(STEP_KERNELS["classic"],
                                                                   iterations)


def test_header_edit_changes_the_library_hash(monkeypatch, tmp_path):
    """A library is named by its source and every `csrc/` header it
    includes: editing a header that only an included header includes still
    builds anew instead of loading a stale library."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    name = "composite_windowed_sorted.cu"
    assert set(_build.source_files(name)) == {name, "bitonic.cuh", "qmin.cuh", "windowed.cuh"}
    before = {s: _build._lib_path(s) for s in ("sort_blocks.cu", name, "fill_table.cu")}
    with open(os.path.join(src, "bitonic.cuh"), "a") as f:
        f.write("\n// edited\n")
    after = {s: _build._lib_path(s) for s in before}
    assert after["sort_blocks.cu"] != before["sort_blocks.cu"]
    assert after[name] != before[name]
    assert after["fill_table.cu"] == before["fill_table.cu"]
