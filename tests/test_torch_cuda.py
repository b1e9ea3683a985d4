"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. A CUDA kernel has no CPU mode, so every kernel test here
needs an NVIDIA GPU with `nvcc` and skips elsewhere (the library-hash test
runs anywhere). This file imports no JAX, so it runs on a machine without
it:

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


def test_header_edit_changes_the_library_hash(monkeypatch, tmp_path):
    """A library is named by its source and every `csrc/` header it
    includes: editing a header that only an included header includes still
    builds anew instead of loading a stale library."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    name = "composite_windowed_sorted.cu"
    assert set(_build.source_files(name)) == {name, "bitonic.cuh", "windowed.cuh"}
    before = {s: _build._lib_path(s) for s in ("sort_blocks.cu", name, "fill_table.cu")}
    with open(os.path.join(src, "bitonic.cuh"), "a") as f:
        f.write("\n// edited\n")
    after = {s: _build._lib_path(s) for s in before}
    assert after["sort_blocks.cu"] != before["sort_blocks.cu"]
    assert after[name] != before[name]
    assert after["fill_table.cu"] == before["fill_table.cu"]
