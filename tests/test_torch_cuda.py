"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. A CUDA kernel has no CPU mode, so every test here needs an
NVIDIA GPU with `nvcc` and skips elsewhere. This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

`chip_smoke.py` holds the same kernels at the full slice shapes.
"""

import numpy as np
import pytest
import torch

from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.core.config import RasterizeConfig
from sags_tpu_torch.ops import binning, composite
from sags_tpu_torch.ops import rasterize as rz

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
