"""Port parity: the plain PyTorch versions of the three main-path kernels
(`fill_table`, `composite_fused`, `composite_fused_bwd`) against their JAX
counterparts on the CPU — the XLA scatter branch of `bin_gaussians` for the
table, and the Pallas compositor kernels run with `interpret=True`.

On the CPU every wrapper takes its plain version; the CUDA kernels are held
against the same plain versions on the card by `chip_smoke.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core.camera import make_camera as jax_make_camera
from sags_tpu.core.config import RasterizeConfig
from sags_tpu.ops import pallas_composite as jpc
from sags_tpu.ops import pallas_sort as jps
from sags_tpu.ops import rasterize as jrz
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.ops import binning, composite, sort
from sags_tpu_torch.ops import rasterize as trz

W, H = 64, 48
TILES_X, TILES_Y = 4, 3


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
    return means, opac, scales, quats, colors, objs


def _both(seed, K, chunk):
    """(JAX preprocess, port preprocess, cfgs) of one scene."""
    kw = dict(max_tiles_per_gaussian=16, tile_capacity=K, chunk=chunk)
    jcfg, tcfg = RasterizeConfig(**kw), tconf.RasterizeConfig(**kw)
    means, opac, scales, quats, colors, objs = _scene(seed)
    jc = jax_make_camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), W, H, 1.2, 0.9)
    tc = make_camera(torch.eye(3), torch.zeros(3), W, H, 1.2, 0.9)
    pj = jrz.preprocess(*map(jnp.asarray, (means, opac, scales, quats)), jc, jcfg,
                        colors=jnp.asarray(colors))
    pt = trz.preprocess(*map(torch.as_tensor, (means, opac, scales, quats)), tc, tcfg,
                        colors=torch.as_tensor(colors))
    return pj, pt, jcfg, tcfg, objs


@pytest.mark.parametrize("K", [16, 64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_fill_table_plain_matches_xla_scatter(seed, K):
    """Exactly equal tables, counts and overflow counters (K=16 overflows)."""
    pj, pt, jcfg, tcfg, _ = _both(seed, K, min(16, K))
    table_j, counts_j, nb_j, ovr_j, ovt_j, seg_j = jrz.bin_gaussians(pj, TILES_X, TILES_Y, jcfg)
    gid_s, starts, ovr_t = trz.sort_pairs(pt, TILES_X, TILES_Y, tcfg)
    table_t = binning.fill_table(gid_s, starts, TILES_X * TILES_Y, K)
    np.testing.assert_array_equal(table_t.numpy(), np.asarray(table_j))
    seg = (starts[1:] - starts[:-1]).numpy()
    np.testing.assert_array_equal(seg, np.asarray(seg_j))
    np.testing.assert_array_equal(np.minimum(seg, K), np.asarray(counts_j))
    assert int(starts[-1]) == int(nb_j) and int(ovr_t) == int(ovr_j)
    assert int(np.maximum(seg - K, 0).sum()) == int(ovt_j)


def test_fill_table_plain_segments():
    """Hand-made segments: empty tiles, a tile longer than K, the last tile."""
    gid = torch.arange(100, 140, dtype=torch.int32)
    starts = torch.tensor([0, 0, 5, 25, 40], dtype=torch.int32)
    out = binning.fill_table_plain(gid, starts, 4, 8).numpy()
    want = -np.ones((4, 8), np.int32)
    want[1, :5] = np.arange(100, 105)
    want[2, :8] = np.arange(105, 113)
    want[3, :8] = np.arange(125, 133)
    np.testing.assert_array_equal(out, want)


def _packed(seed, K, chunk):
    pj, pt, jcfg, tcfg, objs = _both(seed, K, chunk)
    table_j, counts_j = jrz.bin_gaussians(pj, TILES_X, TILES_Y, jcfg)[:2]
    G = trz._pack_gaussians(pt, torch.as_tensor(objs))
    table = torch.as_tensor(np.array(table_j))
    counts = torch.as_tensor(np.array(counts_j))
    return G, table, counts


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("toff", [0, 3])
def test_composite_fused_plain_matches_pallas(chunk, toff):
    """The plain forward against the Pallas kernel in interpret mode, for the
    Pallas chunk sizes: 1e-5 absolute (the same float32 arithmetic; the
    feature sums and prefix products are taken in another order)."""
    G, table, counts = _packed(0, 128, chunk)
    gt = jnp.asarray(G.numpy())[jnp.maximum(jnp.asarray(table.numpy()), 0)].transpose(0, 2, 1)
    acc_j, T_j = jpc.composite_fused(gt, jnp.asarray(counts.numpy()), 16, TILES_X,
                                     chunk=chunk, tile_offset=jnp.asarray([toff]),
                                     interpret=True)
    acc_t, T_t = composite.composite_fused(G, table, counts, 16, TILES_X, chunk=chunk,
                                           tile_offset=toff)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), atol=1e-5)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
    assert float(T_t.min()) >= 1e-4 * (1 - 1e-6)  # the floor is never crossed


@pytest.mark.parametrize("chunk", [32, 128])
def test_composite_fused_bwd_plain_matches_pallas(chunk):
    """The plain backward against the Pallas backward in interpret mode:
    ≤ 2e-4 relative per output row (the JAX package's own bar for its fused
    backward; the Pallas kernel recomputes T in log space, the plain version
    with a linear product)."""
    G, table, counts = _packed(1, 128, chunk)
    rng = np.random.default_rng(5)
    NT = TILES_X * TILES_Y
    d_acc = rng.normal(size=(NT, 256, 24)).astype(np.float32)
    d_T = rng.normal(size=(NT, 256)).astype(np.float32)
    _, T = composite.composite_fused(G, table, counts, 16, TILES_X, chunk=chunk)
    gt = jnp.asarray(G.numpy())[jnp.maximum(jnp.asarray(table.numpy()), 0)].transpose(0, 2, 1)
    dgt_j = np.asarray(jpc.composite_fused_bwd(
        gt, jnp.asarray(counts.numpy()), jnp.asarray(d_acc), jnp.asarray(d_T),
        jnp.asarray(T.numpy()), 16, TILES_X, chunk=chunk, interpret=True))
    dgt_t = composite.composite_fused_bwd(G, table, counts, torch.as_tensor(d_acc),
                                          torch.as_tensor(d_T), T, 16, TILES_X,
                                          chunk=chunk).numpy()
    assert dgt_t.shape == dgt_j.shape == (NT, 32, 128)
    scale = np.abs(dgt_j).max(axis=(0, 2))
    live = scale > 0
    rel = np.abs(dgt_t - dgt_j).max(axis=(0, 2))[live] / scale[live]
    assert rel.max() <= 2e-4, rel
    np.testing.assert_array_equal(dgt_t[:, ~live], 0.0)


def _far_and_sharp(seed, P=320, K=128):
    """Packed rows made by hand over the 4x3 tiles: ordinary splats, wide
    ones centred 100-250 pixels outside the image (their conics small enough
    to pass the alpha gate there) and sharp, tilted ones (sigma 0.4-1 pixel)
    inside it; a random table with an empty tile and a full one."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, P)
    far, sharp = kind == 1, kind == 2
    mx = rng.uniform(0, W, P)
    my = rng.uniform(0, H, P)
    side = rng.integers(0, 2, P) * 2 - 1
    mx = np.where(far, np.where(side > 0, W + rng.uniform(100, 250, P),
                                -rng.uniform(100, 250, P)), mx)
    my = np.where(far, my + side * rng.uniform(0, 150, P), my)
    sig = np.where(far, rng.uniform(40, 90, (2, P)),
                   np.where(sharp, rng.uniform(0.4, 1.0, (2, P)), rng.uniform(2, 10, (2, P))))
    rho = rng.uniform(-0.8, 0.8, P)
    det = (sig[0] * sig[1]) ** 2 * (1 - rho ** 2)
    ca, cc = sig[1] ** 2 / det, sig[0] ** 2 / det
    cb = -rho * sig[0] * sig[1] / det
    op = rng.uniform(0.3, 0.99, P)
    G = np.zeros((P, 32), np.float32)
    G[:, :6] = np.stack([mx, my, ca, cb, cc, op], -1)
    G[:, 8:] = rng.normal(size=(P, 24))
    NT = TILES_X * TILES_Y
    table = rng.integers(0, P, (NT, K)).astype(np.int32)
    counts = rng.integers(K // 4, K + 1, NT).astype(np.int32)
    counts[1], counts[2] = 0, K
    table[np.arange(K)[None, :] >= counts[:, None]] = -1
    return torch.as_tensor(G), torch.as_tensor(table), torch.as_tensor(counts), far, sharp


def _row_rel(got, want):
    scale = np.abs(want).max(axis=(0, 2))
    live = scale > 0
    return np.abs(got - want).max(axis=(0, 2))[live] / scale[live], live


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_composite_fused_bwd_matrix_form(seed, chunk):
    """The backward's sums over a tile's pixels as the CUDA kernel takes them
    (two float32 matrix products, the geometry gradients from six moments
    about the tile's centre) against the direct sums and against the Pallas
    backward in interpret mode: ≤ 2e-4 relative per output row, on splats
    100+ pixels from the tile (where the moment expansion cancels most) and
    on sharp conics."""
    G, table, counts, far, sharp = _far_and_sharp(seed)
    NT, K = table.shape
    rng = np.random.default_rng(seed + 10)
    d_acc = rng.normal(size=(NT, 256, 24)).astype(np.float32)
    d_T = rng.normal(size=(NT, 256)).astype(np.float32)
    _, T = composite.composite_fused(G, table, counts, 16, TILES_X, chunk=chunk)
    args = (G, table, counts, torch.as_tensor(d_acc), torch.as_tensor(d_T), T, 16, TILES_X)
    direct = composite.composite_fused_bwd_plain(*args, chunk=chunk).numpy()
    matrix = composite.composite_fused_bwd_plain(*args, chunk=chunk, matrix_form=True).numpy()
    # the far and the sharp splats both carry gradient in this scene
    ids = table.numpy()
    geom = np.abs(direct[:, :5]).sum(axis=1)
    for which in (far, sharp):
        assert geom[(ids >= 0) & which[np.maximum(ids, 0)]].max() > 0
    rel, live = _row_rel(matrix, direct)
    assert live[:6].all() and live[8:].all() and rel.max() <= 2e-4, rel
    np.testing.assert_array_equal(matrix[:, 6:8], 0.0)
    np.testing.assert_array_equal(matrix[1], 0.0)  # the empty tile
    gt = jnp.asarray(G.numpy())[jnp.maximum(jnp.asarray(ids), 0)].transpose(0, 2, 1)
    dgt_j = np.asarray(jpc.composite_fused_bwd(
        gt, jnp.asarray(counts.numpy()), jnp.asarray(d_acc), jnp.asarray(d_T),
        jnp.asarray(T.numpy()), 16, TILES_X, chunk=chunk, interpret=True))
    rel_j, _ = _row_rel(matrix, dgt_j)
    assert rel_j.max() <= 2e-4, rel_j


SORT_SHAPES = [(3, 1, 2), (3, 1, 4), (3, 1, 8), (2, 1, 16), (2, 1, 64), (2, 1, 128),
               (2, 2, 128), (2, 4, 128), (2, 8, 128), (2, 16, 128), (1, 32, 128),
               (1, 64, 128)]


@pytest.mark.parametrize("E", [1, 2, 8])
@pytest.mark.parametrize("shape", SORT_SHAPES, ids=lambda s: f"n{s[1] * s[2]}")
def test_sort_network_schedule(shape, E):
    """The stage schedule of `csrc/bitonic.cuh` (in-thread, by shuffle, in
    transposed rounds through shared memory) run in plain PyTorch with the
    kernel's index arithmetic: every stage of the network exactly once, in
    order, each placed by its distance; exactly `torch.sort` and the JAX
    package's network in interpret mode, on random keys and heavy ties."""
    n = shape[1] * shape[2]
    stages = sort.network_schedule(n, E)
    want = [(k, j) for k in (2 << i for i in range(n.bit_length() - 1))
            for j in (k >> (s + 1) for s in range(k.bit_length() - 1))]
    assert [(k, j) for k, j, _, _ in stages] == want
    for k, j, place, b in stages:
        if j < E or j >= 32 * E:  # a round also takes the stages below its first
            assert place == ("thread" if j < E else "round")
        if place == "round":  # the thread's registers span j: b <= log2(j) < b + log2(E)
            assert b <= j.bit_length() - 1 < b + max(E.bit_length() - 1, 1)
        else:
            assert place == ("thread" if j < E else "shuffle")
    rng = np.random.default_rng(n + E)
    for hi in (2 ** 31, 4):
        x = torch.as_tensor(rng.integers(-hi, hi, size=shape).astype(np.int32))
        got = sort.sort_blocks_network_plain(x, E)
        assert torch.equal(got, sort.sort_blocks_plain(x))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jps.sort_blocks(jnp.asarray(x.numpy()), interpret=True)))


def test_scatter_rows_sums_by_id():
    rng = np.random.default_rng(2)
    NT, CH, K, P = 6, 32, 16, 40
    table = rng.integers(-1, P, (NT, K)).astype(np.int32)
    dgt = rng.normal(size=(NT, CH, K)).astype(np.float32)
    want = np.zeros((P, CH), np.float64)
    rows = dgt.transpose(0, 2, 1).reshape(-1, CH)
    for r, g in zip(rows, table.reshape(-1)):
        if g >= 0:
            want[g] += r
    got = composite.scatter_rows(torch.as_tensor(dgt), torch.as_tensor(table), P)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    again = composite.scatter_rows(torch.as_tensor(dgt), torch.as_tensor(table), P)
    assert torch.equal(got, again)


def test_scatter_rows_mostly_padding():
    """A table that is mostly padding: the padding rows span several of the
    scatter's padding segments and none of them reaches dG."""
    rng = np.random.default_rng(4)
    NT, CH, K, P = 12, 32, 64, 30
    table = np.where(rng.uniform(size=(NT, K)) < 0.8, -1,
                     rng.integers(0, P, (NT, K))).astype(np.int32)
    dgt = rng.normal(size=(NT, CH, K)).astype(np.float32)
    want = np.zeros((P, CH), np.float64)
    np.add.at(want, table[table >= 0], dgt.transpose(0, 2, 1)[table >= 0])
    got = composite.scatter_rows(torch.as_tensor(dgt), torch.as_tensor(table), P)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card raises instead
    of falling back to the plain version."""
    meta = torch.device("meta")
    gid = torch.zeros(8, dtype=torch.int32, device=meta)
    starts = torch.zeros(3, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        binning.fill_table(gid, starts, 2, 16)
    G = torch.zeros((4, 32), device=meta)
    table = torch.zeros((2, 16), dtype=torch.int32, device=meta)
    counts = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        composite.composite_fused(G, table, counts, 16, 2)
    with pytest.raises(ValueError):
        composite.composite_fused_bwd(G, table, counts, torch.zeros((2, 256, 24), device=meta),
                                      torch.zeros((2, 256), device=meta),
                                      torch.zeros((2, 256), device=meta), 16, 2)
