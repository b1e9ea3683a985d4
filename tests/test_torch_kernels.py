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
from sags_tpu_torch.ops import binning, composite, sort, windowed
from sags_tpu_torch.ops import rasterize as trz

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

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


def _fill_edge_segments(K, seed=0):
    """Segments for `fill_table`'s edge cases: counts of 0, 1-3 and 5-7 (a
    vector half inside), exactly K, above K, starts at every residue mod 4,
    and the last segment ending at n_sorted."""
    rng = np.random.default_rng(seed)
    counts = [0, 1, 2, 3, 5, 6, 7, K, K + 37, 0, 4 * K, 9]
    counts += list(rng.integers(0, 2 * K, 12))
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    gid = rng.permutation(int(starts[-1]) + 11)[:int(starts[-1])].astype(np.int32)
    return gid, starts, len(counts)


def _fill_table_vector_model(gid, starts, NT, K, n_threads):
    """The CUDA kernel's indexing in numpy: thread `tid` of a grid of
    `n_threads` takes vectors tid, tid + n_threads, ...; vector v is row
    v // (K/4), columns 4 (v % (K/4)) .. +3; a vector wholly past the
    tile's count stores -1 without reading. Returns (table, writes per
    vector, the ids' positions read)."""
    n, vpr = len(gid), K // 4
    out = np.full((NT * vpr, 4), 7777, np.int32)
    writes = np.zeros(NT * vpr, np.int64)
    reads = []
    for tid in range(n_threads):
        for v in range(tid, NT * vpr, n_threads):
            t, k0 = v // vpr, 4 * (v % vpr)
            s = int(starts[t])
            cnt = min(int(starts[t + 1]) - s, K)
            o = [-1, -1, -1, -1]
            if k0 < cnt:
                for j in range(4):
                    if k0 + j < cnt and s + k0 + j < n:
                        o[j] = int(gid[s + k0 + j])
                        reads.append(s + k0 + j)
            out[v] = o
            writes[v] += 1
    return out.reshape(NT, K), writes, np.asarray(reads)


@pytest.mark.parametrize("n_threads", [64, 100_000])
@pytest.mark.parametrize("K", [16, 128])
def test_fill_table_vector_indexing(K, n_threads):
    """The kernel's 16-byte-vector grid-stride indexing equals the plain
    version on the edge cases, writes every vector once whether the grid is
    smaller or larger than the work, and reads exactly the kept ids, each
    once."""
    gid, starts, NT = _fill_edge_segments(K)
    got, writes, reads = _fill_table_vector_model(gid, starts, NT, K, n_threads)
    want = binning.fill_table_plain(torch.as_tensor(gid), torch.as_tensor(starts),
                                    NT, K).numpy()
    np.testing.assert_array_equal(got, want)
    assert (writes == 1).all()
    kept = np.concatenate([np.arange(s, s + min(e - s, K))
                           for s, e in zip(starts[:-1], starts[1:])])
    np.testing.assert_array_equal(np.sort(reads), kept)
    assert int(starts[-1]) == len(gid)  # the last segment ends at n_sorted


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


def _conic_rows(rng, mx, my, s_major, s_minor, theta, op):
    """Packed rows [P, 32] of splats with the given centres, axes (pixels),
    major-axis angles and opacities; random features."""
    cs, sn = np.cos(theta), np.sin(theta)
    ia, ib = 1.0 / s_major ** 2, 1.0 / s_minor ** 2
    G = np.zeros((len(mx), 32), np.float32)
    G[:, :6] = np.stack([mx, my, cs * cs * ia + sn * sn * ib, cs * sn * (ia - ib),
                         sn * sn * ia + cs * cs * ib, op], -1)
    G[:, 8:] = rng.normal(size=(len(mx), 24))
    return G


ALPHA_MIN = np.float32(1.0 / 255.0)
STRIP_CASES = ["mixed", "far", "sharp", "alpha_edge", "small"] + [f"thin_{i}" for i in range(8)]


def _strip_scene(case, P=320, K=128):
    """Packed rows and a random table over the 4x3 tiles for one family of
    splats that a strip cull could get wrong."""
    rng = np.random.default_rng(STRIP_CASES.index(case))
    u = rng.uniform
    if case == "mixed":
        return _far_and_sharp(3, P, K)[:3]
    if case == "far":  # wide, tilted, centred 100-250 pixels outside the image
        side = rng.integers(0, 2, P) * 2 - 1
        mx = np.where(side > 0, W + u(100, 250, P), -u(100, 250, P))
        G = _conic_rows(rng, mx, u(-150, H + 150, P), u(60, 140, P), u(30, 60, P),
                        u(0, np.pi, P), u(0.3, 0.99, P))
    elif case == "sharp":  # sigma 0.4 pixels, on and between pixel centres
        mx, my = u(0, W, P), u(0, H, P)
        mx[::3], my[::3] = np.round(mx[::3]), np.round(my[::3])
        G = _conic_rows(rng, mx, my, np.full(P, 0.4), np.full(P, 0.4), u(0, np.pi, P),
                        u(0.05, 0.99, P))
    elif case == "alpha_edge":  # opacity an ulp below, at and an ulp above alpha_min:
        # such a pair gates only where its exponent is exactly zero
        op = np.array([np.nextafter(ALPHA_MIN, np.float32(0)), ALPHA_MIN,
                       np.nextafter(ALPHA_MIN, np.float32(1))], np.float32)[rng.integers(0, 3, P)]
        G = _conic_rows(rng, np.round(u(0, W, P)), np.round(u(0, H, P)), u(1, 5, P),
                        u(0.5, 2, P), u(0, np.pi, P), op)
    elif case == "small":
        G = _conic_rows(rng, u(0, W, P), u(0, H, P), u(0.8, 2.0, P), u(0.5, 0.8, P),
                        u(0, np.pi, P), u(0.3, 0.99, P))
    else:  # aspect 50:1 at one of eight angles, centres in and around the image
        minor = u(0.5, 2.0, P)
        theta = int(case[5:]) * np.pi / 8 + u(-0.02, 0.02, P)
        G = _conic_rows(rng, u(-50, W + 50, P), u(-50, H + 50, P), 50 * minor, minor, theta,
                        u(0.05, 0.99, P))
    NT = TILES_X * TILES_Y
    table = rng.integers(0, P, (NT, K)).astype(np.int32)
    counts = rng.integers(K // 2, K + 1, NT).astype(np.int32)
    counts[1], counts[2] = 0, K
    table[np.arange(K)[None, :] >= counts[:, None]] = -1
    table[3, 5] = -1  # an empty slot below a tile's count
    return torch.as_tensor(G), torch.as_tensor(table), torch.as_tensor(counts)


def _strips(G, table, counts, toff=0):
    """(strip_live [NT, 8, K], the strips in which some pixel gates the pair)."""
    return (composite.strip_live(G, table, counts, TILES_X, toff, float(ALPHA_MIN)),
            composite.strip_gated(G, table, counts, TILES_X, toff, float(ALPHA_MIN)))


@pytest.mark.parametrize("case", STRIP_CASES)
def test_strip_live_never_drops_a_gated_pair(case):
    """The forward kernel's strip cull (`composite.strip_live`) keeps every
    (strip, pair) in which some pixel passes the alpha gate: wide splats far
    outside the image, sigma 0.4 px, opacity within an ulp of alpha_min,
    aspect 50:1 at eight angles; and nothing past a tile's count is walked.
    On small splats it drops most strips, and on every family something."""
    G, table, counts = _strip_scene(case)
    for toff, n in ((0, 12), (3, 9)):
        live, gated = _strips(G, table[:n], counts[:n], toff)
        assert int((gated & ~live).sum()) == 0
        assert gated.any()
        below = torch.arange(table.shape[1])[None, None, :] < counts[:n, None, None]
        assert not (live & ~below).any()
        share = 1.0 - float(live.sum()) / float(below.expand_as(live).sum())
        assert share > (0.5 if case in ("small", "sharp") else 0.0), share


def _walk_model(G, table, counts, live, chunk, alpha_min=float(ALPHA_MIN), t_min=1e-4):
    """The forward kernel's loop in numpy: each strip of 32 pixels walks only
    the pairs its cull kept, and the chunk's cut is cleared when the walk
    crosses a chunk's first pair. Returns (acc [NT, 256, 24], T [NT, 256])."""
    G, table, counts, live = (np.asarray(x) for x in (G, table, counts, live))
    NT, K = table.shape
    px, py = (np.asarray(x) for x in composite.tile_pixel_coords(NT, TILES_X, 16))
    acc = np.zeros((NT, 256, 24), np.float32)
    T = np.ones((NT, 256), np.float32)
    for t in range(NT):
        for s in range(8):
            p = slice(32 * s, 32 * s + 32)
            cut = np.zeros(32, bool)
            start_seen = False
            for k in range(min(int(counts[t]), K)):
                start_seen |= k % chunk == 0
                if not live[t, s, k]:
                    continue
                if start_seen:
                    cut[:] = False
                    start_seen = False
                r = G[table[t, k]] if table[t, k] >= 0 else np.zeros(32, np.float32)
                dx, dy = r[0] - px[t, p], r[1] - py[t, p]
                power = np.float32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
                alpha = np.minimum(np.float32(0.99), r[5] * np.exp(power))
                test = T[t, p] * (1 - alpha)
                on = (power <= 0) & (alpha >= alpha_min) & ~cut
                ok = on & (test >= t_min)
                cut |= on & ~ok
                acc[t, p] += np.where(ok, alpha * T[t, p], 0)[:, None] * r[None, 8:]
                T[t, p] = np.where(ok, test, T[t, p])
    return acc, T


@pytest.mark.parametrize("K,chunk", [(128, 32), (128, 64), (96, 48)])
def test_strip_walk_composites_like_the_plain_loop(K, chunk):
    """Walking only the pairs a strip's cull kept, with the cut cleared at
    the first walked pair of a new chunk, composites what the plain version
    composites from every pair: 1e-5 absolute, for chunks that are and are
    not a multiple of the kernel's group of 32."""
    G, table, counts = _far_and_sharp(2, 320, K)[:3]
    live = composite.strip_live(G, table, counts, TILES_X, 0, float(ALPHA_MIN))
    assert 0 < int(live.sum()) < int(counts.sum()) * 8
    acc_m, T_m = _walk_model(G, table, counts, live, chunk)
    acc_p, T_p = composite.composite_fused_plain(G, table, counts, 16, TILES_X,
                                                 alpha_min=float(ALPHA_MIN), chunk=chunk)
    np.testing.assert_allclose(acc_m, acc_p.numpy(), atol=1e-5)
    np.testing.assert_allclose(T_m, T_p.numpy(), atol=1e-5)


# Two spans of the windowed loop's window: rows 0..255 are window ids 0..255,
# rows 256..383 window ids 384..511 (block 2 of the window is empty)
SPAN_BASES, SPAN_DESTS, SPAN_NBLKS = (0, 2), (0, 3), (2, 1)


def _windowed_scene(case, bf16=False):
    """`_strip_scene(case)` as the windowed loop takes it: the anchor-sorted
    store G_s [384, 48] (columns 40..47 the obj channels packed as bf16
    pairs), each tile's work list in window ids through the two-span plan
    above, the plan, and the global rows the list resolves to."""
    G, table, counts = _strip_scene(case)
    NT, K = table.shape
    G_s = torch.zeros((128 * 3, windowed.BF16_CH))
    G_s[:G.shape[0], :32] = G
    if bf16:
        bits = G[:, windowed.OBJ0:windowed.OBJ0 + windowed.N_OBJ].to(torch.bfloat16) \
            .view(torch.int16).to(torch.int32) & 0xFFFF
        packed = bits[:, 0::2] | (bits[:, 1::2] << 16)
        G_s[:G.shape[0], windowed.COL_OBJ_BF16:] = packed.view(torch.float32)
    tl = torch.where(table < 256, table, table - 256 + 384)
    tl = torch.where(table >= 0, tl, -1).reshape(NT, K // 128, 128).to(torch.int32)
    plan = [torch.tensor(x, dtype=torch.int32).repeat(NT)
            for x in (SPAN_BASES, SPAN_DESTS, SPAN_NBLKS)]
    rows = windowed.window_rows(tl, *plan, 2)
    assert torch.equal(rows, table.long())
    return G_s, tl, counts, plan, rows


@pytest.mark.parametrize("ewa", ["vpu", "quad"])
@pytest.mark.parametrize("case", STRIP_CASES)
def test_windowed_strip_live_never_drops_a_gated_entry(case, ewa):
    """The windowed loop's strip cull (`windowed.strip_live`) keeps every
    (strip, entry) in which some pixel passes the loop's own alpha gate, in
    either EWA form: under "quad" the exponent is a sum of six monomials
    about the tile origin, which cancel for the thin splats and those
    100-250 px outside the image, and the margin grows with them. Nothing
    past a tile's count is walked; on small splats most strips drop."""
    G_s, _, counts, _, rows = _windowed_scene(case)
    for toff, n in ((0, 12), (3, 9)):
        live = windowed.strip_live(G_s, rows[:n], counts[:n], TILES_X, toff,
                                   float(ALPHA_MIN), ewa)
        gated = windowed.strip_gated(G_s, rows[:n], counts[:n], TILES_X, toff,
                                     float(ALPHA_MIN), ewa)
        assert int((gated & ~live).sum()) == 0
        assert gated.any()
        below = torch.arange(rows.shape[1])[None, None, :] < counts[:n, None, None]
        assert not (live & ~below).any()
        share = 1.0 - float(live.sum()) / float(below.expand_as(live).sum())
        assert share > (0.5 if case in ("small", "sharp") else 0.0), share


def _bf16_np(x):
    """float32 → bfloat16 → float32 in numpy, round to nearest even."""
    u = np.asarray(x, np.float32).view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)).astype(np.uint32)
    return np.where((u & 0x7FFFFFFF) > 0x7F800000, np.uint32(0x7FC00000), r).view(np.float32)


def _windowed_walk_model(G_s, rows, counts, live, chunk, ewa, prec, bf16,
                         alpha_min=ALPHA_MIN, t_min=np.float32(1e-4)):
    """The windowed loop of `csrc/windowed.cuh` in numpy: each strip walks
    only the entries its cull kept, clears the chunk's cut at the first
    walked entry of a new chunk, and adds each composited entry's w·f in the
    tier's rounding (`windowed._feat_term`). The gate is the loop's
    (`windowed._alpha_gate`). Returns (acc [NT, 256, 24], T [NT, 256])."""
    NT, K = rows.shape
    G = windowed._loop_rows(G_s, bf16)
    px, py = composite.tile_pixel_coords(NT, TILES_X, 16)
    Gc = windowed._gather(G, rows)
    alpha, gate = (x.numpy() for x in windowed._alpha_gate(Gc, px, py, 16, ewa,
                                                          float(alpha_min)))
    feats, counts, live = Gc[..., 8:].numpy(), counts.numpy(), live.numpy()
    obj = slice(windowed.OBJ0 - 8, windowed.OBJ0 - 8 + windowed.N_OBJ)
    acc = np.zeros((NT, 256, 24), np.float32)
    T = np.ones((NT, 256), np.float32)
    for t in range(NT):
        for s in range(8):
            p = slice(32 * s, 32 * s + 32)
            cut = np.zeros(32, bool)
            pending = False
            for k in range(min(int(counts[t]), K)):
                pending |= k % chunk == 0
                if not live[t, s, k]:
                    continue
                if pending:
                    cut[:], pending = False, False
                a = alpha[t, p, k]
                test = T[t, p] * (np.float32(1) - a)
                on = gate[t, p, k] & ~cut
                ok = on & (test >= t_min)
                cut |= on & ~ok
                w = np.where(ok, a * T[t, p], np.float32(0))[:, None]
                f = feats[t, k][None, :]
                if prec == "highest" and not bf16:
                    term = w * f
                else:
                    wh = _bf16_np(w)
                    if prec == "default":
                        term = wh * _bf16_np(f)
                    elif prec == "high":
                        fh = _bf16_np(f)
                        term = wh * fh + wh * _bf16_np(f - fh) + _bf16_np(w - wh) * fh
                    else:
                        term = w * f
                    if bf16:
                        term[:, obj] = wh * f[:, obj]
                acc[t, p] += term
                T[t, p] = np.where(ok, test, T[t, p])
    return acc, T


@pytest.mark.parametrize("ewa,prec,bf16,chunk", [
    ("vpu", "highest", False, 32), ("vpu", "highest", False, 48),
    ("vpu", "highest", False, 512), ("vpu", "high", False, 48),
    ("vpu", "default", False, 32), ("vpu", "highest", True, 512),
    ("quad", "highest", False, 48), ("quad", "default", True, 32)])
def test_windowed_strip_walk_composites_like_the_plain_loop(ewa, prec, bf16, chunk):
    """Walking only the entries a strip's cull kept, with the chunk's cut
    cleared at the first walked entry of a new chunk, composites bitwise
    what `_composite_rows_plain` composites from every entry: in every
    `feat_prec` tier, under `bf16_obj`, in both EWA forms, for chunks of
    one group, of one and a half and longer than the list; on a scene with
    wide splats far outside the image and sharp ones, through a two-span
    plan."""
    G_s, tl, counts, plan, rows = _windowed_scene("mixed", bf16)
    live = windowed.strip_live(G_s, rows, counts, TILES_X, 0, float(ALPHA_MIN), ewa)
    assert 0 < int(live.sum()) < int(counts.sum()) * 8
    acc_m, T_m = _windowed_walk_model(G_s, rows, counts, live, chunk, ewa, prec, bf16)
    acc_p, T_p = windowed.composite_windowed_plain(
        G_s, tl, counts, *plan, 16, TILES_X, alpha_min=float(ALPHA_MIN), chunk=chunk,
        n_span=2, ewa_impl=ewa, feat_prec=prec, bf16_obj=bf16)
    assert float(T_p.min()) < 0.5  # the scene composites
    np.testing.assert_array_equal(acc_m, acc_p.numpy())
    np.testing.assert_array_equal(T_m, T_p.numpy())


def _keys_with(nv, rng, NT=3, S=2048):
    """Window keys [NT, S] with exactly nv valid ones per tile: (dq << 11) |
    slot, dq drawn with ties."""
    keys = np.full((NT, S), windowed.KEY_INVALID, np.int32)
    for t in range(NT):
        slots = rng.choice(S, nv, replace=False)
        keys[t, slots] = (rng.integers(0, 1 << 12, nv) << windowed.IDX_BITS) | slots
    return torch.as_tensor(keys)


@pytest.mark.parametrize("nv", [0, 1, 5, 512, 1000, 2048])
def test_compacted_sort_gives_the_full_sorts_ids(nv):
    """The kernel sort's key phase sorts only its valid keys, appended in
    whatever order the warps' atomics give and padded to the next power of
    two: the same ids (the first min(nv, k_tile) in key order, −1 after)
    and the same nv as sorting the whole window, from no valid key to all
    2048 slots, with k_tile = 512."""
    rng = np.random.default_rng(nv)
    keys = _keys_with(nv, rng)
    appended = torch.as_tensor(np.stack([rng.permutation(keys.shape[1]) for _ in keys]))
    ids, nv_m = windowed.compacted_sort_plain(keys, 512, appended)
    want, nv_p = windowed.sorted_ids_plain(keys, 512)
    assert torch.equal(nv_m, nv_p) and int(nv_p[0]) == nv
    assert torch.equal(ids, want.to(torch.int32))


def test_compacted_sort_on_a_prepared_window():
    """The same on the keys `window_keys_plain` makes for a binned scene (16
    window blocks, four spans): the ids `composite_windowed_sorted_plain`
    composites."""
    _, pt, _, _, objs = _both(0, 256, 32)
    cfg = tconf.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=256,
                                window_blocks=16, windowed_mid_frac=1.0,
                                windowed_big_frac=1.0, windowed_big_capacity=64)
    G_s, b, d, n, ss, se, *_ = trz._prepare_windowed(pt, torch.as_tensor(objs), TILES_X,
                                                     TILES_Y, cfg, build_table=False)
    keys = windowed.window_keys_plain(G_s, b, d, n, ss, se, 16, TILES_X, cfg.alpha_min, 4, 16)
    rng = np.random.default_rng(9)
    appended = torch.as_tensor(np.stack([rng.permutation(keys.shape[1]) for _ in keys]))
    for k_tile in (8, 256):
        ids, nv = windowed.compacted_sort_plain(keys, k_tile, appended)
        want, nv_p = windowed.sorted_ids_plain(keys, k_tile)
        assert torch.equal(nv, nv_p) and int(nv.max()) > 8
        assert torch.equal(ids, want.to(torch.int32))


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


def jax_preprocess_reference():
    """The JAX package's `preprocess` (SH degree 0, default config) and the
    VJP of Σ_k out.k · up_k on `test_torch_preprocess.preprocess_scene(5,
    n=600)`, with its inputs: the arrays of `tests/data/preprocess_jax.npz`,
    which `test_torch_cuda.py` holds the card's kernel pair to."""
    import test_torch_preprocess as tp

    cam, leaves, active = tp.preprocess_scene(tp.REF_SEED, "cpu", "sh", n=tp.REF_N)
    out = tp.reference_inputs(cam, leaves, active)
    jc = jax_make_camera(out["cam_R"], out["cam_t"], cam.width, cam.height, cam.fovx,
                         cam.fovy)
    out["world_view"], out["full_proj"] = np.asarray(jc.world_view), np.asarray(jc.full_proj)
    names = list(leaves)
    xs = tuple(jnp.asarray(out[k]) for k in names)

    def run(m, o, s, q, sh, off):
        return jrz.preprocess(m, o, s, q, jc, RasterizeConfig(), shs=sh, sh_degree=0,
                              active_mask=jnp.asarray(out["active"]), mean2d_offset=off)

    pre = run(*xs)
    for k in tp.REF_OUTPUTS:
        out[k] = np.asarray(getattr(pre, k))

    def loss(*xs):
        p = run(*xs)
        return sum((getattr(p, k) * out["up_" + k]).sum() for k in tp.DIFF)

    for k, g in zip(names, jax.grad(loss, argnums=tuple(range(len(xs))))(*xs)):
        out["grad_" + k] = np.asarray(g)
    return out


def test_preprocess_reference_is_the_jax_packages():
    """`tests/data/preprocess_jax.npz` holds the JAX package's outputs and
    gradients on its scene bit for bit, and the port's plain `preprocess` on
    the CPU lies within the tolerances the card's kernel pair is held to."""
    import dataclasses

    import test_torch_preprocess as tp

    want = jax_preprocess_reference()
    ref = np.load(tp.REFERENCE)
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        assert ref[k].dtype == v.dtype and np.array_equal(ref[k], v), k
    cam, leaves, active = tp.preprocess_scene(tp.REF_SEED, "cpu", "sh", n=tp.REF_N)
    cam = dataclasses.replace(cam, world_view=torch.as_tensor(ref["world_view"]),
                              full_proj=torch.as_tensor(ref["full_proj"]))
    pre = tp.run_project(trz.preprocess, cam, leaves, active, tconf.RasterizeConfig())
    tp.assert_near_reference(pre, tp.reference_grads(pre, leaves, ref), ref)


if __name__ == "__main__":  # writes the reference file
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_platforms", "cpu")
    import test_torch_preprocess as tp

    os.makedirs(os.path.dirname(tp.REFERENCE), exist_ok=True)
    np.savez_compressed(tp.REFERENCE, **jax_preprocess_reference())
