"""Port parity: the windowed render path of `sags_tpu_torch` against
`sags_tpu` on the CPU — the block sort, `_prepare_windowed` (work list, span
plan and every counter), both windowed compositors, `rasterize` in both
depth-ordering modes, and the occupancy probe with the budgets derived from
it. The JAX side runs its Pallas kernels in interpret mode; the port runs
its kernels' plain versions (CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core.camera import make_camera as jax_make_camera
from sags_tpu.core.config import RasterizeConfig
from sags_tpu.ops import rasterize as jrz
from sags_tpu.ops.pallas_sort import sort_blocks as jax_sort_blocks
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.ops import rasterize as trz
from sags_tpu_torch.ops import sort as tsort
from sags_tpu_torch.ops import windowed as win

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

W, H = 96, 64
TILES_X, TILES_Y = 6, 4
FIELDS_F = ("color", "depth", "objects", "alpha", "final_T")
FIELDS_I = ("n_binned", "overflow_rect", "overflow_tile", "overflow_window",
            "overflow_big", "tile_peak", "overflow_tile_live", "is_used")
BASE = dict(max_tiles_per_gaussian=16, tile_capacity=256, window_blocks=16,
            windowed_mid_frac=1.0, windowed_big_frac=1.0)
CASES = {
    "store_off": dict(windowed_big_capacity=0),
    "store_on": dict(windowed_big_capacity=64),
    "base_split": dict(windowed_big_capacity=64, windowed_base_split_frac=1.0),
    # every buffer too small: tier saturation, expansion trim, span budget cut
    "starved": dict(windowed_big_capacity=64, windowed_mid_frac=0.01,
                    windowed_big_frac=0.01, windowed_copy_ring_frac=0.3,
                    windowed_expand_frac=0.02, window_blocks=1,
                    windowed_pair_sort="stable"),
}


def _scene(seed=5, n=512):
    """`tests/test_rasterize.py:450-485`'s scene: depth-scaled splats, a few
    wide enough for the slice store."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 10.0, (n, 1))
    xy = rng.uniform(-0.5, 0.5, (n, 2)) * z
    means = np.concatenate([xy, z], 1).astype(np.float32)
    scales = (rng.uniform(0.005, 0.03, (n, 3)) * z).astype(np.float32)
    scales[:16] *= 8.0
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, -1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, (n,)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    objs = rng.normal(size=(n, 16)).astype(np.float32)
    return means, opac, scales, quats, colors, objs


def _cams():
    return (jax_make_camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                            W, H, 1.2, 0.9),
            make_camera(torch.eye(3), torch.zeros(3), W, H, 1.2, 0.9))


def _configs(case, **extra):
    kw = dict(BASE, **CASES[case], **extra)
    return RasterizeConfig(pallas_interpret=True, **kw), tconf.RasterizeConfig(**kw)


_jax_prepare = jax.jit(jrz._prepare_windowed,
                       static_argnames=("tiles_x", "tiles_y", "cfg", "build_table"))


def _pre_both(case):
    jcfg, tcfg = _configs(case)
    means, opac, scales, quats, colors, objs = _scene()
    jc, tc = _cams()
    jpre = jrz.preprocess(*map(jnp.asarray, (means, opac, scales, quats)), jc, jcfg,
                          colors=jnp.asarray(colors))
    tpre = trz.preprocess(*map(torch.as_tensor, (means, opac, scales, quats)), tc, tcfg,
                          colors=torch.as_tensor(colors))
    return jcfg, tcfg, jpre, tpre, objs


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_G_s(jg, tg):
    # the packed rows of two preprocess implementations: same float32
    # arithmetic, another summation order; 1e-6 relative to each column's
    # scale (dz0 and the conic rows reach 1e2-1e3)
    jg, tg = _np(jg), _np(tg)
    scale = np.maximum(np.abs(jg).max(axis=0), 1e-6)
    assert np.all(np.abs(tg - jg) <= 1e-6 * scale + 1e-7), np.abs(tg - jg).max(axis=0)


@pytest.mark.parametrize("data", ["random", "ties"])
def test_sort_blocks_plain_matches_jax(data):
    """Exactly equal to the bitonic network (`tests/test_pallas_sort.py`)."""
    rng = np.random.default_rng(1)
    if data == "random":
        x = rng.integers(-2 ** 31, 2 ** 31, size=(2, 8, 128), dtype=np.int32)
    else:
        x = rng.integers(0, 8, size=(3, 1, 128), dtype=np.int32)
    want = np.asarray(jax_sort_blocks(jnp.array(x), interpret=True))
    np.testing.assert_array_equal(tsort.sort_blocks(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_windowed_matches_jax(case):
    """Integers exact (tables, counts, span plan, every counter); the
    anchor-sorted rows to 1e-6 relative."""
    jcfg, tcfg, jpre, tpre, objs = _pre_both(case)
    jo = _jax_prepare(jpre, jnp.asarray(objs), tiles_x=TILES_X, tiles_y=TILES_Y, cfg=jcfg)
    to = trz._prepare_windowed(tpre, torch.as_tensor(objs), TILES_X, TILES_Y, tcfg)
    names = ("G_s", "table_global", "table_local", "counts", "bases", "dests", "nblks",
             "n_binned", "overflow_rect", "overflow_tile", "overflow_window",
             "overflow_big")
    assert len(jo) == len(to) == len(names)
    _assert_G_s(jo[0], to[0])
    for name, a, b in zip(names[1:], jo[1:], to[1:]):
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)
    if case == "starved":
        assert int(to[10]) > 0 and int(to[11]) > 0  # window and big overflow
    if case != "store_off":
        assert to[0].shape[0] > objs.shape[0]  # slice-store copies exist

    jo = _jax_prepare(jpre, jnp.asarray(objs), tiles_x=TILES_X, tiles_y=TILES_Y,
                      cfg=jcfg, build_table=False)
    to = trz._prepare_windowed(tpre, torch.as_tensor(objs), TILES_X, TILES_Y, tcfg,
                               build_table=False)
    names = ("G_s", "bases", "dests", "nblks", "sstarts", "sends", "overflow_rect",
             "overflow_window_raw", "overflow_big")
    assert len(jo) == len(to) == len(names)
    _assert_G_s(jo[0], to[0])
    for name, a, b in zip(names[1:], jo[1:], to[1:]):
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)


@pytest.mark.parametrize("mode", ["host", "kernel"])
def test_windowed_compositors_match_jax(mode):
    """The plain `composite_windowed` and `composite_windowed_sorted` on the
    JAX package's own prepared inputs, against its Pallas kernels
    (interpret): acc and T to 1e-4 absolute, nv exact."""
    jcfg, tcfg, jpre, _, objs = _pre_both("store_on")
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    kw = dict(alpha_min=tcfg.alpha_min, t_min=tcfg.transmittance_min,
              chunk=trz._windowed_chunk(tcfg), n_span=4)
    if mode == "host":
        (G_s, tg, tl, counts, bases, dests, nblks, *_) = _jax_prepare(
            jpre, jnp.asarray(objs), tiles_x=TILES_X, tiles_y=TILES_Y, cfg=jcfg)
        acc_j, T_j = jrz._composite_windowed_with_xla_vjp(
            G_s, tg, tl, counts, bases, dests, nblks, 23, TILES_X, TILES_Y, jcfg)
        acc_t, T_t = win.composite_windowed(t(G_s), t(tl), t(counts), t(bases), t(dests),
                                            t(nblks), 16, TILES_X, **kw)
    else:
        (G_s, bases, dests, nblks, ss, se, *_) = _jax_prepare(
            jpre, jnp.asarray(objs), tiles_x=TILES_X, tiles_y=TILES_Y, cfg=jcfg,
            build_table=False)
        acc_j, T_j, nv_j = jrz._composite_windowed_kernel_sort(
            G_s, bases, dests, nblks, ss, se, 23, TILES_X, TILES_Y, jcfg)
        acc_t, T_t, nv_t = win.composite_windowed_sorted(
            t(G_s), t(bases), t(dests), t(nblks), t(ss), t(se), 16, TILES_X,
            w_blocks=tcfg.window_blocks, k_tile=tcfg.tile_capacity, **kw)
        np.testing.assert_array_equal(nv_t.numpy(), np.asarray(nv_j))
        assert int(nv_t.sum()) > 0
    np.testing.assert_allclose(acc_t[..., :23].numpy(), np.asarray(acc_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4, rtol=0)


def _render_both(sort, case="store_on", **extra):
    jcfg, tcfg = _configs(case, windowed_sort=sort, **extra)
    means, opac, scales, quats, colors, objs = _scene()
    jc, tc = _cams()
    jo = jrz.rasterize(*map(jnp.asarray, (means, opac, scales, quats)), jc, jcfg,
                       colors=jnp.asarray(colors), obj_features=jnp.asarray(objs),
                       windowed=True)
    to = trz.rasterize(*map(torch.as_tensor, (means, opac, scales, quats)), tc, tcfg,
                       colors=torch.as_tensor(colors), obj_features=torch.as_tensor(objs))
    return jo, to


@pytest.mark.parametrize("sort", ["host", "kernel"])
def test_rasterize_windowed_matches_jax(sort):
    """`rasterize` with the default `windowed=None` takes the windowed path:
    images to 1e-4, every counter and `is_used` exact."""
    jo, to = _render_both(sort)
    for f in FIELDS_F:
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
    for f in FIELDS_I:
        np.testing.assert_array_equal(np.asarray(getattr(to, f)),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    assert int(to.overflow_window) == 0 and int(to.n_binned) > 0


def test_kernel_sort_equals_host_table_bitwise():
    """With no window overflow both modes composite the same candidates in
    the same order with the same arithmetic: the same bits
    (`tests/test_rasterize.py:441-447` holds the JAX package to it)."""
    means, opac, scales, quats, colors, objs = _scene(seed=6)
    _, tc = _cams()
    args = [torch.as_tensor(a) for a in (means, opac, scales, quats)]
    outs = {}
    for sort in ("host", "kernel"):
        cfg = tconf.RasterizeConfig(**BASE, windowed_big_capacity=64, windowed_sort=sort)
        outs[sort] = trz.rasterize(*args, tc, cfg, colors=torch.as_tensor(colors),
                                   obj_features=torch.as_tensor(objs))
    h, k = outs["host"], outs["kernel"]
    assert int(h.overflow_window) == 0 and int(k.overflow_window) == 0
    assert int(h.n_binned) == int(k.n_binned)
    for f in FIELDS_F:
        assert torch.equal(getattr(h, f), getattr(k, f)), f


def test_occupancy_and_budgets_match_jax():
    """The probe's counts exactly, and the same derived config from them."""
    jcfg, tcfg = _configs("store_on")
    means, opac, scales, quats, *_ = _scene()
    active = np.random.default_rng(3).uniform(size=means.shape[0]) > 0.05
    jc, tc = _cams()
    jocc = jrz.windowed_occupancy(*map(jnp.asarray, (means, opac, scales, quats)), jc,
                                  jcfg, active_mask=jnp.asarray(active))
    tocc = trz.windowed_occupancy(*map(torch.as_tensor, (means, opac, scales, quats)),
                                  tc, tcfg, active_mask=torch.as_tensor(active))
    assert set(jocc) == set(tocc)
    for k in jocc:
        np.testing.assert_array_equal(tocc[k].numpy(), np.asarray(jocc[k]), err_msg=k)
    occ = {k: np.asarray(v) for k, v in jocc.items()}
    P = means.shape[0]
    for margin in (1.05, 1.2):
        jd = jrz.derive_windowed_budgets(jcfg, occ, P, margin=margin)
        td = trz.derive_windowed_budgets(tcfg, occ, P, margin=margin)
        for f in dataclasses.fields(td):
            if f.name != "pallas_interpret":  # the JAX side's CPU switch
                assert getattr(td, f.name) == getattr(jd, f.name), f.name


def test_windowed_render_is_forward_only():
    """The kernel-sort render is forward-only, as in the JAX package: asking
    for its gradient raises. The host-table render differentiates
    (`tests/test_torch_windowed_train.py` holds its gradients)."""
    means, opac, scales, quats, colors, objs = _scene(n=64)
    _, tc = _cams()
    leaves = [torch.tensor(a, requires_grad=True) for a in (means, opac, scales, quats)]
    for sort in ("host", "kernel"):
        cfg = tconf.RasterizeConfig(**BASE, windowed_sort=sort)
        out = trz.rasterize(*leaves, tc, cfg, colors=torch.as_tensor(colors),
                            obj_features=torch.as_tensor(objs))
        if sort == "kernel":
            with pytest.raises(NotImplementedError):
                out.color.sum().backward()
        else:
            grads = torch.autograd.grad(out.color.sum(), leaves)
            assert all(bool(torch.isfinite(g).all()) for g in grads)
            assert float(grads[0].abs().sum()) > 0
