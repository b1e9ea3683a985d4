"""Port parity: windowed training (`train_windowed=True`) of `sags_tpu_torch`
against `sags_tpu` on the CPU — the windowed backward
(`composite_windowed_bwd`), the gradients of `rasterize(windowed=True)`
with and without the slice store, two `slam_step`s, and the windowed
forward's options (`windowed_bf16`, `feature_precision`, `ewa_impl`). The
JAX side runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions (CPU tensors)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.ops import rasterize as jrz
from sags_tpu.ops.pallas_windowed import composite_windowed as jax_composite_windowed
from sags_tpu.ops.pallas_windowed import composite_windowed_bwd as jax_windowed_bwd
from sags_tpu.slam import step as jax_step
from sags_tpu_torch import interop
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.ops import rasterize as trz
from sags_tpu_torch.ops import windowed as win
from sags_tpu_torch.slam import step as t_step
from sags_tpu_torch.utils.draws import ReplayDraws
from test_torch_step import (ATOL, assert_map_close, configs, jax_state_to_numpy,
                             scene, uniform_draw)
from test_torch_windowed import (TILES_X, TILES_Y, W, H, _cams, _configs, _jax_prepare,
                                 _np, _pre_both, _scene)

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py


def _blocked(G_s, window_blocks):
    """The JAX package's blocked row store [NB, 32, 128] of `G_s`
    (`sags_tpu/ops/rasterize.py:1327-1331`)."""
    P = G_s.shape[0]
    P_pad = -(-(P + window_blocks * 128) // 128) * 128
    G_pad = jnp.concatenate([G_s[:, :32], jnp.zeros((P_pad - P, 32), G_s.dtype)], axis=0)
    return G_pad.T.reshape(32, P_pad // 128, 128).transpose(1, 0, 2)


def _bwd_case(case):
    """The JAX package's own prepared inputs of one windowed case with seeded
    cotangents: (the port's arguments as tensors, keywords, the Pallas
    backward's dGt in interpret mode, counts). The JAX side runs once per
    case (`_bwd_case_np`); each caller gets tensors of its own."""
    arrays, ints, kw, want, counts = _bwd_case_np(case)
    return (*(torch.tensor(a) for a in arrays), *ints), dict(kw), want, counts


@functools.lru_cache(maxsize=None)
def _bwd_case_np(case):
    jcfg, tcfg, jpre, _, objs = _pre_both(case)
    G_s, _, tl, counts, bases, dests, nblks, *_ = _jax_prepare(
        jpre, jnp.asarray(objs), tiles_x=TILES_X, tiles_y=TILES_Y, cfg=jcfg)
    chunk = trz._windowed_chunk(tcfg)
    kw = dict(alpha_min=jcfg.alpha_min, t_min=jcfg.transmittance_min, chunk=chunk, n_span=4)
    gb = _blocked(G_s, jcfg.window_blocks)
    _, T = jax_composite_windowed(gb, tl, counts, bases, dests, nblks, 24, 16, TILES_X,
                                  w_blocks=jcfg.window_blocks, interpret=True, **kw)
    rng = np.random.default_rng(11)
    NT = TILES_X * TILES_Y
    d_acc = rng.normal(size=(NT, 256, 24)).astype(np.float32)
    d_acc[..., 23] = 0.0  # the pad channel's cotangent, as `rasterize` pads it
    d_T = rng.normal(size=(NT, 256)).astype(np.float32)
    want = np.asarray(jax_windowed_bwd(gb, tl, counts, bases, dests, nblks,
                                       jnp.asarray(d_acc), jnp.asarray(d_T), T, 16, TILES_X,
                                       w_blocks=jcfg.window_blocks, interpret=True, **kw))
    arrays = tuple(np.asarray(x) for x in (G_s, tl, counts, bases, dests, nblks, d_acc,
                                           d_T, T))
    return arrays, (16, TILES_X), kw, want, np.asarray(counts)


def _row_rel(got, want):
    scale = np.abs(want).max(axis=(0, 2))
    live = scale > 0
    return np.abs(got - want).max(axis=(0, 2))[live] / scale[live], live


@pytest.mark.parametrize("case", ["store_off", "store_on", "starved"])
def test_windowed_bwd_plain_matches_jax(case):
    """`composite_windowed_bwd_plain` on the JAX package's own prepared
    inputs against its Pallas kernel (interpret): 1e-4 relative to each
    output row's scale; the rows 6-7 and every slot past a tile's count are
    zero."""
    args, kw, want, counts = _bwd_case(case)
    got = win.composite_windowed_bwd(*args, **kw).numpy()
    rel, live = _row_rel(got, want)
    assert rel.max() <= 1e-4, rel
    assert live[:6].all() and live[8:].sum() >= 20 and not live[6:8].any()
    past = np.arange(got.shape[2])[None, :] >= counts[:, None]
    assert not got.transpose(0, 2, 1)[past].any()


@pytest.mark.parametrize("case", ["store_off", "store_on", "starved"])
def test_windowed_bwd_matrix_form(case):
    """The windowed backward's sums over a tile's pixels as the CUDA kernel
    takes them (`matrix_form=True`: two float32 matrix products, the geometry
    gradients from six moments about the tile's centre) against the direct
    sums, 2e-5 relative per output row (the moment expansion's cancellation;
    the slice store's copies keep their parents' centres), and against the
    Pallas kernel at the direct form's bar of 1e-4."""
    args, kw, want, counts = _bwd_case(case)
    direct = win.composite_windowed_bwd_plain(*args, **kw).numpy()
    matrix = win.composite_windowed_bwd_plain(*args, **kw, matrix_form=True).numpy()
    rel, live = _row_rel(matrix, direct)
    assert live[:6].all() and rel.max() <= 2e-5, rel
    rel_j, _ = _row_rel(matrix, want)
    assert rel_j.max() <= 1e-4, rel_j
    np.testing.assert_array_equal(matrix[:, 6:8], 0.0)
    past = np.arange(matrix.shape[2])[None, :] >= counts[:, None]
    assert not matrix.transpose(0, 2, 1)[past].any()


def _loss_j(out, tgt):
    return (jnp.sum((out.color - tgt) ** 2) + 0.1 * jnp.sum(out.objects ** 2)
            + 1e-3 * jnp.sum(out.depth ** 2) + jnp.sum(out.final_T ** 2))


def _loss_t(out, tgt):
    return (((out.color - tgt) ** 2).sum() + 0.1 * (out.objects ** 2).sum()
            + 1e-3 * (out.depth ** 2).sum() + (out.final_T ** 2).sum())


def _grads_both(case, **extra):
    """Gradients of the same loss w.r.t. means, opacities, scales, quats,
    colors and obj_features through both windowed renders."""
    jcfg, tcfg = _configs(case, **extra)
    args = _scene()
    jc, tc = _cams()
    tgt = np.random.default_rng(9).uniform(0, 1, (3, H, W)).astype(np.float32)

    def jloss(m, o, s, q, c, ob):
        out = jrz.rasterize(m, o, s, q, jc, jcfg, colors=c, obj_features=ob, windowed=True)
        return _loss_j(out, jnp.asarray(tgt))

    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = trz.rasterize(*ts[:4], tc, tcfg, colors=ts[4], obj_features=ts[5])
    gt = torch.autograd.grad(_loss_t(out, torch.as_tensor(tgt)), ts)
    return gj, gt, out


def _assert_grads(gj, gt, tol):
    for name, a, b in zip(("means", "opacity", "scales", "quats", "colors", "obj"), gj, gt):
        a, b = np.asarray(a), b.numpy()
        rel = np.abs(a - b).max() / np.abs(a).max()
        assert rel <= tol, (name, rel)


@pytest.mark.parametrize("case", ["store_off", "store_on"])
def test_windowed_gradients_match_jax(case):
    """All six gradients of the windowed render against `jax.grad` through
    the JAX package's windowed backward kernel: 1e-4 relative. With the
    slice store on, the copies' gradients fold back onto their parents."""
    gj, gt, out = _grads_both(case)
    _assert_grads(gj, gt, 1e-4)
    assert int(out.overflow_window) == 0 and int(out.n_binned) > 0


def test_windowed_bf16_gradient_matches_jax():
    """`windowed_bf16`: the backward is the exact recompute through the
    classic compositor in both packages: 1e-4 relative."""
    gj, gt, _ = _grads_both("store_on", windowed_bf16=True, chunk=16)
    _assert_grads(gj, gt, 1e-4)


def _render(cfg, jax_side):
    args = _scene()
    jc, tc = _cams()
    if jax_side:
        return jrz.rasterize(*map(jnp.asarray, args[:4]), jc, cfg, colors=jnp.asarray(args[4]),
                             obj_features=jnp.asarray(args[5]), windowed=True)
    return trz.rasterize(*map(torch.as_tensor, args[:4]), tc, cfg,
                         colors=torch.as_tensor(args[4]),
                         obj_features=torch.as_tensor(args[5]))


VARIANTS = {"bf16": dict(windowed_bf16=True), "high": dict(feature_precision="high"),
            "default": dict(feature_precision="default"), "quad": dict(ewa_impl="quad")}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_windowed_variant_renders_match_jax(variant):
    """Each windowed forward option against the JAX render of the same
    config: color and final_T to 1e-5 absolute, objects to 1e-5 of their
    scale, except where the two packages round differently on purpose:
    - `"quad"`: the six monomials are summed in XLA's dot order there and
      one at a time here; where the terms reach 1e2 the exponent moves by
      ~1e-5 (1.9e-5 measured on color, no gate flips): 1e-4;
    - `windowed_bf16`: w = α·T is rounded to bf16, and a last-bit
      difference in T can move it across a rounding tie: objects to one
      bf16 step (2^-8) of a weight times the largest obj value;
    - `"default"` is one bf16 product per feature on the TPU, but XLA's CPU
      dot ignores the precision and computes in float32, so the JAX render
      here is the float32 one: the port's color is held to it at the TPU's
      bf16 bar (8e-3, `tests/test_pallas_tpu.py:254`) and must differ from
      its own `"highest"` render."""
    jcfg, tcfg = _configs("store_on", **VARIANTS[variant])
    jo, to = _render(jcfg, True), _render(tcfg, False)
    tol = {"quad": 1e-4, "default": 8e-3}.get(variant, 1e-5)
    np.testing.assert_allclose(to.final_T.numpy(), np.asarray(jo.final_T),
                               atol=1e-4 if variant == "quad" else 1e-5, rtol=0)
    np.testing.assert_allclose(to.color.numpy(), np.asarray(jo.color), atol=tol, rtol=0)
    o_ref = np.asarray(jo.objects)
    o_tol = {"bf16": 2.0 ** -8 * np.abs(_scene()[5]).max(),
             "default": np.inf}.get(variant, tol * np.abs(o_ref).max())
    np.testing.assert_allclose(to.objects.numpy(), o_ref, atol=o_tol, rtol=0)
    full = _render(_configs("store_on")[1], False)
    if variant == "default":
        assert float((to.color - full.color).abs().max()) > 0
        assert torch.equal(to.final_T, full.final_T)
    if variant == "bf16":  # rgb, depth and T are the float32 render's bits
        for f in ("color", "depth", "final_T"):
            assert torch.equal(getattr(to, f), getattr(full, f)), f
        assert not torch.equal(to.objects, full.objects)


def _windowed_configs(**extra):
    jcfg, tcfg = configs()
    raster = dict(max_tiles_per_gaussian=16, tile_capacity=128, chunk=16,
                  train_windowed=True, windowed_big_capacity=64, **extra)
    return (jcfg.replace(raster=dataclasses.replace(jcfg.raster, pallas_interpret=True,
                                                    **raster)),
            tcfg.replace(raster=dataclasses.replace(tcfg.raster, **raster)))


def _carried_state(jcfg):
    from sags_tpu.core.camera import make_camera as jax_make_camera
    from sags_tpu_torch.core.camera import make_camera

    rng = np.random.default_rng(3)
    pts, cols, mask, img, obj = scene(rng)
    s = jax_step.init_state(jcfg, jax.random.key(0))
    s, _ = jax_step.add_frame_points(s, jnp.asarray(pts), jnp.asarray(cols),
                                     jnp.asarray(mask), jcfg)
    W_, H_ = img.shape[2], img.shape[1]
    jcam = jax_make_camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), W_, H_,
                           1.2, 0.9)
    tcam = make_camera(torch.eye(3), torch.zeros(3), W_, H_, 1.2, 0.9)
    return s, jcam, tcam, img, obj


def test_train_windowed_slam_steps_match_jax():
    """Two `slam_step`s under `train_windowed=True` (slice store on) from one
    JAX state carried over by `interop`, JAX's draws replayed: losses,
    every counter, the map and the Adam moments at `test_torch_step.py`'s
    tolerances."""
    jcfg, tcfg = _windowed_configs()
    s, jcam, tcam, img, obj = _carried_state(jcfg)
    draws = ReplayDraws([], "cpu")
    p = interop.state_from_numpy(jax_state_to_numpy(s), "cpu", draws=draws)
    step_j = jax.jit(lambda st: jax_step.slam_step(st, jcam, jnp.asarray(img),
                                                   jnp.asarray(obj), jcfg))
    calls = []
    real = win.composite_windowed_bwd
    try:
        win.composite_windowed_bwd = lambda *a, **k: calls.append(1) or real(*a, **k)
        for it in range(2):
            if it % jcfg.semantics.cls3d_interval == 0:
                draws.push(uniform_draw(s.rng, (s.map.capacity,)))
            s, mj = step_j(s)
            p, mt = t_step.slam_step(p, tcam, torch.as_tensor(img), torch.as_tensor(obj),
                                     tcfg)
            for f in ("loss", "loss_rgb", "loss_obj", "loss_obj_3d"):
                np.testing.assert_allclose(float(getattr(mt, f)), float(getattr(mj, f)),
                                           rtol=1e-5, atol=1e-7, err_msg=f)
            for f in ("n_active", "n_binned", "overflow_tile", "overflow_rect",
                      "overflow_window", "overflow_big", "tile_peak",
                      "overflow_tile_live"):
                assert int(getattr(mt, f)) == int(getattr(mj, f)), f
            assert_map_close(s.map, p.map, ATOL)
            tree, jtree = interop.state_to_numpy(p), jax_state_to_numpy(s)
            for k in ("xyz", "f_dc", "opacity_logit", "obj_dc"):
                scale = np.abs(jtree["opt"]["mu"][k]).max() + 1e-30
                np.testing.assert_allclose(tree["opt"]["mu"][k] / scale,
                                           jtree["opt"]["mu"][k] / scale, atol=1e-4,
                                           err_msg=k)
    finally:
        win.composite_windowed_bwd = real
    assert len(calls) == 2  # each step's gradient took the windowed backward


def test_train_windowed_without_pallas_backward_trains_classic():
    """`pallas_backward=False` pins the classic path, as in the JAX package:
    one step equals the `train_windowed=False` step bitwise, and renders
    through no windowed compositor."""
    jcfg, tcfg = _windowed_configs(pallas_backward=False)
    s, _, tcam, img, obj = _carried_state(jcfg)
    tree = jax_state_to_numpy(s)
    u = uniform_draw(s.rng, (s.map.capacity,))
    classic = tcfg.replace(raster=dataclasses.replace(tcfg.raster, train_windowed=False))
    outs = []
    real = win.composite_windowed
    try:
        win.composite_windowed = None  # any windowed render would fail
        for cfg in (tcfg, classic):
            p = interop.state_from_numpy(tree, "cpu", draws=ReplayDraws([u], "cpu"))
            outs.append(t_step.slam_step(p, tcam, torch.as_tensor(img),
                                         torch.as_tensor(obj), cfg))
    finally:
        win.composite_windowed = real
    (pa, ma), (pb, mb) = outs
    for f in ma._fields:
        assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    for f in pa.map._fields:
        a, b = getattr(pa.map, f), getattr(pb.map, f)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f
