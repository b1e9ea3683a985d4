"""Port parity: the full classic `rasterize` of `sags_tpu_torch` against
`sags_tpu.ops.rasterize` on the CPU — every `RenderOutput` field and counter,
and the gradients of all six parameter groups through the port's
`torch.autograd.Function` (plain backward + deterministic scatter) against
`jax.grad` of the same loss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core.camera import make_camera as jax_make_camera
from sags_tpu.core.config import RasterizeConfig
from sags_tpu.ops import rasterize as jrz
from sags_tpu.core.transforms import so3_exp as jax_so3_exp
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.ops import rasterize as trz

W, H = 64, 48
FIELDS_F = ("color", "depth", "objects", "alpha", "final_T")
FIELDS_I = ("radii", "n_binned", "overflow_rect", "overflow_tile", "overflow_window",
            "overflow_big", "tile_peak", "overflow_tile_live", "is_used")


def _scene(seed, n=400):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.8, 1.8, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(1.0, 5.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.05, 0.97, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    shs = rng.normal(size=(n, 3, 1)).astype(np.float32)
    objs = rng.normal(size=(n, 16)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    return means, opac, scales, quats, colors, shs, objs, active


def _cams(rot):
    R = np.asarray(jax_so3_exp(jnp.asarray(rot, jnp.float32)))
    t = np.array([0.1, -0.05, -0.2], np.float32)
    return (jax_make_camera(R, t, W, H, 1.2, 0.9),
            make_camera(torch.as_tensor(R), torch.as_tensor(t), W, H, 1.2, 0.9))


CASES = {
    # name: (config overrides, use SH instead of colors, background, rotation)
    "tight": (dict(), False, None, (0.0, 0.0, 0.0)),
    "circle_rect_sh_bg": (dict(tight_rect=False), True, (0.2, 0.5, 0.9), (0.05, -0.1, 0.02)),
    "overflow": (dict(tile_capacity=32, max_tiles_per_gaussian=4), False, None,
                 (0.0, 0.08, 0.0)),
    "in_frustum": (dict(is_used_mode="in_frustum"), True, None, (0.0, 0.0, 0.1)),
}


def _render_both(case, seed=0):
    over, use_sh, bg, rot = CASES[case]
    kw = dict(max_tiles_per_gaussian=16, tile_capacity=128, chunk=16)
    kw.update(over)
    jcfg, tcfg = RasterizeConfig(**kw), tconf.RasterizeConfig(**kw)
    means, opac, scales, quats, colors, shs, objs, active = _scene(seed)
    jc, tc = _cams(rot)
    common_j = dict(obj_features=jnp.asarray(objs), active_mask=jnp.asarray(active),
                    bg_color=None if bg is None else jnp.asarray(bg, jnp.float32))
    common_t = dict(obj_features=torch.as_tensor(objs), active_mask=torch.as_tensor(active),
                    bg_color=None if bg is None else torch.tensor(bg))
    if use_sh:
        common_j["shs"], common_t["shs"] = jnp.asarray(shs), torch.as_tensor(shs)
    else:
        common_j["colors"], common_t["colors"] = jnp.asarray(colors), torch.as_tensor(colors)
    jo = jrz.rasterize(*map(jnp.asarray, (means, opac, scales, quats)), jc, jcfg,
                       fused=False, windowed=False, **common_j)
    to = trz.rasterize(*map(torch.as_tensor, (means, opac, scales, quats)), tc, tcfg,
                       windowed=False, **common_t)
    return jo, to


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_forward_matches_jax(case):
    jo, to = _render_both(case)
    # same float32 arithmetic in another summation order: 1e-5 on [0,1]
    # images, 1e-4 on depth (scaled by the 15 m background)
    tol = {"depth": 1e-4}
    for f in FIELDS_F:
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   atol=tol.get(f, 1e-5), err_msg=f)
    for f in FIELDS_I:
        np.testing.assert_array_equal(np.asarray(getattr(to, f)),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    if case == "overflow":
        assert int(to.overflow_tile) > 0 and int(to.overflow_rect) > 0


def _loss_j(out, tgt):
    return (jnp.sum((out.color - tgt) ** 2) + 0.1 * jnp.sum(out.objects ** 2)
            + 0.01 * jnp.sum(out.depth) + jnp.sum(out.final_T) + jnp.sum(out.alpha))


def _loss_t(out, tgt):
    return (((out.color - tgt) ** 2).sum() + 0.1 * (out.objects ** 2).sum()
            + 0.01 * out.depth.sum() + out.final_T.sum() + out.alpha.sum())


@pytest.mark.parametrize("case", ["tight", "circle_rect_sh_bg"])
def test_rasterize_gradients_match_jax(case):
    over, use_sh, bg, rot = CASES[case]
    kw = dict(max_tiles_per_gaussian=16, tile_capacity=128, chunk=16, **over)
    jcfg, tcfg = RasterizeConfig(**kw), tconf.RasterizeConfig(**kw)
    means, opac, scales, quats, colors, shs, objs, active = _scene(1)
    feat = shs if use_sh else colors
    key = "shs" if use_sh else "colors"
    jc, tc = _cams(rot)
    tgt = np.random.default_rng(9).uniform(0, 1, (3, H, W)).astype(np.float32)

    def jloss(m, o, s, q, c, ob):
        out = jrz.rasterize(m, o, s, q, jc, jcfg, obj_features=ob, fused=False,
                            windowed=False, active_mask=jnp.asarray(active),
                            **{key: c})
        return _loss_j(out, jnp.asarray(tgt))

    args = (means, opac, scales, quats, feat, objs)
    gj = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = trz.rasterize(ts[0], ts[1], ts[2], ts[3], tc, tcfg, obj_features=ts[5],
                        windowed=False, active_mask=torch.as_tensor(active),
                        **{key: ts[4]})
    gt = torch.autograd.grad(_loss_t(out, torch.as_tensor(tgt)), ts)
    # the JAX bar for its fused backward against XLA autodiff: ≤2e-4 relative
    for name, a, b in zip(("means", "opacity", "scales", "quats", key, "obj"), gj, gt):
        a, b = np.asarray(a), b.numpy()
        rel = np.abs(a - b).max() / np.abs(a).max()
        assert rel <= 2e-4, (name, rel)


def test_windowed_path_raises():
    means, opac, scales, quats, colors, *_ = _scene(0, 16)
    _, tc = _cams((0.0, 0.0, 0.0))
    args = [torch.as_tensor(a) for a in (means, opac, scales, quats)]
    with pytest.raises(NotImplementedError, match="windowed"):
        trz.rasterize(*args, tc, tconf.RasterizeConfig(), colors=torch.as_tensor(colors))
    with pytest.raises(NotImplementedError):
        trz.rasterize(*args, tc, tconf.RasterizeConfig(windowed=False),
                      colors=torch.as_tensor(colors), windowed=True)
