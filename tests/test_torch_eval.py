"""Port parity: the eval surface of `sags_tpu_torch` against `sags_tpu` on the
CPU — PSNR / SSIM / LPIPS (the seeded `random_alex` bank), and
`SLAMPipeline.evaluate` and the windowed-budget adaptation on one map carried
over from the JAX package by `sags_tpu_torch.interop`. The JAX pipeline
renders windowed with its Pallas kernels in interpret mode."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import convolve

from sags_tpu.core import config as jax_config
from sags_tpu.eval.lpips_jax import lpips_backend as jax_lpips_backend
from sags_tpu.eval.lpips_jax import lpips_jax
from sags_tpu.eval.metrics import psnr as jax_psnr
from sags_tpu.eval.metrics import ssim as jax_ssim
from sags_tpu.io.datasets import SyntheticDataset as JaxSynthetic
from sags_tpu.slam import step as jax_step
from sags_tpu.slam.pipeline import Keyframe as JaxKeyframe
from sags_tpu.slam.pipeline import SLAMPipeline as JaxPipeline
from sags_tpu_torch import interop
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.eval import metrics as tmetrics
from sags_tpu_torch.io.datasets import Frame as TorchFrame
from sags_tpu_torch.slam.pipeline import Keyframe, SLAMPipeline
from sags_tpu_torch.slam.step import HOST_FIELDS
from test_torch_step import jax_state_to_numpy

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

W, H = 64, 48


def _img(seed, shape=(3, 64, 64)):
    """`tests/test_eval_metrics.py`'s smooth random image."""
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return np.clip(convolve(x, np.ones((1, 5, 5), np.float32) / 25.0, mode="nearest"),
                   0, 1)


def test_metrics_match_jax():
    """The three metrics at 64×64 to 1e-5 relative, the backend tag equal;
    PSNR masks gt == 0 pixels on both sides."""
    a, b = _img(0), _img(3)
    b[:, :4, :4] = 0.0
    noisy = np.clip(a + np.random.default_rng(1).normal(0, 0.05, a.shape), 0, 1)
    for pred, gt in ((a, b), (noisy.astype(np.float32), a)):
        tp, tg = torch.as_tensor(pred), torch.as_tensor(gt)
        for got, want in ((tmetrics.psnr(tp, tg), jax_psnr(pred, gt)),
                          (tmetrics.ssim(tp, tg), jax_ssim(pred, gt)),
                          (tmetrics.lpips(tp, tg), lpips_jax(pred, gt))):
            assert got == pytest.approx(want, rel=1e-5)
    assert tmetrics.lpips(torch.as_tensor(a), torch.as_tensor(a)) < 1e-6
    assert tmetrics.lpips_backend() == jax_lpips_backend() == "random_alex"
    pair = tmetrics.evaluate_pair(torch.as_tensor(a), torch.as_tensor(b))
    assert set(pair) == {"psnr", "ssim", "lpips", "lpips_net"}


def _cfg(mod, **raster):
    kw = dict(max_tiles_per_gaussian=16, tile_capacity=128, tile_capacity_max=256,
              chunk=32, windowed_big_capacity=64, **raster)
    if mod is jax_config:
        kw["pallas_interpret"] = True  # the JAX package renders windowed on TPU only
    return mod.SLAMConfig(
        raster=mod.RasterizeConfig(**kw),
        map=mod.MapConfig(initial_capacity=2048, initial_scale=0.08, initial_opacity=0.6),
        semantics=mod.SemanticsConfig(num_classes=24), post_train_iters=0)


@pytest.fixture(scope="module")
def world():
    """Three synthetic frames and a JAX map grown from the first two."""
    frames = list(JaxSynthetic(n_frames=3, width=W, height=H, n_world=4096,
                               pts_per_frame=512, step=0.1, clutter=0.3))
    cfg = _cfg(jax_config)
    state = JaxPipeline(cfg, point_budget=512, rng_seed=0).state
    for f in frames[:2]:
        state, _ = jax_step.add_frame_points(
            state, jnp.asarray(f.points), jnp.asarray(f.colors),
            jnp.ones(len(f.points), bool), cfg)
    return frames, state, jax_state_to_numpy(state)


def _pipes(world, keyframe: bool, **raster):
    """The JAX and the port pipeline holding the same map (and, with
    `keyframe`, the same newest keyframe: the probe's viewpoint)."""
    frames, state, tree = world
    jp = JaxPipeline(_cfg(jax_config, **raster), point_budget=512, rng_seed=0)
    jp.state = state
    tp = SLAMPipeline(_cfg(tconf, **raster), point_budget=512, rng_seed=0, device="cpu")
    tp.state = interop.state_from_numpy(tree, "cpu")
    if keyframe:
        f = frames[1]
        jp.keyframes.append(JaxKeyframe(camera=jp._camera_for(f, f.pose),
                                        image=jnp.asarray(f.image),
                                        objects=jnp.zeros((H, W), jnp.int32), pose=f.pose))
        tp.keyframes.append(Keyframe(camera=tp._camera_for(f, f.pose),
                                     image=torch.tensor(f.image),
                                     objects=torch.zeros((H, W), dtype=torch.int32),
                                     pose=torch.as_tensor(f.pose)))
    return jp, tp


def test_evaluate_matches_jax(world):
    """Budgets probed once, rendered windowed at tile_capacity_max: PSNR to
    0.01 dB, SSIM and LPIPS to 1e-4, the coverage counters exact."""
    frames = world[0]
    jp, tp = _pipes(world, keyframe=True)
    js = jp.evaluate(frames, every=2)
    ts = tp.evaluate([TorchFrame(**vars(f)) for f in frames], every=2)
    assert len(ts) == len(js) == 2
    for j, t in zip(js, ts):
        assert t["psnr"] == pytest.approx(j["psnr"], abs=0.01)
        assert t["ssim"] == pytest.approx(j["ssim"], abs=1e-4)
        assert t["lpips"] == pytest.approx(j["lpips"], abs=1e-4)
        assert t["lpips_net"] == j["lpips_net"]
        assert (t["overflow_pairs"], t["n_binned"]) == (j["overflow_pairs"], j["n_binned"])
        assert t["n_binned"] > 0
    assert tp.cfg == _cfg(tconf)  # evaluation adapts nothing


@pytest.mark.parametrize("kind", ["window", "big"])
@pytest.mark.parametrize("probe", [True, False])
def test_windowed_budget_growth_matches_jax(world, kind, probe):
    """Three strikes of window (big) overflow resize the windowed budgets:
    from the occupancy probe at the newest keyframe when there is one, else
    by the doubling fallback. Both pipelines land on the same config."""
    jp, tp = _pipes(world, keyframe=probe, window_blocks=10, windowed_mid_frac=0.25,
                    windowed_big_frac=0.125)
    before = tp.cfg.raster
    m = dict(loss=0.0, n_binned=1000, overflow_tile=0, overflow_rect=0,
             overflow_window=50 if kind == "window" else 0,
             overflow_big=50 if kind == "big" else 0, tile_peak=64, overflow_tile_live=0)
    for _ in range(3):
        jp._maybe_grow_capacity(types.SimpleNamespace(**m))
        tp._maybe_grow_capacity(np.array([m[f] for f in HOST_FIELDS], np.float32))
    jr, tr = jp.cfg.raster, tp.cfg.raster
    assert tr != before
    for f in dataclasses.fields(tr):
        if f.name != "pallas_interpret":
            assert getattr(tr, f.name) == getattr(jr, f.name), f.name
    if not probe:
        assert (tr.window_blocks == 12) == (kind == "window")
        assert (tr.windowed_mid_frac == 0.5) == (kind == "big")
