"""Port parity: a short `SLAMPipeline.run` (fused front-end, GICP tracking)
of `sags_tpu_torch` against `sags_tpu` on the same synthetic frames, made once
as numpy by the JAX package's dataset."""

import jax
import numpy as np
import pytest

from sags_tpu.core import config as jax_config
from sags_tpu.io.datasets import SyntheticDataset as JaxSynthetic
from sags_tpu.slam.pipeline import SLAMPipeline as JaxPipeline
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.io.datasets import Frame as TorchFrame
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.slam.pipeline import SLAMPipeline
from sags_tpu_torch.utils.draws import ReplayDraws
from sags_tpu_torch.utils.traj import ate_rmse

N_FRAMES, W, H = 6, 64, 48


def _cfg(mod):
    return mod.SLAMConfig(
        raster=mod.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32),
        map=mod.MapConfig(initial_capacity=4096, initial_scale=0.08),
        semantics=mod.SemanticsConfig(cls3d_sample=32, num_classes=24),
        keyframes=mod.KeyframeConfig(keyframe_freq=2, window=8),
        tracking=mod.TrackingConfig(backend="gicp", max_points=512),
        gicp=mod.GICPConfig(max_iterations=24, knn_max_distance=2.0),
        post_train_iters=0, metrics_interval=2,
    )


@pytest.fixture(scope="module")
def frames():
    return list(JaxSynthetic(n_frames=N_FRAMES, width=W, height=H, n_world=4096,
                             pts_per_frame=512, step=0.1, clutter=0.3))


def _jax_draws(cfg, n_frames, point_budget):
    """Replay the JAX pipeline's key chain as numpy draws for the port:
    `init_state` splits the seed key into (classifier, state rng, -); the
    classifier takes two uniforms; then every frame's add splits once (the
    obj embedding) and every trained frame's step splits once (the cls3d
    sample, used on steps ≡ 0 mod cls3d_interval). Every frame trains here:
    frame 0 is a keyframe and the others replay one."""
    r1, rng, _ = jax.random.split(jax.random.key(0), 3)
    k1, k2 = jax.random.split(r1)
    C, O = cfg.semantics.num_classes, cfg.semantics.num_objects
    out = [np.asarray(jax.random.uniform(k1, (C, O))),
           np.asarray(jax.random.uniform(k2, (C,)))]
    for step in range(n_frames):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(sub, (point_budget, O))))
        rng, sub = jax.random.split(rng)
        if step % cfg.semantics.cls3d_interval == 0:
            out.append(np.asarray(jax.random.uniform(sub, (cfg.map.initial_capacity,))))
    return out


def test_pipeline_run_matches_jax(frames):
    jcfg, tcfg = _cfg(jax_config), _cfg(tconf)
    jr = JaxPipeline(jcfg, point_budget=512, rng_seed=0).run(frames, post_train=0)

    draws = ReplayDraws(_jax_draws(jcfg, N_FRAMES, 512), "cpu")
    tp = SLAMPipeline(tcfg, point_budget=512, rng_seed=0, device="cpu", draws=draws)
    tr = tp.run([TorchFrame(**vars(f)) for f in frames], post_train=0)
    assert not draws.queue  # every replayed draw was consumed

    assert tr.train_iters == jr.train_iters == N_FRAMES
    assert tr.n_keyframes == jr.n_keyframes
    # the same GICP solves on the same scans. The LM accept/converge tests
    # are thresholds, so float32 rounding can end a solve one trial apart:
    # measured 2e-7 on most frames, 1.8e-4 on one — bound 5e-4 (m / rad),
    # against a 0.1 m step per frame
    np.testing.assert_allclose(tr.poses_est, jr.poses_est, atol=5e-4)
    ate, _ = ate_rmse(tr.poses_est, tr.poses_gt, align=False)
    assert ate < 0.12, ate
    # per-frame training losses (measured ≤ 7e-5 relative): the cameras
    # follow the tracked poses above, and gradient summation order differs
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=1e-3)
    assert int(tr.state.map.count) == int(jr.state.map.count)


def test_synthetic_dataset_matches_jax(frames):
    """The port's own dataset: same world, poses, point samples and RNG
    stream; its ground-truth images come from the port's rasterizer."""
    ds = SyntheticDataset(n_frames=3, width=W, height=H, n_world=4096,
                          pts_per_frame=512, step=0.1, clutter=0.3, device="cpu")
    for got, want in zip(ds, frames[:3]):
        np.testing.assert_allclose(got.pose, want.pose, atol=1e-6)
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.colors, want.colors)
        np.testing.assert_allclose(got.scan, want.scan, atol=1e-5)
        # rendered by two rasterizers: forward bar of the JAX suite
        np.testing.assert_allclose(got.image, want.image, atol=1e-3)
        np.testing.assert_allclose(got.depth, want.depth, atol=1e-2)
