"""Port parity: `SLAMPipeline.run` through the per-module front-end
(`fused_frontend=False`) of `sags_tpu_torch` against `sags_tpu`, on the same
synthetic frames made once as numpy by the JAX package's dataset, with the
JAX pipeline's random draws replayed into the port. Trackers "gicp",
"vgicp", "gicp_map" and "none" here; "esikf" in `test_torch_esikf.py`, which
reuses this file's harness.

Bars, per frame: poses to 1e-4 (m, and rad through the rotation entries),
training losses to 1e-4 relative; `train_iters`, `n_keyframes` and the map's
capacity and count equal. A step with the cls3d term (every
`cls3d_interval`-th) is held to 1e-3, the fused parity test's bar: its kNN
over the map's positions, which differ by the poses' rounding (~1e-5 m), can
pick other neighbours (measured up to 3e-4 there, ≤ 3e-6 elsewhere)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from sags_tpu.core import config as jax_config
from sags_tpu.io.datasets import SyntheticDataset as JaxSynthetic
from sags_tpu.slam import pipeline as jax_pipeline_mod
from sags_tpu.slam import step as jax_step
from sags_tpu.slam.pipeline import SLAMPipeline as JaxPipeline
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.io.datasets import Frame as TorchFrame
from sags_tpu_torch.slam.pipeline import SLAMPipeline
from sags_tpu_torch.utils.draws import ReplayDraws
from test_torch_pipeline import _jax_draws

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

N_FRAMES, W, H, POINTS = 6, 64, 48, 512


def module_cfg(mod, backend, **tracking):
    return mod.SLAMConfig(
        raster=mod.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32),
        map=mod.MapConfig(initial_capacity=4096, initial_scale=0.08),
        semantics=mod.SemanticsConfig(cls3d_sample=32, num_classes=24),
        keyframes=mod.KeyframeConfig(keyframe_freq=2, window=8),
        tracking=mod.TrackingConfig(backend=backend, max_points=POINTS, **tracking),
        gicp=mod.GICPConfig(max_iterations=24, knn_max_distance=2.0),
        post_train_iters=0, metrics_interval=2, fused_frontend=False,
    )


_MAKE_SLAM_STEP = jax_step.make_slam_step


@functools.lru_cache(maxsize=None)
def _jax_step_for(cfg):
    return _MAKE_SLAM_STEP(cfg, donate=False)


@pytest.fixture(scope="module")
def shared_jax_steps():
    """One compiled JAX training step for every tracker: the step reads
    neither the tracking config nor `lidar_axes`, and `make_slam_step`
    would otherwise compile it again for each pipeline."""
    default_tracking = jax_config.TrackingConfig()

    def make(cfg, donate=True, mesh=None):
        assert mesh is None
        return _jax_step_for(dataclasses.replace(cfg, tracking=default_tracking,
                                                 lidar_axes=False))

    jax_pipeline_mod.slam_step_mod.make_slam_step = make
    yield
    jax_pipeline_mod.slam_step_mod.make_slam_step = _MAKE_SLAM_STEP


def run_both(frames, backend, lidar_axes=False, **tracking):
    """(JAX result, port result, port pipeline) of one run over `frames`."""
    jcfg = dataclasses.replace(module_cfg(jax_config, backend, **tracking),
                               lidar_axes=lidar_axes)
    tcfg = dataclasses.replace(module_cfg(tconf, backend, **tracking), lidar_axes=lidar_axes)
    jr = JaxPipeline(jcfg, point_budget=POINTS, rng_seed=0).run(frames, post_train=0)
    draws = ReplayDraws(_jax_draws(jcfg, len(frames), POINTS), "cpu")
    tp = SLAMPipeline(tcfg, point_budget=POINTS, rng_seed=0, device="cpu", draws=draws)
    tr = tp.run([TorchFrame(**vars(f)) for f in frames], post_train=0)
    assert not draws.queue  # every replayed draw was consumed
    return jr, tr, tp


def assert_runs_match(jr, tr, pose_atol=1e-4, loss_rtol=1e-4):
    assert tr.train_iters == jr.train_iters == len(jr.poses_est)
    assert tr.n_keyframes == jr.n_keyframes
    # m on the translations, rad through the rotation entries
    np.testing.assert_allclose(tr.poses_est, jr.poses_est, atol=pose_atol)
    cls3d = np.arange(len(jr.losses)) % jax_config.SemanticsConfig().cls3d_interval == 0
    got, want = np.asarray(tr.losses), np.asarray(jr.losses)
    np.testing.assert_allclose(got[~cls3d], want[~cls3d], rtol=loss_rtol)
    np.testing.assert_allclose(got[cls3d], want[cls3d], rtol=max(loss_rtol, 1e-3))
    assert tr.state.map.capacity == jr.state.map.capacity
    assert int(tr.state.map.count) == int(jr.state.map.count)


@pytest.fixture(scope="module")
def frames():
    return list(JaxSynthetic(n_frames=N_FRAMES, width=W, height=H, n_world=4096,
                             pts_per_frame=POINTS, step=0.1, clutter=0.3))


@pytest.mark.parametrize("backend", ["gicp", "vgicp", "gicp_map", "none"])
def test_per_module_pipeline_matches_jax(frames, shared_jax_steps, backend):
    tracking = {"anchor_min_points": 256} if backend == "gicp_map" else {}
    jr, tr, tp = run_both(frames, backend, **tracking)
    assert_runs_match(jr, tr)
    if backend == "gicp_map":
        assert tp._map_anchored and tp.anchored_at is not None
    if backend == "none":
        np.testing.assert_allclose(tr.poses_est, tr.poses_gt, atol=1e-6)


@pytest.mark.parametrize("capacity,batch", [(64, 24), (40, 64)])
def test_add_points_matches_jax_through_overflow(capacity, batch):
    """`add_points` (which writes without reading the host) against the JAX
    package's over four masked folds that fill the map and overflow it,
    with a batch smaller and larger than the capacity; the JAX draws
    replayed. Bars: every field and `n_dropped` bitwise."""
    import jax
    import torch

    from sags_tpu.mapping import gaussian_map as jgm
    from sags_tpu_torch.mapping import gaussian_map as tgm

    rng = np.random.default_rng(capacity)
    jm = jgm.init_map(capacity, jax_config.MapConfig())
    tm = tgm.init_map(capacity, tconf.MapConfig(), "cpu")
    key = jax.random.key(0)
    for step in range(4):
        pts = rng.normal(size=(batch, 3)).astype(np.float32)
        cols = rng.uniform(size=(batch, 3)).astype(np.float32)
        mask = rng.uniform(size=batch) < 0.7
        track = rng.uniform(size=batch) < 0.5
        key, sub = jax.random.split(key)
        jm, jd = jgm.add_points(jm, pts, cols, mask, sub, trackable=track, keyframe_id=step)
        draws = ReplayDraws([np.asarray(jax.random.uniform(sub, (batch, jm.obj_dc.shape[1])))],
                            "cpu")
        tm, td = tgm.add_points(tm, torch.as_tensor(pts), torch.as_tensor(cols),
                                torch.as_tensor(mask), draws, trackable=torch.as_tensor(track),
                                keyframe_id=step)
        assert int(td) == int(jd)
        for f in tgm.GaussianMap._fields:
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                          err_msg=f)
    assert int(tm.count) == capacity  # filled, the rest dropped
