"""Port parity: `slam_step`, `add_frame_points`, surfel covariances and GICP
of `sags_tpu_torch` against `sags_tpu`, from one JAX state carried over by
`sags_tpu_torch.interop`, with JAX's random draws replayed into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core.camera import make_camera as jax_make_camera
from sags_tpu.core.config import (GICPConfig, MapConfig, RasterizeConfig,
                                  SemanticsConfig, SLAMConfig)
from sags_tpu.ops import gicp as jax_gicp
from sags_tpu.slam import step as jax_step
from sags_tpu_torch import interop
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.ops import gicp as t_gicp
from sags_tpu_torch.slam import step as t_step
from sags_tpu_torch.utils.draws import ReplayDraws

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

W, H = 64, 48


def jax_state_to_numpy(s) -> dict:
    """Export a JAX `SLAMState` into the `interop` numpy tree."""
    def adam(st):
        return {"count": int(st.count),
                "mu": {k: np.asarray(v) for k, v in st.mu._asdict().items()},
                "nu": {k: np.asarray(v) for k, v in st.nu._asdict().items()}}

    cls = s.cls_opt_state[0]  # optax.adam = chain(scale_by_adam, scale_by_lr)
    return {
        "map": {k: np.asarray(v) for k, v in s.map._asdict().items()},
        "opt": adam(s.opt_state),
        "classifier": {"weight": np.asarray(s.classifier.weight),
                       "bias": np.asarray(s.classifier.bias)},
        "cls_opt": adam(cls),
        "step": int(s.step),
    }


def configs():
    kw = dict(
        raster=dict(max_tiles_per_gaussian=16, tile_capacity=128, chunk=16),
        map=dict(initial_capacity=512, initial_scale=0.06),
        semantics=dict(cls3d_sample=16, num_classes=20),
    )
    j = SLAMConfig(raster=RasterizeConfig(**kw["raster"]), map=MapConfig(**kw["map"]),
                   semantics=SemanticsConfig(**kw["semantics"]))
    t = tconf.SLAMConfig(raster=tconf.RasterizeConfig(**kw["raster"]),
                         map=tconf.MapConfig(**kw["map"]),
                         semantics=tconf.SemanticsConfig(**kw["semantics"]))
    return j, t


def scene(rng, n=300):
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                    rng.uniform(2.0, 4.0, n)], -1).astype(np.float32)
    cols = rng.uniform(0.05, 1.0, (n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-20:] = False
    img = rng.uniform(0.0, 1.0, (3, H, W)).astype(np.float32)
    img[:, :4, :4] = 0.0  # exercise the gt == 0 mask of L1/SSIM
    obj = rng.integers(0, 20, (H, W)).astype(np.int32)
    return pts, cols, mask, img, obj


def uniform_draw(rng_key, shape):
    """The U[0,1) numbers JAX draws from `split(state.rng)[1]`."""
    _, sub = jax.random.split(rng_key)
    return np.asarray(jax.random.uniform(sub, shape))


def assert_map_close(jm, tm, atol):
    for f in ("xyz", "f_dc", "log_scales", "quats", "opacity_logit", "obj_dc"):
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   atol=atol[f], rtol=0, err_msg=f)
    for f in ("active", "trackable", "keyframe_id", "count"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def carried():
    rng = np.random.default_rng(3)
    jcfg, tcfg = configs()
    pts, cols, mask, img, obj = scene(rng)
    s = jax_step.init_state(jcfg, jax.random.key(0))
    s, _ = jax_step.add_frame_points(s, jnp.asarray(pts), jnp.asarray(cols),
                                     jnp.asarray(mask), jcfg)
    jcam = jax_make_camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                           W, H, 1.2, 0.9)
    tcam = make_camera(torch.eye(3), torch.zeros(3), W, H, 1.2, 0.9)
    return jcfg, tcfg, s, jcam, tcam, img, obj, rng


# gradients differ by summation order (~1e-6 relative); Adam's first steps
# normalise them (û ≈ ±1), so parameters agree to a small multiple of each
# group's learning rate times that relative error
ATOL = {"xyz": 1e-6, "f_dc": 1e-4, "log_scales": 1e-4, "quats": 1e-4,
        "opacity_logit": 2e-3, "obj_dc": 1e-4}


def test_slam_steps_and_add_match_jax(carried):
    jcfg, tcfg, s, jcam, tcam, img, obj, rng = carried
    draws = ReplayDraws([], "cpu")
    p = interop.state_from_numpy(jax_state_to_numpy(s), "cpu", draws=draws)
    step_j = jax.jit(lambda st: jax_step.slam_step(st, jcam, jnp.asarray(img),
                                                   jnp.asarray(obj), jcfg))
    for it in range(2):  # step 0 runs the cls3d term and the prune; step 1 not
        if it % jcfg.semantics.cls3d_interval == 0:
            draws.push(uniform_draw(s.rng, (s.map.capacity,)))
        s, mj = step_j(s)
        p, mt = t_step.slam_step(p, tcam, torch.as_tensor(img), torch.as_tensor(obj), tcfg)
        for f in ("loss", "loss_rgb", "loss_obj", "loss_obj_3d"):
            np.testing.assert_allclose(float(getattr(mt, f)), float(getattr(mj, f)),
                                       rtol=1e-5, atol=1e-7, err_msg=f)
        for f in ("n_active", "n_binned", "overflow_tile", "overflow_rect",
                  "overflow_window", "overflow_big", "tile_peak", "overflow_tile_live"):
            assert int(getattr(mt, f)) == int(getattr(mj, f)), f
        assert p.step == int(s.step)
        assert_map_close(s.map, p.map, ATOL)
        tree = interop.state_to_numpy(p)
        jtree = jax_state_to_numpy(s)
        assert tree["opt"]["count"] == jtree["opt"]["count"]
        for k in ("xyz", "f_dc", "opacity_logit", "obj_dc"):
            # first moments: the gradients themselves, ~1e-6 relative
            scale = np.abs(jtree["opt"]["mu"][k]).max() + 1e-30
            np.testing.assert_allclose(tree["opt"]["mu"][k] / scale,
                                       jtree["opt"]["mu"][k] / scale, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(tree["classifier"]["weight"],
                                   jtree["classifier"]["weight"], atol=1e-6)
        np.testing.assert_allclose(tree["classifier"]["bias"],
                                   jtree["classifier"]["bias"], atol=1e-6)

    # map growth: 200 more points (60 of them masked) after the two steps
    pts, cols, mask, _, _ = scene(rng, 200)
    draws.push(uniform_draw(s.rng, (200, jcfg.map.num_objects)))
    s, dj = jax_step.add_frame_points(s, jnp.asarray(pts), jnp.asarray(cols),
                                      jnp.asarray(mask), jcfg, keyframe_id=3)
    p, dt = t_step.add_frame_points(p, torch.as_tensor(pts), torch.as_tensor(cols),
                                    torch.as_tensor(mask), tcfg, keyframe_id=3)
    assert int(dt) == int(dj)
    assert_map_close(s.map, p.map, ATOL)


def test_cls3d_step_gradients_are_bitwise_reproducible():
    """Two backward passes of a step's loss with the cls3d term give bitwise
    equal gradients on the CPU, in every parameter group: the neighbour
    gather sums the cotangents of a row that is several samples' neighbour in
    a fixed order. At 1000 samples of 3000 points, on four threads, plain
    indexing's backward does not."""
    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.models.classifier import ClassifierParams

    rng = np.random.default_rng(11)
    _, tcfg = configs()
    tcfg = tcfg.replace(map=tconf.MapConfig(initial_capacity=4096, initial_scale=0.06),
                        semantics=tconf.SemanticsConfig(cls3d_sample=1000, num_classes=20))
    pts, cols, mask, img, obj = scene(rng, 3000)
    state = t_step.init_state(tcfg, seed=0, device="cpu")
    state, _ = t_step.add_frame_points(state, torch.as_tensor(pts), torch.as_tensor(cols),
                                       torch.as_tensor(mask), tcfg)
    cam = make_camera(torch.eye(3), torch.zeros(3), W, H, 1.2, 0.9)
    m = state.map
    u = rng.uniform(size=m.capacity).astype(np.float32)

    def grads():
        params = gm.Params(*(p.detach().requires_grad_(True) for p in gm.params_of(m)))
        clf = ClassifierParams(*(p.detach().requires_grad_(True) for p in state.classifier))
        loss, (_, _, loss_3d, _) = t_step._loss_fn(
            params, clf, m, cam, torch.as_tensor(img), torch.as_tensor(obj), True,
            ReplayDraws([u], "cpu"), tcfg)
        assert float(loss_3d.detach()) > 0
        return torch.autograd.grad(loss, tuple(params) + tuple(clf), allow_unused=True)

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        first = grads()
        for _ in range(3):
            for name, a, b in zip(gm.Params._fields + ClassifierParams._fields, first,
                                  grads()):
                assert (a is None and b is None) or torch.equal(a, b), name
    finally:
        torch.set_num_threads(threads)
    assert float(first[gm.Params._fields.index("obj_dc")].abs().max()) > 0


def test_interop_round_trip(carried):
    _, _, s, *_ = carried
    tree = jax_state_to_numpy(s)
    back = interop.state_to_numpy(interop.state_from_numpy(tree, "cpu"))
    for group in ("map", "classifier"):
        for k, v in tree[group].items():
            np.testing.assert_array_equal(back[group][k], v, err_msg=k)
    for group in ("opt", "cls_opt"):
        assert back[group]["count"] == tree[group]["count"]
        for mom in ("mu", "nu"):
            for k, v in tree[group][mom].items():
                np.testing.assert_array_equal(back[group][mom][k], v)


@pytest.mark.parametrize("budget", [128, 512])
def test_trackable_subset_matches_jax(carried, budget):
    """The scan-to-map target: newest trackable Gaussians first, regularized
    covariances from (q, s); `budget` below and at the map's capacity."""
    from sags_tpu.mapping import gaussian_map as jgm
    from sags_tpu_torch.mapping import gaussian_map as tgm

    jcfg, _, s, *_ = carried
    p = interop.state_from_numpy(jax_state_to_numpy(s), "cpu")
    th = jcfg.tracking.opacity_threshold
    want = jgm.trackable_subset(s.map, th, budget)
    got = tgm.trackable_subset(p.map, th, budget)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])


def _scan(rng, n=400):
    """Two overlapping noisy planes + a blob: a well-conditioned GICP pair."""
    a = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                  3.0 + 0.01 * rng.normal(size=n)], -1)
    b = np.stack([-1.5 + 0.01 * rng.normal(size=n), rng.uniform(-1, 1, n),
                  rng.uniform(1, 5, n)], -1)
    c = rng.normal(size=(n // 2, 3)) * 0.2 + np.array([0.5, 0.2, 2.0])
    return np.concatenate([a, b, c]).astype(np.float32)


@pytest.mark.parametrize("reg", ["normalized_ellipse", "plane", "min_eig"])
def test_estimate_covariances_match_jax(reg):
    rng = np.random.default_rng(1)
    pts = _scan(rng)
    mask = np.ones(len(pts), bool)
    mask[-50:] = False
    pj = jax_gicp.estimate_covariances(jnp.asarray(pts), jnp.asarray(mask), 10, 0.5, reg)
    pt = t_gicp.estimate_covariances(torch.as_tensor(pts), torch.as_tensor(mask), 10, 0.5, reg)
    # closed-form eigensystems of float32 covariances: 1e-4 absolute on the
    # regularized (unitless, O(1)) covariances and on the sqrt-eigenvalue scales
    np.testing.assert_allclose(pt.covs.numpy(), np.asarray(pj.covs), atol=1e-4)
    np.testing.assert_allclose(pt.scales.numpy(), np.asarray(pj.scales), atol=1e-4)
    # quaternions up to sign
    qj, qt = np.asarray(pj.quats), pt.quats.numpy()
    dots = np.abs(np.sum(qj * qt, -1))
    assert np.quantile(dots, 0.99) > 1 - 1e-4


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_gicp_align_matches_jax(optimizer):
    rng = np.random.default_rng(2)
    tgt = _scan(rng)
    ang = np.array([0.02, -0.03, 0.015], np.float32)
    Rt = np.asarray(jax_gicp.so3_exp(jnp.asarray(ang)))
    src = ((tgt - np.array([0.05, -0.02, 0.08], np.float32)) @ Rt).astype(np.float32)
    mask = np.ones(len(src), bool)
    cfg = GICPConfig(knn_max_distance=2.0, optimizer=optimizer)
    rj = jax_gicp.gicp_align(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
                             jnp.asarray(mask), jnp.eye(4), cfg)
    rt = t_gicp.gicp_align(torch.as_tensor(src), torch.as_tensor(tgt),
                           torch.as_tensor(mask), torch.as_tensor(mask), torch.eye(4),
                           tconf.GICPConfig(knn_max_distance=2.0, optimizer=optimizer))
    # same optimizer path: iteration counts equal, pose within 1e-5 (float32 solves)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    assert rt.lm_iterations == 0 if optimizer == "gn" else rt.lm_iterations > 0
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-5)


def test_lsq_align_rejects_an_unknown_optimizer():
    with pytest.raises(ValueError):
        t_gicp.lsq_align(None, None, torch.eye(4), tconf.GICPConfig(optimizer="dogleg"))


def test_track_add_write_row_and_camera_match_jax():
    """`FusedFrontend.track_add` on a frame after the first: the pose and
    the camera at it as the JAX package's program gives them (1e-5, the
    GICP test's bar), and one idle metrics row with `write_row=True`, none
    with `write_row=False` (the semantics split's `train_only` writes it)."""
    from sags_tpu.slam import fused as jax_fused
    from sags_tpu_torch.slam import fused as t_fused

    rng = np.random.default_rng(6)
    jcfg, tcfg = configs()
    gkw = dict(knn_max_distance=2.0)
    jcfg = jcfg.replace(gicp=GICPConfig(**gkw))
    tcfg = tcfg.replace(gicp=tconf.GICPConfig(**gkw))
    prev = _scan(rng, 160)
    ang = np.array([0.01, 0.02, -0.01], np.float32)
    Rt = np.asarray(jax_gicp.so3_exp(jnp.asarray(ang)))
    scan = ((prev - np.array([0.03, 0.01, -0.04], np.float32)) @ Rt).astype(np.float32)
    mask = np.ones(len(scan), bool)
    cols = rng.uniform(0.05, 1.0, (len(scan), 3)).astype(np.float32)
    pose_in = np.eye(4, dtype=np.float32)
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.2, -0.1, 0.3]

    s = jax_step.init_state(jcfg, jax.random.key(0))
    covs = jax_gicp.estimate_covariances(jnp.asarray(prev), jnp.asarray(mask), 10, 2.0,
                                         jcfg.gicp.regularization).covs
    jt = jax_fused.init_track_state(len(scan), 4)._replace(
        T=jnp.asarray(T0), prev_scan=jnp.asarray(prev), prev_mask=jnp.asarray(mask),
        prev_covs=covs)
    args = tuple(map(jnp.asarray, (scan, mask, scan, cols, mask, pose_in)))
    fe_j = jax_fused.FusedFrontend(jcfg, H, W, sensor_frame=True)
    _, _, T_j, cam_j = fe_j.track_add(False, False, False)(s, jt, *args)

    p = interop.state_from_numpy(jax_state_to_numpy(s), "cpu")
    tt = t_fused.init_track_state(len(scan), 4, "cpu")._replace(
        T=torch.as_tensor(T0), prev_scan=torch.as_tensor(prev),
        prev_mask=torch.as_tensor(mask), prev_covs=torch.as_tensor(np.array(covs)))
    targs = tuple(map(torch.as_tensor, (scan, mask, scan, cols, mask, pose_in)))
    fe_t = t_fused.FusedFrontend(tcfg, H, W, sensor_frame=True)
    for write_row in (False, True):
        _, track, T_t, cam_t = fe_t.track_add(p, tt, *targs, first=False,
                                              write_row=write_row)
        assert track.mi == tt.mi + int(write_row)
        assert torch.equal(track.metrics, tt.metrics) != write_row
        np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-5)
        assert (cam_t.width, cam_t.height) == (cam_j.width, cam_j.height)
        np.testing.assert_allclose([cam_t.fovx, cam_t.fovy], [cam_j.fovx, cam_j.fovy],
                                   rtol=1e-6)
        for f in ("world_view", "full_proj", "cam_center"):
            np.testing.assert_allclose(getattr(cam_t, f).numpy(), np.asarray(getattr(cam_j, f)),
                                       atol=1e-5, err_msg=f)
