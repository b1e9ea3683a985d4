"""Port parity of the offline 3DGS trainer (`sags_tpu_torch.slam.offline`
against `sags_tpu.slam.offline`) and of the pieces it runs: the kNN scale
init, the `mean2d_offset` probe, `cov3d_precomp` and `fused=False` of the
rasterizer, `mark_visible`, the L2 and photometric losses, the
densification stats, clone/split with JAX's normals replayed, the opacity
resets and prunes, and the offline state's interop. The JAX side renders
through its XLA path (`fused=False`). Each test states its bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core import config as jconf
from sags_tpu.core.camera import make_camera as jax_make_camera
from sags_tpu.mapping import gaussian_map as jgm
from sags_tpu.ops import knn as jknn
from sags_tpu.ops import rasterize as jrz
from sags_tpu.slam import offline as joff
from sags_tpu.utils import losses as jlosses
from sags_tpu_torch import interop
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.mapping import gaussian_map as tgm
from sags_tpu_torch.ops import knn as tknn
from sags_tpu_torch.ops import rasterize as trz
from sags_tpu_torch.slam import offline as toff
from sags_tpu_torch.utils import losses as tlosses
from sags_tpu_torch.utils.draws import ReplayDraws
from test_torch_step import ATOL

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

T = lambda a: torch.from_numpy(np.array(a))
ITERS = 12


def _cfg(mod, **opt):
    """`tests/test_offline.py`'s small config; `opt` overrides its schedule."""
    kw = dict(feature_lr=0.05, opacity_lr=0.1, scaling_lr=0.02, densify_from_iter=10,
              densification_interval=15, densify_grad_threshold=1e-4,
              opacity_reset_interval=10_000)
    kw.update(opt)
    return mod.SLAMConfig(
        raster=mod.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32),
        map=mod.MapConfig(initial_capacity=8192), opt=mod.OptimizationConfig(**kw))


# densify at 4, 8 and 12, the opacity reset at 8
SCHEDULE = dict(densify_from_iter=4, densification_interval=4, opacity_reset_interval=8)


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def jax_map_to_numpy(m) -> dict:
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def jax_offline_to_numpy(s) -> dict:
    """Export a JAX `OfflineState` into the `interop` tree."""
    return {"map": jax_map_to_numpy(s.map),
            "opt": {"count": int(s.opt_state.count),
                    "mu": {k: np.asarray(v) for k, v in s.opt_state.mu._asdict().items()},
                    "nu": {k: np.asarray(v) for k, v in s.opt_state.nu._asdict().items()}},
            "step": int(s.step)}


def to_port_map(m) -> tgm.GaussianMap:
    return interop._map_from(jax_map_to_numpy(m), "cpu")


def split_normals(rng_key, N, n_split=2):
    """The N(0,1) draws of one JAX `densify_event` from state rng `rng_key`:
    (the state's next key, [n_split draws of [N,3]])."""
    rng, sub = jax.random.split(rng_key)
    out = []
    for _ in range(n_split):
        sub, s2 = jax.random.split(sub)
        out.append(np.asarray(jax.random.normal(s2, (N, 3))))
    return rng, out


@pytest.fixture(scope="module")
def frames():
    return list(SyntheticDataset(n_frames=3, width=96, height=64, n_world=1500,
                                 pts_per_frame=600, step=0.2, device="cpu"))


@pytest.fixture(scope="module")
def trained(frames):
    """Both packages' `train_offline` over the same frames for ITERS steps,
    JAX's draws replayed into the port. JAX's training step is wrapped to
    record each call's (state in, state out, loss): the run's states, which
    `test_train_steps_from_jax_state_match` steps the port from."""
    jcfg, tcfg = _cfg(jconf, **SCHEDULE), _cfg(tconf, **SCHEDULE)
    n = sum(len(f.points) for f in frames)
    capacity = 4096
    r1, rng = jax.random.split(jax.random.key(0))
    draws = [np.asarray(jax.random.uniform(r1, (n, jcfg.map.num_objects)))]
    for step in range(1, ITERS + 1):
        if step >= 4 and step % 4 == 0:
            rng, normals = split_normals(rng, capacity)
            draws += normals
    steps = []
    make_train_step = joff.make_train_step

    def recording(cfg, donate=False):
        assert not donate  # a recorded state must stay valid
        fn = make_train_step(cfg, donate=donate)

        def step(state, cam, img):
            out, loss = fn(state, cam, img)
            steps.append((state, out, loss))
            return out, loss
        return step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(joff, "make_train_step", recording)
        js, jl = joff.train_offline(frames, jcfg, ITERS, capacity=capacity, seed=0)
    ts, tl = toff.train_offline(frames, tcfg, ITERS, capacity=capacity, seed=0,
                                device="cpu", draws=ReplayDraws(draws, "cpu"))
    assert len(steps) == ITERS
    return js, jl, ts, tl, steps


def test_knn_scale_init_matches_jax():
    """`mean_knn3_sqdist` and `scale_init_from_points` over several query
    chunks, to 1e-5 relative."""
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(700, 3)) * 0.5).astype(np.float32)
    got = tknn.mean_knn3_sqdist(T(pts), chunk=256).numpy()
    want = np.asarray(jknn.mean_knn3_sqdist(jnp.asarray(pts), chunk=256))
    assert rel(got, want) <= 1e-5
    got = tknn.scale_init_from_points(T(pts)).numpy()
    want = np.asarray(jknn.scale_init_from_points(jnp.asarray(pts)))
    assert got.shape == want.shape == (700, 3)
    assert rel(got, want) <= 1e-5


def test_probe_gradient_matches_jax(frames):
    """One training step's d loss / d mean2d_offset from one state: the
    probe gradient to 1e-5 relative of its max, the loss to 1e-6; then
    `train_step` itself: the accumulated stats and the loss."""
    jcfg, tcfg = _cfg(jconf), _cfg(tconf)
    f = frames[1]
    s = joff.init_from_points(f.points, f.colors, jcfg, capacity=1024,
                              rng=jax.random.key(3))
    ts = interop.offline_state_from_numpy(jax_offline_to_numpy(s), "cpu")
    jcam = jax_make_camera(np.asarray(f.pose)[:3, :3], np.asarray(f.pose)[:3, 3],
                           96, 64, *_fovs(jcfg, 96, 64))
    tcam = make_camera(T(np.asarray(f.pose, np.float32)[:3, :3]),
                       T(np.asarray(f.pose, np.float32)[:3, 3]), 96, 64,
                       *_fovs(tcfg, 96, 64))
    img = np.asarray(f.image, np.float32)

    def jloss(probe):
        m = s.map
        out = jrz.rasterize(m.xyz, jgm.get_opacity(m), jgm.get_scaling(m),
                            jgm.get_rotation(m), jcam, jcfg.raster, shs=jgm.get_shs(m),
                            sh_degree=jcfg.map.sh_degree, active_mask=m.active,
                            mean2d_offset=probe, fused=False)
        return jlosses.rgb_loss(out.color, jnp.asarray(img), jcfg.opt.lambda_dssim)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.zeros((1024, 2), jnp.float32))
    m = ts.map
    probe = torch.zeros((1024, 2), requires_grad=True)
    out = trz.rasterize(m.xyz, tgm.get_opacity(m), tgm.get_scaling(m), tgm.get_rotation(m),
                        tcam, tcfg.raster, shs=tgm.get_shs(m), sh_degree=tcfg.map.sh_degree,
                        active_mask=m.active, mean2d_offset=probe, fused=False)
    tl = tlosses.rgb_loss(out.color, T(img), tcfg.opt.lambda_dssim)
    (tg,) = torch.autograd.grad(tl, probe)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert np.abs(np.asarray(jg)).max() > 0
    assert rel(tg.numpy(), jg) <= 1e-5

    s2, jl2 = joff.make_train_step(jcfg, donate=False)(s, jcam, jnp.asarray(img))
    ts2, tl2 = toff.train_step(ts, tcam, T(img), tcfg)
    assert ts2.step == int(s2.step) == 1
    assert abs(float(tl2) - float(jl2)) <= 1e-6 * abs(float(jl2))
    np.testing.assert_array_equal(ts2.map.denom.numpy(), np.asarray(s2.map.denom))
    np.testing.assert_array_equal(ts2.map.max_radii2d.numpy(), np.asarray(s2.map.max_radii2d))
    assert rel(ts2.map.xyz_grad_accum.numpy(), s2.map.xyz_grad_accum) <= 1e-5


def _fovs(cfg, W, H):
    from sags_tpu_torch.core.camera import focal2fov

    c = cfg.camera
    return focal2fov(c.fx * W / c.width, W), focal2fov(c.fy * H / c.height, H)


def _random_map(rng, cap=256, n=200):
    """A JAX map with n of cap slots taken: scales spread around the clone /
    split boundary, opacities over (0, 1), a few slots inactive."""
    cfg = _cfg(jconf)
    m = jgm.init_map(cap, cfg.map)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    m, _ = jgm.add_points(m, jnp.asarray(pts), jnp.asarray(cols), jnp.ones(n, bool),
                          jax.random.key(1))
    q = rng.normal(size=(cap, 4)).astype(np.float32)
    return m._replace(
        log_scales=jnp.asarray(rng.uniform(np.log(0.005), np.log(0.08), (cap, 3)),
                               jnp.float32),
        quats=jnp.asarray(q),
        opacity_logit=jnp.asarray(rng.normal(0, 2.5, cap), jnp.float32),
        active=m.active.at[:10].set(False),
        keyframe_id=jnp.asarray(rng.integers(-1, 6, cap), jnp.int32),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 4e-4, cap), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 3, cap), jnp.float32),
        max_radii2d=jnp.asarray(rng.uniform(0, 5, cap), jnp.float32))


def assert_maps_equal(tm, jm, float_atol=0.0):
    for f, w in jax_map_to_numpy(jm).items():
        g = getattr(tm, f).numpy()
        if w.dtype.kind == "f" and float_atol:
            np.testing.assert_allclose(g, w, atol=float_atol, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_add_densification_stats_exact():
    rng = np.random.default_rng(2)
    jm = _random_map(rng)
    grad = rng.normal(0, 1e-3, (256, 2)).astype(np.float32)
    radii = rng.integers(-1, 4, 256).astype(np.int32)
    want = jgm.add_densification_stats(jm, jnp.asarray(grad), jnp.asarray(radii))
    got = tgm.add_densification_stats(to_port_map(jm), T(grad), T(radii))
    assert_maps_equal(got, want)


@pytest.mark.parametrize("cap", [256, 230])
def test_densify_and_clone_split_matches_jax(cap):
    """Clones and splits from one map with JAX's normals replayed; at
    capacity 230 the appends overflow. Selection (active, count, drops,
    every copied field) exact; xyz and log-scales to 1e-6."""
    rng = np.random.default_rng(4)
    jm = _random_map(rng, cap=cap, n=120)
    key = jax.random.key(7)
    want, jdrops = jgm.densify_and_clone_split(jm, 1e-4, 2.5, key)
    sub = key
    normals = []
    for _ in range(2):
        sub, s2 = jax.random.split(sub)
        normals.append(np.asarray(jax.random.normal(s2, (cap, 3))))
    got, tdrops = tgm.densify_and_clone_split(to_port_map(jm), 1e-4, 2.5,
                                              ReplayDraws(normals, "cpu"))
    assert int(tdrops) == int(jdrops)
    if cap == 230:
        assert int(jdrops) > 0
    jw = jax_map_to_numpy(want)
    assert int(jw["count"]) > 120  # something was appended
    for f, w in jw.items():
        g = getattr(got, f).numpy()
        if f in ("xyz", "log_scales"):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_allclose(
        tgm.quat_to_rot_cached(T(np.asarray(jm.quats))).numpy(),
        np.asarray(jgm.quat_to_rot_cached(jm.quats)), atol=1e-6)


RESETS = {
    "reset_opacity": lambda g, m, vis: g.reset_opacity(m),
    "reset_opacity_0.05": lambda g, m, vis: g.reset_opacity(m, ceiling=0.05),
    "reset_unreliable_opacity": lambda g, m, vis: g.reset_unreliable_opacity(m, vis),
    "reset_visible_opacity": lambda g, m, vis: g.reset_visible_opacity(m, vis),
    "prune_large_and_transparent2": lambda g, m, vis: g.prune_large_and_transparent2(
        m, 0.3, 0.05, vis),
    "prune_large_and_transparent": lambda g, m, vis: g.prune_large_and_transparent(
        m, 0.005, None),
}


@pytest.mark.parametrize("name", list(RESETS))
def test_opacity_resets_and_prunes_match_jax(name):
    """Each reset and prune on a map with opacities across (0, 1) and scales
    across the large-scale thresholds: masks exact, logits and log-scales
    to 1e-6."""
    rng = np.random.default_rng(5)
    jm = _random_map(rng)
    vis = rng.uniform(size=256) < 0.6
    jvis = jnp.asarray(vis) if name != "prune_large_and_transparent" else None
    want = RESETS[name](jgm, jm, jvis)
    got = RESETS[name](tgm, to_port_map(jm), T(vis))
    assert_maps_equal(got, want, float_atol=1e-6)


def test_gaussians_from_keyframes_and_mark_visible_match_jax(frames):
    rng = np.random.default_rng(6)
    jm = _random_map(rng)
    for g, w in zip(tgm.gaussians_from_keyframes(to_port_map(jm), 3),
                    jgm.gaussians_from_keyframes(jm, 3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)
    pose = np.asarray(frames[0].pose, np.float32)
    jcam = jax_make_camera(pose[:3, :3], pose[:3, 3], 96, 64, 1.2, 1.0)
    tcam = make_camera(T(pose[:3, :3]), T(pose[:3, 3]), 96, 64, 1.2, 1.0)
    pts = frames[2].points
    np.testing.assert_array_equal(trz.mark_visible(T(pts), tcam).numpy(),
                                  np.asarray(jrz.mark_visible(jnp.asarray(pts), jcam)))


def test_losses_match_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(size=(3, 40, 56)).astype(np.float32)
    b = rng.uniform(size=(3, 40, 56)).astype(np.float32)
    b[:, :5, :5] = 0.0  # the gt == 0 mask
    for mz in (True, False):
        np.testing.assert_allclose(float(tlosses.l2_loss(T(a), T(b), mask_zeros=mz)),
                                   float(jlosses.l2_loss(jnp.asarray(a), jnp.asarray(b),
                                                         mask_zeros=mz)), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.rgb_loss(T(a), T(b), 0.3)),
                               float(jlosses.rgb_loss(jnp.asarray(a), jnp.asarray(b), 0.3)),
                               rtol=1e-6)


@pytest.mark.parametrize("packed", [False, True])
def test_cov3d_precomp_matches_jax(packed):
    """A render from precomputed covariances ([P,3,3] or packed [P,6]),
    classic path: colour, depth and alpha to 1e-5, radii exact."""
    rng = np.random.default_rng(8)
    n = 300
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 4, n)], -1).astype(np.float32)
    A = rng.normal(0, 0.05, (n, 3, 3)).astype(np.float32)
    cov = (A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)).astype(np.float32)
    if packed:
        iu = np.triu_indices(3)
        cov = cov[:, iu[0], iu[1]]
    op = rng.uniform(0.2, 0.9, n).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    cfgj, cfgt = _cfg(jconf).raster, _cfg(tconf).raster
    jcam = jax_make_camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 64, 48,
                           1.2, 0.9)
    tcam = make_camera(torch.eye(3), torch.zeros(3), 64, 48, 1.2, 0.9)
    ones = np.ones((n, 3), np.float32)
    quat = np.tile(np.float32([0, 0, 0, 1]), (n, 1))
    jo = jrz.rasterize(jnp.asarray(pts), jnp.asarray(op), jnp.asarray(ones),
                       jnp.asarray(quat), jcam, cfgj, colors=jnp.asarray(cols),
                       cov3d_precomp=jnp.asarray(cov), fused=False)
    to = trz.rasterize(T(pts), T(op), T(ones), T(quat), tcam, cfgt, colors=T(cols),
                       cov3d_precomp=T(cov), fused=False)
    for f in ("color", "depth", "alpha"):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(to.radii.numpy(), np.asarray(jo.radii))
    assert int((to.radii > 0).sum()) > 100


def test_train_offline_losses_match_jax(trained):
    """12 iterations: every loss to 1e-4 relative, finite."""
    _, jl, _, tl, _ = trained
    assert len(tl) == len(jl) == ITERS
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def _max_err(tm, jm) -> dict:
    """Per parameter group: the largest |port − JAX| entry."""
    return {f: float(np.abs(getattr(tm, f).numpy() - np.asarray(getattr(jm, f))).max())
            for f in ("xyz", "f_dc", "log_scales", "quats", "opacity_logit")}


# One step from one state: `test_torch_step.py`'s ATOL, but three groups at
# measured bars (measured beside each). Adam with eps = 1e-15 moves an entry
# by about ±lr whatever its gradient's size, so an entry whose gradient is
# at rounding level (the quaternions of the kNN init's isotropic Gaussians
# and of their split copies, zero in exact arithmetic; positions whose
# gradient cancels over the pixels) takes a step of any size up to lr.
STEP_BAR = dict(ATOL, xyz=2.5e-6, log_scales=2e-4, quats=5e-4)  # 1.19e-6, 1.06e-4, 2.85e-4
# The 12-step run carries each step's rounding on, and a split copy sits at
# its parent's position plus R·(z ⊙ s), so a scale that differs by δ moves
# the copy by |z|·s·δ (measured beside each).
RUN_BAR = {"xyz": 1e-4, "f_dc": 5e-3, "log_scales": 2e-2, "quats": 4e-3,
           "opacity_logit": 2.5e-3}  # 3.89e-5, 2.22e-3, 9.17e-3, 1.99e-3, 1.04e-3


def test_train_offline_map_matches_jax(trained):
    """After densify at 4, 8 and 12 and the reset at 8: `active`, `count`,
    trackable and keyframe ids exact, the obj channels (no gradient) equal,
    the other parameters within RUN_BAR, the step count equal."""
    js, _, ts, _, _ = trained
    for f in ("active", "trackable", "keyframe_id", "count", "obj_dc"):
        np.testing.assert_array_equal(getattr(ts.map, f).numpy(),
                                      np.asarray(getattr(js.map, f)), err_msg=f)
    err = _max_err(ts.map, js.map)
    assert all(err[f] <= RUN_BAR[f] for f in err), err
    assert ts.step == int(js.step) == ITERS
    assert int(js.map.count) > 1800  # the densify events appended


def test_offline_state_interop_round_trip(trained):
    _, _, ts, _, _ = trained
    tree = interop.offline_state_to_numpy(ts)
    back = interop.offline_state_from_numpy(tree, "cpu")
    assert back.step == ts.step and back.opt_state.count == ts.opt_state.count
    for f in tgm.GaussianMap._fields:
        assert torch.equal(getattr(back.map, f), getattr(ts.map, f)), f
    for a, b in zip(back.opt_state.mu + back.opt_state.nu, ts.opt_state.mu + ts.opt_state.nu):
        assert torch.equal(a, b)


def test_train_steps_from_jax_state_match(frames, trained):
    """The 12 steps of the run, each from JAX's state before it (the JAX
    run's own, recorded by `trained`: its densify events and reset applied in
    between): the loss to 1e-5 relative, `active` and `count` exact, each
    group within STEP_BAR."""
    from sags_tpu_torch.slam.pipeline import camera_for

    _, _, _, _, steps = trained
    tcfg = _cfg(tconf, **SCHEDULE)
    tcams = [camera_for(tcfg, f, np.asarray(f.pose), "cpu") for f in frames]
    imgs = [np.asarray(f.image, np.float32) for f in frames]
    order = np.random.default_rng(0)  # `_optimize`'s view order, seed 0
    worst = dict.fromkeys(RUN_BAR, 0.0)
    for it, (s_in, s, jl) in enumerate(steps, start=1):
        i = order.integers(len(frames))
        ts = interop.offline_state_from_numpy(jax_offline_to_numpy(s_in), "cpu")
        ts, tl = toff.train_step(ts, tcams[i], T(imgs[i]), tcfg)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), it
        for f in ("active", "count"):
            np.testing.assert_array_equal(getattr(ts.map, f).numpy(),
                                          np.asarray(getattr(s.map, f)), err_msg=f)
        for f, e in _max_err(ts.map, s.map).items():
            worst[f] = max(worst[f], e)
    assert all(worst[f] <= STEP_BAR[f] for f in worst), worst
