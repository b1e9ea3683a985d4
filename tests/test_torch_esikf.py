"""Port parity of the ESIKF tracker (`sags_tpu_torch.ops.esikf` against
`sags_tpu.ops.esikf`), of `SyntheticDataset`'s IMU samples, and of
`SLAMPipeline.run` under tracking "esikf" (with the IMU and the velocity
bootstrap, without the bootstrap, and LiDAR-inertial-visual under
`lidar_axes` with LiDAR-frame data), on the scenes of `tests/test_esikf.py`.
Each test states its bars."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core.transforms import LIDAR_TO_CAM
from sags_tpu.core.transforms import so3_exp as jax_so3_exp
from sags_tpu.io.datasets import SyntheticDataset as JaxSynthetic
from sags_tpu.ops import esikf as je
from sags_tpu.ops import gicp as jg
from sags_tpu_torch import interop
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.ops import esikf as te
from sags_tpu_torch.ops import gicp as tg
from sags_tpu_torch.utils.traj import ate_rmse
from test_esikf import make_room
from test_torch_pipeline_modules import (POINTS, assert_runs_match, run_both,  # noqa: F401
                                         shared_jax_steps)

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

T = lambda a: torch.from_numpy(np.array(a))


def to_port(state) -> te.ESIKFState:
    return interop.esikf_state_from_numpy(
        {f: np.asarray(getattr(state, f)) for f in te.ESIKFState._fields}, "cpu")


def voxel_map_to_port(vm) -> tg.VoxelMap:
    return tg.VoxelMap(**{f: (vm.resolution if f == "resolution" else T(getattr(vm, f)))
                          for f in tg.VoxelMap._fields})._replace(
        num_points=T(vm.num_points).to(torch.float32))


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def assert_states_match(got: te.ESIKFState, want, atol=1e-5, p_rtol=1e-4):
    for f in ("R", "p", "v", "bg", "ba", "g"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=atol, err_msg=f)
    assert rel(got.P.numpy(), want.P) <= p_rtol, rel(got.P.numpy(), want.P)


def test_propagate_matches_jax():
    """Five IMU samples of a moving, rotating body. Bars: R, p, v to 1e-5
    absolute; P to 1e-5 relative."""
    rng = np.random.default_rng(1)
    s = je.init_state()._replace(v=jnp.asarray([0.3, -0.1, 0.8]),
                                 bg=jnp.asarray([1e-3, -2e-3, 5e-4]))
    gyro = rng.normal(0, 0.3, (5, 3)).astype(np.float32)
    accel = (rng.normal(0, 0.5, (5, 3)) + [0, 0, 9.81]).astype(np.float32)
    dts = np.full(5, 0.02, np.float32)
    want = je.propagate(s, jnp.asarray(gyro), jnp.asarray(accel), jnp.asarray(dts))
    got = te.propagate(to_port(s), T(gyro), T(accel), T(dts))
    assert_states_match(got, want, p_rtol=1e-5)


def room_scene():
    """`test_esikf.py::test_scan_update_recovers_pose`: a room's voxel map and
    a scan seen from a small offset, the prior at the identity."""
    world = make_room(np.random.default_rng(0))
    mask = jnp.ones(len(world), bool)
    covs = jg.estimate_covariances(jnp.asarray(world), mask, k=10, knn_max_distance=0.5,
                                   regularization="none").covs
    vm = jg.build_voxel_map(jnp.asarray(world), covs, mask, 0.5, 4096)
    R_true = np.asarray(jax_so3_exp(jnp.asarray([0.01, -0.02, 0.03], jnp.float32)))
    t_true = np.array([0.05, 0.08, -0.06], np.float32)
    scan = make_room(np.random.default_rng(11), 2000)
    pts_body = ((scan - t_true) @ R_true).astype(np.float32)
    s = je.init_state()
    s = s._replace(P=s.P.at[:6, :6].set(np.eye(6) * 0.05))
    return s, pts_body, np.ones(len(pts_body), bool), vm, {"meas_noise": 0.05}


def floor_walls_scene():
    """`test_esikf.py::test_scan_update_corrects_full_state`: a floor and two
    walls, v cross-coupled with p in the prior."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
    pts[:, 2] = 0.05 * rng.standard_normal(512)
    pts[:170, 0] = 2.0 + 0.05 * rng.standard_normal(170)
    pts[:170, 2] = rng.uniform(0, 2, 170)
    pts[170:340, 1] = -2.0 + 0.05 * rng.standard_normal(170)
    pts[170:340, 2] = rng.uniform(0, 2, 170)
    mask = np.ones(512, bool)
    covs = jg.estimate_covariances(jnp.asarray(pts), jnp.asarray(mask), k=10,
                                   knn_max_distance=4.0, regularization="none").covs
    vm = jg.build_voxel_map(jnp.asarray(pts), covs, jnp.asarray(mask), 0.5, 2048)
    st = je.init_state()
    P = np.array(st.P)
    P[3:6, 3:6] = np.eye(3) * 1e-2
    P[6:9, 6:9] = np.eye(3) * 1e-1
    P[3:6, 6:9] = P[6:9, 3:6] = np.eye(3) * 2e-2
    st = st._replace(P=jnp.asarray(P), v=jnp.asarray([0.5, -0.3, 0.2]))
    scan = pts - np.array([0.15, -0.1, 0.05], np.float32)
    return st, scan, mask, vm, {"min_planarity": 0.1}


@pytest.mark.parametrize("num_iters", [4, 10])
@pytest.mark.parametrize("scene", [room_scene, floor_walls_scene])
def test_scan_update_matches_jax(scene, num_iters):
    """Bars: R, p (and v, bg, ba, g) to 1e-5 absolute, P to 1e-4 relative,
    `n_matched` exact, `mean_residual` to 1e-5."""
    s, pts, mask, vm, kw = scene()
    want = je.scan_update(s, jnp.asarray(pts), jnp.asarray(mask), vm, num_iters=num_iters,
                          **kw)
    got = te.scan_update(to_port(s), T(pts), T(mask), voxel_map_to_port(vm),
                         num_iters=num_iters, **kw)
    assert_states_match(got.state, want.state)
    assert int(got.n_matched) == int(want.n_matched) > 100
    assert abs(float(got.mean_residual) - float(want.mean_residual)) <= 1e-5


def photo_scene():
    """`test_esikf.py`'s photometric scene: a smooth textured image, 400
    anchors at 2-4 m whose intensities are the image at their true
    projections, the state 4 cm off."""
    rng = np.random.default_rng(0)
    W, H = 160, 120
    u = np.arange(W)[None, :] / W
    v = np.arange(H)[:, None] / H
    gray = (0.5 + 0.3 * np.sin(6.28 * 2 * u) * np.cos(6.28 * 1.5 * v)
            + 0.2 * u * v).astype(np.float32)
    image = np.repeat(gray[None], 3, axis=0)
    M = 400
    pts_c = np.stack([rng.uniform(-0.8, 0.8, M), rng.uniform(-0.6, 0.6, M),
                      rng.uniform(2.0, 4.0, M)], 1).astype(np.float32)
    uu = 120.0 * pts_c[:, 0] / pts_c[:, 2] + W / 2.0
    vv = 120.0 * pts_c[:, 1] / pts_c[:, 2] + H / 2.0
    inb = (uu > 2) & (uu < W - 3) & (vv > 2) & (vv < H - 3)
    intens = gray[np.clip(vv.astype(int), 0, H - 1), np.clip(uu.astype(int), 0, W - 1)]
    st = je.init_state(P0_pos=1e-2, P0_rot=1e-3)
    st = st._replace(p=jnp.asarray([0.03, -0.02, 0.01], jnp.float32))
    return st, pts_c, intens.astype(np.float32), inb, image


@pytest.mark.parametrize("extrinsic", [False, True])
def test_photo_update_matches_jax(extrinsic):
    """Body == camera, and the LiDAR body with the camera rotated by
    LIDAR_TO_CAM and offset (`R_ext`, `t_ext`). Bars: as `scan_update`'s,
    `n_used` exact."""
    st, pts_c, intens, inb, image = photo_scene()
    kw = dict(num_iters=4, meas_noise=0.05)
    pts, jkw, tkw = pts_c, {}, {}
    if extrinsic:
        t_ext = np.array([0.02, -0.01, 0.03], np.float32)
        pts = (pts_c @ LIDAR_TO_CAM.T + t_ext).astype(np.float32)
        jkw = dict(R_ext=jnp.asarray(LIDAR_TO_CAM), t_ext=jnp.asarray(t_ext))
        tkw = dict(R_ext=T(LIDAR_TO_CAM), t_ext=T(t_ext))
    want = je.photo_update(st, jnp.asarray(pts), jnp.asarray(intens), jnp.asarray(inb),
                           jnp.asarray(image), 120.0, 120.0, 80.0, 60.0, **kw, **jkw)
    got = te.photo_update(to_port(st), T(pts), T(intens), T(inb), T(image),
                          120.0, 120.0, 80.0, 60.0, **kw, **tkw)
    assert_states_match(got.state, want.state)
    assert int(got.n_used) == int(want.n_used) > 100
    assert abs(float(got.mean_residual) - float(want.mean_residual)) <= 1e-5


def surfel_folds(mod, pts_list, capacity, world_extent, intensities):
    to = jnp.asarray if mod is je else T
    kw = {} if mod is je else {"device": "cpu"}
    sm = mod.surfel_map_init(resolution=0.5, capacity=capacity, world_extent=world_extent,
                             **kw)
    for pts, it in zip(pts_list, intensities):
        sm = mod.surfel_map_update(sm, to(pts), to(np.ones(len(pts), bool)),
                                   intensity=None if it is None else to(it))
    return sm


def assert_surfels_match(got: te.SurfelMap, want):
    for f in ("keys", "n", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in ("sum_p", "sum_pp", "sum_i"):
        w = np.asarray(getattr(want, f))
        if np.abs(w).max() > 0:
            assert rel(getattr(got, f).numpy(), w) <= 1e-5, f


@pytest.mark.parametrize("case", ["two_folds", "drops", "capacity"])
def test_surfel_map_update_matches_jax(case):
    """Two incremental folds (one with intensities), a fold with points
    outside the grid, and a fold past capacity, against the JAX package's;
    and the incremental folds against one batch fold of the same points.
    Bars: keys, n and overflow exact; moments to 1e-5 relative."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-4, 4, (256, 3)).astype(np.float32)
    b = rng.uniform(-4, 4, (256, 3)).astype(np.float32)
    capacity, extent = 1024, 128.0
    if case == "drops":
        b[:20] *= 40.0  # beyond the ±4 m grid
        extent = 8.0
    if case == "capacity":
        capacity = 64
    its = [rng.uniform(0, 1, 256).astype(np.float32), None]
    got = surfel_folds(te, [a, b], capacity, extent, its)
    assert_surfels_match(got, surfel_folds(je, [a, b], capacity, extent, its))
    batch = surfel_folds(te, [np.concatenate([a, b])], capacity, extent,
                         [np.concatenate([its[0], np.zeros(256, np.float32)])])
    assert_surfels_match(batch, surfel_folds(je, [np.concatenate([a, b])], capacity, extent,
                                             [np.concatenate([its[0], np.zeros(256, np.float32)])]))
    if case == "two_folds":
        np.testing.assert_array_equal(got.keys.numpy(), batch.keys.numpy())
        np.testing.assert_allclose(got.sum_p.numpy(), batch.sum_p.numpy(), atol=1e-5)
        # the second fold from the JAX package's map after the first
        first = surfel_folds(je, [a], capacity, extent, its[:1])
        start = interop.surfel_map_from_numpy(
            {f: (first.resolution if f == "resolution" else np.asarray(getattr(first, f)))
             for f in te.SurfelMap._fields}, "cpu")
        carried = te.surfel_map_update(start, T(b), T(np.ones(256, bool)))
        assert_surfels_match(carried, surfel_folds(je, [a, b], capacity, extent, its))
    if case == "drops":
        assert int(got.overflow) >= 20
    if case == "capacity":
        assert int(got.overflow) > 0


def test_surfel_map_voxels_and_anchors_match_jax():
    """The voxel view and the photometric anchors of a map folded from a
    plane 60 m out and a random cloud (`test_esikf.py`'s far-plane case).
    Bars: 1e-5 absolute on means, covariances and intensities; counts and
    validity exact."""
    rng = np.random.default_rng(3)
    base = np.array([60.0, 58.0, 2.0], np.float32)
    plane = base + np.stack([rng.uniform(-0.14, 0.14, 2000), rng.uniform(-0.14, 0.14, 2000),
                             rng.normal(0, 1e-3, 2000)], axis=1).astype(np.float32)
    cloud = rng.uniform(-4, 4, (512, 3)).astype(np.float32)
    its = [rng.uniform(0, 1, 2000).astype(np.float32), rng.uniform(0, 1, 512).astype(np.float32)]
    args = ([plane, cloud], 256, 128.0, its)
    sm_t, sm_j = surfel_folds(te, *args), surfel_folds(je, *args)
    vt, vj = te.surfel_map_voxels(sm_t), je.surfel_map_voxels(sm_j)
    np.testing.assert_array_equal(vt.keys.numpy(), np.asarray(vj.keys))
    np.testing.assert_array_equal(vt.num_points.numpy(), np.asarray(vj.num_points))
    assert int(vt.n_voxels) == int(vj.n_voxels)
    np.testing.assert_array_equal(vt.mins.numpy(), np.asarray(vj.mins))
    np.testing.assert_allclose(vt.means.numpy(), np.asarray(vj.means), atol=1e-5)
    np.testing.assert_allclose(vt.covs.numpy(), np.asarray(vj.covs), atol=1e-5)
    for g, w in zip(te.surfel_map_anchors(sm_t), je.surfel_map_anchors(sm_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("kw", [dict(resolution=0.05, world_extent=256.0),
                                dict(resolution=0.3, world_extent=128.0)])
def test_surfel_map_init_raises_where_jax_does(kw):
    try:
        je.surfel_map_init(**kw)
        jax_raised = False
    except ValueError:
        jax_raised = True
    if jax_raised:
        with pytest.raises(ValueError):
            te.surfel_map_init(**kw, device="cpu")
    else:
        sm = te.surfel_map_init(**kw, device="cpu")
        np.testing.assert_array_equal(sm.dims.numpy(), np.asarray(je.surfel_map_init(**kw).dims))


def test_entry_points_raise_without_a_gpu():
    """`init_state` and `surfel_map_init` run on the card unless given a
    device: without one they raise, as `resolve_device` does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        te.init_state()
    with pytest.raises(RuntimeError, match="CUDA"):
        te.surfel_map_init()
    assert te.init_state(device="cpu").P.device.type == "cpu"
    assert te.surfel_map_init(device="cpu").keys.device.type == "cpu"


def test_synthetic_imu_matches_jax():
    """`SyntheticDataset(imu_substeps=5)`: the IMU samples to 1e-6 of the JAX
    package's, and every other field of each frame bitwise what the port's
    dataset without IMU gives (the samples draw nothing from its stream)."""
    kw = dict(n_frames=3, width=32, height=24, n_world=1024, pts_per_frame=128, step=0.25,
              clutter=0.3, seed=1)
    jax_frames = list(JaxSynthetic(imu_substeps=5, **kw))
    with_imu = list(SyntheticDataset(imu_substeps=5, device="cpu", **kw))
    without = list(SyntheticDataset(device="cpu", **kw))
    assert with_imu[0].imu is None and without[1].imu is None
    for got, want, plain in zip(with_imu[1:], jax_frames[1:], without[1:]):
        assert got.imu.shape == (5, 7)
        np.testing.assert_allclose(got.imu, want.imu, atol=1e-6)
    for got, plain in zip(with_imu, without):
        for f in ("image", "points", "colors", "pose", "depth", "scan"):
            np.testing.assert_array_equal(getattr(got, f), getattr(plain, f), err_msg=f)
        assert got.timestamp == plain.timestamp


@pytest.fixture(scope="module")
def esikf_frames():
    kw = dict(n_frames=6, width=64, height=48, n_world=4096, pts_per_frame=POINTS,
              step=0.12, clutter=0.35, imu_substeps=5)
    return {"body": list(JaxSynthetic(**kw)),
            "lidar": list(JaxSynthetic(lidar_frame=True, **kw))}


@pytest.mark.parametrize("variant", ["imu_bootstrap", "no_bootstrap", "visual_lidar_axes"])
def test_esikf_pipeline_matches_jax(esikf_frames, shared_jax_steps, variant):
    """`SLAMPipeline.run` under "esikf" for 6 frames against the JAX
    package's. Bars: poses 2e-3 (m, rad) a frame, losses 1e-3 relative, the
    ATE within 1% of the JAX package's; counts equal.

    Why not `test_torch_pipeline_modules.py`'s 1e-4: once the surfel map
    holds voxels of three or more nearly coincident points (covariances of
    1e-6 and below, the 1e-6 regularizer's size), `sym_eig3` gives them a
    normal that follows rounding, and `scan_update` can pick such a plane.
    The JAX package's own jitted and eager evaluations of one update on the
    same inputs then differ by 2e-4 m; the port agrees with the eager one to
    2e-8 and moves by 1e-8 under one-ulp changes of the scan. Measured here:
    poses within 1e-7 to 3e-5 over the first four frames and up to 7.1e-4
    by the sixth, losses within 2.2e-4, ATEs within 0.2%."""
    if variant == "visual_lidar_axes":
        jr, tr, _ = run_both(esikf_frames["lidar"], "esikf", lidar_axes=True,
                             esikf_visual=True)
    else:
        jr, tr, _ = run_both(esikf_frames["body"], "esikf",
                             esikf_bootstrap=variant == "imu_bootstrap")
    assert_runs_match(jr, tr, pose_atol=2e-3, loss_rtol=1e-3)
    ate_t, _ = ate_rmse(tr.poses_est, tr.poses_gt, align=False)
    ate_j, _ = ate_rmse(jr.poses_est, jr.poses_gt, align=False)
    assert abs(ate_t - ate_j) <= 0.01 * ate_j, (ate_t, ate_j)
