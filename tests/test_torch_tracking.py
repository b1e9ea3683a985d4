"""Port parity: the registration library and the other tracking modes of
`sags_tpu_torch` against `sags_tpu` on the CPU: the voxel map, VGICP, the
single-thread GICP, NDT, the pygicp class API, `FusedFrontend` under
"vgicp" and anchored "gicp_map", and `SLAMPipeline.run` under "gicp_map".

Poses are held to 1e-5 (the bar of `test_torch_step.py`'s GICP case) with
equal iteration counts and convergence flags; integer outputs exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core import config as jax_config
from sags_tpu.core.config import GICPConfig
from sags_tpu.ops import gicp as jg
from sags_tpu.ops import ndt as jn
from sags_tpu.ops import registration as jr
from sags_tpu.slam import fused as jax_fused
from sags_tpu.slam import step as jax_step
from sags_tpu_torch import interop
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.ops import gicp as tg
from sags_tpu_torch.ops import ndt as tn
from sags_tpu_torch.ops import registration as tr
from sags_tpu_torch.slam import fused as t_fused
from tests.test_gicp import CFG, clouds, errors  # noqa: F401 (fixture reuse)
from tests.test_torch_step import H, W, _scan, configs, jax_state_to_numpy

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

POSE_ATOL = 1e-5
# VGICP over several neighbour offsets (DIRECT7, DIRECT_RADIUS): each point
# also meets the voxels beside its own, whose residuals are large and cancel
# in b. The packages round the transformed points differently (XLA's dot
# against torch's mm: one ulp of a 4 m coordinate on millimetre residuals),
# and a float64 evaluation of b at the true pose sits as far from either
# package's as they sit from each other. Measured after the same iteration
# counts: 4.0e-5 (DIRECT7), 4.6e-5 (DIRECT_RADIUS 1.5).
NEIGHBOR_POSE_ATOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _tcfg(jcfg: GICPConfig) -> tconf.GICPConfig:
    return tconf.GICPConfig(**dataclasses.asdict(jcfg))


def _assert_same_align(rt, rj, atol=POSE_ATOL):
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=atol)


def _assert_rel(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def target_covs(clouds):  # noqa: F811
    _, target, _, mask = clouds
    return np.asarray(jg.estimate_covariances(jnp.asarray(target), jnp.asarray(mask), 10, 0.5,
                                              "normalized_ellipse").covs)


# -- small functions ---------------------------------------------------------


@pytest.mark.parametrize("method,radius", [("direct1", 1.5), ("direct7", 1.5),
                                           ("direct27", 1.5), ("direct_radius", 1.5),
                                           ("direct_radius", 2.2)])
def test_neighbor_offsets_match_jax(method, radius):
    assert tg.neighbor_offsets(method, radius) == jg.neighbor_offsets(method, radius)


def test_covariances_from_qs_match_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = rng.uniform(0.01, 0.5, (64, 3)).astype(np.float32)
    want = np.asarray(jg.covariances_from_qs(jnp.asarray(q), jnp.asarray(s)))
    np.testing.assert_allclose(tg.covariances_from_qs(_t(q), _t(s)).numpy(), want, atol=1e-7)


@pytest.mark.parametrize("kw", [dict(z_values=True), dict(regularization="frobenius")])
def test_estimate_covariances_options_match_jax(kw):
    """The options the registration classes reach: the withz scale division
    and FROBENIUS regularization."""
    rng = np.random.default_rng(1)
    pts = _scan(rng, 200)
    mask = np.ones(len(pts), bool)
    mask[-20:] = False
    z = rng.uniform(0.5, 3.0, len(pts)).astype(np.float32)
    reg = kw.get("regularization", "normalized_ellipse")
    zj, zt = (jnp.asarray(z), _t(z)) if kw.get("z_values") else (None, None)
    pj = jg.estimate_covariances(jnp.asarray(pts), jnp.asarray(mask), 10, 0.5, reg, z_values=zj)
    pt = tg.estimate_covariances(_t(pts), _t(mask), 10, 0.5, reg, z_values=zt)
    np.testing.assert_allclose(pt.covs.numpy(), np.asarray(pj.covs), atol=1e-4)
    np.testing.assert_allclose(pt.scales.numpy(), np.asarray(pj.scales), atol=1e-4)


def test_correspondence_dump_matches_jax(clouds):  # noqa: F811
    source, target, T_gt, mask = clouds
    smask = mask.copy()
    smask[::7] = False
    T = T_gt.astype(np.float32)
    T[:3, 3] += 0.05  # off the true pose: some matches beyond the 5 cm gate
    for thr in (float("inf"), 0.05):
        ij, sj = jg.correspondence_dump(jnp.asarray(T), jnp.asarray(source),
                                        jnp.asarray(target), jnp.asarray(smask),
                                        jnp.asarray(mask), corr_dist_threshold=thr)
        it, st = tg.correspondence_dump(_t(T), _t(source), _t(target), _t(smask), _t(mask),
                                        corr_dist_threshold=thr)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        # both kNNs take ‖a‖² + ‖b‖² − 2a·b in float32 at ‖a‖² up to ~30 m²,
        # whose rounding (torch's mm against XLA's dot) is ~1e-5: measured
        # 1.5e-5 at most
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-5)
        assert (it.numpy() == -1).any()


# -- the Gaussian voxel map ----------------------------------------------------


@pytest.mark.parametrize("mode", ["additive", "additive_weighted", "multiplicative"])
@pytest.mark.parametrize("max_voxels", [1024, 40])
def test_build_voxel_map_matches_jax(clouds, target_covs, mode, max_voxels):  # noqa: F811
    """Keys, counts, n_voxels and overflow exact; means and covariances to
    1e-5 relative. 40 voxels is below the map's voxel count (overflow > 0);
    a masked-out tenth of the points must not count."""
    _, target, _, mask = clouds
    mask = mask.copy()
    mask[::10] = False
    vj = jg.build_voxel_map(jnp.asarray(target), jnp.asarray(target_covs), jnp.asarray(mask),
                            0.5, max_voxels, mode=mode)
    vt = tg.build_voxel_map(_t(target), _t(target_covs), _t(mask), 0.5, max_voxels, mode=mode)
    np.testing.assert_array_equal(vt.keys.numpy(), np.asarray(vj.keys))
    np.testing.assert_array_equal(vt.num_points.numpy(), np.asarray(vj.num_points))
    assert int(vt.n_voxels) == int(vj.n_voxels)
    assert int(vt.overflow) == int(vj.overflow)
    assert (int(vt.overflow) > 0) == (max_voxels == 40)
    np.testing.assert_array_equal(vt.mins.numpy(), np.asarray(vj.mins))
    np.testing.assert_array_equal(vt.dims.numpy(), np.asarray(vj.dims))
    _assert_rel(vt.means.numpy(), vj.means)
    _assert_rel(vt.covs.numpy(), vj.covs)


def test_lookup_voxels_matches_jax(clouds, target_covs):  # noqa: F811
    """Every voxel's coordinates and their 27-neighbourhoods, plus
    coordinates outside the grid: indices and found flags exact."""
    _, target, _, mask = clouds
    vj = jg.build_voxel_map(jnp.asarray(target), jnp.asarray(target_covs), jnp.asarray(mask),
                            0.5, 1024)
    vt = tg.build_voxel_map(_t(target), _t(target_covs), _t(mask), 0.5, 1024)
    base = np.floor(target / 0.5).astype(np.int32)
    offs = np.asarray(jg.neighbor_offsets("direct27"), np.int32)
    coords = (base[::4, None] + offs[None]).reshape(-1, 3)
    coords = np.concatenate([coords, np.array([[100, 0, 0], [-50, -50, -50]], np.int32)])
    ij, fj = jg.lookup_voxels(vj, jnp.asarray(coords))
    it, ft = tg.lookup_voxels(vt, _t(coords))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ft.numpy().any() and not ft.numpy().all()


def test_voxel_downsample_matches_jax(rng):
    pts = rng.uniform(0, 4, (1000, 3)).astype(np.float32)
    mask = np.ones(1000, bool)
    mask[:50] = False
    oj, mj = jg.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.7, 256)
    ot, mt = tg.voxel_downsample(_t(pts), _t(mask), 0.7, 256)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _assert_rel(ot.numpy(), oj)


# -- aligns -------------------------------------------------------------------


def _align_pair(fj, ft, clouds, cfg, **kw):  # noqa: F811
    source, target, _, mask = clouds
    rj = fj(jnp.asarray(source), jnp.asarray(target), jnp.asarray(mask), jnp.asarray(mask),
            jnp.eye(4), cfg, **kw)
    rt = ft(_t(source), _t(target), _t(mask), _t(mask), torch.eye(4), _tcfg(cfg), **kw)
    return rj, rt


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_gicp_align_st_matches_jax(clouds, optimizer):  # noqa: F811
    """The carried correspondence state through both optimizer branches."""
    cfg = dataclasses.replace(CFG, optimizer=optimizer)
    rj, rt = _align_pair(jg.gicp_align_st, tg.gicp_align_st, clouds, cfg)
    _assert_same_align(rt, rj)


def test_lsq_align_updates_the_carry_at_each_linearization():
    """The carry advances once per outer iteration, accepted or not."""
    seen = []

    def linearize(T, carry):
        seen.append(carry)
        H = torch.eye(6)
        return H, torch.zeros(6), torch.tensor(1.0), None, carry + 1

    cfg = tconf.GICPConfig(max_iterations=3)
    res = tg.lsq_align(linearize, lambda T, corr: torch.tensor(1.0), torch.eye(4), cfg,
                       carry_init=0)
    assert seen == list(range(res.iterations))


def test_align_without_correspondences_keeps_the_guess(clouds):  # noqa: F811
    """No valid target point: H = 0 and every LM step is non-finite; both
    packages reject every trial and return the initial guess, unconverged
    (the port does not raise on the singular system)."""
    source, target, _, mask = clouds
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.1, -0.2, 0.05]
    none = np.zeros_like(mask)
    rj = jg.gicp_align(jnp.asarray(source), jnp.asarray(target), jnp.asarray(mask),
                       jnp.asarray(none), jnp.asarray(T0), CFG)
    rt = tg.gicp_align(_t(source), _t(target), _t(mask), _t(none), _t(T0), _tcfg(CFG))
    _assert_same_align(rt, rj)
    np.testing.assert_array_equal(rt.T.numpy(), T0)
    assert not rt.converged


@pytest.mark.parametrize("kw,atol", [
    (dict(), POSE_ATOL),
    (dict(neighbor_search="direct7"), NEIGHBOR_POSE_ATOL),
    (dict(voxel_accumulation="multiplicative"), POSE_ATOL),
])
def test_vgicp_align_matches_jax(clouds, kw, atol):  # noqa: F811
    rj, rt = _align_pair(jg.vgicp_align, tg.vgicp_align, clouds,
                         dataclasses.replace(CFG, **kw))
    _assert_same_align(rt, rj, atol)
    te, re = errors(rt.T.numpy(), clouds[2])
    assert te < 0.05 and re < 1.0, (te, re)


@pytest.mark.parametrize("mode,res", [("p2d", 0.5), ("d2d", 1.0)])
def test_ndt_align_matches_jax(clouds, mode, res):  # noqa: F811
    cfg = dataclasses.replace(GICPConfig(), voxel_resolution=res, neighbor_search="direct7",
                              max_voxels=4096)
    rj, rt = _align_pair(jn.ndt_align, tn.ndt_align, clouds, cfg, mode=mode)
    _assert_same_align(rt, rj)
    with pytest.raises(ValueError):
        _align_pair(jn.ndt_align, tn.ndt_align, clouds, cfg, mode="p2p")


def test_ndt_voxel_map_matches_jax(clouds):  # noqa: F811
    _, target, _, mask = clouds
    vj = jn.build_ndt_voxel_map(jnp.asarray(target), jnp.asarray(mask), 1.0, 512)
    vt = tn.build_ndt_voxel_map(_t(target), _t(mask), 1.0, 512)
    np.testing.assert_array_equal(vt.num_points.numpy(), np.asarray(vj.num_points))
    _assert_rel(vt.means.numpy(), vj.means)
    _assert_rel(vt.covs.numpy(), vj.covs, 1e-4)  # scatter E[ppᵀ] − μμᵀ cancels


# -- the pygicp class API -------------------------------------------------------


def _both(cls_j, cls_t, cfg, **kw):
    return cls_j(cfg, **kw), cls_t(_tcfg(cfg), device="cpu", **kw)


def test_fast_gicp_class_matches_jax(clouds):  # noqa: F811
    """Covariances and their q/s export, withz, fromqs, filters, swap, the
    correspondence getter and the final Hessian, method by method."""
    source, target, T_gt, _ = clouds
    j, t = _both(jr.FastGICP, tr.FastGICP, CFG)
    for reg in (j, t):
        reg.set_num_threads(4).set_correspondence_randomness(10).set_max_knn_distance(0.5)
        reg.set_max_correspondence_distance(1.0)
        reg.set_input_target(target)
        reg.set_input_source(source)
    cj, ct = j.calculate_source_covariance(), t.calculate_source_covariance()
    np.testing.assert_allclose(ct.covs.numpy(), np.asarray(cj.covs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.get_target_scales(), j.get_target_scales(), atol=1e-4)
    qj, qt = j.get_source_rotationsq().reshape(-1, 4), t.get_source_rotationsq().reshape(-1, 4)
    assert np.quantile(np.abs(np.sum(qj * qt, -1)), 0.99) > 1 - 1e-4
    z = np.linalg.norm(source, axis=-1)
    j.calculate_source_covariance_withz(z)
    t.calculate_source_covariance_withz(z)
    np.testing.assert_allclose(t.get_source_scales(), j.get_source_scales(), atol=1e-4)
    np.testing.assert_allclose(t.align(), j.align(), atol=POSE_ATOL)
    assert t.has_converged() == j.has_converged()
    te, re = errors(t.get_final_transformation(), T_gt)
    assert te < 0.05 and re < 1.0
    Hj = j.get_final_hessian()
    np.testing.assert_allclose(t.get_final_hessian(), Hj, atol=1e-4 * np.abs(Hj).max())
    (ij, sj), (it, st) = j.get_source_correspondence(), t.get_source_correspondence()
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(st, sj, atol=2e-5)  # the kNN's rounding, as above

    # covariances imported from (q, s): the source's own export
    qs = (j.get_target_rotationsq(), j.get_target_scales())
    j.set_target_covariance_fromqs(*qs)
    t.set_target_covariance_fromqs(*qs)
    keep = np.arange(int(len(source) * 0.75))
    j.set_source_filter(len(keep), keep)
    t.set_source_filter(len(keep), keep)
    np.testing.assert_allclose(t.align(), j.align(), atol=POSE_ATOL)
    j.swap_source_and_target()
    t.swap_source_and_target()
    np.testing.assert_allclose(t.align(), j.align(), atol=POSE_ATOL)
    te, re = errors(t.get_final_transformation(), np.linalg.inv(T_gt))
    assert te < 0.05 and re < 1.0


def test_fast_vgicp_and_aliases_match_jax(clouds):  # noqa: F811
    source, target, T_gt, _ = clouds
    j, t = _both(jr.FastVGICP, tr.FastVGICP, CFG)
    for reg in (j, t):
        reg.set_resolution(0.5).set_neighbor_search_method("DIRECT_RADIUS", radius=1.5)
        reg.set_voxel_accumulation_mode("ADDITIVE_WEIGHTED")
        reg.set_input_target(target)
        reg.set_input_source(source)
    (mj, cj), (mt, ct) = j.get_voxel_mean_cov(), t.get_voxel_mean_cov()
    assert mt.shape == mj.shape and ct.shape == cj.shape
    _assert_rel(mt, mj)
    _assert_rel(ct, cj)
    np.testing.assert_allclose(t.align(), j.align(), atol=NEIGHBOR_POSE_ATOL)
    assert t.has_converged() == j.has_converged()
    for cls_j, cls_t in ((jr.FastGICPSingleThread, tr.FastGICPSingleThread),
                         (jr.FastVGICPCuda, tr.FastVGICPCuda)):
        j, t = _both(cls_j, cls_t, CFG)
        assert t.method == j.method
        for reg in (j, t):
            reg.set_input_target(target)
            reg.set_input_source(source)
        np.testing.assert_allclose(t.align(), j.align(), atol=POSE_ATOL)
        te, re = errors(t.get_final_transformation(), T_gt)
        assert te < 0.05 and re < 1.0


def test_ndt_class_matches_jax(clouds):  # noqa: F811
    source, target, T_gt, _ = clouds
    cfg = dataclasses.replace(GICPConfig(), max_voxels=4096)
    j, t = jr.NDTCuda(cfg, mode="d2d"), tr.NDTCuda(_tcfg(cfg), mode="d2d", device="cpu")
    for reg in (j, t):
        reg.set_resolution(0.5).set_distance_mode("P2D").set_neighbor_search_method("DIRECT7")
        reg.set_input_source(source)
        reg.set_input_target(target)
    np.testing.assert_allclose(t.align(), j.align(), atol=POSE_ATOL)
    assert t.has_converged() == j.has_converged()
    te, re = errors(t.align(np.eye(4)), T_gt)
    assert te < 0.10 and re < 1.5, (te, re)  # `tests/test_ndt.py`'s gate


@pytest.mark.parametrize("method,ds", [("GICP", -1.0), ("VGICP", 0.1), ("GICP_ST", -1.0),
                                       ("NDT_CUDA", -1.0)])
def test_align_points_and_downsample_match_jax(clouds, method, ds):  # noqa: F811
    source, target, _, _ = clouds
    kw = dict(method=method, downsample_resolution=ds, k_correspondences=10,
              voxel_resolution=0.5)
    np.testing.assert_allclose(tr.align_points(target, source, device="cpu", **kw),
                               jr.align_points(target, source, **kw), atol=POSE_ATOL)
    if ds > 0:
        _assert_rel(tr.downsample(source, ds, device="cpu"), jr.downsample(source, ds))


# -- the fused front-end ---------------------------------------------------------


def _track_add_setup(tracking, gicp_kw, map_points=None, prev_delta=None):
    """Both packages' `FusedFrontend`, a state carried over from one JAX
    state and a track state on a frame after the first. Returns (jax
    (frontend, state, track, args), port (frontend, state, track, args), T0)."""
    rng = np.random.default_rng(6)
    jcfg, tcfg = configs()
    jcfg = jcfg.replace(gicp=GICPConfig(**gicp_kw), tracking=jax_config.TrackingConfig(**tracking))
    tcfg = tcfg.replace(gicp=tconf.GICPConfig(**gicp_kw), tracking=tconf.TrackingConfig(**tracking))
    prev = _scan(rng, 160)
    ang = np.array([0.01, 0.02, -0.01], np.float32)
    Rt = np.asarray(jg.so3_exp(jnp.asarray(ang)))
    scan = ((prev - np.array([0.03, 0.01, -0.04], np.float32)) @ Rt).astype(np.float32)
    mask = np.ones(len(scan), bool)
    cols = rng.uniform(0.05, 1.0, (len(scan), 3)).astype(np.float32)
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.2, -0.1, 0.3]
    delta = np.eye(4, dtype=np.float32) if prev_delta is None else prev_delta

    s = jax_step.init_state(jcfg, jax.random.key(0))
    if map_points is not None:  # the map the scan-to-map align anchors against
        s, _ = jax_step.add_frame_points(s, jnp.asarray(map_points),
                                         jnp.asarray(np.full_like(map_points, 0.5)),
                                         jnp.ones(len(map_points), bool), jcfg)
    covs = jg.estimate_covariances(jnp.asarray(prev), jnp.asarray(mask), 10, 2.0,
                                   jcfg.gicp.regularization).covs
    jt = jax_fused.init_track_state(len(scan), 4)._replace(
        T=jnp.asarray(T0), prev_scan=jnp.asarray(prev), prev_mask=jnp.asarray(mask),
        prev_covs=covs, prev_delta=jnp.asarray(delta))
    args = (scan, mask, scan, cols, mask, np.eye(4, dtype=np.float32))
    p = interop.state_from_numpy(jax_state_to_numpy(s), "cpu")
    tt = t_fused.init_track_state(len(scan), 4, "cpu")._replace(
        T=_t(T0), prev_scan=_t(prev), prev_mask=_t(mask), prev_covs=_t(covs),
        prev_delta=_t(delta))
    return ((jax_fused.FusedFrontend(jcfg, H, W, sensor_frame=True), s, jt,
             tuple(map(jnp.asarray, args))),
            (t_fused.FusedFrontend(tcfg, H, W, sensor_frame=True), p, tt,
             tuple(map(_t, args))), T0)


def _track_add_pair(tracking, gicp_kw, anchored, map_points=None, prev_delta=None):
    """`FusedFrontend.track_add` of both packages on one frame. Returns
    (T_jax, T_port, T0)."""
    (fe_j, s, jt, jargs), (fe_t, p, tt, targs), T0 = _track_add_setup(
        tracking, gicp_kw, map_points, prev_delta)
    _, _, T_j, _ = fe_j.track_add(anchored, False, False)(s, jt, *jargs)
    _, _, T_t, _ = fe_t.track_add(p, tt, *targs, first=False, write_row=False,
                                  anchored=anchored)
    assert len(fe_t.lm_log) == 1
    return np.asarray(T_j), T_t.numpy(), T0


def test_track_add_vgicp_matches_jax():
    Tj, Tt, T0 = _track_add_pair(dict(backend="vgicp", max_points=480),
                                 dict(knn_max_distance=2.0, voxel_resolution=0.5), False)
    np.testing.assert_allclose(Tt, Tj, atol=POSE_ATOL)
    assert np.abs(Tt - T0).max() > 1e-3  # the scan moved


_T0_OFFSET = np.array([0.2, -0.1, 0.3], np.float32)
_ANCHORED_MAP = dict(
    map_points=(_scan(np.random.default_rng(6), 160) + _T0_OFFSET).astype(np.float32),
    prev_delta=np.array([[1, 0, 0, 0.01], [0, 1, 0, 0], [0, 0, 1, -0.01], [0, 0, 0, 1]],
                        np.float32))


def _ANCHORED_CASE(max_jump):
    return (dict(backend="gicp_map", max_points=480, max_jump=max_jump, map_corr_threshold=0.5),
            dict(knn_max_distance=2.0))


@pytest.mark.parametrize("max_jump", [0.5, 1e-6])
def test_track_add_anchored_gicp_map_matches_jax(max_jump):
    """Scan-to-map against the map's trackable Gaussians (the previous scan
    in the world), gated at `map_corr_threshold`, from the constant-velocity
    prediction T·prev_delta; with `max_jump` below any solve's move the
    prediction is kept (up to the port's projection onto SO(3))."""
    Tj, Tt, T0 = _track_add_pair(*_ANCHORED_CASE(max_jump), True, **_ANCHORED_MAP)
    np.testing.assert_allclose(Tt, Tj, atol=POSE_ATOL)
    pred = T0 @ _ANCHORED_MAP["prev_delta"]
    if max_jump < 1e-3:
        np.testing.assert_allclose(Tt, pred, atol=1e-6)
    else:
        assert np.abs(Tt - pred).max() > 1e-3  # the solve moved off the prediction


def test_anchored_chain_keeps_the_pose_rigid():
    """Ten anchored frames on one scan and map, each frame's (T, delta) fed
    to the next. The JAX package's warm start T·(Tᵀ-inverse(T_prev)·T)
    feeds back the rounding of RRᵀ = I, which grows ~2.4× a frame (over 24
    frames it reaches 5e-2 by frame 16 and the solves then fail,
    `tools/gicp_map_drift.py`); the port projects each anchored pose onto
    SO(3), so it stays at float32 rounding and its pose at the first
    frame's."""
    (fe_j, s, jt, jargs), (fe_t, p, tt, targs), _ = _track_add_setup(
        *_ANCHORED_CASE(0.5), **_ANCHORED_MAP)
    fn = fe_j.track_add(True, False, False)
    ortho = lambda T: float(np.abs(T[:3, :3] @ T[:3, :3].T - np.eye(3)).max())
    err_j, err_t, poses = [], [], []
    for _ in range(10):
        _, jt, T_j, _ = fn(s, jt, *jargs)
        _, tt, T_t, _ = fe_t.track_add(p, tt, *targs, first=False, write_row=False,
                                       anchored=True)
        err_j.append(ortho(np.asarray(T_j, np.float64)))
        err_t.append(ortho(T_t.numpy().astype(np.float64)))
        poses.append(T_t.numpy())
    np.testing.assert_allclose(np.stack(poses), np.broadcast_to(poses[0], (10, 4, 4)),
                               atol=POSE_ATOL)
    assert max(err_t) < 1e-6, err_t
    assert err_j[-1] > 100 * max(err_j[:2]) and err_j[-1] > 1e-5, err_j


def test_frontend_modes_and_esikf():
    assert t_fused.FusedFrontend.MODES == jax_fused.FusedFrontend.MODES
    _, tcfg = configs()
    cfg = tcfg.replace(tracking=tconf.TrackingConfig(backend="esikf"))
    with pytest.raises(NotImplementedError, match="esikf"):
        t_fused.FusedFrontend(cfg, H, W, sensor_frame=True)


# -- the pipeline ----------------------------------------------------------------


def test_pipeline_gicp_map_matches_jax():
    """`SLAMPipeline.run` under "gicp_map" on `test_torch_pipeline.py`'s
    harness, `anchor_min_points` midway between the trackable counts after
    the second frame (663) and the third (1175): both packages anchor after
    the third frame, on the same host probe, then track three frames
    scan-to-map."""
    from sags_tpu.io.datasets import SyntheticDataset as JaxSynthetic
    from sags_tpu.slam.pipeline import SLAMPipeline as JaxPipeline
    from sags_tpu_torch.io.datasets import Frame as TorchFrame
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.draws import ReplayDraws
    from sags_tpu_torch.utils.traj import ate_rmse
    from tests.test_torch_pipeline import N_FRAMES, _cfg, _jax_draws
    from tests.test_torch_pipeline import H as PH
    from tests.test_torch_pipeline import W as PW

    frames = list(JaxSynthetic(n_frames=N_FRAMES, width=PW, height=PH, n_world=4096,
                               pts_per_frame=512, step=0.1, clutter=0.3))

    def cfg(mod):
        c = _cfg(mod)
        return c.replace(tracking=dataclasses.replace(c.tracking, backend="gicp_map",
                                                      anchor_min_points=920))

    def recording(base):
        class Recording(base):
            def _frame_fused(self, *a, **k):
                T = super()._frame_fused(*a, **k)
                self.anchored_log.append(self._map_anchored)
                return T
        return Recording

    jcfg, tcfg = cfg(jax_config), cfg(tconf)
    jp = recording(JaxPipeline)(jcfg, point_budget=512, rng_seed=0)
    jp.anchored_log = []
    jres = jp.run(frames, post_train=0)
    draws = ReplayDraws(_jax_draws(jcfg, N_FRAMES, 512), "cpu")
    tp = recording(SLAMPipeline)(tcfg, point_budget=512, rng_seed=0, device="cpu", draws=draws)
    tp.anchored_log = []
    tres = tp.run([TorchFrame(**vars(f)) for f in frames], post_train=0)
    assert not draws.queue

    assert tp.anchored_log == jp.anchored_log == [False, False] + [True] * (N_FRAMES - 2)
    assert tp.anchored_at == 3  # the fourth frame is the first tracked scan-to-map
    # one align a frame after the first
    assert len(tp.lm_log) == N_FRAMES - 1
    # measured ≤ 1.5e-5 (m / rad) per frame: the harness's bars hold
    np.testing.assert_allclose(tres.poses_est, jres.poses_est, atol=5e-4)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    ate, _ = ate_rmse(tres.poses_est, tres.poses_gt, align=False)
    assert ate < 0.12, ate
    assert int(tres.state.map.count) == int(jres.state.map.count)
