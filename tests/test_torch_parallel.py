"""The port's tile-sharded mesh (`sags_tpu_torch.parallel.mesh`, the sharded
compositors, `slam_step(mesh=)`, `SLAMPipeline(mesh=)`) on real multi-rank
gloo groups over the CPU, against the JAX package's sharded paths
(`tests/test_parallel.py`'s scenes, JAX on its virtual CPU mesh) and
against the port's own unsharded paths.

Ranks are spawned with `torch.multiprocessing` and meet through a `file://`
rendezvous under the test's temporary directory. A rank runs a function of
this module, which imports no JAX at top level (a child imports the module
to find the function); the JAX references are built in the parent's
fixtures.
"""

import dataclasses
import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sags_tpu_torch import interop
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.ops import rasterize as trz
from sags_tpu_torch.ops import windowed as win
from sags_tpu_torch.parallel import mesh as pmesh
from sags_tpu_torch.slam import step as t_step
from sags_tpu_torch.slam.pipeline import SLAMPipeline
from sags_tpu_torch.utils.draws import ReplayDraws

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

RANK_TIMEOUT_S = 240


def _rank_main(fn, rank, n, root, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        mesh = pmesh.make_mesh(n, devices=["cpu"] * n)
        torch.save(fn(mesh, *args), os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n, root, *args) -> list:
    """fn(mesh, *args) on n spawned gloo ranks over the CPU; each rank's
    result, in rank order."""
    os.makedirs(root)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, str(root), args))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RANK_TIMEOUT_S + 60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * n, [p.exitcode for p in procs]
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def assert_trees_bitwise(a, b, path="") -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_trees_bitwise(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_bitwise(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# --- the mesh module --------------------------------------------------------

@pytest.mark.parametrize("NT,n,NT_pad", [(30, 4, 32), (32, 4, 32), (1280, 3, 1281),
                                         (1, 2, 2)])
def test_tile_sharding_pads_the_grid_and_slices_each_rank(NT, n, NT_pad):
    x = torch.arange(NT * 3, dtype=torch.int32).reshape(NT, 3)
    rows = []
    for rank in range(n):
        mesh = pmesh.Mesh(None, rank, n, torch.device("cpu"))
        pad, lo, hi = pmesh.tile_sharding(mesh, NT)
        assert (pad, lo, hi) == (NT_pad, rank * NT_pad // n, (rank + 1) * NT_pad // n)
        part = pmesh.shard_tiles(x, mesh, fill=-1)
        assert part.shape == (NT_pad // n, 3)
        rows.append(part)
    full = torch.cat(rows)
    assert torch.equal(full[:NT], x)
    assert bool((full[NT:] == -1).all())
    assert pmesh.shard_tiles(x, None) is x
    assert pmesh.replicated(x, None) is x


def test_make_mesh_takes_every_launched_rank(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        pmesh.make_mesh(devices=["cpu"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="every rank takes part"):
        pmesh.make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 devices for 2 ranks"):
        pmesh.make_mesh(devices=["cpu"] * 3)
    assert not dist.is_initialized()


# --- scenes: tests/test_parallel.py's ---------------------------------------

STEP_W, STEP_H = 128, 64
WIN_W, WIN_H = 96, 80


def step_configs(mod):
    return mod.SLAMConfig(
        raster=mod.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=64, chunk=16),
        map=mod.MapConfig(initial_capacity=512),
        semantics=mod.SemanticsConfig(cls3d_sample=16, num_classes=16))


def windowed_config(mod, **kw):
    return mod.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=16,
                               pallas_interpret=True, window_blocks=24,
                               windowed_mid_frac=1.0, windowed_big_frac=1.0, **kw)


def windowed_scene():
    """`test_sharded_windowed_render_matches_single_device`'s scene: 1024
    splats over 6 × 5 = 30 tiles (padded to 32 over 4 ranks)."""
    rng = np.random.default_rng(0)
    n = 1024
    z = rng.uniform(2.0, 10.0, (n, 1))
    xy = rng.uniform(-0.5, 0.5, (n, 2)) * z
    means = np.concatenate([xy, z], 1).astype(np.float32)
    scales = (rng.uniform(0.005, 0.02, (n, 3)) * z).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, -1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, (n,)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    objs = rng.normal(size=(n, 16)).astype(np.float32)
    tgt = rng.uniform(0, 1, (3, WIN_H, WIN_W)).astype(np.float32)
    return (means, opac, scales, quats, colors, objs), tgt


def render_and_grads(A, tgt, cfg, mesh):
    """The windowed render of the scene and the gradients of
    `test_parallel.py`'s loss w.r.t. the means and the object features."""
    means, opac, scales, quats, colors, objs = (torch.as_tensor(a) for a in A)
    means.requires_grad_(True)
    objs.requires_grad_(True)
    cam = make_camera(torch.eye(3), torch.zeros(3), WIN_W, WIN_H, 1.2, 0.9)
    r = trz.rasterize(means, opac, scales, quats, cam, cfg, colors=colors,
                      obj_features=objs, windowed=True, mesh=mesh)
    loss = (torch.sum((r.color - torch.as_tensor(tgt)) ** 2) + torch.sum(r.final_T ** 2)
            + torch.sum(r.objects ** 2) * 1e-3)
    g_means, g_objs = torch.autograd.grad(loss, (means, objs))
    return {"color": r.color.detach(), "depth": r.depth.detach(),
            "objects": r.objects.detach(), "final_T": r.final_T.detach(),
            "n_binned": int(r.n_binned), "g_means": g_means, "g_objs": g_objs}


def sharded_step(mesh, tree, draw, img, obj, cfg):
    cam = make_camera(torch.eye(3), torch.zeros(3), STEP_W, STEP_H, 1.2, 1.0)
    state = interop.state_from_numpy(tree, "cpu", draws=ReplayDraws([draw], "cpu"))
    step = t_step.make_slam_step(cfg, mesh=mesh)
    s, m = step(state, cam, torch.as_tensor(img), torch.as_tensor(obj))
    return {"state": interop.state_to_numpy(s),
            "metrics": {k: v.clone() for k, v in m._asdict().items()}}


def _four_rank_cases(mesh, step_in, win_in):
    A, tgt = win_in
    out = {}
    # gather_tiles / shard_tiles and their gradients on 30 rows of 5
    x = torch.arange(150, dtype=torch.float32).reshape(30, 5)
    part = pmesh.shard_tiles(x, mesh).requires_grad_(True)
    full = pmesh.gather_tiles(part, mesh, 30)
    w = torch.arange(150, dtype=torch.float32).reshape(30, 5) + 1.0
    (g,) = torch.autograd.grad((full * w).sum(), part)
    out["gather"] = {"full": full.detach(), "grad": g, "want": pmesh.shard_tiles(w, mesh)}
    # the classic sharded step
    out["step"] = sharded_step(mesh, *step_in)
    # the windowed sharded render and gradients, both backward routes
    cfg = windowed_config(tconf)
    out["render"] = render_and_grads(A, tgt, cfg, mesh)
    out["recompute"] = render_and_grads(
        A, tgt, dataclasses.replace(cfg, pallas_backward=False), mesh)
    # windowed_sort="kernel" under a mesh: the host-table render
    sorted_kernel = win.composite_windowed_sorted

    def refuse(*a, **k):
        raise AssertionError("the kernel-sort compositor ran under a mesh")

    win.composite_windowed_sorted = refuse
    try:
        out["kernel_sort"] = render_and_grads(
            A, tgt, dataclasses.replace(cfg, windowed_sort="kernel"), mesh)
    finally:
        win.composite_windowed_sorted = sorted_kernel
    return out


def _one_rank_cases(mesh, step_in, win_in):
    A, tgt = win_in
    cfg = windowed_config(tconf)
    return {"step": [sharded_step(m, *step_in) for m in (mesh, None)],
            "render": [render_and_grads(A, tgt, cfg, m) for m in (mesh, None)]}


@pytest.fixture(scope="module")
def step_inputs():
    """The JAX state of `tests/test_parallel.py:setup` after its 256-point
    add, as the port's numpy tree, with the step's cls3d draw, the target
    images and the JAX package's sharded step on its 4-device mesh."""
    import jax
    import jax.numpy as jnp

    from sags_tpu.core import config as jconf
    from sags_tpu.core.camera import make_camera as jax_make_camera
    from sags_tpu.parallel.mesh import make_mesh
    from sags_tpu.slam import step as jax_step

    from test_torch_step import jax_state_to_numpy, uniform_draw

    jcfg = step_configs(jconf)
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-2, 2, (256, 2)), rng.uniform(2, 6, (256, 1))],
                         1).astype(np.float32)
    cols = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    s = jax_step.init_state(jcfg, jax.random.key(0))
    s, _ = jax.jit(lambda s, p, c, m: jax_step.add_frame_points(s, p, c, m, jcfg))(
        s, jnp.asarray(pts), jnp.asarray(cols), jnp.ones(256, bool))
    cam = jax_make_camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                          STEP_W, STEP_H, 1.2, 1.0)
    img = np.random.default_rng(1).uniform(0, 1, (3, STEP_H, STEP_W)).astype(np.float32)
    obj = np.zeros((STEP_H, STEP_W), np.int32)
    draw = uniform_draw(s.rng, (s.map.capacity,))  # step 0 runs the cls3d term
    s4, m4 = jax_step.make_slam_step(jcfg, donate=False, mesh=make_mesh(4))(
        s, cam, jnp.asarray(img), jnp.asarray(obj))
    ref = {"loss": float(m4.loss), "n_binned": int(m4.n_binned),
           "f_dc": np.asarray(s4.map.f_dc), "xyz": np.asarray(s4.map.xyz)}
    return (jax_state_to_numpy(s), draw, img, obj, step_configs(tconf)), ref


@pytest.fixture(scope="module")
def windowed_inputs():
    """The windowed scene and the JAX package's sharded windowed render and
    gradients on its 4-device mesh (Pallas in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from sags_tpu.core import config as jconf
    from sags_tpu.core.camera import make_camera as jax_make_camera
    from sags_tpu.ops import rasterize as jrz
    from sags_tpu.parallel.mesh import make_mesh

    A, tgt = windowed_scene()
    cfg = windowed_config(jconf)
    cam = jax_make_camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                          WIN_W, WIN_H, 1.2, 0.9)
    mesh = make_mesh(4)
    J = tuple(jnp.asarray(a) for a in A)

    def render(m, o):
        return jrz.rasterize(m, J[1], J[2], J[3], cam, cfg, colors=J[4], obj_features=o,
                             windowed=True, mesh=mesh)

    def loss(m, o):
        r = render(m, o)
        return (jnp.sum((r.color - jnp.asarray(tgt)) ** 2) + jnp.sum(r.final_T ** 2)
                + jnp.sum(r.objects ** 2) * 1e-3)

    r = jax.jit(render)(J[0], J[5])
    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(J[0], J[5])
    ref = {"color": np.asarray(r.color), "depth": np.asarray(r.depth),
           "objects": np.asarray(r.objects), "g_means": np.asarray(g[0]),
           "g_objs": np.asarray(g[1])}
    return (A, tgt), ref


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, step_inputs, windowed_inputs):
    return run_ranks(_four_rank_cases, 4, tmp_path_factory.mktemp("mesh") / "four",
                     step_inputs[0], windowed_inputs[0])


def test_gather_tiles_round_trip_and_gradient(four_ranks):
    """All-gather of the padded tile rows cut back to NT; the gradient of a
    rank's rows is its rows of the whole cotangent, not a sum over ranks."""
    x = torch.arange(150, dtype=torch.float32).reshape(30, 5)
    for res in four_ranks:
        assert torch.equal(res["gather"]["full"], x)
        assert torch.equal(res["gather"]["grad"], res["gather"]["want"])


def test_sharded_step_matches_jax(step_inputs, four_ranks):
    """The 4-rank classic step against the JAX package's 4-device one, at
    `tests/test_parallel.py`'s bars."""
    ref = step_inputs[1]
    res = four_ranks[0]["step"]
    np.testing.assert_allclose(float(res["metrics"]["loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(res["state"]["map"]["f_dc"], ref["f_dc"], atol=1e-5)
    np.testing.assert_allclose(res["state"]["map"]["xyz"], ref["xyz"], atol=1e-6)
    assert int(res["metrics"]["n_binned"]) == ref["n_binned"]


def test_sharded_ranks_end_bitwise_equal(four_ranks):
    """Every rank's step state, render and gradients equal rank 0's bit for
    bit: the replicated part is deterministic and the collectives hand
    every rank the same sums."""
    for res in four_ranks[1:]:
        for key in ("step", "render", "recompute", "kernel_sort"):
            assert_trees_bitwise(res[key], four_ranks[0][key], key)


def test_sharded_windowed_render_matches_jax(windowed_inputs, four_ranks):
    ref = windowed_inputs[1]
    res = four_ranks[0]["render"]
    np.testing.assert_allclose(res["color"].numpy(), ref["color"], atol=1e-5)
    np.testing.assert_allclose(res["depth"].numpy(), ref["depth"], atol=1e-4)
    np.testing.assert_allclose(res["objects"].numpy(), ref["objects"], atol=1e-4)


def _max_rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(b).max() + 1e-8))


def test_sharded_windowed_gradients_match_jax(windowed_inputs, four_ranks):
    ref = windowed_inputs[1]
    res = four_ranks[0]["render"]
    for k in ("g_means", "g_objs"):
        assert _max_rel(res[k].numpy(), ref[k]) < 1e-4, k


def test_sharded_recompute_route_at_offset(windowed_inputs, four_ranks):
    """`pallas_backward=False` recomputes through the classic compositor at
    each rank's tile offset: its gradients equal the unsharded recompute's
    to 1e-4 relative (ranks 1-3 composite at offsets 8, 16, 24)."""
    A, tgt = windowed_inputs[0]
    cfg = dataclasses.replace(windowed_config(tconf), pallas_backward=False)
    want = render_and_grads(A, tgt, cfg, None)
    res = four_ranks[0]["recompute"]
    assert torch.equal(res["color"], four_ranks[0]["render"]["color"])
    for k in ("g_means", "g_objs"):
        assert _max_rel(res[k].numpy(), want[k].numpy()) < 1e-4, k


def test_kernel_sort_under_a_mesh_renders_through_the_host_table(four_ranks):
    res = four_ranks[0]
    assert_trees_bitwise(res["kernel_sort"], res["render"])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory, step_inputs, windowed_inputs):
    return run_ranks(_one_rank_cases, 1, tmp_path_factory.mktemp("mesh") / "one",
                     step_inputs[0], windowed_inputs[0])[0]


@pytest.mark.parametrize("case", ["step", "render"])
def test_one_rank_is_bitwise_the_unsharded_path(one_rank, case):
    """With one rank the slice is the whole grid and the collectives are
    identities: the sharded step and render equal `mesh=None` bit for bit."""
    sharded, plain = one_rank[case]
    assert_trees_bitwise(sharded, plain)


# --- SLAMPipeline(mesh=...) ---------------------------------------------------

N_FRAMES, PW, PH = 4, 64, 48


def pipeline_config(fused_frontend):
    """`tests/test_torch_pipeline.py`'s operating point."""
    return tconf.SLAMConfig(
        raster=tconf.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128,
                                     chunk=32),
        map=tconf.MapConfig(initial_capacity=4096, initial_scale=0.08),
        semantics=tconf.SemanticsConfig(cls3d_sample=32, num_classes=24),
        keyframes=tconf.KeyframeConfig(keyframe_freq=2, window=8),
        tracking=tconf.TrackingConfig(backend="gicp", max_points=512),
        gicp=tconf.GICPConfig(max_iterations=24, knn_max_distance=2.0),
        post_train_iters=0, metrics_interval=2, fused_frontend=fused_frontend)


def pipeline_run(mesh):
    frames = list(SyntheticDataset(n_frames=N_FRAMES, width=PW, height=PH, n_world=4096,
                                   pts_per_frame=512, step=0.1, clutter=0.3,
                                   device="cpu"))
    out = {}
    for fused in (True, False):
        pipe = SLAMPipeline(pipeline_config(fused), point_budget=512, rng_seed=0,
                            device="cpu", mesh=mesh)
        r = pipe.run(frames, post_train=0)
        out[fused] = {"poses": r.poses_est, "losses": r.losses,
                      "state": interop.state_to_numpy(r.state)}
        if fused:
            pipe._rebuild_frontend()  # a capacity rebuild keeps the mesh
            out["rebuilt_mesh_kept"] = pipe._fused.mesh is mesh
    return out


@pytest.fixture(scope="module")
def two_rank_pipelines(tmp_path_factory):
    return run_ranks(pipeline_run, 2, tmp_path_factory.mktemp("mesh") / "pipe")


@pytest.fixture(scope="module")
def unsharded_pipelines():
    return pipeline_run(None)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_module"])
def test_sharded_pipeline_matches_unsharded(two_rank_pipelines, unsharded_pipelines,
                                            fused):
    """A 2-rank `SLAMPipeline(mesh=...)` over 4 frames (both front-ends)
    against the port's unsharded run: the trajectory at
    `tests/test_torch_pipeline.py`'s bar, the losses to 1e-5 relative, and
    both ranks' final states bitwise equal."""
    want = unsharded_pipelines[fused]
    got = [r[fused] for r in two_rank_pipelines]
    assert len(got[0]["losses"]) == N_FRAMES
    np.testing.assert_allclose(got[0]["poses"], want["poses"], atol=5e-4)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-5)
    assert_trees_bitwise(got[1], got[0])
    assert all(r["rebuilt_mesh_kept"] for r in two_rank_pipelines)
