"""The port's CLI (`sags_tpu_torch.cli.main`), called in-process with
`--device cpu` at `tests/test_cli.py`'s tiny sizes: run-slam with a
checkpoint and --resume, under every tracking backend and mask back-end,
over the socket from `serve`, run-gicp in both
modes and align against the JAX CLI on the same inputs, render and eval of
a saved map, and train; and the kernel headers shipped as package data.
The other sources and the viewer: `tests/test_torch_rosbag.py`,
`tests/test_torch_datasets.py`, `tests/test_torch_aux.py`."""

import fnmatch
import json
import os
import re
import socket
import threading
import tomllib

import numpy as np
import pytest
import torch

from sags_tpu.cli import main as jcli
from sags_tpu_torch.cli import main as tcli
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.slam import checkpoint as tckpt
from sags_tpu_torch.slam import step as t_step
from tests.test_gicp import clouds  # noqa: F401 (fixture reuse)

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

TINY = ["--width", "64", "--height", "48", "--device", "cpu"]
SLAM = ["--point-budget", "256", "--capacity", "4096"]
# `tests/test_torch_tracking.py`'s bars: one align from the same inputs
# (POSE_ATOL), and a chain that aligns scans against a map built from its own
# earlier poses (`test_pipeline_gicp_map_matches_jax`): there a pose's
# rounding moves the next target, and one align answers a one-ulp change of
# its target's points by up to 1.3e-4 in either package (the JAX CLI's
# third map-mode pose against a JAX align from the same pose written out
# and read back).
POSE_ATOL, CHAIN_ATOL = 1e-5, 5e-4
# the keys of the JAX CLI's run-slam JSON line (`sags_tpu/cli/main.py:176-189`)
RUN_SLAM_KEYS = {"frames", "train_iters", "fps", "fps_steady", "ate_rmse", "mean_psnr",
                 "mean_ssim", "mean_lpips", "lpips_net", "eval_overflow_pairs",
                 "active_gaussians", "keyframes", "timed_out", "tracking"}


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def tiny_config():
    """`tests/test_torch_step.py`'s raster and map sizes, and a 512-point
    tracker budget (the default 8192 makes each GICP iteration an exact kNN
    over 8192 x 8192 pairs on one CPU core)."""
    return tconf.SLAMConfig(
        raster=tconf.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=16),
        map=tconf.MapConfig(initial_capacity=4096, initial_scale=0.06),
        tracking=tconf.TrackingConfig(backend="none", max_points=512))


@pytest.fixture(scope="module")
def slam_run(tmp_path_factory):
    """run-slam over 2 synthetic frames with gicp tracking, writing a
    checkpoint, the map, the trajectory and its plot. The run starts from
    a checkpoint of a fresh state in `tiny_config` (tracking "none"): a
    resumed run adopts the persisted config, and `--tracking` overrides it."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("slam")
    paths = {k: str(d / k) for k in ("init", "ck", "map.ply", "traj.txt", "traj.png")}
    cfg = tiny_config()
    tckpt.save_state(paths["init"], t_step.init_state(cfg, seed=0, device="cpu"), cfg)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tcli.main(["run-slam", "--resume", paths["init"], "--frames", "2",
                         "--post-train", "2", "--scan-points", "512", *SLAM, *TINY,
                         "--tracking", "gicp", "--checkpoint", paths["ck"],
                         "--save", paths["map.ply"], "--traj-out", paths["traj.txt"],
                         "--traj-plot", paths["traj.png"]])
    return res, json.loads(out.getvalue().strip().splitlines()[-1]), paths


def test_run_slam_checkpoint_and_resume(slam_run, capsys):
    """The JSON line has the reference's keys and finite metrics; the
    checkpoint loads bitwise equal to the run's final state, with the
    explicit --tracking and --capacity in its config; the TUM file is the
    estimated trajectory; a second `--resume` without --tracking keeps the
    persisted "gicp" (`tests/test_cli.py:91-111`) and carries the step on."""
    res, line, paths = slam_run
    assert set(line) == RUN_SLAM_KEYS
    assert line["frames"] == 2 and line["train_iters"] >= 1 and line["tracking"] == "gicp"
    for k in ("ate_rmse", "mean_psnr", "mean_ssim", "mean_lpips"):
        assert line[k] is not None and np.isfinite(line[k]), k
    back, cfg = tckpt.load_state(paths["ck"], device="cpu")
    assert cfg == tiny_config().replace(
        tracking=tconf.TrackingConfig(backend="gicp", max_points=512), post_train_iters=2)
    assert back.step == res.state.step and back.opt_state.count == res.state.opt_state.count
    for a, b in zip([*back.map, *back.opt_state.mu, *back.opt_state.nu, *back.classifier],
                    [*res.state.map, *res.state.opt_state.mu, *res.state.opt_state.nu,
                     *res.state.classifier]):
        assert torch.equal(a, b)
    assert torch.equal(back.rng.generator.get_state(), res.state.rng.generator.get_state())
    rows = np.loadtxt(paths["traj.txt"])
    np.testing.assert_allclose(rows[:, 1:4], res.poses_est[:, :3, 3], atol=1e-6)
    assert open(paths["traj.png"], "rb").read(8) == b"\x89PNG\r\n\x1a\n"

    res2 = tcli.main(["run-slam", "--frames", "2", "--scan-points", "512", *SLAM, *TINY,
                      "--resume", paths["ck"]])
    line2 = last_json(capsys)
    assert line2["frames"] == 2 and line2["tracking"] == "gicp"
    assert line2["train_iters"] >= 2 + 2 - 1  # the persisted post_train_iters ran
    assert res2.state.step == res.state.step + line2["train_iters"]  # carried on


@pytest.mark.parametrize("flags", [
    ["--tracking", "vgicp"], ["--tracking", "gicp_map"], ["--tracking", "esikf"],
    ["--tracking", "gicp", "--semantics"],
    ["--tracking", "none", "--semantics", "--mask-backend", "sam"],
], ids=["vgicp", "gicp_map", "esikf", "semantics_geometric", "semantics_sam"])
def test_run_slam_backends(slam_run, flags, capsys):
    """run-slam from the tiny persisted config under each other tracking
    backend and with either mask back-end: the reference's JSON keys, the
    backend reported, a finite ATE (0 where the poses are given)."""
    _, _, paths = slam_run
    tcli.main(["run-slam", "--resume", paths["init"], "--frames", "2", "--post-train", "1",
               "--scan-points", "512", *SLAM, *TINY, *flags])
    line = last_json(capsys)
    assert set(line) == RUN_SLAM_KEYS
    assert line["frames"] == 2 and line["tracking"] == flags[1]
    assert line["ate_rmse"] is not None and np.isfinite(line["ate_rmse"])


def test_render_and_eval_saved_map(slam_run, tmp_path, capsys):
    """render writes a PNG that decodes to the rendered image; eval scores
    the saved map against the dataset."""
    import imageio.v2 as imageio

    _, _, paths = slam_run
    out = str(tmp_path / "view.png")
    img = tcli.main(["render", "--map", paths["map.ply"], "--out", out, "--width", "64",
                     "--height", "48", "--device", "cpu"])
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8 and img.max() > 0
    np.testing.assert_array_equal(imageio.imread(out), img)
    capsys.readouterr()
    tcli.main(["eval", "--map", paths["map.ply"], "--frames", "2", "--every", "1", *TINY])
    line = last_json(capsys)
    assert set(line) == {"n_eval", "psnr", "ssim", "lpips", "lpips_net"}
    assert line["n_eval"] == 2 and np.isfinite(line["psnr"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_feeds_run_slam_over_socket(capsys):
    """`serve` in a thread publishes 2 frames; `run-slam --dataset socket`
    consumes them (`tests/test_cli.py:114-160`)."""
    port = str(_free_port())
    t = threading.Thread(target=tcli.main, args=(["serve", "--frames", "2", "--width", "48",
                                                  "--height", "36", "--scan-points", "256",
                                                  "--port", port, "--device", "cpu"],),
                         daemon=True)
    t.start()
    tcli.main(["run-slam", "--dataset", "socket", "--port", port, "--post-train", "1",
               "--point-budget", "256", "--capacity", "2048", "--device", "cpu"])
    t.join(30.0)
    assert not t.is_alive()
    line = last_json(capsys)
    assert line["frames"] == 2 and not line["timed_out"]
    assert line["mean_psnr"] is None  # a live stream is not replayed for eval


@pytest.mark.parametrize("mode,atol", [("scan", POSE_ATOL), ("map", CHAIN_ATOL)])
def test_run_gicp_matches_jax_cli(mode, atol, tmp_path, capsys):
    """run-gicp over 4 frames, both packages' CLIs on the same flags: the same
    JSON keys and values of `frames`, `method`, `mode`; the KITTI pose files
    and the ATEs agree to POSE_ATOL scan to scan and CHAIN_ATOL scan to
    keyframe map."""
    argv = ["run-gicp", "--frames", "4", "--width", "64", "--height", "48", "--mode", mode,
            "--keyframe-every", "2"]
    jcli.main([*argv, "--out-poses", str(tmp_path / "j.txt")])
    jl = last_json(capsys)
    tcli.main([*argv, "--device", "cpu", "--out-poses", str(tmp_path / "t.txt")])
    tl = last_json(capsys)
    assert set(tl) == set(jl)
    assert all(tl[k] == jl[k] for k in ("frames", "method", "mode"))
    Tt, Tj = np.loadtxt(tmp_path / "t.txt"), np.loadtxt(tmp_path / "j.txt")
    assert Tt.shape == Tj.shape == (4, 12)
    np.testing.assert_allclose(Tt, Tj, atol=atol)
    assert abs(tl["ate_rmse"] - jl["ate_rmse"]) <= atol


def test_align_gicp_matches_jax_cli(clouds, tmp_path, capsys):  # noqa: F811
    """align --method gicp on `tests/test_gicp.py`'s structured pair written
    as .npy: the same JSON keys, counts and method; the translations agree
    to POSE_ATOL."""
    source, target, T, _ = clouds
    np.save(tmp_path / "t.npy", target)
    np.save(tmp_path / "s.npy", source)
    argv = ["align", "--target", str(tmp_path / "t.npy"), "--source",
            str(tmp_path / "s.npy"), "--method", "gicp", "--n", "1"]
    jcli.main(argv)
    jl = last_json(capsys)
    tcli.main([*argv, "--device", "cpu"])
    tl = last_json(capsys)
    assert set(tl) == set(jl)
    assert all(tl[k] == jl[k] for k in ("method", "n_target", "n_source"))
    np.testing.assert_allclose(tl["translation"], jl["translation"], atol=POSE_ATOL)
    np.testing.assert_allclose(tl["translation"], T[:3, 3], atol=0.02)


def test_train_saves_a_map(tmp_path, capsys):
    """train over 2 frames for 4 iterations: the reference's JSON keys, a
    finite loss, the PLY written."""
    out = tmp_path / "train.ply"
    tcli.main(["train", "--frames", "2", "--iters", "4", *TINY, "--save", str(out)])
    line = last_json(capsys)
    assert set(line) == {"iters", "final_loss", "active_gaussians", "iters_per_sec"}
    assert line["iters"] == 4 and np.isfinite(line["final_loss"])
    assert line["active_gaussians"] > 0 and out.exists()


def test_default_device_is_the_card():
    """Without a GPU and without `--device cpu`, an entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["run-slam", "--frames", "2"])


def test_kernel_headers_are_package_data():
    """Every `#include "..."` under `sags_tpu_torch/csrc/`, and every source,
    matches a package-data pattern of `pyproject.toml`."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"]["sags_tpu_torch"]
    csrc = os.path.join(root, "sags_tpu_torch", "csrc")
    names = sorted(os.listdir(csrc))
    included = set()
    for name in names:
        with open(os.path.join(csrc, name)) as f:
            included.update(re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M))
    assert included and included <= set(names)
    for name in sorted(included | set(names)):
        assert any(fnmatch.fnmatch(f"csrc/{name}", p) for p in patterns), name
