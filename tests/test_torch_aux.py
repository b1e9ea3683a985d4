"""Port parity: the SIBR viewer (`viz/network_gui.py` and the CLI's
`serve_viewer`), the native host library's loader (`io/native.py`),
`utils/profiling.py`, `utils/general.py` and `viz/rerun_viz.py` against
`sags_tpu` and `tests/test_aux.py` / `tests/test_native.py`. The fake
viewer and its requests are `torch_support`'s."""

import os
import random
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sags_tpu.utils import general as jgeneral
from sags_tpu.utils import profiling as jprof
from sags_tpu.viz import network_gui as jgui
from sags_tpu.viz import rerun_viz as jrerun
from sags_tpu_torch.cli import main as tcli
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.core.config import MapConfig, SLAMConfig
from sags_tpu_torch.io import native
from sags_tpu_torch.mapping import gaussian_map as tgm
from sags_tpu_torch.slam.step import render_map
from sags_tpu_torch.utils import general as tgeneral
from sags_tpu_torch.utils import profiling as tprof
from sags_tpu_torch.utils.draws import TorchDraws
from sags_tpu_torch.viz import network_gui as tgui
from sags_tpu_torch.viz import rerun_viz as trerun
from torch_support import sibr_request, unflip, viewer_client

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

W, H = 32, 24


def test_network_gui_roundtrip():
    """`tests/test_aux.py::test_network_gui_roundtrip` against the port: a
    fake viewer's request is answered with the render's bytes and the
    verify string."""
    gui = tgui.NetworkGUI(port=0, device="cpu")
    port = gui.listener.getsockname()[1]
    result = {}
    msg = sibr_request(make_camera(np.eye(3), np.zeros(3), W, H, 1.0, 0.8, device="cpu"))
    t = threading.Thread(target=viewer_client, args=(port, [msg], result))
    t.start()
    deadline = time.time() + 5
    served = False
    while time.time() < deadline and not served:
        served = gui.serve_once(lambda cam: torch.full((3, cam.height, cam.width), 0.5),
                                verify="test-ok")
        time.sleep(0.01)
    t.join(timeout=5)
    gui.close()
    assert served
    (img, verify), = result["replies"]
    assert verify == "test-ok" and len(img) == H * W * 3 and img[0] == 127  # 0.5 * 255


def test_minicam_matches_jax():
    """MiniCam of one request in both packages: `world_view`, `full_proj`
    and `cam_center` within 1e-6, the sizes and fovs equal."""
    rng = np.random.default_rng(0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.linalg.det(R)
    cam = make_camera(R, rng.normal(size=3), W, H, 1.0, 0.8, device="cpu")
    V = cam.world_view.numpy()
    msg = sibr_request(cam)
    args = (msg["resolution_x"], msg["resolution_y"], msg["fov_y"], msg["fov_x"],
            msg["z_near"], msg["z_far"], *unflip(msg))
    t = tgui.MiniCam(*args, device="cpu").camera
    j = jgui.MiniCam(*args).camera
    for name in ("world_view", "full_proj", "cam_center"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=1e-6, rtol=0)
    for name in ("width", "height", "fovx", "fovy", "znear", "zfar"):
        assert getattr(t, name) == getattr(j, name)
    np.testing.assert_allclose(t.world_view.numpy(), V, atol=1e-6)
    np.testing.assert_allclose(t.cam_center.numpy(), cam.cam_center.numpy(), atol=1e-5)


def tiny_map(n=256, seed=0):
    rng = np.random.default_rng(seed)
    m = tgm.init_map(512, MapConfig(initial_scale=0.08), "cpu")
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 5, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    m, _ = tgm.add_points(m, torch.as_tensor(pts), torch.as_tensor(cols),
                          torch.ones(n, dtype=torch.bool), TorchDraws(seed, "cpu"),
                          initial_scale=0.08, initial_opacity=0.6)
    return m


def test_serve_viewer_replies_are_render_map():
    """The CLI viewer's serving loop (`serve_viewer`, what `viewer` runs)
    answers 2 requests on a tiny map at `SLAMConfig()`; each reply is
    bitwise the uint8 image of `render_map` at the request's camera."""
    m, cfg = tiny_map(), SLAMConfig()
    gui = tgui.NetworkGUI(port=0, device="cpu")
    port = gui.listener.getsockname()[1]
    cams = [make_camera(np.eye(3), np.array([0.1 * i, 0.0, -0.2 * i]), W, H, 1.0, 0.8,
                        device="cpu") for i in range(2)]
    msgs = [sibr_request(c) for c in cams]
    result, served = {}, []
    # the loop in a thread, the client here: a failing client raises
    t = threading.Thread(target=lambda: served.append(tcli.serve_viewer(gui, m, cfg, requests=2)),
                         daemon=True)
    t.start()
    try:
        viewer_client(port, msgs, result)
        t.join(timeout=30)
    finally:
        gui.close()
    assert served == [2] and len(result["replies"]) == 2
    for (img, verify), msg in zip(result["replies"], msgs):
        cam = tgui.MiniCam(W, H, msg["fov_y"], msg["fov_x"], msg["z_near"], msg["z_far"],
                           *unflip(msg), device="cpu").camera
        with torch.no_grad():
            color = render_map(m, cam, cfg).color.numpy()
        want = np.clip(color * 255, 0, 255).astype(np.uint8).transpose(1, 2, 0)
        assert verify == "ok" and img == np.ascontiguousarray(want).tobytes()
        assert want.max() > 0


# --- the native host library (`tests/test_native.py`'s five cases) --------


def test_native_available_and_built_outside_native():
    """The port builds the library into its own build directory, never into
    `native/`."""
    assert native.available(), native.build_error
    assert os.path.exists(native.lib_path())
    assert os.path.dirname(native.lib_path()) != os.path.dirname(native.SOURCE)


def test_native_voxel_downsample_semantics_and_fallback(monkeypatch):
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 4, (2000, 3)).astype(np.float32)
    out = native.voxel_downsample(pts, 2.0)
    assert 4 <= len(out) <= 8
    assert (out >= 0).all() and (out <= 4).all()
    # each centroid is the mean of its voxel's points
    for c in out:
        cell = np.floor(c / 2.0)
        sel = (np.floor(pts / 2.0) == cell).all(1)
        np.testing.assert_allclose(c, pts[sel].mean(0), atol=1e-4)
    # the fallback (the port's voxel grid) gives the same set of centroids
    monkeypatch.setattr(native, "_library", lambda: None)
    fb = native.voxel_downsample(pts, 2.0, device="cpu")
    key = lambda a: a[np.lexsort(np.floor(a / 2.0).T[::-1])]
    np.testing.assert_allclose(key(fb), key(out), atol=1e-5)


def test_native_kdtree_knn_exact():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1500, 3)).astype(np.float32)
    q = rng.normal(size=(64, 3)).astype(np.float32)
    d2, idx = native.KDTree(pts).knn(q, k=5)
    D = ((q[:, None] - pts[None]) ** 2).sum(-1)
    bf = np.argsort(D, axis=1)[:, :5]
    np.testing.assert_allclose(d2, np.take_along_axis(D, bf, 1), rtol=1e-4, atol=1e-5)
    assert idx.dtype == np.int32 and np.array_equal(idx, bf)


def test_native_decode_xyzrgb_and_fallback(monkeypatch):
    rng = np.random.default_rng(0)
    n, step = 100, 32
    raw = bytearray(n * step)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3))
    for i in range(n):
        struct.pack_into("<fff", raw, i * step, *xyz[i])
        packed = (int(cols[i, 0]) << 16) | (int(cols[i, 1]) << 8) | int(cols[i, 2])
        struct.pack_into("<I", raw, i * step + 16, packed)
    got_xyz, got_rgb = native.decode_xyzrgb(bytes(raw), step, 0, 16)
    np.testing.assert_array_equal(got_xyz, xyz)
    np.testing.assert_allclose(got_rgb, cols / 255.0, atol=1e-6)
    monkeypatch.setattr(native, "_library", lambda: None)
    fb_xyz, fb_rgb = native.decode_xyzrgb(bytes(raw), step, 0, 16)
    assert np.array_equal(fb_xyz, got_xyz) and np.array_equal(fb_rgb, got_rgb)


def test_kdtree_python_fallback(monkeypatch):
    """The fallback (the port's kNN, here on the CPU) agrees with the native
    path, with the library hidden."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(400, 3)).astype(np.float32)
    q = rng.normal(size=(16, 3)).astype(np.float32)
    d2_n, idx_n = native.KDTree(pts).knn(q, k=4)
    monkeypatch.setattr(native, "_library", lambda: None)
    d2_f, idx_f = native.KDTree(pts, device="cpu").knn(q, k=4)
    np.testing.assert_allclose(np.sort(d2_n, 1), np.sort(d2_f, 1), rtol=1e-4, atol=1e-5)
    assert idx_f.dtype == np.int32 and np.array_equal(idx_n, idx_f)


# --- profiling, general utilities, rerun ---------------------------------


def test_phase_timer_matches_jax():
    """`summary()` and `report()` of recorded times equal the JAX one's;
    `phase` records one time a phase, with an output or without."""
    rng = np.random.default_rng(0)
    t, j = tprof.PhaseTimer(), jprof.PhaseTimer()
    for name in ("decode", "track", "b_train"):
        for s in rng.uniform(0.001, 0.05, 5):
            t.record(name, float(s))
            j.record(name, float(s))
    assert t.summary() == j.summary() and t.report() == j.report()
    with t.phase("render") as h:
        h["out"] = {"x": [torch.ones(3)], "y": (torch.zeros(2),)}
    with t.phase("render", result=torch.ones(2)):
        pass
    assert t.summary()["render"]["count"] == 2


def test_trace_writes_a_file(tmp_path):
    with tprof.trace(str(tmp_path)) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == str(tmp_path) and any(f.endswith(".json") for f in os.listdir(tmp_path))


def test_general_matches_jax():
    """`strip_symmetric`, `inverse_sigmoid` and the re-exported rotations
    against the JAX package's (1e-7 relative); `get_expon_lr_func` at
    `tests/test_torch_core.py`'s 1e-6 (the JAX schedule rounds to float32 at
    each step of its formula, the port's is a host double); `safe_state`
    leaves `random` and numpy at the JAX one's next draws."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(7, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1)
    np.testing.assert_array_equal(tgeneral.strip_symmetric(torch.as_tensor(cov)).numpy(),
                                  np.asarray(jgeneral.strip_symmetric(jnp.asarray(cov))))
    x = rng.uniform(0.01, 0.99, 50).astype(np.float32)
    np.testing.assert_allclose(tgeneral.inverse_sigmoid(torch.as_tensor(x)).numpy(),
                               np.asarray(jgeneral.inverse_sigmoid(jnp.asarray(x))), rtol=1e-7,
                               atol=1e-7)
    tf = tgeneral.get_expon_lr_func(1.6e-4, 1.6e-6, 100, 0.01, 30000)
    jf = jgeneral.get_expon_lr_func(1.6e-4, 1.6e-6, 100, 0.01, 30000)
    for step in (0, 1, 50, 100, 7000, 30000, 40000):
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6)
    q = rng.normal(size=(9, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = rng.uniform(0.01, 1, (9, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeneral.build_rotation(torch.as_tensor(q)).numpy(),
                               np.asarray(jgeneral.build_rotation(jnp.asarray(q))),
                               rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(
        tgeneral.build_scaling_rotation(torch.as_tensor(s), torch.as_tensor(q)).numpy(),
        np.asarray(jgeneral.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q))),
        rtol=1e-7, atol=1e-7)
    gen = tgeneral.safe_state(7, device="cpu")
    t_draws = (random.random(), np.random.rand())
    key = jgeneral.safe_state(7)
    assert t_draws == (random.random(), np.random.rand())
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 7
    assert jax.random.key_data(key).shape[-1] == 2


def test_rerun_helpers_match_jax():
    """`id2rgb` and `feature_to_rgb` bitwise, on arrays and on tensors;
    rerun is not installed, so the logger is disabled and logs nothing."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, (9, 11))
    ids[0, :3] = 0
    assert np.array_equal(trerun.id2rgb(ids), jrerun.id2rgb(ids))
    assert np.array_equal(trerun.id2rgb(torch.as_tensor(ids)), jrerun.id2rgb(ids))
    feats = rng.normal(size=(6, 9, 11)).astype(np.float32)
    assert np.array_equal(trerun.feature_to_rgb(feats), jrerun.feature_to_rgb(feats))
    assert np.array_equal(trerun.feature_to_rgb(torch.as_tensor(feats)),
                          jrerun.feature_to_rgb(feats))
    assert trerun.available() is False and jrerun.available() is False
    logger = trerun.RerunLogger()
    assert not logger.enabled
    logger.log_frame(0, image=torch.zeros(3, 4, 4), pose=np.eye(4))
    logger.log_trajectory(np.tile(np.eye(4), (3, 1, 1)))
