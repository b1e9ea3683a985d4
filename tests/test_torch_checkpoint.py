"""Port parity: `slam/checkpoint.py` (save and load of the whole SLAM state,
bitwise, in the JAX package's on-disk layout, read both ways) and the rest of
`utils/traj.py` and `io/stream.py` against `sags_tpu`."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sags_tpu.io import stream as jstream
from sags_tpu.io.datasets import SyntheticDataset as JaxSynthetic
from sags_tpu.mapping import gaussian_map as jgm
from sags_tpu.models.classifier import make_classifier_optimizer
from sags_tpu.slam import checkpoint as jckpt
from sags_tpu.slam import step as jax_step
from sags_tpu.utils import traj as jtraj
from sags_tpu_torch import interop
from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.io import stream as tstream
from sags_tpu_torch.io.datasets import Frame as TorchFrame
from sags_tpu_torch.mapping import gaussian_map as tgm
from sags_tpu_torch.slam import checkpoint as tckpt
from sags_tpu_torch.slam import step as t_step
from sags_tpu_torch.utils import traj as ttraj
from torch_support import assert_states_bitwise
from test_torch_step import W, H, configs, jax_state_to_numpy, scene

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py


def _port_stepped(seed=5, steps=2):
    """A port state on the CPU after points were added and `steps` training
    steps, each drawing the cls3d sample from the generator (interval 1)."""
    rng = np.random.default_rng(seed)
    _, tcfg = configs()
    tcfg = tcfg.replace(semantics=type(tcfg.semantics)(cls3d_sample=16, num_classes=20,
                                                       cls3d_interval=1))
    pts, cols, mask, img, obj = scene(rng)
    s = t_step.init_state(tcfg, seed=seed, device="cpu")
    s, _ = t_step.add_frame_points(s, torch.as_tensor(pts), torch.as_tensor(cols),
                                   torch.as_tensor(mask), tcfg)
    cam = make_camera(torch.eye(3), torch.zeros(3), W, H, 1.2, 0.9)
    args = (cam, torch.as_tensor(img), torch.as_tensor(obj), tcfg)
    for _ in range(steps):
        s, _ = t_step.slam_step(s, *args)
    return s, tcfg, args


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Port save → port load restores every tensor, the host counters and
    the generator state bit for bit, and the config; one `slam_step` from
    each state (drawing from the generator) gives bitwise equal states.
    The counterpart of `tests/test_aux.py::test_checkpoint_roundtrip`."""
    s, tcfg, args = _port_stepped()
    tckpt.save_state(str(tmp_path), s, tcfg)
    back, cfg = tckpt.load_state(str(tmp_path), device="cpu")
    assert cfg == tcfg
    assert back.rng.seed == 5
    assert_states_bitwise(s, back)
    s1, m1 = t_step.slam_step(s, *args)
    s2, m2 = t_step.slam_step(back, *args)
    assert float(m1.loss_obj_3d) > 0  # the step drew its cls3d sample
    assert torch.equal(m1.loss, m2.loss)
    assert_states_bitwise(s1, s2)


def _jax_stepped(jcfg, key=7):
    """A JAX `SLAMState` whose every group moved from its init: points added,
    one map-optimizer and one classifier-optimizer update from random
    gradients, the step counter set."""
    rng = np.random.default_rng(1)
    pts, cols, mask, _, _ = scene(rng)
    s = jax_step.init_state(jcfg, jax.random.key(key))
    s, _ = jax_step.add_frame_points(s, jnp.asarray(pts), jnp.asarray(cols),
                                     jnp.asarray(mask), jcfg)
    _, update = jgm.make_optimizer(jcfg.opt, spatial_lr_scale=jcfg.scene_extent)
    params = jgm.params_of(s.map)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
    upd, opt_state = update(grads, s.opt_state, params, 3)
    m = s.map._replace(**jgm.apply_updates(params, upd, s.map.active)._asdict())
    cgrads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
                          s.classifier)
    cupd, cls_opt = make_classifier_optimizer(jcfg.semantics.classifier_lr).update(
        cgrads, s.cls_opt_state, s.classifier)
    return s._replace(map=m, opt_state=opt_state, classifier=optax.apply_updates(
        s.classifier, cupd), cls_opt_state=cls_opt, step=jnp.int32(3))


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A `sags_tpu` checkpoint loads in the port equal, bit for bit, to
    `interop.state_from_numpy` of the same JAX state; the config round-trips
    to the same dict; the draw hook is seeded from the key data."""
    jcfg, _ = configs()
    s = _jax_stepped(jcfg)
    assert int(s.opt_state.count) == 1
    jckpt.save_state(str(tmp_path), s, jcfg)
    got, cfg = tckpt.load_state(str(tmp_path), device="cpu")
    want = interop.state_from_numpy(jax_state_to_numpy(s), "cpu", seed=7)
    assert_states_bitwise(got, want, generator=False)  # the hook: seeded below
    assert (got.step, got.opt_state.count, got.cls_opt_state.count) == (3, 1, 1)
    assert float(got.opt_state.nu[0].abs().max()) > 0
    assert float(got.cls_opt_state.mu[0].abs().max()) > 0
    assert tckpt._cfg_to_dict(cfg) == jckpt._cfg_to_dict(jcfg)
    hi, lo = np.asarray(jax.random.key_data(s.rng), np.uint32)
    assert got.rng.seed == (int(hi) << 32) | int(lo)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port checkpoint loads in `sags_tpu.slam.checkpoint.load_state`:
    every leaf equal, by name, to the port state's, the key the port's seed,
    the config equal; the generator entry is ignored."""
    s, tcfg, _ = _port_stepped(seed=9)
    tckpt.save_state(str(tmp_path), s, tcfg)
    js, jcfg = jckpt.load_state(str(tmp_path))
    got, want = jax_state_to_numpy(js), interop.state_to_numpy(s)
    assert got["step"] == want["step"] == 2
    for group in ("map", "classifier"):
        for k, v in want[group].items():
            np.testing.assert_array_equal(got[group][k], v, err_msg=k)
            assert got[group][k].dtype == v.dtype, k
    for group in ("opt", "cls_opt"):
        assert got[group]["count"] == want[group]["count"] == 2
        for part in ("mu", "nu"):
            for k, v in want[group][part].items():
                np.testing.assert_array_equal(got[group][part][k], v, err_msg=(group, k))
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(js.rng)), [0, 9])
    # the JAX loader keeps JSON's lists where the port restores tuples
    assert jckpt._cfg_to_dict(jcfg) == json.loads(json.dumps(tckpt._cfg_to_dict(tcfg)))


def test_checkpoint_on_another_device_type_reseeds(tmp_path):
    """A generator state saved from another device type cannot be set: the
    loaded hook is seeded from the key leaf instead."""
    s, tcfg, _ = _port_stepped(seed=4, steps=1)
    tckpt.save_state(str(tmp_path), s, tcfg)
    meta_path = tmp_path / "meta.json"
    meta = json.loads(meta_path.read_text())
    assert meta["torch_generator"] == "cpu"
    meta["torch_generator"] = "cuda"
    meta_path.write_text(json.dumps(meta))
    back, _ = tckpt.load_state(str(tmp_path), device="cpu")
    fresh = torch.Generator().manual_seed(4)
    assert torch.equal(back.rng.generator.get_state(), fresh.get_state())
    assert torch.equal(back.map.xyz, s.map.xyz)


def _poses(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        T = np.eye(4)
        T[:3, :3] = Q
        T[:3, 3] = rng.normal(size=3)
        out.append(T)
    return np.stack(out)


def test_trajectory_helpers_match_jax(tmp_path):
    """`rpe` equal to the JAX package's (same numpy arithmetic: bitwise);
    `_rotmat_to_quat_xyzw` equal in all four of Shepperd's branches; the TUM
    and KITTI files byte-identical; `plot_trajectory` writes a PNG."""
    est, gt = _poses(seed=0), _poses(seed=1)
    for delta in (1, 2):
        assert ttraj.rpe(est, gt, delta) == jtraj.rpe(est, gt, delta)
    for axis, ang in [((1, 0, 0), 0.1), ((1, 0, 0), 3.1), ((0, 1, 0), 3.1), ((0, 0, 1), 3.1)]:
        a = np.asarray(axis, float)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
        np.testing.assert_array_equal(ttraj._rotmat_to_quat_xyzw(R),
                                      jtraj._rotmat_to_quat_xyzw(R))
    for name, fn, kw in (("tum", "save_tum_trajectory", {"timestamps": 0.5 * np.arange(6)}),
                         ("tum0", "save_tum_trajectory", {}),
                         ("kitti", "save_kitti_trajectory", {})):
        getattr(ttraj, fn)(str(tmp_path / f"{name}_t.txt"), est, **kw)
        getattr(jtraj, fn)(str(tmp_path / f"{name}_j.txt"), est, **kw)
        assert ((tmp_path / f"{name}_t.txt").read_bytes()
                == (tmp_path / f"{name}_j.txt").read_bytes()), name
    out = tmp_path / "traj.png"
    assert ttraj.plot_trajectory(str(out), est, gt_poses=gt)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and out.stat().st_size > 1000


def _frames_equal(a, b):
    for f in ("image", "points", "colors", "depth", "imu", "scan"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
    assert (a.pose is None) == (b.pose is None)
    if a.pose is not None:
        np.testing.assert_array_equal(np.asarray(a.pose), np.asarray(b.pose))
    assert a.timestamp == b.timestamp


@pytest.mark.parametrize("pose_free", [False, True])
def test_stream_records_decode_across_packages(pose_free):
    """A record encoded by either package decodes in the other to the same
    frame, pose-less frames included (the NaN pose maps back to None); a
    port frame holding tensors encodes as its numpy arrays. Then a port
    publisher feeds a JAX consumer over a socket, and back."""
    frames = list(JaxSynthetic(n_frames=2, width=32, height=24, imu_substeps=3,
                               pose_free=pose_free))
    assert (frames[0].pose is None) == pose_free
    for f in frames:
        tf = tstream._decode(jstream._encode(f))
        assert isinstance(tf, TorchFrame)
        _frames_equal(tf, f)
        _frames_equal(jstream._decode(tstream._encode(tf)), f)
        held = TorchFrame(**{k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
                             for k, v in vars(tf).items()})
        assert tstream._encode(held) == tstream._encode(tf)
    assert tstream.MAX_RECORD_BYTES == jstream.MAX_RECORD_BYTES
    for serve, consume in ((tstream.serve_frames, jstream.socket_frames),
                           (jstream.serve_frames, tstream.socket_frames)):
        ready = threading.Event()
        t = threading.Thread(target=serve, args=(frames,),
                             kwargs={"port": 0, "ready": ready}, daemon=True)
        t.start()
        assert ready.wait(10.0)
        got = list(consume(ready.port))
        t.join(10.0)
        assert not t.is_alive() and len(got) == 2
        for a, b in zip(got, frames):
            _frames_equal(a, b)
