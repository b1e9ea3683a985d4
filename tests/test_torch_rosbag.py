"""Port parity: `io/rosbag.py` (the ROS1 bag reader and writer, the four
message codecs, the approximate-time synchronizer, `RosbagDataset`) against
`sags_tpu.io.rosbag` on seeded messages, and `run-slam --dataset rosbag`
of both packages' CLIs on one tiny bag (written by `torch_support.write_rosbag`)."""

import bz2
import contextlib
import io
import json
import struct

import numpy as np
import pytest
import torch

from sags_tpu.cli import main as jcli
from sags_tpu.io import rosbag as jrb
from sags_tpu_torch.cli import main as tcli
from sags_tpu_torch.io import rosbag as trb
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.slam import checkpoint as tckpt
from sags_tpu_torch.slam import step as t_step
from torch_support import write_rosbag
from test_torch_cli import POSE_ATOL, RUN_SLAM_KEYS, tiny_config

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

IMG, CLOUD, ODOM, IMU = ("sensor_msgs/Image", "sensor_msgs/PointCloud2",
                         "nav_msgs/Odometry", "sensor_msgs/Imu")


def raw_image(stamp, enc, data: np.ndarray, pad: int = 0) -> bytes:
    """A sensor_msgs/Image of any encoding, rows padded by `pad` bytes (the
    encoders write rgb8 and 32FC1 only)."""
    H, W = data.shape[:2]
    rows = data.reshape(H, -1).view(np.uint8)
    step = rows.shape[1] + pad
    body = np.zeros((H, step), np.uint8)
    body[:, :rows.shape[1]] = rows
    payload = body.tobytes()
    return (trb._w_header(stamp) + struct.pack("<II", H, W) + trb._w_string(enc)
            + trb._u8.pack(0) + trb._u32.pack(step) + trb._u32.pack(len(payload)) + payload)


def raw_cloud_xyz(stamp, pts: np.ndarray) -> bytes:
    """A PointCloud2 with x, y, z only (no rgb field) at a 16-byte step."""
    n = len(pts)
    body = np.zeros((n, 4), "<f4")
    body[:, :3] = pts
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7)]
    fbytes = trb._u32.pack(len(fields)) + b"".join(
        trb._w_string(nm) + trb._u32.pack(off) + trb._u8.pack(dt) + trb._u32.pack(1)
        for nm, off, dt in fields)
    payload = body.tobytes()
    return (trb._w_header(stamp) + struct.pack("<II", 1, n) + fbytes + trb._u8.pack(0)
            + struct.pack("<II", 16, 16 * n) + trb._u32.pack(len(payload)) + payload
            + trb._u8.pack(1))


def messages(rb, seed=0):
    """One seeded message list made with package `rb`'s encoders: every
    message type, an odometry turned 180° and one near it, and images in
    rgb8, bgr8, mono8, 16UC1 and 32FC1 (rows padded)."""
    rng = np.random.default_rng(seed)
    H, W = 6, 5
    msgs = []
    for i in range(3):
        t = 50.0 + 0.1 * i
        img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        pts = rng.normal(size=(20, 3)).astype(np.float32)
        cols = rng.uniform(0, 1, (20, 3)).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        q = rng.normal(size=4)
        pose[:3, :3] = rb._quat_to_rot(*(q / np.linalg.norm(q)))
        pose[:3, 3] = rng.normal(size=3)
        msgs += [("/rgb_img", IMG, t, rb.encode_image(t, img)),
                 ("/cloud_registered", CLOUD, t + 0.01, rb.encode_pointcloud2(t + 0.01, pts, cols)),
                 ("/aft_mapped_to_init", ODOM, t + 0.02, rb.encode_odometry(t + 0.02, pose)),
                 ("/imu", IMU, t + 0.03, rb.encode_imu(t + 0.03, rng.normal(size=3),
                                                       rng.normal(size=3)))]
    for R in (np.diag([-1.0, -1.0, 1.0]), np.array([[-1.0, 1e-4, 0], [-1e-4, -1.0, 0],
                                                    [0, 0, 1.0]])):
        pose = np.eye(4)
        pose[:3, :3] = R
        msgs.append(("/aft_mapped_to_init", ODOM, 51.0, rb.encode_odometry(51.0, pose)))
    msgs.append(("/depth", IMG, 52.0, rb.encode_image(52.0, rng.uniform(0, 5, (H, W)).astype(np.float32))))
    u8 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    msgs.append(("/bgr", IMG, 52.1, raw_image(52.1, "bgr8", u8, pad=3)))
    msgs.append(("/mono", IMG, 52.2, raw_image(52.2, "mono8", u8[..., 0], pad=2)))
    msgs.append(("/d16", IMG, 52.3, raw_image(52.3, "16UC1",
                                              rng.integers(0, 65535, (H, W)).astype("<u2"), pad=4)))
    msgs.append(("/d32", IMG, 52.4, raw_image(52.4, "32FC1",
                                              rng.uniform(0, 9, (H, W)).astype("<f4"), pad=8)))
    cloud = rng.normal(size=(12, 3)).astype(np.float32)
    cloud[3] = np.nan
    msgs.append(("/xyz", CLOUD, 52.5, raw_cloud_xyz(52.5, cloud)))
    return msgs


def _bytes_of(rb, path, msgs):
    rb.write_bag(str(path), msgs)
    return path.read_bytes()


def test_write_bag_is_byte_for_byte(tmp_path):
    """Each package's encoders give the same message bytes, and each
    `write_bag` the same file."""
    jm, tm = messages(jrb), messages(trb)
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        assert a == b
    assert _bytes_of(jrb, tmp_path / "j.bag", jm) == _bytes_of(trb, tmp_path / "t.bag", tm)


def _decode(rb, topic, mtype, raw):
    if mtype == IMG:
        return rb.decode_image(raw)
    if mtype == CLOUD:
        return rb.decode_pointcloud2(raw)
    if mtype == ODOM:
        return rb.decode_odometry(raw)
    return rb.decode_imu(raw)


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def test_read_bag_both_ways_and_codecs_bitwise(tmp_path):
    """Each package's `read_bag` reads the other's bag into identical tuples;
    every codec's output is bitwise the JAX one's, on every message."""
    msgs = messages(trb)
    trb.write_bag(str(tmp_path / "t.bag"), msgs)
    jrb.write_bag(str(tmp_path / "j.bag"), messages(jrb))
    tj = list(trb.read_bag(str(tmp_path / "j.bag")))
    jt = list(jrb.read_bag(str(tmp_path / "t.bag")))
    assert tj == jt and len(tj) == len(msgs)
    assert list(trb.read_bag(str(tmp_path / "t.bag"), topics=["/imu", "/d16"])) == \
        list(jrb.read_bag(str(tmp_path / "t.bag"), topics=["/imu", "/d16"]))
    for topic, mtype, _, raw in tj:
        got, want = _decode(trb, topic, mtype, raw), _decode(jrb, topic, mtype, raw)
        assert _same(got, want), topic
    # the rgb-less cloud got the mid-gray colors, its NaN point dropped
    _, pts, cols = trb.decode_pointcloud2(tj[-1][3])
    assert pts.shape == (11, 3) and (cols == 0.5).all()


@pytest.mark.parametrize("comp", ["bz2", "lz4"])
def test_hand_built_chunk_compression(tmp_path, comp):
    """A bag whose one chunk is bz2-compressed reads alike in both; an lz4
    chunk is refused by both, naming it."""
    msgs = messages(trb)[:8]
    plain = tmp_path / "plain.bag"
    trb.write_bag(str(plain), msgs)
    data = plain.read_bytes()
    # the writer's layout: magic, the bag header record, one chunk record
    off = len(trb.MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    (dlen,) = struct.unpack_from("<I", data, off + 4 + hlen)
    head = data[:off + 8 + hlen + dlen]
    chunk_off = off + 8 + hlen + dlen
    (chlen,) = struct.unpack_from("<I", data, chunk_off)
    body = data[chunk_off + 8 + chlen:]
    packed = bz2.compress(body) if comp == "bz2" else b"\x04\x22\x4d\x18junk"
    path = tmp_path / f"{comp}.bag"
    path.write_bytes(head + trb._record(
        {b"op": b"\x05", b"compression": comp.encode(), b"size": trb._u32.pack(len(body))},
        packed))
    if comp == "lz4":
        for rb in (trb, jrb):
            with pytest.raises(ValueError, match="lz4"):
                list(rb.read_bag(str(path)))
        return
    got, want = list(trb.read_bag(str(path))), list(jrb.read_bag(str(path)))
    assert got == want and [m[3] for m in got] == [m[3] for m in msgs]


def _jittered_stream(seed, n=40, drop=0.15):
    """Three streams at 10 Hz with up to ±60 ms jitter, each message dropped
    with probability `drop`, merged in stamp order."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(3):
        for i in range(n):
            if rng.uniform() < drop:
                continue
            out.append((0.1 * i + rng.uniform(-0.06, 0.06), s, f"{s}:{i}"))
    out.sort()
    return out


@pytest.mark.parametrize("queue_size,slop", [(10, 0.1), (3, 0.05)])
def test_synchronizer_matches(queue_size, slop):
    """The same groups, emitted at the same messages, on a seeded jittered
    stream with drops."""
    stream = _jittered_stream(7)
    a = trb.ApproximateTimeSynchronizer(3, queue_size, slop)
    b = jrb.ApproximateTimeSynchronizer(3, queue_size, slop)
    n = 0
    for stamp, s, msg in stream:
        got, want = a.add(s, stamp, msg), b.add(s, stamp, msg)
        assert got == want
        n += len(got)
    assert n > 5


@pytest.fixture(scope="module")
def synthetic_frames():
    return list(SyntheticDataset(n_frames=3, width=32, height=24, n_world=2048,
                                 pts_per_frame=512, step=0.1, clutter=0.35,
                                 imu_substeps=5, device="cpu"))


@pytest.mark.parametrize("lidar_axes", [False, True])
def test_rosbag_dataset_frames_match(synthetic_frames, tmp_path, lidar_axes):
    """`RosbagDataset` of both packages on one bag: every field of every
    frame bitwise (image, points, colors, pose, timestamp, IMU, scan)."""
    bag = tmp_path / "seq.bag"
    write_rosbag(str(bag), synthetic_frames)
    kw = dict(imu_topic="/imu", lidar_axes=lidar_axes)
    tf, jf = list(trb.RosbagDataset(str(bag), **kw)), list(jrb.RosbagDataset(str(bag), **kw))
    assert len(tf) == len(jf) == 3
    for a, b in zip(tf, jf):
        for name in ("image", "points", "colors", "pose", "scan", "imu", "depth"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert _same(x, y), name
        assert a.timestamp == b.timestamp
    # frame 1's samples, led by the bag's first one (dt 0, as the reader
    # gives the first sample of a bag)
    assert tf[0].imu is None and tf[1].imu.shape == (6, 7) and tf[1].imu[0, 6] == 0.0
    for i in (1, 2):
        np.testing.assert_allclose(tf[i].imu[-5:], synthetic_frames[i].imu, atol=1e-6)
    if not lidar_axes:
        np.testing.assert_allclose(tf[2].pose, synthetic_frames[2].pose, atol=1e-6)
        np.testing.assert_allclose(tf[2].scan, synthetic_frames[2].scan, atol=1e-5)


@pytest.fixture(scope="module")
def jax_rosbag_run(synthetic_frames, tmp_path_factory):
    """The JAX CLI's run-slam over the tiny bag, resumed from a checkpoint of
    a fresh port state in `tiny_config` (the JAX package reads the port's
    checkpoints), shared by the cases below."""
    d = tmp_path_factory.mktemp("bag")
    bag, ck = str(d / "seq.bag"), str(d / "init")
    write_rosbag(bag, synthetic_frames)
    cfg = tiny_config()
    tckpt.save_state(ck, t_step.init_state(cfg, seed=0, device="cpu"), cfg)
    argv = ["run-slam", "--dataset", "rosbag", "--path", bag, "--resume", ck,
            "--tracking", "gicp", "--post-train", "1", "--point-budget", "256",
            "--imu-topic", "/imu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jcli.main([*argv, "--traj-out", str(d / "j.txt")])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return argv, line, np.loadtxt(d / "j.txt"), d


def test_run_slam_rosbag_matches_jax_cli(jax_rosbag_run, capsys):
    """run-slam --dataset rosbag, both CLIs on one bag (32x24, 3 frames):
    the same JSON keys, frame count and tracker, no eval (a streamed
    source), and the trajectory within POSE_ATOL."""
    argv, jl, jtraj, d = jax_rosbag_run
    capsys.readouterr()
    res = tcli.main([*argv, "--device", "cpu", "--traj-out", str(d / "t.txt")])
    tl = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(tl) == set(jl) == RUN_SLAM_KEYS
    assert tl["frames"] == jl["frames"] == 3 and tl["tracking"] == jl["tracking"] == "gicp"
    assert tl["mean_psnr"] is None and jl["mean_psnr"] is None
    assert np.isfinite(tl["ate_rmse"]) and abs(tl["ate_rmse"] - jl["ate_rmse"]) <= POSE_ATOL
    ttraj = np.loadtxt(d / "t.txt")
    assert ttraj.shape == jtraj.shape == (3, 8)
    np.testing.assert_allclose(ttraj, jtraj, atol=POSE_ATOL)
    np.testing.assert_allclose(res.poses_est[:, :3, 3], ttraj[:, 1:4], atol=1e-6)
