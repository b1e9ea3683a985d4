"""Port parity: the dataset readers of `io/datasets.py` (TUM, Replica,
Blender, KITTI, the timestamp association, the depth back-projection,
`scannetpp_to_traj`) and the PNG decoder of `io/images.py` against
`sags_tpu.io.datasets` and `imageio` on fixture directories the tests
write, and `run-gicp --dataset kitti` of both packages' CLIs."""

import json
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from sags_tpu.cli import main as jcli
from sags_tpu.io import datasets as jds
from sags_tpu_torch.cli import main as tcli
from sags_tpu_torch.io import datasets as tds
from sags_tpu_torch.io import images
from test_kitti_traj import _write_kitti_seq
from test_torch_cli import CHAIN_ATOL, POSE_ATOL, last_json
import torch_support

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py


def png_bytes(img: np.ndarray, filters=(0, 1, 2, 3, 4)) -> bytes:
    """`img` ([H,W] or [H,W,C] uint8 / uint16) as a PNG whose rows cycle
    through `filters` (the CLI's writer uses filter 0 only)."""
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    H, W = img.shape[:2]
    raw = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1).view(np.uint8)
    bpp = ch * depth // 8
    rows = []
    for y in range(H):
        x = raw[y].astype(np.int32)
        b = raw[y - 1].astype(np.int32) if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        rows.append(bytes([f]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (images.PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def write_png(path, img, filters=(0, 1, 2, 3, 4)):
    with open(path, "wb") as f:
        f.write(png_bytes(img, filters))


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray8", "gray16"])
def test_png_decoder_matches_imageio(tmp_path, kind):
    """Every row filter, 8-bit RGB, RGBA and gray and 16-bit gray: the
    decoder gives the image and what `imageio` reads, bitwise; a PNG that
    Pillow wrote (its own filter choice) too."""
    rng = np.random.default_rng(len(kind))
    H, W = 11, 13
    shape = {"rgb8": (H, W, 3), "rgba8": (H, W, 4), "gray8": (H, W), "gray16": (H, W)}[kind]
    hi = 65536 if kind == "gray16" else 256
    img = rng.integers(0, hi, shape).astype(np.uint16 if kind == "gray16" else np.uint8)
    img[3:6, 2:9] = img[3, 2]  # flat runs, where Sub / Up / Paeth predict well
    path = tmp_path / "a.png"
    write_png(path, img)
    got, ref = images.imread(str(path)), np.asarray(imageio.imread(path))
    assert got.dtype == ref.dtype == img.dtype and got.shape == ref.shape == img.shape
    assert np.array_equal(got, ref) and np.array_equal(got, img)
    imageio.imwrite(tmp_path / "b.png", img)
    assert np.array_equal(images.imread(str(tmp_path / "b.png")), img)


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_cli_write_png_reads_back(tmp_path, kind):
    """The CLI's writer: an [H,W,3] uint8 image as 8-bit RGB, an [H,W]
    uint16 one as 16-bit gray; `imageio` and the port's decoder read the
    image back bitwise."""
    rng = np.random.default_rng(7)
    shape, hi, dtype = {"rgb8": ((9, 14, 3), 256, np.uint8),
                        "gray16": ((9, 14), 65536, np.uint16)}[kind]
    img = rng.integers(0, hi, shape).astype(dtype)
    path = str(tmp_path / "a.png")
    tcli.write_png(path, img)
    ref = np.asarray(imageio.imread(path))
    assert ref.dtype == dtype and np.array_equal(ref, img)
    assert np.array_equal(images.imread(path), img)


def test_imread_other_formats_go_through_imageio(tmp_path, monkeypatch):
    """A non-PNG file goes through imageio; without it the reader raises
    ImportError naming it and never falls back."""
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3)).astype(np.uint8)
    imageio.imwrite(tmp_path / "a.bmp", img)
    assert np.array_equal(images.imread(str(tmp_path / "a.bmp")), np.asarray(
        imageio.imread(tmp_path / "a.bmp")))
    import sys

    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imageio"):
        images.imread(str(tmp_path / "a.bmp"))


def test_associate_timestamps_and_backproject():
    """`tests/test_io_semantics.py:59`'s case and a seeded jittered pair give
    the same pairs; `backproject_depth` is bitwise the JAX package's."""
    a, b = [0.0, 1.0, 2.0, 3.0], [0.02, 1.5, 2.95]
    assert tds.associate_timestamps(a, b, 0.08) == jds.associate_timestamps(a, b, 0.08)
    assert (0, 0) in tds.associate_timestamps(a, b) and (3, 2) in tds.associate_timestamps(a, b)
    rng = np.random.default_rng(1)
    ta = np.sort(rng.uniform(0, 10, 120)).tolist()
    tb = sorted(t + rng.normal(0, 0.05) for t in ta if rng.uniform() > 0.2)
    for dt in (0.02, 0.08):
        got = tds.associate_timestamps(ta, tb, dt)
        assert got == jds.associate_timestamps(ta, tb, dt) and len(got) > 10
    depth = rng.uniform(0, 12, (24, 32)).astype(np.float32)
    depth[::5, ::3] = 0.0
    rgb = rng.uniform(0, 1, (3, 24, 32)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    for stride in (1, 4):
        got = tds.backproject_depth(depth, rgb, 30.0, 31.0, 16.0, 12.0, pose, stride)
        want = jds.backproject_depth(depth, rgb, 30.0, 31.0, 16.0, 12.0, pose, stride)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _frames_equal(tf, jf, pose_atol=0.0):
    assert len(tf) == len(jf) > 0
    for a, b in zip(tf, jf):
        for name in ("image", "points", "colors", "depth", "scan"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert (a.pose is None) == (b.pose is None)
        if a.pose is not None:
            assert a.pose.dtype == b.pose.dtype
            np.testing.assert_allclose(a.pose, b.pose, atol=pose_atol, rtol=0)
        assert a.timestamp == b.timestamp


def _rgbd(rng, H=24, W=32, scale=5000.0):
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    depth = (rng.uniform(0.02, 12.0, (H, W)) * scale).astype(np.uint16)
    return rgb, depth


def test_tum_reader_matches(tmp_path):
    """TUM layout with depth and ground-truth stamps a few ms off the rgb
    ones (and one rgb frame without a depth match): the same items and
    frames, images and depths bitwise, poses within 1e-6."""
    rng = np.random.default_rng(2)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rgb_l, depth_l, gt_l = ["# rgb"], ["# depth"], ["# timestamp tx ty tz qx qy qz qw"]
    for i in range(6):
        t = 1305031102.0 + 0.1 * i
        rgb, depth = _rgbd(rng)
        write_png(tmp_path / "rgb" / f"{t:.6f}.png", rgb)
        rgb_l.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i != 3:
            td = t + 0.004 * (i % 3)
            write_png(tmp_path / "depth" / f"{td:.6f}.png", depth)
            depth_l.append(f"{td:.6f} depth/{td:.6f}.png")
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        gt_l.append(f"{t - 0.003:.4f} " + " ".join(f"{v:.6f}" for v in (*rng.normal(size=3), *q)))
    for name, lines in (("rgb.txt", rgb_l), ("depth.txt", depth_l), ("groundtruth.txt", gt_l)):
        (tmp_path / name).write_text("\n".join(lines) + "\n")
    t_ds, j_ds = tds.TUMDataset(str(tmp_path)), jds.TUMDataset(str(tmp_path))
    assert len(t_ds) == len(j_ds) == 5
    assert [it[:3] for it in t_ds.items] == [it[:3] for it in j_ds.items]
    _frames_equal(list(t_ds), list(j_ds), pose_atol=1e-6)


def test_replica_reader_matches(tmp_path):
    """Replica layout with PNG colour frames (as valid as JPEG for the
    reader's `frame*` listing): frames bitwise, poses bitwise."""
    rng = np.random.default_rng(3)
    (tmp_path / "results").mkdir()
    poses = []
    for i in range(4):
        rgb, depth = _rgbd(rng, scale=6553.5)
        write_png(tmp_path / "results" / f"frame{i:06d}.png", rgb)
        write_png(tmp_path / "results" / f"depth{i:06d}.png", depth)
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.normal(size=3)
        poses.append(T.reshape(-1))
    np.savetxt(tmp_path / "traj.txt", np.stack(poses))
    t_ds, j_ds = tds.ReplicaDataset(str(tmp_path)), jds.ReplicaDataset(str(tmp_path))
    assert len(t_ds) == len(j_ds) == 4
    _frames_equal(list(t_ds), list(j_ds))


@pytest.mark.parametrize("white", [False, True])
def test_blender_reader_matches(tmp_path, white):
    """NeRF-synthetic layout, RGBA PNGs composited on either background,
    a `file_path` with and one without its extension: frames bitwise."""
    rng = np.random.default_rng(4)
    frames = []
    for i in range(3):
        img = rng.integers(0, 256, (16, 20, 4)).astype(np.uint8)
        write_png(tmp_path / f"r_{i}.png", img)
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.normal(size=3)
        frames.append({"file_path": f"./r_{i}" + (".png" if i == 1 else ""),
                       "transform_matrix": T.tolist()})
    (tmp_path / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.69, "frames": frames}))
    t_ds = tds.BlenderDataset(str(tmp_path), white_background=white)
    j_ds = jds.BlenderDataset(str(tmp_path), white_background=white)
    assert t_ds.camera_angle_x == j_ds.camera_angle_x and len(t_ds) == 3
    _frames_equal(list(t_ds), list(j_ds))


def test_scannetpp_to_traj_same_bytes(tmp_path):
    rng = np.random.default_rng(5)
    frames = [{"file_path": f"DSC{9 - i:05d}.JPG", "transform_matrix": rng.normal(size=(4, 4)).tolist()}
              for i in range(5)]
    (tmp_path / "t.json").write_text(json.dumps({"frames": frames}))
    tds.scannetpp_to_traj(str(tmp_path / "t.json"), str(tmp_path / "t.txt"))
    jds.scannetpp_to_traj(str(tmp_path / "t.json"), str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("variant", ["calib_colon", "calib_bare", "no_calib", "max_points",
                                     "pose_less"])
def test_kitti_reader_matches(tmp_path, variant):
    """KITTI velodyne layout (`tests/test_kitti_traj.py`'s sequence, a NaN
    point added): times, poses through `Tr` (with or without the colon) or
    without calib, `max_points`, and the pose-less stream: frames bitwise,
    poses within 1e-6."""
    _write_kitti_seq(tmp_path, n_frames=3, with_calib=True)
    velo = tmp_path / "velodyne"
    rec = np.fromfile(velo / "000001.bin", np.float32).reshape(-1, 4)
    rec[5, 1] = np.nan
    rec.tofile(velo / "000001.bin")
    if variant == "calib_bare":
        text = (tmp_path / "calib.txt").read_text().replace("Tr: ", "Tr ")
        (tmp_path / "calib.txt").write_text(text)
    kw = dict(poses_file=str(tmp_path / "poses.txt"), times_file=str(tmp_path / "times.txt"),
              calib_file=str(tmp_path / "calib.txt"))
    if variant == "no_calib":
        kw.pop("calib_file")
    if variant == "max_points":
        kw["max_points"] = 500
    if variant == "pose_less":
        kw = dict(times_file=kw["times_file"])
    t_ds = tds.KITTIOdometryDataset(str(velo), **kw)
    j_ds = jds.KITTIOdometryDataset(str(velo), **kw)
    assert t_ds.has_gt == j_ds.has_gt == (variant != "pose_less") and len(t_ds) == 3
    if variant.startswith("calib"):
        np.testing.assert_array_equal(t_ds._read_calib_tr(kw["calib_file"]),
                                      j_ds._read_calib_tr(kw["calib_file"]))
    _frames_equal(list(t_ds), list(j_ds), pose_atol=1e-6)
    if variant == "max_points":
        assert len(t_ds.scan(0)) == 500


@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti")
    _write_kitti_seq(d, n_frames=4, with_calib=True)
    return d


@pytest.mark.parametrize("mode,atol", [("scan", POSE_ATOL), ("map", CHAIN_ATOL)])
def test_run_gicp_kitti_matches_jax_cli(kitti_seq, mode, atol, tmp_path, capsys):
    """run-gicp --dataset kitti with --poses, --times and --calib, both
    packages' CLIs: the same JSON keys and values of `frames`, `method`,
    `mode`; pose files and ATEs within POSE_ATOL scan to scan and CHAIN_ATOL
    to the keyframe map (`tests/test_torch_cli.py`'s bars)."""
    d = kitti_seq
    argv = ["run-gicp", "--dataset", "kitti", "--path", str(d / "velodyne"), "--poses",
            str(d / "poses.txt"), "--times", str(d / "times.txt"), "--calib",
            str(d / "calib.txt"), "--mode", mode, "--keyframe-every", "2"]
    jcli.main([*argv, "--out-poses", str(tmp_path / "j.txt")])
    jl = last_json(capsys)
    poses = tcli.main([*argv, "--device", "cpu", "--out-poses", str(tmp_path / "t.txt")])
    tl = last_json(capsys)
    assert set(tl) == set(jl)
    assert all(tl[k] == jl[k] for k in ("frames", "method", "mode")) and tl["frames"] == 4
    Tt, Tj = np.loadtxt(tmp_path / "t.txt"), np.loadtxt(tmp_path / "j.txt")
    np.testing.assert_allclose(Tt, Tj, atol=atol)
    np.testing.assert_allclose(Tt, poses[:, :3, :4].reshape(4, 12), atol=1e-6)
    assert abs(tl["ate_rmse"] - jl["ate_rmse"]) <= atol and tl["ate_rmse"] < 0.05


def test_run_gicp_kitti_pose_less(kitti_seq, capsys):
    """Without --poses there is no ground truth: `ate_rmse` is null and
    nothing raises; with --poses and no --calib the CLI warns."""
    d = kitti_seq
    argv = ["run-gicp", "--dataset", "kitti", "--path", str(d / "velodyne"), "--device", "cpu"]
    tcli.main(argv)
    line = last_json(capsys)
    assert line["frames"] == 4 and line["ate_rmse"] is None
    tcli.main([*argv, "--poses", str(d / "poses.txt")])
    captured = capsys.readouterr()
    assert "--calib" in captured.err
    assert json.loads(captured.out.strip().splitlines()[-1])["ate_rmse"] is not None


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """3 frames of the CLI's synthetic stream at 64x48 (the eval's LPIPS needs
    that much), and a checkpoint of a fresh state in `tests/test_torch_cli.py`'s
    tiny config to resume from."""
    from sags_tpu_torch.slam import checkpoint as tckpt
    from sags_tpu_torch.slam import step as t_step
    from test_torch_cli import tiny_config

    frames = list(tds.SyntheticDataset(n_frames=3, width=64, height=48, n_world=2048,
                                       pts_per_frame=512, step=0.1, clutter=0.35,
                                       imu_substeps=5, device="cpu"))
    ck = str(tmp_path_factory.mktemp("ck") / "init")
    cfg = tiny_config()
    tckpt.save_state(ck, t_step.init_state(cfg, seed=0, device="cpu"), cfg)
    return frames, ck


@pytest.mark.parametrize("name", ["tum", "replica"])
def test_stream_as_tum_or_replica_reads_back_and_runs(stream, name, tmp_path, capsys):
    """The TUM and Replica writers of `torch_support`: both packages'
    readers give the same frames, the images and depths are the written
    ones to their quantization, the poses the stream's (Replica bitwise,
    TUM through its quaternion within 1e-6); run-slam on the directory (a
    list source, so it evaluates) reports finite metrics."""
    frames, ck = stream
    writer, scale = {"tum": (torch_support.write_tum, 5000.0),
                     "replica": (torch_support.write_replica, 6553.5)}[name]
    writer(str(tmp_path), frames)
    t_cls, j_cls = {"tum": (tds.TUMDataset, jds.TUMDataset),
                    "replica": (tds.ReplicaDataset, jds.ReplicaDataset)}[name]
    back = list(t_cls(str(tmp_path)))
    _frames_equal(back, list(j_cls(str(tmp_path))), pose_atol=1e-6)
    assert len(back) == 3
    for f, b in zip(frames, back):
        rgb, d16 = torch_support.quantized(f, scale)
        assert np.array_equal(b.image, rgb.transpose(2, 0, 1).astype(np.float32) / 255.0)
        assert np.array_equal(b.depth, d16.astype(np.float32) / np.float32(scale))
        np.testing.assert_allclose(b.pose, f.pose, atol=1e-6 if name == "tum" else 0, rtol=0)
    tcli.main(["run-slam", "--dataset", name, "--path", str(tmp_path), "--resume", ck,
               "--tracking", "gicp", "--post-train", "1", "--point-budget", "256",
               "--device", "cpu"])
    line = last_json(capsys)
    assert line["frames"] == 3 and line["tracking"] == "gicp"
    for k in ("ate_rmse", "mean_psnr", "mean_ssim"):
        assert line[k] is not None and np.isfinite(line[k]), k


def test_stream_as_kitti_reads_back(stream, tmp_path):
    """The KITTI writer of `torch_support`: the scans come back bitwise and
    the poses, through the calib's non-identity Tr, within 1e-6 of the
    stream's, in both packages' readers."""
    frames, _ = stream
    kp = torch_support.write_kitti(str(tmp_path), frames)
    kw = dict(poses_file=kp["poses.txt"], times_file=kp["times.txt"],
              calib_file=kp["calib.txt"])
    back = list(tds.KITTIOdometryDataset(kp["velodyne"], **kw))
    _frames_equal(back, list(jds.KITTIOdometryDataset(kp["velodyne"], **kw)), pose_atol=1e-6)
    for f, b in zip(frames, back):
        assert np.array_equal(b.scan, f.scan)
        np.testing.assert_allclose(b.pose, f.pose, atol=1e-6, rtol=0)
        assert abs(b.timestamp - f.timestamp) < 1e-9
