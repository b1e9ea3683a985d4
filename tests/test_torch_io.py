"""Port parity of the offline readers and writers (`sags_tpu_torch.io.colmap`,
`colmap_scene`, `ply`, `pcd` against `sags_tpu.io`): each package reads the
files the other writes (COLMAP models are written here, in text and binary),
the COLMAP scene of `tests/test_colmap_scene.py`'s recipe assembles alike in
both, and a short `train_offline_scene` run agrees. Each test states its
bars."""

import os
import struct

import jax
import numpy as np
import pytest
import torch

from sags_tpu.core import config as jconf
from sags_tpu.io import colmap as jcolmap
from sags_tpu.io import colmap_scene as jscene
from sags_tpu.io import pcd as jpcd
from sags_tpu.io import ply as jply
from sags_tpu.mapping import gaussian_map as jgm
from sags_tpu.slam import offline as joff
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.core.camera import focal2fov, make_camera
from sags_tpu_torch.io import colmap as tcolmap
from sags_tpu_torch.io import colmap_scene as tscene
from sags_tpu_torch.io import datasets as tdatasets
from sags_tpu_torch.io import pcd as tpcd
from sags_tpu_torch.io import ply as tply
from sags_tpu_torch.mapping import gaussian_map as tgm
from sags_tpu_torch.ops import rasterize as trz
from sags_tpu_torch.slam import offline as toff
from sags_tpu_torch.utils.draws import ReplayDraws
from test_colmap_scene import _write_colmap_text_model

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

T = lambda a: torch.from_numpy(np.array(a))
W, H, F = 64, 48, 60.0


def _poses(n=4):
    """Camera-to-world (R, centre) of `n` views: a small sideways sweep,
    the last two turned a little about y."""
    out = []
    for i in range(n):
        a = 0.05 * (i - 1) if i >= 2 else 0.0
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                     np.float32)
        out.append((R, np.array([0.3 * (i - 1), 0.05 * i, 0.0], np.float32)))
    return out


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """`tests/test_colmap_scene.py`'s recipe (512 points in a box 4 m out,
    PINHOLE 64×48, f = 60, images as .npy renders, an empty points2D line per
    image), rendered by the port, with four views and a depth map for one."""
    root = tmp_path_factory.mktemp("colmap_io")
    rng = np.random.default_rng(0)
    n = 512
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    cols = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    cams = {1: ("PINHOLE", W, H, [F, F, W / 2, H / 2])}
    imgs = {}
    os.makedirs(root / "images", exist_ok=True)
    cfg = tconf.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=256, chunk=64)
    for i, (R, c) in enumerate(_poses()):
        qvec = tcolmap.rotmat2qvec(R.T)  # world→cam, as COLMAP stores it
        imgs[i + 1] = (qvec.tolist(), (-R.T @ c).tolist(), 1, f"view{i}.npy")
        cam = make_camera(T(R), T(c), W, H, focal2fov(F, W), focal2fov(F, H))
        out = trz.rasterize(T(pts), torch.full((n,), 0.8), torch.full((n, 3), 0.05),
                            torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(n, 1), cam, cfg,
                            colors=T(cols))
        np.save(root / "images" / f"view{i}.npy", out.color.numpy().transpose(1, 2, 0))
    _write_colmap_text_model(root, cams, imgs, pts.tolist(), (cols * 255).tolist())
    os.makedirs(root / "depth_images")
    tscene.write_depth_bin(str(root / "depth_images" / "view1.bin"),
                           rng.uniform(0.5, 5.0, (H, W)).astype(np.float32))
    return str(root)


def _write_binary_model(d, cams, imgs, xyz, rgb, err):
    """cameras.bin, images.bin, points3D.bin in COLMAP's binary layout."""
    os.makedirs(d, exist_ok=True)
    ids = {v[0]: k for k, v in jcolmap.CAMERA_MODELS.items()}
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, (model, w, h, params) in cams.items():
            f.write(struct.pack("<iiQQ", cid, ids[model], w, h))
            f.write(struct.pack("<" + "d" * len(params), *params))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid, (qvec, tvec, cam_id, name, n_pts) in imgs.items():
            f.write(struct.pack("<i4d3di", iid, *qvec, *tvec, cam_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", n_pts))
            f.write(b"\x00" * (24 * n_pts))
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c, e) in enumerate(zip(xyz, rgb, err)):
            f.write(struct.pack("<QdddBBBd", i + 1, *p, *c, e))
            f.write(struct.pack("<Q", 2))
            f.write(b"\x00" * 16)


def _assert_models_equal(a, b):
    ca, ia, xa, ra = a
    cb, ib, xb, rb = b
    assert sorted(ca) == sorted(cb) and sorted(ia) == sorted(ib)
    for k in ca:
        assert ca[k][:4] == cb[k][:4]
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == (ib[k].id, ib[k].camera_id, ib[k].name)
        np.testing.assert_array_equal(ia[k].qvec, ib[k].qvec)
        np.testing.assert_array_equal(ia[k].tvec, ib[k].tvec)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ra, rb)


def test_colmap_text_and_binary_models_read_alike(scene_dir, tmp_path):
    """The text model of the scene and a binary model (two cameras, a
    featured image, a 0-feature one) read identically by both packages;
    qvec ↔ rotmat to 1e-6."""
    sparse = os.path.join(scene_dir, "sparse", "0")
    _assert_models_equal(tcolmap.load_colmap_model(sparse), jcolmap.load_colmap_model(sparse))
    rng = np.random.default_rng(1)
    cams = {1: ("PINHOLE", 640, 480, [500.0, 501.0, 320.0, 240.0]),
            3: ("SIMPLE_PINHOLE", 320, 240, [250.0, 160.0, 120.0])}
    imgs = {1: ([0.9999, 0.01, 0.0, 0.0], [0.5, 0.2, 0.1], 1, "a.png", 3),
            7: ([0.7, 0.1, -0.7, 0.1], [-1.0, 0.0, 2.5], 3, "dir/b.png", 0)}
    xyz = rng.normal(size=(20, 3))
    rgb = rng.integers(0, 256, (20, 3))
    err = rng.uniform(0, 2, 20)
    d = str(tmp_path / "bin")
    _write_binary_model(d, cams, imgs, xyz, rgb, err)
    got, want = tcolmap.load_colmap_model(d), jcolmap.load_colmap_model(d)
    _assert_models_equal(got, want)
    assert got[1][7].name == "dir/b.png" and got[0][3].model == "SIMPLE_PINHOLE"
    np.testing.assert_array_equal(tcolmap.read_points3d_binary(os.path.join(d, "points3D.bin"))[2],
                                  err)
    for q in ([0.9999, 0.01, 0.0, 0.0], [0.7, 0.1, -0.7, 0.1]):
        q = np.asarray(q) / np.linalg.norm(q)
        R = tcolmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_allclose(tcolmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R), atol=1e-6)


@pytest.mark.parametrize("eval_split", [False, True])
def test_load_colmap_scene_matches_jax(scene_dir, eval_split):
    """Cameras (matrices to 1e-6), images, depths, names, points, colours,
    radius and the llffhold split equal; the resolution policy the same."""
    kw = dict(eval_split=eval_split, llffhold=3)
    got = tscene.load_colmap_scene(scene_dir, device="cpu", **kw)
    want = jscene.load_colmap_scene(scene_dir, **kw)
    assert len(got.train_views) == len(want.train_views) == (2 if eval_split else 4)
    assert len(got.test_views) == len(want.test_views) == (2 if eval_split else 0)
    for gv, wv in zip(got.train_views + got.test_views, want.train_views + want.test_views):
        assert gv.name == wv.name
        np.testing.assert_array_equal(gv.image, wv.image)
        assert (gv.depth is None) == (wv.depth is None)
        if gv.depth is not None:
            np.testing.assert_array_equal(gv.depth, wv.depth)
        gc, wc = gv.camera, wv.camera
        assert (gc.width, gc.height) == (wc.width, wc.height)
        assert abs(gc.fovx - float(wc.fovx)) <= 1e-7 and abs(gc.fovy - float(wc.fovy)) <= 1e-7
        for f in ("world_view", "full_proj", "cam_center"):
            np.testing.assert_allclose(getattr(gc, f).numpy(), np.asarray(getattr(wc, f)),
                                       atol=1e-6, err_msg=f)
    assert sum(v.depth is not None for v in got.train_views + got.test_views) == 1
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.radius == want.radius
    np.testing.assert_array_equal(got.translate, want.translate)
    from sags_tpu.io.datasets import resolution_policy

    for args in ((640, 480, -1), (3200, 1800, -1), (640, 480, 2), (640, 480, 1)):
        assert tdatasets.resolution_policy(*args) == resolution_policy(*args)


def test_depth_bin_both_ways(tmp_path):
    d = np.random.default_rng(3).uniform(0.1, 9.0, (48, 64)).astype(np.float32)
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    tscene.write_depth_bin(a, d)
    jscene.write_depth_bin(b, d)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(tscene.read_depth_bin(b), d)
    np.testing.assert_array_equal(jscene.read_depth_bin(a, 2.0), tscene.read_depth_bin(a, 2.0))


def _port_map(rng, cap=64, n=40, sh_degree=1):
    cfg = tconf.MapConfig(sh_degree=sh_degree)
    m = tgm.init_map(cap, cfg, "cpu")
    m, _ = tgm.add_points(m, T(rng.normal(size=(n, 3)).astype(np.float32)),
                          T(rng.uniform(size=(n, 3)).astype(np.float32)),
                          torch.ones(n, dtype=torch.bool),
                          ReplayDraws([rng.uniform(size=(n, 16))], "cpu"))
    m.f_rest.copy_(T(rng.normal(size=tuple(m.f_rest.shape)).astype(np.float32)))
    m.quats.copy_(T(rng.normal(size=(cap, 4)).astype(np.float32)))
    m.active[::5] = False
    return m, cfg


def test_ply_both_ways(tmp_path):
    """A port map's active rows through each package's writer and reader:
    every field bitwise, the map built by either `load_map_ply` equal."""
    m, cfg = _port_map(np.random.default_rng(4))
    act = m.active.numpy()
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    tply.save_map_ply(a, m)
    jply.save_ply(b, *(getattr(m, f).numpy()[act] for f in
                       ("xyz", "f_dc", "f_rest", "opacity_logit", "log_scales", "quats",
                        "obj_dc")))
    for path in (a, b):
        got, want = tply.load_ply(path), jply.load_ply(path)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], getattr(m, k).numpy()[act], err_msg=k)
    tm = tply.load_map_ply(a, device="cpu")
    jm = jply.load_map_ply(a)
    assert tm.capacity == jm.capacity == 32 and int(tm.count) == int(act.sum())
    for f in tgm.GaussianMap._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)


def test_pcd_both_ways(tmp_path):
    pts = np.random.default_rng(5).normal(size=(100, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
    tpcd.save_pcd(a, pts)
    jpcd.save_pcd(b, pts)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(tpcd.load_pcd(b), pts)
    np.testing.assert_array_equal(jpcd.load_pcd(a), pts)
    c = str(tmp_path / "c.pcd")
    with open(c, "w") as f:
        f.write("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
                "COUNT 1 1 1 1\nWIDTH 3\nHEIGHT 1\nPOINTS 3\nDATA ascii\n"
                "1 2 3 0.5\n4 5 6 0.1\n7 8 9 0.2\n")
    np.testing.assert_array_equal(tpcd.load_pcd(c, ("x", "z", "intensity")),
                                  jpcd.load_pcd(c, ("x", "z", "intensity")))


def test_train_offline_scene_matches_jax(scene_dir):
    """6 iterations on the scene, JAX's draws replayed (no densify event):
    losses to 1e-4 relative and finite, `active` and `count` exact."""
    kw = dict(raster=dict(max_tiles_per_gaussian=16, tile_capacity=256, chunk=64,
                          windowed=False), opt=dict(densify_from_iter=10_000))

    def cfg(mod):
        return mod.SLAMConfig(raster=mod.RasterizeConfig(**kw["raster"]),
                              map=mod.MapConfig(initial_capacity=2048),
                              opt=mod.OptimizationConfig(**kw["opt"]))

    jsc = jscene.load_colmap_scene(scene_dir)
    tsc = tscene.load_colmap_scene(scene_dir, device="cpu")
    r1, _ = jax.random.split(jax.random.key(0))
    draws = [np.asarray(jax.random.uniform(r1, (len(jsc.points), 16)))]
    js, jl = joff.train_offline_scene(jsc, cfg(jconf), iterations=6)
    ts, tl = toff.train_offline_scene(tsc, cfg(tconf), iterations=6, device="cpu",
                                      draws=ReplayDraws(draws, "cpu"))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert np.isfinite(tl).all()
    for f in ("active", "count"):
        np.testing.assert_array_equal(getattr(ts.map, f).numpy(), np.asarray(getattr(js.map, f)))
    assert int(jgm.n_active(js.map)) == 512
