"""The frame maker and the work counts."""

import math

import numpy as np
import pytest
import torch

from benchmarks.data import frames as fd
from benchmarks.harness import work
from benchmarks.reference import render as rr


def _spec():
    return fd.StreamSpec(width=64, height=48, fx=43.2, fy=43.2, cx=31.8, cy=23.6,
                         n_world_per_20m=4096, pts_per_frame=256, step=0.075, clutter=0.3)


def test_frame_maker_is_deterministic_by_seed():
    a = fd.make_pool(_spec(), 6, 2 ** 31 + 7, "cpu")
    b = fd.make_pool(_spec(), 6, 2 ** 31 + 7, "cpu")
    c = fd.make_pool(_spec(), 6, 2 ** 31 + 8, "cpu")
    for x, y in zip((a.world_xyz, a.images, a.sel, a.poses), (b.world_xyz, b.images, b.sel, b.poses)):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.images, c.images)
    assert a.images.shape == (6, 3, 48, 64) and 0.0 <= a.images.min() and a.images.max() <= 1.0
    assert (a.images.sum(1) > 0).mean() > 0.2  # the world covers the view
    # a scan is its world points in the sensor frame
    T = a.poses[3]
    assert np.allclose(a.scan(3) @ T[:3, :3].T + T[:3, 3], a.points(3), atol=1e-5)


def test_patrol_goes_there_and_back():
    assert [fd.patrol(k, 4) for k in range(9)] == [0, 1, 2, 3, 2, 1, 0, 1, 2]


def _one(x, y, op, s=1e-4):
    return (torch.tensor([[x, y, 5.0]]), torch.tensor([op]), torch.full((1, 3), s))


def _scene(stack):
    """Gaussians in front of a camera at the origin looking down +z, on
    pixel centres (x, y) of a 32x32 image with focal length 16 px."""
    xyz, op, sc = (torch.cat(t) for t in zip(*stack))
    n = len(op)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(n, 1)
    g = rr.Gaussians(xyz, op, sc, q, torch.ones(n, 3), torch.zeros(n, 16),
                     torch.ones(n, dtype=torch.bool))
    cam = rr.camera(torch.eye(4), 32, 32, 16.0, 16.0)
    return g, cam


def _at_pixel(px, py):
    """World point at 5 m that projects onto pixel centre (px, py)."""
    return ((px - 15.5) * 5.0 / 16.0, (py - 15.5) * 5.0 / 16.0)


def test_live_pairs_on_a_hand_counted_scene():
    r = rr.Raster()
    # one point-like Gaussian: only the 0.3 px² low-pass is left, so
    # alpha = 0.5·exp(-d²/0.6) ≥ 1/255 where d² ≤ 0.6·ln(127.5) = 2.91:
    # the centre, its 4 edge neighbours and its 4 corners
    x, y = _at_pixel(8.0, 8.0)
    g, cam = _scene([_one(x, y, 0.5)])
    assert rr.render(g, cam, r, count_live=True).live_pairs == 9
    # five stacked at 0.95: the centre pixel's transmittance 1, 0.05,
    # 0.0025, 1.25e-4 lets three through; the neighbours (alpha 0.18 and
    # 0.034) all five
    g, cam = _scene([_one(x, y, 0.95)] * 5)
    assert rr.render(g, cam, r, count_live=True).live_pairs == 3 + 4 * 5 + 4 * 5


def test_work_models_bound_their_kernels():
    w = work.pair_work("composite_bwd_kernel", live=1000, binned=2000, gaussians=500, tiles=4)
    assert w["mm"] == 1000 * work.BWD_MM and w["fp"] == 1000 * (work.BWD_OPS - work.BWD_MM)
    assert work.least_s(w) == max(w["mm"] / work.PEAK_TF32, w["fp"] / work.PEAK_FP32,
                                  w["bytes"] / work.PEAK_BYTES)
    with pytest.raises(KeyError):
        work.pair_work("sort_blocks", 1, 1, 1, 1)
    x, y = _at_pixel(8.0, 8.0)
    g, cam = _scene([_one(x, y, 0.5)])
    out = work.count([{"g": g, "cam": cam, "raster": rr.Raster(), "ssim": True,
                       "kernels": ["composite_fwd_kernel", "composite_bwd_kernel"]}], "cpu")
    assert out["live"] == 9
    assert set(out["least_s"]) == {"composite_fwd_kernel", "composite_bwd_kernel"}
    assert out["ops_s"] > 0 and math.isfinite(out["ops_s"])
