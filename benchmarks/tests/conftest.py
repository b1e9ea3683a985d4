"""CPU tests of the benchmark: run them from the repository root with
`python -m pytest benchmarks/tests`. They import neither JAX nor the JAX
package."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(2)


def tiny(name: str):
    """Cell `name` cut to a size the CPU runs in seconds: 64x48 images, a
    sparse world, a 2^12 map, 256-slot tiles."""
    from benchmarks.harness import spec

    c = copy.deepcopy(spec.load_cell(name))
    cf = c.config
    cf["stream"].update(width=64, height=48, world_points_per_20m=8192, scan_points=1024,
                        point_budget=1024)
    s = cf["slam"]
    s["map"]["initial_capacity"] = 2 ** 12
    s["tracking"]["max_points"] = 1024
    s["raster"].update(tile_capacity=256, tile_capacity_max=256)
    s["keyframes"]["keyframe_freq"] = 5
    s["metrics_interval"] = 5
    if "offline" in cf:
        cf["offline"]["n_views"] = 4
    p = c.params
    if c.traffic == "stream":
        p.update(pool_frames=24, warm_frames=8, stretch_units=2)
    elif c.traffic == "replay":
        p.update(warm_iters=4, stretch_units=2)
    return c


@pytest.fixture
def tiny_cell():
    return tiny
