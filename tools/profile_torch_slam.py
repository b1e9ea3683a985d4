"""Where the time of the PyTorch port's SLAM frame goes, on one CUDA card.

Runs `SLAMPipeline.run` at the SLAM loop's operating point (`loop_cell`:
640x512, 4096-point scans, GICP tracking, one training step per frame),
warms up, then traces a window of frames with
`sags_tpu_torch.utils.profiling.trace`, which writes the Chrome trace and
`spans.json` into `build/profile/slam_frames[_windowed]/`. Prints one JSON
line a frame's worth: the window's wall ms, the device's busy ms (the union
of its operations' intervals) and idle share, launches, and per program span
(`frame`, `track`, `gicp.lm_trial`, `map.add`, `train`, `raster.bin`,
`raster.composite_bwd`, `step.adam`, ...) its count, syncs, host ms and
device ms, and the kernels that take the most device time.
`--train-windowed` trains through the windowed render
(`RasterizeConfig.train_windowed`).

    python tools/profile_torch_slam.py [--warm 32] [--frames 8] [--top 25] [--train-windowed]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def loop_cell(device, n_frames, train_windowed=False):
    """The SLAM loop's operating point: its `SLAMConfig` and `n_frames`
    frames of a seeded `SyntheticDataset` (640x512, a 65,536-point world,
    4096-point scans 0.075 m apart, clutter 0.3)."""
    from sags_tpu_torch.core.config import (KeyframeConfig, MapConfig, RasterizeConfig,
                                            SLAMConfig, TrackingConfig)
    from sags_tpu_torch.io.datasets import SyntheticDataset

    cfg = SLAMConfig(
        raster=RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=512, chunk=64,
                               train_windowed=train_windowed),
        map=MapConfig(initial_capacity=2 ** 18),
        keyframes=KeyframeConfig(keyframe_freq=5, window=16),
        tracking=TrackingConfig(backend="gicp", max_points=4096),
        post_train_iters=0, metrics_interval=5)
    ds = SyntheticDataset(n_frames=n_frames, width=640, height=512, n_world=65536,
                          pts_per_frame=4096, step=0.075, clutter=0.3, device=device)
    return cfg, list(ds)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=32)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--train-windowed", action="store_true")
    args = ap.parse_args()

    from sags_tpu_torch import resolve_device
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils import profiling

    device = resolve_device("cuda")
    cfg, frames = loop_cell(device, args.warm + args.frames, args.train_windowed)
    pipe = SLAMPipeline(cfg, point_budget=cfg.tracking.max_points, rng_seed=0,
                        device=device)
    pipe.run(frames[:args.warm], post_train=0)
    out_dir = os.path.join(ROOT, "build", "profile", "slam_frames_windowed"
                           if args.train_windowed else "slam_frames")
    with profiling.trace(out_dir):
        pipe.run(frames[args.warm:], post_train=0)
    with open(os.path.join(out_dir, "spans.json")) as f:
        summary = json.load(f)
    summary["top_device"] = summary["top_device"][:args.top]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    r = pipe.cfg.raster
    print(json.dumps({
        "card": smi, "frames": args.frames, "train_windowed": args.train_windowed,
        "tile_capacity": r.tile_capacity,
        "max_tiles_per_gaussian": r.max_tiles_per_gaussian, "window_blocks": r.window_blocks,
        "per_frame": profiling.per_unit(summary, args.frames),
    }))


if __name__ == "__main__":
    main()
