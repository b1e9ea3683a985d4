"""Where the time of the PyTorch port's eval render goes, on one CUDA card.

Builds the SLAM loop's map (`profile_torch_slam.loop_cell`: 48 frames at
640x512), then, for each render mode of `SLAMPipeline.evaluate` (windowed
with the host table, windowed with the kernel sort, classic), renders the eval
poses once to warm up and traces them with
`sags_tpu_torch.utils.profiling.trace` (the Chrome trace and `spans.json`
in `build/profile/eval_<mode>/`). Prints one JSON line per mode, a render's
worth: wall ms, the device's busy ms (the union of its operations'
intervals) and idle share, launches, per program span of `ops/rasterize.py`
(`raster.preprocess`, `raster.prepare_windowed` or `raster.bin`,
`raster.composite`) its count, syncs, host ms and device ms, and the kernels
that take the most device time.

    python tools/profile_torch_eval.py [--every 6] [--top 12]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--every", type=int, default=6)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    from profile_torch_slam import loop_cell
    from sags_tpu_torch import resolve_device
    from sags_tpu_torch.slam import step as slam_step
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils import profiling

    device = resolve_device("cuda")
    cfg, frames = loop_cell(device, 48)
    pipe = SLAMPipeline(cfg, point_budget=cfg.tracking.max_points, rng_seed=0,
                        device=device)
    res = pipe.run(frames, post_train=0)
    r = pipe.cfg.raster
    modes = {
        "windowed_host": pipe.eval_config(True),
        "windowed_kernel": pipe.cfg.replace(raster=dataclasses.replace(
            r, windowed_sort="kernel", window_blocks=16,
            tile_capacity=max(r.tile_capacity, r.tile_capacity_max))),
        "classic": pipe.cfg.replace(raster=dataclasses.replace(r, windowed=False)),
    }
    idx = list(range(0, len(frames), args.every))
    cams = [pipe._camera_for(frames[i], res.poses_est[i]) for i in idx]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    for mode, mcfg in modes.items():
        out_dir = os.path.join(ROOT, "build", "profile", f"eval_{mode}")
        with torch.no_grad():
            for c in cams:
                slam_step.render_map(pipe.state.map, c, mcfg)
            torch.cuda.synchronize()
            with profiling.trace(out_dir):
                for c in cams:
                    slam_step.render_map(pipe.state.map, c, mcfg)
        with open(os.path.join(out_dir, "spans.json")) as f:
            summary = json.load(f)
        summary["top_device"] = summary["top_device"][:args.top]
        print(json.dumps({
            "card": smi, "mode": mode, "renders": len(cams),
            "max_tiles_per_gaussian": mcfg.raster.max_tiles_per_gaussian,
            "window_blocks": mcfg.raster.window_blocks,
            "tile_capacity": mcfg.raster.tile_capacity,
            "per_render": profiling.per_unit(summary, len(cams)),
        }), flush=True)


if __name__ == "__main__":
    main()
