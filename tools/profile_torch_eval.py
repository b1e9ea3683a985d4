"""Where the time of the PyTorch port's eval render goes, on one CUDA card.

Builds `chip_smoke.py`'s map (the SLAM loop cell: 48 frames at 640x512),
then, for each render mode of `chip_smoke.py`'s eval phase (windowed with
the host table, windowed with the kernel sort, classic), renders the eval
poses once to warm up and profiles them with `torch.profiler`. Prints one
JSON line per mode: wall ms per render, the device's busy ms and idle share,
host and device ms per render in each stage of `ops/rasterize.py`
(preprocess, the windowed preparation or the classic binning, the table
fill, the compositor kernel), and the kernels that take the most device
time.

    python tools/profile_torch_eval.py [--every 6] [--top 12]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _range(module, name, label):
    """Wrap `module.name` in a profiler range named `label`."""
    from torch.profiler import record_function

    fn = getattr(module, name)

    def ranged(*a, **k):
        with record_function(label):
            return fn(*a, **k)

    setattr(module, name, ranged)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--every", type=int, default=6)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from sags_tpu_torch import resolve_device
    from sags_tpu_torch.ops import composite, rasterize, windowed
    from sags_tpu_torch.slam import step as slam_step
    from sags_tpu_torch.slam.pipeline import SLAMPipeline

    device = resolve_device("cuda")
    cfg, frames, _ = chip_smoke.slam_setup(device, 48)
    pipe = SLAMPipeline(cfg, point_budget=cfg.tracking.max_points, rng_seed=0,
                        device=device)
    res = pipe.run(frames, post_train=0)
    for module, name in ((rasterize, "preprocess"), (rasterize, "_prepare_windowed"),
                         (rasterize, "bin_gaussians"), (rasterize, "fill_table"),
                         (composite, "composite_fused"),
                         (windowed, "composite_windowed"),
                         (windowed, "composite_windowed_sorted")):
        _range(module, name, "stage_" + name)
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
    out_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    n = len(cams)
    for mode, mcfg in modes.items():
        with torch.no_grad():
            for c in cams:
                slam_step.render_map(pipe.state.map, c, mcfg)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for c in cams:
                    slam_step.render_map(pipe.state.map, c, mcfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        events = prof.events()
        on_device = [e for e in events if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.name.startswith("stage_")]
        device_us = sum(e.device_time_total for e in on_device)
        stages = {}
        for e in events:
            if e.device_type == DeviceType.CPU and e.name.startswith("stage_"):
                s = stages.setdefault(e.name[6:], {"host_ms_per_render": 0.0,
                                                   "device_ms_per_render": 0.0})
                s["host_ms_per_render"] += e.cpu_time_total / 1e3 / n
                s["device_ms_per_render"] += e.device_time_total / 1e3 / n
        by_name = {}
        for e in on_device:
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.device_time_total)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
        prof.export_chrome_trace(os.path.join(out_dir, f"eval_{mode}.json"))
        print(json.dumps({
            "card": smi, "mode": mode, "renders": n,
            "max_tiles_per_gaussian": mcfg.raster.max_tiles_per_gaussian,
            "window_blocks": mcfg.raster.window_blocks,
            "tile_capacity": mcfg.raster.tile_capacity,
            "wall_ms_per_render": wall * 1e3 / n,
            "device_busy_ms_per_render": device_us / 1e3 / n,
            "device_idle_share": max(0.0, 1.0 - device_us / 1e6 / wall),
            "kernel_launches_per_render": len(on_device) / n,
            "stages": stages,
            "top_device": [{"name": name[:90], "calls_per_render": calls / n,
                            "device_ms_per_render": us / 1e3 / n}
                           for name, (calls, us) in top],
        }), flush=True)


if __name__ == "__main__":
    main()
