"""Where the time of the PyTorch port's SLAM frame goes, on one CUDA card.

Runs `SLAMPipeline.run` at `chip_smoke.py`'s operating point (the pipeline
bench's: 640x512, 4096-point scans, GICP tracking, one training step per
frame), warms up, then profiles a window of frames with `torch.profiler`.
Prints one JSON line: the window's wall time per frame, the device's busy
time and idle share, host and device time per frame in each per-frame stage
(`_track`, `_add`, `_train_and_metrics` of `slam/fused.py`), and the kernels
that take the most device time. Writes the Chrome trace beside the build
(`build/profile/`).

    python tools/profile_torch_slam.py [--warm 32] [--frames 8] [--top 25]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("_track", "_add", "_train_and_metrics")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warm", type=int, default=32)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from sags_tpu_torch import resolve_device
    from sags_tpu_torch.slam.fused import FusedFrontend
    from sags_tpu_torch.slam.pipeline import SLAMPipeline

    device = resolve_device("cuda")
    for name in STAGES:  # a profiler range around each per-frame stage
        def ranged(self, *a, _fn=getattr(FusedFrontend, name), _name=name, **k):
            with record_function("stage" + _name):
                return _fn(self, *a, **k)
        setattr(FusedFrontend, name, ranged)

    cfg, frames = chip_smoke.slam_setup(device, args.warm + args.frames)
    pipe = SLAMPipeline(cfg, point_budget=cfg.tracking.max_points, rng_seed=0,
                        device=device)
    pipe.run(frames[:args.warm], post_train=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run(frames[args.warm:], post_train=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.frames
    from torch.autograd import DeviceType

    events = prof.events()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and not e.name.startswith("stage")]
    device_us = sum(e.device_time_total for e in on_device)
    stages = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("stage"):
            s = stages.setdefault(e.name, {"host_ms_per_frame": 0.0,
                                           "device_ms_per_frame": 0.0, "calls": 0})
            s["host_ms_per_frame"] += e.cpu_time_total / 1e3 / n
            s["device_ms_per_frame"] += e.device_time_total / 1e3 / n
            s["calls"] += 1
    by_name = {}
    for e in on_device:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.device_time_total)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    out_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "slam_frames.json"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "frames": n, "tile_capacity": pipe.cfg.raster.tile_capacity,
        "wall_ms_per_frame": wall * 1e3 / n,
        "device_busy_ms_per_frame": device_us / 1e3 / n,
        "device_idle_share": max(0.0, 1.0 - device_us / 1e6 / wall),
        "stages": stages,
        "top_device": [{"name": name[:90], "calls_per_frame": calls / n,
                        "device_ms_per_frame": us / 1e3 / n}
                       for name, (calls, us) in kernels],
    }))


if __name__ == "__main__":
    main()
