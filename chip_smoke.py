#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`sags_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line):
  1. build the CUDA kernels from `sags_tpu_torch/csrc` (one nvcc per source,
     in parallel) and print the card's name and power limit;
  2. hold every kernel against its plain PyTorch version at the slice's
     shapes (640x512 → 1280 tiles, K = 512 and 1024, P = 2^18 Gaussians of a
     seeded random scene): fill_table exactly, composite_fused to 1e-3
     absolute, composite_fused_bwd to 2e-4 relative per output row, and the
     scattered dG bitwise equal across two backward runs; time each;
  3. drive `SLAMPipeline.run` (fused front-end, GICP tracking) at the
     pipeline bench's operating point for 32 warm + 16 timed frames and check
     finite, falling losses, the trajectory (ATE < 0.12 m over the first
     0.75 m of path, the bar of `tests/test_pipeline.py`, and within 5% of the
     JAX package's ATE on the same scans over the whole run) and that every
     kernel launched.
The line before the last holds each kernel's launches on the main path, its
time, its plain version's time and its bound at the tile capacity the loop
ended with. The last stdout line is `{"ok": true, "device": {...}}`.
Imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_S = 67e12  # H100 SXM float32 outside the tensor cores
SLICE_W, SLICE_H = 640, 512
# float32 operations per (pixel, pair) that the kernels evaluate, counted from
# their arithmetic (an exp counts as one): the forward's gate, alpha, T update
# and 24 weighted sums; the backward's two forward passes over the pair, the
# 24-term dot product, the chained derivatives and the 30 sums over pixels
FWD_OPS_PER_PIXEL_PAIR = 66.0
BWD_OPS_PER_PIXEL_PAIR = 190.0
# ATE (m) of the JAX package's GICP chain over these 48 frames' scans, from
# `tools/reference_tracking_ate.py`; under tracking "gicp" the pose chain
# depends on the scans only, so the port's loop must land on the same value
REFERENCE_ATE_M = 0.19425298273563385
ATE_BAR_M, ATE_BAR_PATH_M = 0.12, 0.75  # `tests/test_pipeline.py:71`


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_scene(n: int, device, seed: int = 0):
    """A seeded random scene filling a 640x512 view: 2^18 Gaussians at 2-12 m."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)
    z = 2.0 + 10.0 * u(n)
    xyz = torch.stack([(u(n) * 2 - 1) * 0.8 * z, (u(n) * 2 - 1) * 0.65 * z, z], -1)
    scales = torch.exp(math.log(0.01) + u(n, 3) * math.log(8.0))
    quats = torch.randn(n, 4, generator=g)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    opac = 0.05 + 0.9 * u(n)
    colors = u(n, 3)
    objs = torch.randn(n, 16, generator=g)
    return [t.to(device) for t in (xyz, opac, scales, quats, colors, objs)]


def live_pixel_pairs(G, table, counts, tiles_x, chunk, alpha_min, t_min) -> int:
    """The (pixel, pair) evaluations this scene needs: pairs k < count that
    meet a pixel whose transmittance can still take one, T (1 - alpha_min) >=
    t_min. Pixels past that point, and whole tiles, cost the kernels nothing."""
    import torch

    from sags_tpu_torch.ops import composite

    NT, K = table.shape
    px, py = composite.tile_pixel_coords(NT, tiles_x, 16, 0, G.device)
    T = torch.ones_like(px)
    rank = torch.arange(K, device=G.device)
    total = 0
    for c0 in range(0, K, chunk):
        vm = rank[None, c0:c0 + chunk] < counts[:, None]
        Gc = G[torch.clamp(table[:, c0:c0 + chunk], min=0).long()]
        _, _, _, _, _, om, _, m = composite._chunk_quants(Gc, vm, px, py, T,
                                                          alpha_min, t_min)
        cum = torch.cumprod(torch.where(m, om, torch.ones_like(om)), dim=-1)
        T_k = T[..., None] * torch.cat([torch.ones_like(cum[..., :1]),
                                        cum[..., :-1]], dim=-1)
        total += int(((T_k * (1.0 - alpha_min) >= t_min) & vm[:, None, :]).sum())
        T = T * cum[..., -1]
    return total


def kernel_phase(device, P=2 ** 18, width=SLICE_W, height=SLICE_H,
                 capacities=(512, 1024)):
    """Kernels against their plain versions at the slice's shapes."""
    import torch

    from sags_tpu_torch.core.camera import make_camera
    from sags_tpu_torch.core.config import RasterizeConfig
    from sags_tpu_torch.ops import binning, composite
    from sags_tpu_torch.ops import rasterize as rz

    xyz, opac, scales, quats, colors, objs = random_scene(P, device)
    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                      width, height, 2 * math.atan(width / (2 * 431.8)),
                      2 * math.atan(height / (2 * 431.8)))
    tiles_x, tiles_y = width // 16, height // 16
    NT = tiles_x * tiles_y
    results = {}
    for K in capacities:
        cfg = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=K, chunk=64)
        with torch.no_grad():
            pre = rz.preprocess(xyz, opac, scales, quats, cam, cfg, colors=colors)
            gid_s, starts, _ = rz.sort_pairs(pre, tiles_x, tiles_y, cfg)
            G = rz._pack_gaussians(pre, objs).contiguous()
        # -- fill_table: exactly equal
        table = binning.fill_table(gid_s, starts, NT, K)
        plain_table = binning.fill_table_plain(gid_s, starts, NT, K)
        torch.cuda.synchronize()
        assert torch.equal(table, plain_table), "fill_table disagrees with its plain version"
        counts = torch.clamp(starts[1:] - starts[:-1], max=K).to(torch.int32)
        kept = int(counts.sum())
        n_rows = int(torch.unique(table[table >= 0]).numel())
        ft = dict(
            max_abs_err=0.0,
            ms=cuda_ms(lambda: binning.fill_table(gid_s, starts, NT, K), 50),
            plain_ms=cuda_ms(lambda: binning.fill_table_plain(gid_s, starts, NT, K), 10),
            bytes=4 * kept + 4 * (NT + 1) + 4 * NT * K, ops=0.0)

        # -- composite_fused: 1e-3 absolute on acc and T (the JAX bar)
        args = (G, table, counts, 16, tiles_x)
        kw_gate = dict(alpha_min=1.0 / 255.0, t_min=1e-4)
        kw = dict(kw_gate, chunk=64)
        acc, T = composite.composite_fused(*args, **kw)
        acc_p, T_p = composite.composite_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        err_f = max(float((acc - acc_p).abs().max()), float((T - T_p).abs().max()))
        assert err_f <= 1e-3, f"composite_fused disagrees: {err_f}"
        pairs_px = float(live_pixel_pairs(G, table, counts, tiles_x, 64, **kw_gate))
        cf = dict(
            max_abs_err=err_f,
            ms=cuda_ms(lambda: composite.composite_fused(*args, **kw), 20),
            plain_ms=cuda_ms(lambda: composite.composite_fused_plain(*args, **kw), 3),
            # each referenced row once, the kept table entries, acc + T out
            bytes=128 * n_rows + 4 * kept + 4 * NT + 4 * NT * 256 * 25,
            ops=FWD_OPS_PER_PIXEL_PAIR * pairs_px)

        # -- composite_fused_bwd: 2e-4 relative per row of dGt
        g = torch.Generator(device=device).manual_seed(1)
        d_acc = torch.randn(acc.shape, generator=g, device=device)
        d_T = torch.randn(T.shape, generator=g, device=device)
        bargs = (G, table, counts, d_acc, d_T, T, 16, tiles_x)
        dGt = composite.composite_fused_bwd(*bargs, **kw)
        dGt_p = composite.composite_fused_bwd_plain(*bargs, **kw)
        torch.cuda.synchronize()
        diff = (dGt - dGt_p).abs().amax(dim=(0, 2))
        scale = dGt_p.abs().amax(dim=(0, 2))
        live = scale > 0
        rel = float((diff[live] / scale[live]).max())
        assert rel <= 2e-4, f"composite_fused_bwd disagrees: {rel} relative"
        # -- the scatter into dG: bitwise reproducible
        dG1 = composite.scatter_rows(composite.composite_fused_bwd(*bargs, **kw), table, P)
        dG2 = composite.scatter_rows(composite.composite_fused_bwd(*bargs, **kw), table, P)
        torch.cuda.synchronize()
        assert torch.equal(dG1, dG2), "dG is not bitwise reproducible"
        cb = dict(
            max_abs_err=float((dGt - dGt_p).abs().max()), rel_err=rel,
            ms=cuda_ms(lambda: composite.composite_fused_bwd(*bargs, **kw), 10),
            plain_ms=cuda_ms(lambda: composite.composite_fused_bwd_plain(*bargs, **kw), 3),
            bytes=128 * n_rows + 4 * kept + 4 * NT + 4 * NT * 256 * 26 + 4 * NT * 32 * K,
            ops=BWD_OPS_PER_PIXEL_PAIR * pairs_px)
        results[K] = {"fill_table": ft, "composite_fused": cf,
                      "composite_fused_bwd": cb, "kept_pairs": kept,
                      "live_pixel_pairs": pairs_px,
                      "scatter_ms": cuda_ms(lambda: composite.scatter_rows(dGt, table, P), 10)}
        emit({"phase": "kernels", "tile_capacity": K, "kept_pairs": kept,
              "live_pixel_pairs": pairs_px,
              "fill_table_exact": True, "composite_fused_max_abs_err": err_f,
              "composite_fused_bwd_rel_err": rel, "dG_bitwise_reproducible": True})
        del pre, G, table, acc, acc_p, dGt, dGt_p
    return results


def slam_setup(device, n_frames, width=SLICE_W, height=SLICE_H, n_world=65536,
               points=4096, capacity=2 ** 18):
    """The pipeline bench's operating point (`bench.py:bench_pipeline`):
    (SLAMConfig, frames)."""
    from sags_tpu_torch.core.config import (KeyframeConfig, MapConfig,
                                            RasterizeConfig, SLAMConfig,
                                            TrackingConfig)
    from sags_tpu_torch.io.datasets import SyntheticDataset

    cfg = SLAMConfig(
        raster=RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=512, chunk=64),
        map=MapConfig(initial_capacity=capacity),
        keyframes=KeyframeConfig(keyframe_freq=5, window=16),
        tracking=TrackingConfig(backend="gicp", max_points=points),
        post_train_iters=0, metrics_interval=5,
    )
    frames = list(SyntheticDataset(n_frames=n_frames, width=width, height=height,
                                   n_world=n_world, pts_per_frame=points,
                                   step=0.075, clutter=0.3, device=device))
    return cfg, frames


def slam_phase(device, n_warm=32, n_timed=16, **sizes):
    """The port's main path: SLAMPipeline.run at the bench operating point."""
    import numpy as np
    import torch

    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam import step as slam_step
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.traj import ate_rmse

    t0 = time.perf_counter()
    cfg, frames = slam_setup(device, n_warm + n_timed, **sizes)
    data_s = time.perf_counter() - t0
    points = cfg.tracking.max_points
    pipe = SLAMPipeline(cfg, point_budget=points, rng_seed=0, device=device)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    warm = pipe.run(frames[:n_warm], post_train=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    timed = pipe.run(frames[n_warm:], post_train=0)
    end.record()
    torch.cuda.synchronize()
    frame_ms = start.elapsed_time(end) / n_timed
    launches = {k.symbol: k.launches for k in _build.kernels()}

    # one training step alone, on the newest keyframe (after the counts read)
    kf = pipe.keyframes[-1]
    state = pipe.state

    def one_step():
        nonlocal state
        state, _ = slam_step.slam_step(state, kf.camera, kf.image, kf.objects, pipe.cfg)

    step_ms = cuda_ms(one_step, 10)

    poses = np.concatenate([warm.poses_est, timed.poses_est])
    gt = np.concatenate([warm.poses_gt, timed.poses_gt])
    ate, _ = ate_rmse(poses, gt, align=False)
    near = np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=-1) <= ATE_BAR_PATH_M
    ate_near, _ = ate_rmse(poses[near], gt[near], align=False)
    losses = np.asarray(timed.losses)  # the pipeline's log holds every frame
    third = max(1, len(losses) // 3)
    first_mean = float(losses[:third].mean())
    last_mean = float(losses[-third:].mean())
    n_frames = n_warm + n_timed
    emit({"phase": "slam", "frames": n_frames, "train_iters": timed.train_iters,
          "ms_per_frame": frame_ms, "ms_per_train_step": step_ms,
          "warm_seconds": warm_s, "dataset_seconds": data_s, "ate_m": ate,
          "reference_ate_m": REFERENCE_ATE_M,
          f"ate_first_{ATE_BAR_PATH_M}m": ate_near, "frames_first_path": int(near.sum()),
          "loss_first_third": first_mean, "loss_last_third": last_mean,
          "tile_capacity_final": pipe.cfg.raster.tile_capacity,
          "n_active": int(state.map.active.sum()), "launches": launches,
          "launches_per_frame": {k: v / n_frames for k, v in launches.items()},
          "lm_iterations_per_frame": [list(x) for x in pipe.lm_log]})
    assert np.isfinite(losses).all(), "non-finite loss"
    assert len(losses) == n_frames, len(losses)
    assert last_mean < first_mean, (first_mean, last_mean)
    assert ate_near < ATE_BAR_M, f"ATE {ate_near} m over the first {ATE_BAR_PATH_M} m"
    assert ate <= 1.05 * REFERENCE_ATE_M, f"ATE {ate} m, reference {REFERENCE_ATE_M} m"
    for sym, n in launches.items():
        assert n > 0, f"{sym} never launched on the main path"
    return launches, pipe.cfg.raster.tile_capacity


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sags_tpu_torch import resolve_device
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.ops import binning, composite  # noqa: F401  (register kernels)

    device = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"# {src}: {line.strip()}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]

    kres = kernel_phase(device)
    launches, K_final = slam_phase(device)
    if K_final not in kres:
        kres.update(kernel_phase(device, capacities=(K_final,)))

    src = {"fill_table": ("sags_tpu_torch/csrc/fill_table.cu",
                          "sags_tpu/ops/pallas_binning.py:75", "sags_fill_table"),
           "composite_fused": ("sags_tpu_torch/csrc/composite_fused.cu",
                               "sags_tpu/ops/pallas_composite.py:119",
                               "sags_composite_fused"),
           "composite_fused_bwd": ("sags_tpu_torch/csrc/composite_fused_bwd.cu",
                                   "sags_tpu/ops/pallas_composite.py:318",
                                   "sags_composite_fused_bwd")}
    kernels = []
    for name, (path, replaces, sym) in src.items():
        r = kres[K_final][name]
        t_bytes = r["bytes"] / PEAK_BYTES_S * 1e3
        t_ops = r["ops"] / PEAK_FP32_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": path, "replaces": replaces,
            "launches": launches[sym], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    emit({"tile_capacity": K_final,
          "by_tile_capacity": {K: {n: {"ms": kres[K][n]["ms"], "plain_ms": kres[K][n]["plain_ms"]}
                                   for n in src} for K in kres},
          "scatter_ms": {K: kres[K]["scatter_ms"] for K in kres},
          "kept_pairs": {K: kres[K]["kept_pairs"] for K in kres},
          "live_pixel_pairs": {K: kres[K]["live_pixel_pairs"] for K in kres}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
