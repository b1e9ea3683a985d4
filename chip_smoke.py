#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`sags_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line):
  1. build the CUDA kernels from `sags_tpu_torch/csrc` (one nvcc per source,
     in parallel) and print the card's name and power limit;
  2. hold every kernel against its plain PyTorch version at the slice's
     shapes (640x512 → 1280 tiles, P = 2^18 Gaussians of a seeded random
     scene) and time each:
     - classic path, K = 512 and 1024: fill_table exactly (also on edge
       cases: counts of 0, below a vector, K and above K, every start
       residue mod 4, a segment ending at n_sorted), its time beside an
       empty kernel with its grid and torch.full of the same bytes,
       composite_fused to
       1e-3 absolute, composite_fused_bwd to 2e-4 relative per output row,
       and the scattered dG bitwise equal across two backward runs; the
       forward kernel's strip cull (`composite.strip_live`) drops no strip in
       which a pixel gates the pair, on that scene and on seeded scenes of
       large, thin, rotated splats centred off the image (4-8:1, where
       composite_fused is held to 1e-3 too, and 20-60:1, where the
       exponent's cancellation lets a few pixels in 10^5 differ); the share
       of (strip, pair) tests dropped is reported;
     - windowed path, K = 1024, windowed_chunk 512, R = 4, slice store on:
       composite_windowed and composite_windowed_sorted bitwise equal to
       their plain versions (nv exact), composite_windowed_bwd to 2e-4
       relative per output row with the scattered dG_s bitwise equal across
       two runs, each forward option (ewa_impl "quad", feature_precision
       "high" and "default", windowed_bf16) bitwise equal to its plain
       version and, against the float32 longhand render, different and
       within the JAX package's bars, sort_blocks on [1280, 16, 128] random
       int32 (and on blocks of 2, 64, 256 and 8192 keys) exactly equal to
       torch.sort, and the kernel-sort compositor
       bitwise equal to the host-table one on every tile the 16-block
       window did not cut;
     - the pair expansion (a kernel that replaces no TPU kernel), on 40 x 32
       tiles at the offline cell's shape (P = 2^22 slots, 36 tile offsets)
       and at 2^20 slots with 64 (the adapted window's widest) and 16 (the
       SLAM loops'): expand_pairs' live count and overflow equal to its
       plain loop's, its live keys bit for bit once sorted, and through the
       sort gid_s (the live prefix), starts and the table equal to the plain
       loop's and to the sort of every slot and offset's key cut at
       n_binned; its time from a CUDA graph beside its byte bound and the
       plain loop's time; sort_pairs end to end beside the sort of every
       key;
  3. drive `SLAMPipeline.run` (fused front-end, GICP tracking) at the
     pipeline bench's operating point for 32 warm + 16 timed frames and check
     finite, falling losses, the trajectory (ATE < 0.12 m over the first
     0.75 m of path, the bar of `tests/test_pipeline.py`, and within 5% of the
     JAX package's ATE on the same scans over the whole run), that its
     kernels launched, and composite_fused and composite_fused_bwd at the
     loop's own shapes on the newest keyframe: fill_table exactly, 1e-3
     absolute on acc and T, 2e-4 relative per output row of dGt against
     the plain versions, dGt and the scattered dG bitwise equal over two
     launches;
  4. `SLAMPipeline.evaluate` of that map over every 6th frame at the
     estimated poses, windowed with the host table (the default), windowed
     with the kernel sort, and classic: PSNR / SSIM / LPIPS, coverage, and
     the render's time; each windowed mode must launch its compositor and
     agree bitwise with the plain functions on one frame, and its PSNR
     against the classic render is reported;
  5. `SLAMPipeline.run` with `train_windowed=True` over the loop's first
     16 + 8 frames: finite, falling losses, composite_windowed and
     composite_windowed_bwd launched once per training step and the classic
     compositor never, the ATE within 1% of the classic loop's over the
     same frames, two backward passes of the windowed loss on the newest
     keyframe bitwise equal in all seven parameter groups, and
     composite_windowed_bwd at the loop's own shapes on that keyframe to
     2e-4 relative per output row of its plain version;
  6. the semantic loop: `SLAMPipeline.run` with `GeometricMaskGenerator`
     over the loop's first 16 + 8 frames (each keyframe tracked and grown,
     its label map made on the host, its IDs associated on the device,
     then trained on): finite, falling losses, exactly one metrics row a
     frame, the ATE within 1% of the classic loop's over the same frames,
     fill_table, composite_fused and composite_fused_bwd launched and held
     at this loop's shapes on its newest keyframe (this map holds a pair
     at the alpha gate: the needle scene's bars, all but 2e-4 of the
     pixels to 1e-3 and the backward's rows on the gate-stable tiles, at
     most two tiles not gate-stable and a pair at the gate where the
     forward differs most),
     two backward passes with that keyframe's labels bitwise equal with and
     without the cls3d term, and the device association replayed on the
     CPU bitwise (votes, masks, label memory, freed labels); it reports the
     host ms a keyframe spends generating and associating, and, after 100
     post-training steps, the mean best-match IoU of the keyframes' masks
     against `gt_objects`, the share of instances whose label persists, and
     the classifier's foreground accuracy, which must beat the classic
     loop's map's;
  7. SAM's `MaskGenerator` with the shipped weights (their loading held)
     on the card against
     the port's CPU run on three keyframe images (encoder features to 1e-4,
     low-res logits to 1e-3, labels on 99.9% of the pixels), timed per
     encoder call and decoder batch, then a 10-frame loop with it; then SAM
     training at the shipped model's size: `make_training_data` at its
     defaults (four worlds, four frames each, rendered on the card), 100
     `train_sam` steps of batch 16 from a random SAM (seed 0): the mean loss
     of the last 10 steps below the first 10's, `save_fp16` read back by
     `load_pretrained` as the float16-rounded parameters bitwise, and
     two backward passes of one batch bitwise equal in every parameter
     (the upscaling's transposed convolutions are a matmul and a pixel
     shuffle, `models.sam.ConvTranspose2x2`);
  8. tracking: `SLAMPipeline.run` over the loop's first 16 + 8 frames under
     "vgicp" (its ATE within 5% of the JAX package's on the same scans,
     `tools/reference_vgicp_ate.py`) and under "gicp_map" (the map
     anchored, the frame printed; ATE < 0.12 m over the first 0.75 m; its
     whole-run ATE against 1.05 × the classic loop's + 1e-4 over the same
     frames, printed as met or not), each with finite, falling losses, one
     metrics row a frame, LM iterations and `ms_per_frame`, and the three
     training kernels launched and held at the loop's newest keyframe at the
     classic loop's bars; then `FastGICP`, `FastGICPSingleThread`,
     `FastVGICP` (DIRECT1, DIRECT7), `NDTCuda` (P2D) and `align_points` on
     `tests/test_gicp.py`'s structured pair within its 5 cm / 1° gate (NDT
     within `tests/test_ndt.py`'s 10 cm / 1.5°), each align timed, and
     `build_voxel_map` twice on a 4096-point scan, bitwise equal;
  9. the per-module front-end over the loop's first 16 + 8 frames with
     their IMU samples (`imu_substeps=5`): (a) tracking "esikf" at its
     defaults (LiDAR-inertial, bootstrap, 10 update iterations), (b) the
     same with `esikf_visual` (LiDAR-inertial-visual), (c) "gicp" with
     `fused_frontend=False`; each with finite, falling losses, the three
     training kernels launched, its `ms_per_frame`, ATE and the host syncs
     of each warm frame by stage (`torch.cuda.set_sync_debug_mode`): none in
     the ESIKF tracker once the surfel map is live and the bootstrap done,
     one packed fetch a training step. The ATEs of (a), (b) and (c) within
     5% of the JAX package's on the same scans, IMU and images
     (`tools/reference_esikf_ate.py`; (c)'s beside the classic loop's,
     whose align starts from the last delta); the surfel map's size, overflow, matches and photometric
     residuals used; one surfel fold bitwise equal over two runs; the three
     training kernels held at (a)'s newest keyframe at the classic loop's
     bars;
 10. the offline trainer: (a) `train_offline` over the loop's 48 frames
     (196,608 init points, capacity 2^20, `SLAMConfig()` at its defaults)
     for 600 iterations: `init_from_points` seconds (kNN scales included),
     iterations/s, peak memory, active Gaussians and drops after each
     densify event (300, 400, 500, 600; the opacity reset at 600), finite
     losses whose last 100 average below the first 100, the PSNR of three
     training views, `fill_table`, `composite_fused` and
     `composite_fused_bwd` launched exactly once an iteration (no other
     kernel) and held at the trained map on one view at the classic bars
     (the needle rule if the map holds a pair at the alpha gate); (b) 12
     of those frames written as a COLMAP text model (the dataset's PINHOLE
     intrinsics, `.npy` images, a seeded 32,768-point subsample of the
     world as points3D), `load_colmap_scene`, then `train_offline_scene`
     for 100 iterations: its radius, finite and falling losses, one launch
     of each kernel an iteration; (c) `save_map_ply` / `load_map_ply` of
     (a)'s compacted map, every field read back bitwise;
 11. the CLI, `sags_tpu_torch.cli.main.main(argv)` in this process: (a)
     run-slam with the SLAM loop cell's dataset size and capacity (640x512,
     a 65,536-point world, 4096-point scans, step 0.075, capacity 2^18,
     gicp; the rest at `SLAMConfig()`'s defaults) over 24 frames and 20
     post-training steps with --checkpoint, --save and --traj-out: the JAX
     CLI's JSON keys, a finite ATE, the launches exact (composite_fused_bwd
     one a training iteration, composite_fused that plus one a frame for
     the dataset's ground truth, fill_table that plus one an eval render,
     composite_windowed one an eval render), and fill_table,
     composite_fused and its backward held at the run's final training
     config on its map from its last keyframe's view, composite_windowed
     bitwise at its eval config on the first eval view; (b) the checkpoint read back
     bitwise (map, Adam moments, classifier, step, generator state), one
     `slam_step` from it and from the run's state bitwise equal, the same
     checkpoint read on the CPU to the same numbers, save and load seconds
     and bytes, and run-slam --resume over 4 more frames keeping "gicp";
     (c) run-slam over 8 frames under vgicp, gicp_map and esikf, and with
     --semantics under each mask back-end (geometric, SAM); train over 12
     of the cell's frames for 100 iterations (one launch of each classic
     kernel an iteration, the forward's two also once for each
     ground-truth image the dataset renders; the three held on its map at
     its config, the needle rule if the map holds a pair at the alpha
     gate), render of the saved map (the
     PNG decodes to the rendered image), eval, run-gicp in both modes with
     --out-poses, align --method all on the structured pair written as
     .npy (the GICP family within 5 cm / 1°), and serve in a thread feeding
     run-slam --dataset socket for 4 frames;
 12. the other sources through the CLI, at the CLI cell's stream: (a)
     its 24 frames as a ROS1 bag (`/rgb_img`, `/cloud_registered`,
     `/aft_mapped_to_init`, `/imu`), run-slam --dataset rosbag with 20
     post-training steps (launches exact: each classic kernel one a training
     iteration, nothing else; ATE ≤ 1.05 × the synthetic run's; rows 1-3
     held on its map at its training config, rows 4-5 at its eval config),
     8 frames of it under esikf (ATE reported), the bag's decode cost
     alone; (b) 8 frames as TUM and Replica layouts, read back exactly
     (images, depths to their quantization, poses) and run through
     run-slam (launches exact; composite_windowed bitwise on the first eval
     frame); (c) the scans as KITTI velodyne files through a non-identity
     Tr, run-gicp --dataset kitti in both modes within 1e-4 / 5e-4 m of the
     synthetic run-gicp's ATE, and pose-less (ATE null); (d) the bag run's
     saved map served by the viewer to 4 SIBR requests at 640x512, each
     reply bitwise the uint8 `render_map` image, one fill_table and one
     composite_windowed launch a request; (e) the native host library built
     and held against its fallbacks on the card (voxel centroids within
     1e-5, kNN distances within 1e-5 plus the fallback's float32 rounding
     and indices away from ties, the PointCloud2 decode bitwise); (f) a `PhaseTimer` report of (a)-(e) and a
     `trace` of a one-frame bag;
 13. the tile-sharded mesh (`parallel/mesh.py`), run after phase 5 from
     the slam and slam_windowed phases' states: (a) `SLAMPipeline(mesh=
     make_mesh())` on one NCCL rank in this process over the loop cell's
     first 16 frames, its final state bitwise equal to `mesh=None`'s; (b)
     2 and 3 ranks on this card over gloo (spawned; 3 ranks pad the 1280
     tiles to 1281), each loading the two loops' checkpoints and newest
     keyframes and running 5 classic and 5 windowed `slam_step`s: every
     rank's state bitwise equal to the others', the losses (rtol 1e-5),
     f_dc (atol 1e-5) and xyz (atol 1e-6) against the same steps unsharded
     in this process, the compositors at each rank's tile offset against
     their plain versions at the loop bars (classic forward 1e-3, windowed
     forward bitwise, backwards 2e-4 per row), exactly one launch of each
     of the mode's compositors a step on every rank; the ms a step per
     rank and the 32 MiB dG all-reduce alone; (c) a 2-rank
     `SLAMPipeline(mesh=...)` over the 16 frames: finite, falling losses,
     the ATE within 1% of the classic loop's, the ranks bitwise equal; (d)
     with two cards or more, (b) and (c) over NCCL, one rank per card
     (skipped, and said so, on one card).
Launch counts are zeroed just before each main path (each loop, each eval
mode, each offline run, the CLI's run-slam and train, each mesh run on each
rank) and read just after; `cli_launches` on the kernels line is the CLI
run-slam's, `sources_launches` the sources phase's runs' (the bag, TUM,
Replica, the viewer), `mesh_launches` the mesh phase's runs' (per rank). The line before
the last holds each kernel's launches on its path (rows 1-3 also in the
offline run, `offline_launches`), its time, its plain version's time, the
library call's time and its bound. A kernel's `ms` and `library_ms` are device time
from a CUDA graph of its launches (`graph_ms`); `stream_ms` and `plain_ms`
time back-to-back launches from Python (`cuda_ms`), which for a kernel of a
few microseconds is the host's launch rate. The last stdout line is
`{"ok": true, "device": {...}}`. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

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
# ATE (m) of the JAX package's VGICP chain (default `GICPConfig`: 1 m voxels,
# DIRECT1) over the first 24 of those frames' scans, from
# `tools/reference_vgicp_ate.py`; the scan-to-scan chain depends on the scans only
REFERENCE_VGICP_ATE_M = 0.34979772567749023
# ATEs (m) of the JAX package's ESIKF tracker at its defaults over the first
# 24 of those frames' scans with their IMU samples (`imu_substeps=5`),
# LiDAR-inertial and LiDAR-inertial-visual, from `tools/reference_esikf_ate.py`;
# the filter reads scans, IMU, colours and images, never the map
REFERENCE_ESIKF_LI_ATE_M = 0.1774776577949524
REFERENCE_ESIKF_LIV_ATE_M = 0.23271127045154572
# ATE (m) of the JAX package's per-module "gicp" chain over the same frames
# (each align from the identity, `sags_tpu/slam/pipeline.py:201-210`; the
# fused front-end starts from the last delta), same tool
REFERENCE_GICP_PER_MODULE_ATE_M = 0.09637406468391418
IMU_SUBSTEPS = 5  # the CLI's synthetic stream
ATE_BAR_M, ATE_BAR_PATH_M = 0.12, 0.75  # `tests/test_pipeline.py:71`
SLAM_KERNELS = ("sags_expand_pairs", "sags_fill_table", "sags_composite_fused",
                "sags_composite_fused_bwd")
EVAL_EVERY = 6


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


def graph_ms(fn, reps: int = 100, replays: int = 5) -> float:
    """Mean device milliseconds of `fn`'s launches without the host's launch
    cost: `reps` calls captured in one CUDA graph, timed with CUDA events
    over `replays` replays. For kernels of a few microseconds, where
    `cuda_ms`'s back-to-back launches from Python time the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def kernel_ms(fn, reps: int) -> dict:
    """A kernel's `ms`, device time from a CUDA graph (`graph_ms`), and its
    `stream_ms`, back-to-back launches from Python (`cuda_ms`), over `reps`
    launches each. Every kernel on the `kernels` line is timed so."""
    return {"ms": graph_ms(fn, reps), "stream_ms": cuda_ms(fn, reps)}


def row_rel_err(got, want) -> float:
    """Largest error of a backward's dGt [NT, 32, K] relative to each output
    row's largest magnitude (rows that are zero throughout left out)."""
    scale = want.abs().amax(dim=(0, 2))
    live = scale > 0
    return float(((got - want).abs().amax(dim=(0, 2))[live] / scale[live]).max())


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
    """The (pixel, pair) evaluations this scene needs: pairs k < count (not
    -1) that meet a pixel whose transmittance can still take one,
    T (1 - alpha_min) >= t_min. Pixels past that point, and whole tiles, cost
    the kernels nothing."""
    import torch

    from sags_tpu_torch.ops import composite

    NT, K = table.shape
    px, py = composite.tile_pixel_coords(NT, tiles_x, 16, 0, G.device)
    T = torch.ones_like(px)
    rank = torch.arange(K, device=G.device)
    total = 0
    for c0 in range(0, K, chunk):
        vm = (rank[None, c0:c0 + chunk] < counts[:, None]) & (table[:, c0:c0 + chunk] >= 0)
        Gc = G[torch.clamp(table[:, c0:c0 + chunk], min=0).long()]
        _, _, _, _, _, om, _, m = composite._chunk_quants(Gc, vm, px, py, T,
                                                          alpha_min, t_min)
        cum = torch.cumprod(torch.where(m, om, torch.ones_like(om)), dim=-1)
        T_k = T[..., None] * torch.cat([torch.ones_like(cum[..., :1]),
                                        cum[..., :-1]], dim=-1)
        total += int(((T_k * (1.0 - alpha_min) >= t_min) & vm[:, None, :]).sum())
        T = T * cum[..., -1]
    return total


def cull_stats(live, gated, counts):
    """A strip cull (`live` [NT, 8, K]: the kernel's arithmetic and margin)
    against the gate itself (`gated`): the (strip, pair) tests made, the
    share dropped, the share in which some pixel gates the pair (the most a
    cull could keep away), and the dropped ones among those, which must be
    none."""
    import torch

    tests = 8 * int(torch.clamp(counts, max=live.shape[-1]).sum())
    return {"strip_tests": tests, "dropped_share": 1.0 - int(live.sum()) / max(tests, 1),
            "gated_share": int(gated.sum()) / max(tests, 1),
            "gated_strips_dropped": int((gated & ~live).sum())}


def strip_check(G, table, counts, tiles_x, alpha_min, tile_offset=0):
    """`cull_stats` of the classic forward kernel (`composite.strip_live`)
    on the tiles `tile_offset`.. of the grid."""
    from sags_tpu_torch.ops import composite

    return cull_stats(
        composite.strip_live(G, table, counts, tiles_x, tile_offset, alpha_min),
        composite.strip_gated(G, table, counts, tiles_x, tile_offset, alpha_min), counts)


def thin_scene(device, aspect, n=8192, K=1024, width=SLICE_W, height=SLICE_H, seed=3):
    """Packed rows of large, thin, rotated splats (major sigma 100-400 px,
    major : minor drawn from `aspect`) centred 20-300 px outside a 640x512
    image, and the table of the tiles each can gate (the binning's exact
    cull), in id order."""
    import torch

    from sags_tpu_torch.ops import binning

    g = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)
    off = u(20.0, 300.0)
    along = torch.rand(n, generator=g)
    side = torch.randint(0, 4, (n,), generator=g)
    mx = torch.where(side == 0, -off, torch.where(side == 1, width + off, along * width))
    my = torch.where(side == 2, -off, torch.where(side == 3, height + off, along * height))
    major = u(100.0, 400.0)
    minor = major / u(*aspect)
    theta = u(0.0, math.pi)
    cs, sn = torch.cos(theta), torch.sin(theta)
    ia, ib = 1.0 / major ** 2, 1.0 / minor ** 2
    G = torch.zeros((n, 32))
    G[:, 0], G[:, 1] = mx, my
    G[:, 2] = cs * cs * ia + sn * sn * ib
    G[:, 3] = cs * sn * (ia - ib)
    G[:, 4] = sn * sn * ia + cs * cs * ib
    G[:, 5] = u(0.05, 0.95)
    G[:, 8:] = torch.randn((n, 24), generator=g)
    G = G.to(device)
    tiles_x, tiles_y = width // 16, height // 16
    NT = tiles_x * tiles_y
    t = torch.arange(NT, device=device)
    tx, ty = (t % tiles_x)[:, None], (t // tiles_x)[:, None]
    a, b, c, op = (G[None, :, i] for i in (2, 3, 4, 5))
    hit = binning.tile_qmin(a, b, c, G[None, :, 0], G[None, :, 1], tx, ty, 16.0) \
        <= binning.cull_c2(op, 1.0 / 255.0)
    _, gid = hit.nonzero(as_tuple=True)  # by tile, then by id
    starts = torch.zeros(NT + 1, dtype=torch.int32, device=device)
    starts[1:] = torch.cumsum(hit.sum(dim=1), 0)
    table = binning.fill_table(gid.to(torch.int32), starts, NT, K)
    counts = torch.clamp(starts[1:] - starts[:-1], max=K).to(torch.int32)
    return G, table, counts, tiles_x


# The share of a needle scene's pixels that may differ from the plain version
# by more than 1e-3: the kernel contracts the exponent's products and sums
# into fused multiply-adds, the plain version rounds each, and at 20-60:1 the
# exponent's terms cancel to a thousandth of their size, so a few pixels in
# 10^5 see a pair on the other side of the alpha gate. A pair dropped from a
# strip by mistake would move 32 pixels at once.
NEEDLE_PIXELS_OFF = 2e-4


def thin_scene_phase(device, **sizes):
    """composite_fused and its strip cull where the cull is hardest: long
    thin splats that cross the image from centres outside it, at 4-8:1 (acc
    and T to 1e-3 of the plain version) and at 20-60:1 (needles: all but
    `NEEDLE_PIXELS_OFF` of the pixels to 1e-3). On both, no strip is dropped
    in which a pixel gates the pair."""
    import torch

    from sags_tpu_torch.ops import composite

    kw = dict(alpha_min=1.0 / 255.0, t_min=1e-4, chunk=64)
    out = {}
    for name, aspect in (("thin", (4.0, 8.0)), ("needle", (20.0, 60.0))):
        G, table, counts, tiles_x = thin_scene(device, aspect, **sizes)
        args = (G, table, counts, 16, tiles_x)
        acc, T = composite.composite_fused(*args, **kw)
        acc_p, T_p = composite.composite_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        d = torch.maximum((acc - acc_p).abs().amax(dim=-1), (T - T_p).abs())
        off = float((d > 1e-3).sum()) / d.numel()
        strips = strip_check(G, table, counts, tiles_x, kw["alpha_min"])
        out[name] = dict(strips, aspect=aspect, pairs=int(counts.sum()),
                         deepest_tile=int(counts.max()), max_abs_err=float(d.max()),
                         share_of_pixels_off=off,
                         ms=cuda_ms(lambda: composite.composite_fused(*args, **kw), 20))
        emit({"phase": "thin_scene", "name": name, **out[name]})
        assert int(counts.sum()) > 0 and float(T.min()) < 0.5, f"the {name} scene is empty"
        assert strips["gated_strips_dropped"] == 0, \
            f"the strip cull dropped a gated pair on the {name} scene: {strips}"
        assert off <= (0.0 if name == "thin" else NEEDLE_PIXELS_OFF), \
            f"composite_fused disagrees on the {name} scene: {out[name]}"
    return out


def thin_windowed(G, table, tiles_x, tiles_y, span_blocks=4, seed=5):
    """A thin-splat scene's rows as the windowed kernels take them: G_s
    [n, 40] with each row's rect the whole image (columns 32..35) and a
    seeded depth rank (column 36); the host table's work list through one
    span that numbers every row (window id = row); the kernel sort's plan,
    four spans of `span_blocks` blocks a tile (a window of 4 · span_blocks
    blocks), placed by the tile, so the exact tile cull picks among the
    window's rows."""
    import torch

    dev = G.device
    n, NT = G.shape[0], table.shape[0]
    G_s = torch.zeros((n, 40), device=dev)
    G_s[:, :32] = G[:, :32]
    G_s[:, 34], G_s[:, 35] = float(tiles_x), float(tiles_y)
    g = torch.Generator(device="cpu").manual_seed(seed)
    G_s[:, 36] = torch.randperm(n, generator=g).to(dev, torch.float32)
    one = lambda v: torch.full((NT,), v, dtype=torch.int32, device=dev)
    host = (G_s, table.reshape(NT, -1, 128), one(0), one(0), one(n // 128))
    t = torch.arange(NT, device=dev, dtype=torch.int32)
    nb = n // 128
    base = torch.stack([(span_blocks * (t % (nb // span_blocks)) + nb // 4 * j) % nb
                        for j in range(4)], 1)
    dest = torch.arange(4, device=dev, dtype=torch.int32)[None, :].expand(NT, 4) * span_blocks
    flat = lambda x: x.reshape(-1).contiguous()
    ksort = (G_s, flat(base), flat(dest), flat(torch.full_like(base, span_blocks)),
             flat(base * 128), flat((base + span_blocks) * 128))
    return host, ksort


def thin_windowed_phase(device, K=1024, chunk=512, **sizes):
    """`composite_windowed` and `composite_windowed_sorted` on the thin-splat
    scenes (4-8:1 and 20-60:1, centred off the image), under both EWA forms
    and the three feature tiers: acc and T bitwise equal to the plain
    versions, nv exact, and the windowed strip cull dropping no strip in
    which a pixel passes the loop's gate."""
    import torch

    from sags_tpu_torch.ops import windowed as win

    out = {}
    kw = dict(alpha_min=1.0 / 255.0, t_min=1e-4, chunk=chunk)
    for name, aspect in (("thin", (4.0, 8.0)), ("needle", (20.0, 60.0))):
        G, table, counts, tiles_x = thin_scene(device, aspect, K=K, **sizes)
        tiles_y = table.shape[0] // tiles_x
        host, ksort = thin_windowed(G, table, tiles_x, tiles_y)
        hargs = (host[0], host[1], counts, *host[2:], 16, tiles_x)
        sargs = (*ksort, 16, tiles_x)
        res = {}
        for ewa in ("vpu", "quad"):
            for prec in ("highest", "high", "default"):
                vkw = dict(kw, ewa_impl=ewa, feat_prec=prec)
                a, t = win.composite_windowed(*hargs, n_span=1, **vkw)
                a_p, t_p = win.composite_windowed_plain(*hargs, n_span=1, **vkw)
                skw = dict(vkw, n_span=4, w_blocks=16, k_tile=K)
                a_s, t_s, nv = win.composite_windowed_sorted(*sargs, **skw)
                a_sp, t_sp, nv_p = win.composite_windowed_sorted_plain(*sargs, **skw)
                torch.cuda.synchronize()
                ok = {"composite_windowed": torch.equal(a, a_p) and torch.equal(t, t_p),
                      "composite_windowed_sorted": torch.equal(a_s, a_sp)
                      and torch.equal(t_s, t_sp) and torch.equal(nv, nv_p)}
                res[f"{ewa}:{prec}"] = ok
                assert all(ok.values()), f"{name} scene, {ewa}/{prec}: {ok}"
            ids, nv = win.sorted_ids_plain(win.window_keys_plain(
                *ksort, 16, tiles_x, kw["alpha_min"], 4, 16), K)
            srows = win.window_rows(ids, *ksort[1:4], 4)
            res[f"strip_cull:{ewa}"] = {
                "composite_windowed": cull_share(host[0], table.long(), counts, tiles_x,
                                                 kw["alpha_min"], ewa),
                "composite_windowed_sorted": cull_share(host[0], srows, torch.clamp(nv, max=K),
                                                        tiles_x, kw["alpha_min"], ewa)}
            for kern, c in res[f"strip_cull:{ewa}"].items():
                assert c["gated_strips_dropped"] == 0, f"{name} scene, {kern}, {ewa}: {c}"
        res.update(pairs=int(counts.sum()), nv_total=int(nv.sum()), bitwise=True)
        emit({"phase": "thin_windowed", "name": name, "aspect": aspect, **res})
        assert float(t.min()) < 0.5 and int(nv.sum()) > 0, f"the {name} scene is empty"
        out[name] = res
    return out


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
        fill_table_edge_cases(device, K)
        fill = lambda: binning.fill_table(gid_s, starts, NT, K)
        empty = lambda: binning.fill_table_floor(NT, K, device)
        full = lambda: torch.full((NT, K), -1, dtype=torch.int32, device=device)
        ft = dict(
            max_abs_err=0.0, **kernel_ms(fill, 200),
            plain_ms=cuda_ms(lambda: binning.fill_table_plain(gid_s, starts, NT, K), 10),
            # the floor: an empty kernel with the same grid; the same bytes
            # written by torch.full (a reference for the write, not the function)
            empty_ms=graph_ms(empty), empty_stream_ms=cuda_ms(empty, 200),
            full_ms=graph_ms(full), full_stream_ms=cuda_ms(full, 200),
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
        strips = strip_check(G, table, counts, tiles_x, kw_gate["alpha_min"])
        assert strips["gated_strips_dropped"] == 0, \
            f"the strip cull dropped a gated pair: {strips}"
        cf = dict(
            max_abs_err=err_f,
            **kernel_ms(lambda: composite.composite_fused(*args, **kw), 20),
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
        rel = row_rel_err(dGt, dGt_p)
        assert rel <= 2e-4, f"composite_fused_bwd disagrees: {rel} relative"
        # -- the scatter into dG: bitwise reproducible
        dG1 = composite.scatter_rows(composite.composite_fused_bwd(*bargs, **kw), table, P)
        dG2 = composite.scatter_rows(composite.composite_fused_bwd(*bargs, **kw), table, P)
        torch.cuda.synchronize()
        assert torch.equal(dG1, dG2), "dG is not bitwise reproducible"
        assert torch.equal(dGt, composite.composite_fused_bwd(*bargs, **kw)), \
            "dGt is not bitwise reproducible"
        cb = dict(
            max_abs_err=float((dGt - dGt_p).abs().max()), rel_err=rel,
            **kernel_ms(lambda: composite.composite_fused_bwd(*bargs, **kw), 10),
            plain_ms=cuda_ms(lambda: composite.composite_fused_bwd_plain(*bargs, **kw), 3),
            bytes=128 * n_rows + 4 * kept + 4 * NT + 4 * NT * 256 * 26 + 4 * NT * 32 * K,
            ops=BWD_OPS_PER_PIXEL_PAIR * pairs_px)
        results[K] = {"fill_table": ft, "composite_fused": cf,
                      "composite_fused_bwd": cb, "kept_pairs": kept,
                      "live_pixel_pairs": pairs_px, "strip_cull": strips,
                      "scatter_ms": cuda_ms(lambda: composite.scatter_rows(dGt, table, P), 10)}
        emit({"phase": "kernels", "tile_capacity": K, "kept_pairs": kept,
              "live_pixel_pairs": pairs_px, "strip_cull": strips,
              "fill_table_exact": True, "fill_table_edge_cases_exact": True,
              "fill_table": {k: v for k, v in ft.items() if k.endswith("ms")},
              "composite_fused_max_abs_err": err_f,
              "composite_fused_bwd_rel_err": rel, "dG_bitwise_reproducible": True})
        del pre, G, table, acc, acc_p, dGt, dGt_p
    return results


# (slots, tile offsets) of the pair expansion's cases: the offline cell's
# shape, the adapted window's widest (8 x 8) and the SLAM loops' (4 x 4)
EXPAND_CASES = ((2 ** 22, 36), (2 ** 20, 64), (2 ** 20, 16))
# float32 operations of one in-rect offset's conic test: the tile's box (8),
# `qmin.cuh:box_qmin` (the centre test 4, the clamps and the negation 3, the
# four edges' minimisers 16, their four quadratics 36, the minimum of them 3)
# and the gate's comparison (1)
EXPAND_TEST_OPS = 71


def parent_keys(pre, keys, n_live, tiles_x, NT, R):
    """The [R²·P] keys the expansion wrote before it kept the live pairs
    alone, rebuilt from the live ones: entry j·P + g holds slot g's key at
    offset j = dy·R + dx when that pair is live, else ((NT << 16) << 32) | g."""
    import torch

    P = pre.mx.shape[0]
    dev = keys.device
    live = keys[:int(n_live)]
    g = live & 0xFFFFFFFF
    tile = live >> 48
    dx = tile % tiles_x - pre.rmin_x.long()[g]
    dy = tile // tiles_x - pre.rmin_y.long()[g]
    dense = (torch.full((R * R * P,), NT << 16, dtype=torch.int64, device=dev) << 32) \
        | torch.arange(P, dtype=torch.int64, device=dev).repeat(R * R)
    dense[(dy * R + dx) * P + g] = live
    return dense


def sort_all_pairs(dense, NT):
    """`rasterize.sort_pairs` after the expansion as it ran before: the sort
    of every slot and offset's key, sentinels included, the split and the
    tile bounds. Returns (gid_s [R²·P], starts)."""
    import torch

    combined, _ = torch.sort(dense)
    key_s = (combined >> 32).to(torch.int32)
    gid_s = (combined & 0xFFFFFFFF).to(torch.int32)
    bounds = torch.arange(NT + 1, device=dense.device, dtype=torch.int32) << 16
    return gid_s, torch.searchsorted(key_s, bounds, out_int32=True)


def expand_pairs_phase(device, cases=EXPAND_CASES, width=SLICE_W, height=SLICE_H):
    """`expand_pairs` against its plain loop on a seeded random scene at each
    (slots, tile offsets) of `cases`: the live count and overflow exactly,
    the live keys bit for bit once sorted (the kernel's order is not set),
    and through the sort (`sort_pairs`, `bin_gaussians`) every output, also
    against the sort of every slot and offset's key as it ran before
    (`sort_all_pairs`: its gid_s cut at n_binned); its time from a CUDA graph
    (`kernel_ms`) beside its byte bound, and the plain loop's (`cuda_ms`);
    `sort_pairs` end to end (`sort_pairs_ms`, the live count's read
    included) beside the sort of every key (`sort_all_ms`, the expansion
    left out). Returns each case's row, keyed by (slots, tile offsets)."""
    import torch

    from sags_tpu_torch.core.camera import make_camera
    from sags_tpu_torch.core.config import RasterizeConfig
    from sags_tpu_torch.ops import binning
    from sags_tpu_torch.ops import rasterize as rz

    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                      width, height, 2 * math.atan(width / (2 * 431.8)),
                      2 * math.atan(height / (2 * 431.8)))
    tiles_x, tiles_y = width // 16, height // 16
    NT = tiles_x * tiles_y
    results = {}
    for P, max_tiles in cases:
        cfg = RasterizeConfig(max_tiles_per_gaussian=max_tiles, tile_capacity=1024)
        R = binning.offset_window(max_tiles)
        xyz, opac, scales, quats, colors, _ = random_scene(P, device, seed=P + max_tiles)
        with torch.no_grad():
            pre = rz.preprocess(xyz, opac, scales, quats, cam, cfg, colors=colors)
        dq = rz._depth_quant(pre)
        args = (pre, dq, tiles_x, tiles_y, cfg)
        got, n_live, ov = binning.expand_pairs(*args)
        want, want_n, want_ov = binning.expand_pairs_plain(*args)
        torch.cuda.synchronize()
        live = int(n_live)
        assert live == int(want_n) and int(ov) == int(want_ov), \
            f"expand_pairs' counts disagree with its plain loop at P = {P}, MT = {max_tiles}"
        assert torch.equal(torch.sort(got[:live]).values, torch.sort(want).values), \
            f"expand_pairs disagrees with its plain loop at P = {P}, MT = {max_tiles}"
        del want
        binned = rz.bin_gaussians(pre, tiles_x, tiles_y, cfg)
        with swapped(rz, "expand_pairs", binning.expand_pairs_plain):
            binned_p = rz.bin_gaussians(pre, tiles_x, tiles_y, cfg)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(binned, binned_p)), \
            f"bin_gaussians through expand_pairs disagrees with the plain loop " \
            f"at P = {P}, MT = {max_tiles}"
        del binned, binned_p
        dense = parent_keys(pre, got, n_live, tiles_x, NT, R)
        gid_s, starts, _ = rz.sort_pairs(pre, tiles_x, tiles_y, cfg)
        gid_all, starts_all = sort_all_pairs(dense, NT)
        torch.cuda.synchronize()
        assert gid_s.shape == (live,) and torch.equal(gid_s, gid_all[:live]) \
            and torch.equal(starts, starts_all), \
            f"sort_pairs' live prefix disagrees with the sort of every key at P = {P}, " \
            f"MT = {max_tiles}"
        del gid_s, starts, gid_all, starts_all
        sort_all_ms = cuda_ms(lambda: sort_all_pairs(dense, NT), 3)
        del dense
        sort_pairs_ms = cuda_ms(lambda: rz.sort_pairs(pre, tiles_x, tiles_y, cfg), 5)
        v = pre.valid
        n_valid = int(v.sum())
        in_rect = int((torch.clamp(pre.rmax_x - pre.rmin_x, 0, R)
                       * torch.clamp(pre.rmax_y - pre.rmin_y, 0, R))[v].sum())
        # the valid flags, each valid slot's rect, dq, centre, conic and
        # opacity once; the live keys and the two counters written once
        n_bytes = P + 44 * n_valid + 8 * live + 8
        r = dict(kernel_ms(lambda: binning.expand_pairs(*args), 20),
                 plain_ms=cuda_ms(lambda: binning.expand_pairs_plain(*args), 3),
                 bytes=n_bytes, ops=EXPAND_TEST_OPS * in_rect, max_abs_err=0.0,
                 bound_ms=n_bytes / PEAK_BYTES_S * 1e3, valid_slots=n_valid,
                 in_rect_pairs=in_rect, live_pairs=live, live_share=live / (max_tiles * P),
                 overflow_rect=int(ov), sort_pairs_ms=sort_pairs_ms, sort_all_ms=sort_all_ms)
        results[(P, max_tiles)] = r
        emit({"phase": "expand_pairs", "slots": P, "max_tiles": max_tiles,
              "tiles": [tiles_x, tiles_y], "bitwise": True, **r})
        del got, pre, dq, args
    return results


def fill_table_edge_cases(device, K, seed=0):
    """`fill_table` exactly equal to its plain version on counts of 0, 1-3,
    5-7 (a vector half inside), K and above K, starts at every residue mod
    4, and a last segment ending at n_sorted."""
    import numpy as np
    import torch

    from sags_tpu_torch.ops import binning

    rng = np.random.default_rng(seed)
    counts = [0, 1, 2, 3, 5, 6, 7, K, K + 37, 0, 4 * K, 9] + list(rng.integers(0, 2 * K, 52))
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    gid = rng.permutation(int(starts[-1]) + 11)[:int(starts[-1])].astype(np.int32)
    gid_t, starts_t = torch.as_tensor(gid, device=device), torch.as_tensor(starts, device=device)
    got = binning.fill_table(gid_t, starts_t, len(counts), K)
    assert torch.equal(got, binning.fill_table_plain(gid_t, starts_t, len(counts), K)), \
        f"fill_table disagrees with its plain version on the edge cases (K = {K})"


def _sort_stages(n: int) -> int:
    """Compare-exchange stages of a bitonic network over n keys."""
    s = int(math.log2(n))
    return s * (s + 1) // 2


def windowed_cell(device, P=2 ** 18, width=SLICE_W, height=SLICE_H, K=1024):
    """The windowed kernel cell: the seeded scene's preprocessed Gaussians,
    the probe's budgets at tile capacity K, the host-table inputs of
    `composite_windowed` (at the probe's window and, `host16`, cut to the
    kernel sort's 16 blocks) and the inputs of `composite_windowed_sorted`
    at that ceiling."""
    import dataclasses

    import torch

    from sags_tpu_torch.core.camera import make_camera
    from sags_tpu_torch.core.config import RasterizeConfig
    from sags_tpu_torch.ops import rasterize as rz

    xyz, opac, scales, quats, colors, objs = random_scene(P, device)
    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                      width, height, 2 * math.atan(width / (2 * 431.8)),
                      2 * math.atan(height / (2 * 431.8)))
    tiles_x, tiles_y = width // 16, height // 16
    base = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=K, windowed_chunk=512,
                           windowed_big_capacity=128)
    with torch.no_grad():
        occ = {k: v.cpu().numpy() for k, v in
               rz.windowed_occupancy(xyz, opac, scales, quats, cam, base).items()}
        cfg = rz.derive_windowed_budgets(base, occ, P)
        pre = rz.preprocess(xyz, opac, scales, quats, cam, cfg, colors=colors)
        host = rz._prepare_windowed(pre, objs, tiles_x, tiles_y, cfg)
        kcfg = dataclasses.replace(cfg, window_blocks=16, windowed_sort="kernel")
        ksort = rz._prepare_windowed(pre, objs, tiles_x, tiles_y, kcfg, build_table=False)
        host16 = rz._prepare_windowed(pre, objs, tiles_x, tiles_y,
                                      dataclasses.replace(cfg, window_blocks=16))
    kw = dict(alpha_min=cfg.alpha_min, t_min=cfg.transmittance_min,
              chunk=rz._windowed_chunk(cfg), n_span=4)
    return dict(pre=pre, objs=objs, cfg=cfg, tiles_x=tiles_x, tiles_y=tiles_y, kw=kw,
                host=host, args=(host[0], host[2], host[3], host[4], host[5], host[6], 16,
                                 tiles_x),
                ksort=ksort, sargs=(*ksort[:6], 16, tiles_x), host16=host16,
                skw=dict(kw, w_blocks=16, k_tile=K))


class swapped:
    """`module.name` set to `kernel` inside the block: a wrapper launches a
    variant of its kernel (built with other flags) for a measurement, or a
    function the offline trainer calls is observed."""

    def __init__(self, module, name, kernel):
        self.module, self.name, self.kernel = module, name, kernel

    def __enter__(self):
        self.old = getattr(self.module, self.name)
        setattr(self.module, self.name, self.kernel)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.old)


def cull_share(G_s, rows, counts, tiles_x, alpha_min, ewa_impl="vpu", tile_offset=0):
    """`cull_stats` of the windowed loop (`windowed.strip_live`) on the
    entries a kernel composites, whose global rows are `rows`, on the tiles
    `tile_offset`.. of the grid."""
    from sags_tpu_torch.ops import windowed as win

    return cull_stats(
        win.strip_live(G_s, rows, counts, tiles_x, tile_offset, alpha_min, ewa_impl),
        win.strip_gated(G_s, rows, counts, tiles_x, tile_offset, alpha_min, ewa_impl),
        counts)


def sorted_phases(sargs, skw, stops, reps=20):
    """`composite_windowed_sorted`'s time split into its three phases, from
    variants that end after the keys and after the sort (`stops`: the
    kernel built with -DSAGSW_STOP_AFTER=1 and =2)."""
    from sags_tpu_torch.ops import windowed as win

    run = lambda: win.composite_windowed_sorted(*sargs, **skw)
    t = []
    for kern in stops:
        with swapped(win, "SORTED", kern):
            t.append(cuda_ms(run, reps))
    total = cuda_ms(run, reps)
    return {"keys_ms": t[0], "sort_ms": t[1] - t[0], "composite_ms": total - t[1],
            "total_ms": total}


def windowed_kernel_phase(device, P=2 ** 18, width=SLICE_W, height=SLICE_H, K=1024,
                          stops=None):
    """The windowed compositors and the block sort against their plain
    versions at the kernel cell; the kernel sort against the host table;
    the strip cull's share; with `stops`, the kernel sort's phase split."""
    import torch

    from sags_tpu_torch.ops import composite, sort, windowed as win

    cell = windowed_cell(device, P, width, height, K)
    pre, objs, cfg, tiles_x, tiles_y = (cell[k] for k in ("pre", "objs", "cfg", "tiles_x",
                                                          "tiles_y"))
    NT = tiles_x * tiles_y
    (G_s, table, tl, counts, bases, dests, nblks, n_binned, ov_rect, ov_tile, ov_win,
     ov_big) = cell["host"]
    chunk = cell["kw"]["chunk"]
    gate = dict(alpha_min=cfg.alpha_min, t_min=cfg.transmittance_min)
    kw = cell["kw"]
    out = {"window_blocks": cfg.window_blocks, "rows": int(G_s.shape[0]),
           "n_binned": int(n_binned), "overflow_window": int(ov_win),
           "overflow_big": int(ov_big), "overflow_tile": int(ov_tile)}

    # -- composite_windowed: acc and T bitwise equal (the plain version takes
    # the kernel's float32 operations in its order)
    args = cell["args"]
    acc, T = win.composite_windowed(*args, **kw)
    acc_p, T_p = win.composite_windowed_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(float((acc - acc_p).abs().max()), float((T - T_p).abs().max()))
    assert torch.equal(acc, acc_p) and torch.equal(T, T_p), \
        f"composite_windowed disagrees with its plain version: {err}"
    rows = win.window_rows(tl, bases, dests, nblks, 4)
    kept = int((rows >= 0).sum())
    n_rows = int(torch.unique(rows[rows >= 0]).numel())
    pairs_px = float(live_pixel_pairs(G_s[:, :32], rows, counts, tiles_x, chunk, **gate))
    cull = cull_share(G_s, rows, counts, tiles_x, cfg.alpha_min)
    assert cull["gated_strips_dropped"] == 0, f"composite_windowed's cull: {cull}"
    out["composite_windowed"] = dict(
        max_abs_err=err,
        **kernel_ms(lambda: win.composite_windowed(*args, **kw), 20),
        plain_ms=cuda_ms(lambda: win.composite_windowed_plain(*args, **kw), 2),
        # each composited row's 32 columns once, the kept work list, the
        # span plan and counts, acc + T out
        bytes=128 * n_rows + 4 * kept + 4 * NT * (1 + 3 * 4) + 4 * NT * 256 * 25,
        ops=FWD_OPS_PER_PIXEL_PAIR * pairs_px, live_pixel_pairs=pairs_px, strip_cull=cull)
    del acc_p, T_p

    # -- composite_windowed_bwd: 2e-4 relative per row of dGt (the fused
    # backward's bar); dG_s after the scatter bitwise equal over two runs
    g = torch.Generator(device=device).manual_seed(1)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G_s, tl, counts, bases, dests, nblks, d_acc, d_T, T, 16, tiles_x)
    dGt = win.composite_windowed_bwd(*bargs, **kw)
    dGt_p = win.composite_windowed_bwd_plain(*bargs, **kw)
    torch.cuda.synchronize()
    rel_b = row_rel_err(dGt, dGt_p)
    err_b = float((dGt - dGt_p).abs().max())
    del dGt_p
    assert rel_b <= 2e-4, f"composite_windowed_bwd disagrees: {rel_b} relative"
    P_all = G_s.shape[0]
    dG1 = composite.scatter_rows(win.composite_windowed_bwd(*bargs, **kw), table, P_all)
    dG2 = composite.scatter_rows(win.composite_windowed_bwd(*bargs, **kw), table, P_all)
    torch.cuda.synchronize()
    assert torch.equal(dG1, dG2), "dG_s of the windowed backward is not bitwise reproducible"
    out["composite_windowed_bwd"] = dict(
        max_abs_err=err_b, rel_err=rel_b,
        **kernel_ms(lambda: win.composite_windowed_bwd(*bargs, **kw), 10),
        plain_ms=cuda_ms(lambda: win.composite_windowed_bwd_plain(*bargs, **kw), 2),
        # composite_windowed's reads plus d_acc, d_T and T_final in, dGt out
        bytes=128 * n_rows + 4 * kept + 4 * NT * (1 + 3 * 4) + 4 * NT * 256 * 26
        + 4 * NT * 32 * K,
        ops=BWD_OPS_PER_PIXEL_PAIR * pairs_px, live_pixel_pairs=pairs_px)
    del dG1, dG2

    # -- composite_windowed_sorted at the largest window it sorts (16 blocks)
    G2, b2, d2, n2, ss, se, _, ov_raw, _ = cell["ksort"]
    sargs, skw = cell["sargs"], cell["skw"]
    acc_s, T_s, nv = win.composite_windowed_sorted(*sargs, **skw)
    acc_sp, T_sp, nv_p = win.composite_windowed_sorted_plain(*sargs, **skw)
    torch.cuda.synchronize()
    assert torch.equal(nv, nv_p), "composite_windowed_sorted: nv disagrees"
    err_s = max(float((acc_s - acc_sp).abs().max()), float((T_s - T_sp).abs().max()))
    assert torch.equal(acc_s, acc_sp) and torch.equal(T_s, T_sp), \
        f"composite_windowed_sorted disagrees with its plain version: {err_s}"
    del acc_sp, T_sp
    keys = win.window_keys_plain(G2, b2, d2, n2, ss, se, 16, tiles_x, cfg.alpha_min, 4, 16)
    order = torch.sort(keys, dim=1).values[:, :K]
    ids = torch.where(order != win.KEY_INVALID, order & win.IDX_MASK,
                      torch.full_like(order, -1))
    srows = win.window_rows(ids, b2, d2, n2, 4)
    scount = torch.clamp(nv, max=K)
    scull = cull_share(G2, srows, scount, tiles_x, cfg.alpha_min)
    assert scull["gated_strips_dropped"] == 0, f"composite_windowed_sorted's cull: {scull}"
    n_comp = int(torch.unique(srows[srows >= 0]).numel())
    # rows the windows read (in a span and in an allocated block)
    delta = torch.zeros(G2.shape[0] + 1, dtype=torch.int64, device=device)
    lo = ss.long()
    hi = torch.minimum(se.long(), (b2.long() + n2.long()) * 128)
    live = hi > lo
    delta.index_add_(0, lo[live], torch.ones_like(lo[live]))
    delta.index_add_(0, hi[live], -torch.ones_like(hi[live]))
    n_span_rows = int((torch.cumsum(delta, 0)[:-1] > 0).sum())
    # the key tests: each tile's rows in its spans and inside its 16 blocks
    nb = torch.clamp(torch.minimum(n2.long(), 16 - d2.long()), min=0)
    key_rows = int(torch.clamp(
        torch.minimum(torch.clamp(se.long(), max=G2.shape[0]), (b2.long() + nb) * 128)
        - torch.maximum(ss.long(), b2.long() * 128), min=0).sum())
    spairs = float(live_pixel_pairs(G2[:, :32], srows, scount, tiles_x, chunk, **gate))
    # the compare-exchanges of the sort this run's keys need: nv padded to a
    # power of two per tile
    n_pow2 = [1 << max(int(x) - 1, 0).bit_length() for x in nv.tolist()]
    ce = sum((n // 2) * _sort_stages(n) for n in n_pow2 if n > 1)
    out["composite_windowed_sorted"] = dict(
        max_abs_err=err_s, nv_exact=True,
        **kernel_ms(lambda: win.composite_windowed_sorted(*sargs, **skw), 20),
        plain_ms=cuda_ms(lambda: win.composite_windowed_sorted_plain(*sargs, **skw), 2),
        # validity columns (11 floats) of every window row, the 24 features
        # of every composited row, the span plan, acc + T + nv out
        bytes=44 * n_span_rows + 96 * n_comp + 4 * NT * 5 * 4 + 4 * NT * (256 * 25 + 1),
        # compositing, ~40 operations of key math per window row, and the
        # sort's compare-exchanges (a min and a max each)
        ops=FWD_OPS_PER_PIXEL_PAIR * spairs + 40.0 * key_rows + 2.0 * ce,
        live_pixel_pairs=spairs, compare_exchanges=ce, key_rows=key_rows,
        nv_total=int(nv.sum()),
        overflow_window_raw=int(ov_raw), strip_cull=scull)
    if stops is not None:
        out["composite_windowed_sorted"]["phases"] = sorted_phases(sargs, skw, stops)

    variants = variant_checks(pre, objs, cfg, tiles_x, tiles_y, kw, acc, T, acc_s, sargs,
                              skw)

    # -- the kernel sort against the host table at the same 16-block budget:
    # the same bits on every tile whose spans all fit the window
    h = cell["host16"]
    acc_h, T_h = win.composite_windowed(h[0], h[2], h[3], h[4], h[5], h[6], 16, tiles_x,
                                        **kw)
    need = torch.where(se > ss, -torch.div(b2 * 128 - se, 128, rounding_mode="floor"), 0)
    uncut = (n2 == need).reshape(NT, 4).all(dim=1)
    n_uncut = int(uncut.sum())
    assert n_uncut > 0, "every tile's window was cut"
    assert torch.equal(acc_h[uncut], acc_s[uncut]) and torch.equal(T_h[uncut], T_s[uncut]), \
        "kernel sort and host table differ on an uncut tile"
    out["kernel_sort_bitwise_tiles"] = n_uncut

    # -- sort_blocks: exactly torch.sort from 2 keys a block (sorted stage by
    # stage) to 8192 (five transposed rounds), then on [1280, 16, 128]
    g = torch.Generator(device=device).manual_seed(7)
    for shape in ((NT, 1, 2), (NT, 1, 64), (NT, 2, 128), (NT, 16, 128), (64, 64, 128)):
        for hi in (2 ** 31 - 1, 8):  # the whole int32 range, and heavy ties
            x = torch.randint(-hi - 1, hi, shape, generator=g, device=device,
                              dtype=torch.int64).to(torch.int32)
            assert torch.equal(sort.sort_blocks(x), sort.sort_blocks_plain(x)), \
                f"sort_blocks disagrees with torch.sort on blocks of {shape[1] * shape[2]}"
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (NT, 16, 128), generator=g, device=device,
                      dtype=torch.int64).to(torch.int32)
    assert torch.equal(sort.sort_blocks(x), sort.sort_blocks_plain(x)), \
        "sort_blocks disagrees with torch.sort"
    flat = x.reshape(NT, -1)
    ce_full = NT * 1024 * _sort_stages(2048)
    out["sort_blocks"] = dict(
        max_abs_err=0.0, **kernel_ms(lambda: sort.sort_blocks(x), 50),
        plain_ms=cuda_ms(lambda: sort.sort_blocks_plain(x), 50),
        library_ms=graph_ms(lambda: torch.sort(flat, dim=1), 50),
        bytes=8 * x.numel(), ops=2.0 * ce_full, compare_exchanges=ce_full)
    out["variants"] = variants
    emit({"phase": "windowed_kernels", "tile_capacity": K,
          "window_blocks_host": cfg.window_blocks, "rows": out["rows"],
          "n_binned": out["n_binned"], "overflow_window_host": out["overflow_window"],
          "overflow_big": out["overflow_big"], "overflow_tile": out["overflow_tile"],
          "composite_windowed_bitwise": True, "composite_windowed_sorted_bitwise": True,
          "nv_exact": True,
          "nv_total": int(nv.sum()), "overflow_window_raw_16_blocks": int(ov_raw),
          "kernel_sort_bitwise_tiles": n_uncut, "tiles": NT, "sort_blocks_exact": True,
          "sort_blocks_exact_block_sizes": [2, 64, 256, 2048, 8192],
          "composite_windowed_bwd_rel_err": rel_b, "dG_s_bitwise_reproducible": True,
          "variants": variants})
    return out


def variant_checks(pre, objs, cfg, tiles_x, tiles_y, kw, acc, T, acc_s, sargs, skw):
    """The windowed compositors' options. Each kernel against its plain
    version: acc and T bitwise equal, nv exact (the plain version takes the
    kernel's float32 operations in its order, `windowed._composite_rows_plain`,
    so a weight rounds to bf16 alike in both), and each option's rgb not
    equal to the float32 longhand render's (`acc`, `T`; `acc_s` for the
    kernel sort), so an option the kernel ignored fails. Each against that
    render at the JAX package's bars (`tests/test_pallas_tpu.py:181-283`):
    `windowed_bf16` rgb, depth and T bitwise equal, obj within 2e-2
    relative and not equal; `feature_precision` "high" within 1e-4 and
    "default" within 8e-3 on rgb, T bitwise equal; `ewa_impl="quad"` within
    2e-3 on rgb and T."""
    import dataclasses

    import torch

    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.ops import windowed as win

    res = {}
    rgb, obj, rest = slice(0, 3), slice(3, 19), slice(19, 24)

    def against_plain(name, fn, plain, *fargs, **fkw):
        got = fn(*fargs, **fkw)
        want = plain(*fargs, **fkw)
        torch.cuda.synchronize()
        if len(got) == 3:
            assert torch.equal(got[2], want[2]), f"{name}: nv disagrees"
        differ = ((got[0] != want[0]).any(dim=-1) | (got[1] != want[1]))
        err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        res[name] = {"max_abs_err": err, "pixels_not_bitwise": int(differ.sum()),
                     "ms": cuda_ms(lambda: fn(*fargs, **fkw), 10)}
        emit({"phase": "variant", "name": name, **res[name]})
        assert not bool(differ.any()), \
            f"{name}: {int(differ.sum())} pixels differ from the plain version (max {err})"
        return got

    bcfg = dataclasses.replace(cfg, windowed_bf16=True)
    with torch.no_grad():
        G_b, _, tl, counts, bases, dests, nblks, *_ = rz._prepare_windowed(
            pre, objs, tiles_x, tiles_y, bcfg)
    args = (G_b, tl, counts, bases, dests, nblks, 16, tiles_x)
    tiers = {"quad": dict(ewa_impl="quad"), "high": dict(feat_prec="high"),
             "default": dict(feat_prec="default")}
    for name, vkw in tiers.items():
        # the 48-column rows: the compositor reads their first 32 columns
        a, t = against_plain(f"composite_windowed:{name}", win.composite_windowed,
                             win.composite_windowed_plain, *args, **kw, **vkw)
        d_rgb = float((a[..., rgb] - acc[..., rgb]).abs().max())
        d_T = float((t - T).abs().max())
        res[f"composite_windowed:{name}"].update(rgb_vs_highest=d_rgb, T_vs_highest=d_T)
        bar = {"quad": 2e-3, "high": 1e-4, "default": 8e-3}[name]
        assert 0.0 < d_rgb <= bar, f"{name}: rgb {d_rgb} from the float32 longhand render"
        if name == "quad":
            assert d_T <= bar, f"quad: T {d_T} from the longhand render"
        else:
            assert torch.equal(t, T), f"{name}: T differs from the highest tier"
        a_s, _, _ = against_plain(f"composite_windowed_sorted:{name}",
                                  win.composite_windowed_sorted,
                                  win.composite_windowed_sorted_plain, *sargs, **skw, **vkw)
        assert not torch.equal(a_s[..., rgb], acc_s[..., rgb]), \
            f"composite_windowed_sorted:{name}: rgb equals the longhand render's"

    a, t = against_plain("composite_windowed:bf16", win.composite_windowed,
                         win.composite_windowed_plain, *args, **kw, bf16_obj=True)
    o_rel = float((a[..., obj] - acc[..., obj]).abs().max() / acc[..., obj].abs().max())
    res["composite_windowed:bf16"]["obj_rel_vs_float32"] = o_rel
    assert torch.equal(a[..., rgb], acc[..., rgb]) and torch.equal(a[..., rest], acc[..., rest]) \
        and torch.equal(t, T), "bf16: rgb, depth or T differ from the float32 render"
    assert 0.0 < o_rel <= 2e-2, f"bf16: obj {o_rel} relative from the float32 render"
    return res


def slam_config(points=4096, capacity=2 ** 18, train_windowed=False, tracking="gicp",
                fused_frontend=True, **tracking_kw):
    """The pipeline bench's operating point (`bench.py:bench_pipeline`),
    with the tracking backend `tracking` at its defaults but `tracking_kw`."""
    from sags_tpu_torch.core.config import (KeyframeConfig, MapConfig,
                                            RasterizeConfig, SLAMConfig,
                                            TrackingConfig)

    return SLAMConfig(
        raster=RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=512, chunk=64,
                               train_windowed=train_windowed),
        map=MapConfig(initial_capacity=capacity),
        keyframes=KeyframeConfig(keyframe_freq=5, window=16),
        tracking=TrackingConfig(backend=tracking, max_points=points, **tracking_kw),
        post_train_iters=0, metrics_interval=5, fused_frontend=fused_frontend,
    )


def slam_dataset(device, n_frames, width=SLICE_W, height=SLICE_H, n_world=65536,
                 points=4096, imu_substeps=0):
    """The pipeline bench's synthetic sequence."""
    from sags_tpu_torch.io.datasets import SyntheticDataset

    return SyntheticDataset(n_frames=n_frames, width=width, height=height,
                            n_world=n_world, pts_per_frame=points, step=0.075,
                            clutter=0.3, imu_substeps=imu_substeps, device=device)


def slam_setup(device, n_frames, width=SLICE_W, height=SLICE_H, n_world=65536,
               points=4096, capacity=2 ** 18, train_windowed=False):
    """The pipeline bench's operating point: (SLAMConfig, frames, dataset)."""
    cfg = slam_config(points, capacity, train_windowed)
    ds = slam_dataset(device, n_frames, width, height, n_world, points)
    return cfg, list(ds), ds


def slam_phase(device, n_warm=32, n_timed=16, **sizes):
    """The port's main path: SLAMPipeline.run at the bench operating point."""
    import numpy as np
    import torch

    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam import step as slam_step
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.traj import ate_rmse

    t0 = time.perf_counter()
    cfg, frames, ds = slam_setup(device, n_warm + n_timed, **sizes)
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
    fwd, bwd = loop_fused_check(device, pipe.state.map, pipe.cfg, kf.camera)

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
          "composite_fused_at_loop": fwd, "composite_fused_bwd_at_loop": bwd,
          "lm_iterations_per_frame": [list(x) for x in pipe.lm_log]})
    assert np.isfinite(losses).all(), "non-finite loss"
    assert_loop_fused(fwd, bwd, "the loop")
    assert len(losses) == n_frames, len(losses)
    assert last_mean < first_mean, (first_mean, last_mean)
    assert ate_near < ATE_BAR_M, f"ATE {ate_near} m over the first {ATE_BAR_PATH_M} m"
    assert ate <= 1.05 * REFERENCE_ATE_M, f"ATE {ate} m, reference {REFERENCE_ATE_M} m"
    for sym in SLAM_KERNELS:
        assert launches[sym] > 0, f"{sym} never launched in the SLAM loop"
    return launches, pipe, frames, poses, {"ms_per_frame": frame_ms,
                                           "ms_per_train_step": step_ms, "ate_m": ate,
                                           "dataset": ds}


# A pair whose alpha lies within a rounding of alpha_min at some pixel can
# land on the other side of the gate in the forward kernels, which contract
# the exponent into fused multiply-adds while the plain versions round each
# operation (the needle scene's case): that pixel's acc then differs by
# ~alpha_min·|feature|, and that tile's backward rows by the pair's whole
# gradient there. A tile whose forward agrees to GATE_STABLE_ATOL has no
# such pixel; the backward bar holds on those tiles, and the others are
# counted (as pixels, at most NEEDLE_PIXELS_OFF of them).
GATE_STABLE_ATOL = 1e-4
# at most this many tiles may be left out of the backward's bar, each
# diagnosed by a pair at the gate where the forward differs most
GATE_UNSTABLE_TILES = 2


def near_gate_pairs(G, table, counts, tile, pixel, tiles_x, alpha_min, rel=1e-5,
                    tile_offset=0) -> int:
    """The pairs of `tile` (row `tile` of the table, tile `tile_offset +
    tile` of the grid) whose alpha at `pixel` lies within `rel` of
    alpha_min (the plain version's float32 arithmetic)."""
    import torch

    from sags_tpu_torch.ops import composite

    px, py = composite.tile_pixel_coords(1, tiles_x, 16, tile_offset + tile, G.device)
    Gc = G[table[tile, :int(counts[tile])].clamp(min=0).long()][None]
    _, _, power = composite.ewa_power(Gc, px[:, pixel:pixel + 1], py[:, pixel:pixel + 1])
    alpha = torch.clamp(Gc[..., 5][:, None, :] * torch.exp(power), max=0.99)
    return int(((alpha / alpha_min - 1.0).abs() < rel).sum())


def loop_fused_check(device, m, cfg, camera, mesh=None):
    """`composite_fused` and `composite_fused_bwd` against their plain
    versions at the shapes a classic training loop uses (`cfg.raster`'s tile
    capacity, R and chunk) on the inputs `rasterize` prepares from map `m`
    for `camera` (under `mesh`: this rank's tiles at its tile offset):
    `fill_table` exactly; the forward's acc and T to 1e-3 absolute (the
    share of pixels off, the tiles not gate-stable and the near-gate pairs
    at the worst pixel reported), its strip cull dropping no gated pair;
    the backward, with seeded cotangents, to 2e-4 relative per output row,
    as at the kernel cell, over all tiles and over the gate-stable ones,
    dGt and the scattered dG compared over two launches. Returns (forward's,
    backward's) results; `assert_loop_fused` holds them."""
    import torch

    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import binning, composite
    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.parallel.mesh import shard_tiles, tile_sharding

    rc = cfg.raster
    tiles_x, tiles_y = -(-camera.width // rc.tile), -(-camera.height // rc.tile)
    kw = dict(alpha_min=rc.alpha_min, t_min=rc.transmittance_min, chunk=rc.chunk)
    with torch.no_grad():
        pre = rz.preprocess(m.xyz, gm.get_opacity(m), gm.get_scaling(m), gm.get_rotation(m),
                            camera, rc, shs=gm.get_shs(m), sh_degree=cfg.map.sh_degree,
                            active_mask=m.active)
        table, counts, *_ = rz.bin_gaussians(pre, tiles_x, tiles_y, rc)
        G = rz._pack_gaussians(pre, m.obj_dc).contiguous()
        gid_s, starts, _ = rz.sort_pairs(pre, tiles_x, tiles_y, rc)
    NT = tiles_x * tiles_y
    fill_exact = torch.equal(binning.fill_table(gid_s, starts, NT, rc.tile_capacity),
                             binning.fill_table_plain(gid_s, starts, NT, rc.tile_capacity))
    toff = 0
    if mesh is not None:
        _, toff, _ = tile_sharding(mesh, NT)
        table, counts = shard_tiles(table, mesh, -1), shard_tiles(counts, mesh)
        kw["tile_offset"] = toff
    fargs = (G, table, counts, rc.tile, tiles_x)
    acc, T = composite.composite_fused(*fargs, **kw)
    acc_p, T_p = composite.composite_fused_plain(*fargs, **kw)
    torch.cuda.synchronize()
    shapes = {"chunk": rc.chunk, "tile_capacity": rc.tile_capacity,
              "max_tiles_per_gaussian": rc.max_tiles_per_gaussian, "tile_offset": toff,
              "pairs": int(counts.sum()), "deepest_tile": int(counts.max())}
    d = (acc - acc_p).abs()
    d_px = torch.maximum(d.amax(dim=-1), (T - T_p).abs())  # [NT, 256]
    stable = d_px.amax(dim=1) <= GATE_STABLE_ATOL
    worst_tile, worst_px = divmod(int(torch.argmax(d_px)), d_px.shape[1])
    groups = {"rgb": slice(0, 3), "obj": slice(3, 19), "rest": slice(19, None)}
    fwd = dict(shapes, fill_table_exact=fill_exact,
               max_abs_err=float(d_px.max()),
               max_abs_err_by_group={k: float(d[..., g].max()) for k, g in groups.items()},
               scale_by_group={k: float(acc_p[..., g].abs().max()) for k, g in groups.items()},
               pixels_off_1e3=int((d_px > 1e-3).sum()),
               share_of_pixels_off=float((d_px > 1e-3).to(torch.float32).mean()),
               gate_unstable_tiles=int((~stable).sum()),
               near_gate_pairs_at_worst_pixel=near_gate_pairs(
                   G, table, counts, worst_tile, worst_px, tiles_x, rc.alpha_min,
                   tile_offset=toff),
               strip_cull=strip_check(G, table, counts, tiles_x, rc.alpha_min, toff),
               ms=cuda_ms(lambda: composite.composite_fused(*fargs, **kw), 5))
    del acc_p, T_p
    g = torch.Generator(device=device).manual_seed(2)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G, table, counts, d_acc, d_T, T, rc.tile, tiles_x)
    dGt = composite.composite_fused_bwd(*bargs, **kw)
    dGt_2 = composite.composite_fused_bwd(*bargs, **kw)
    dGt_p = composite.composite_fused_bwd_plain(*bargs, **kw)
    dG = composite.scatter_rows(dGt, table, G.shape[0])
    dG_2 = composite.scatter_rows(dGt_2, table, G.shape[0])
    torch.cuda.synchronize()
    bwd = dict(shapes, rel_err=row_rel_err(dGt[stable], dGt_p[stable]),
               rel_err_all_tiles=row_rel_err(dGt, dGt_p),
               gate_unstable_tiles=int((~stable).sum()),
               max_abs_err=float((dGt - dGt_p).abs().max()),
               dGt_bitwise=torch.equal(dGt, dGt_2), dG_bitwise=torch.equal(dG, dG_2),
               ms=cuda_ms(lambda: composite.composite_fused_bwd(*bargs, **kw), 5))
    return fwd, bwd


def assert_loop_fused(fwd, bwd, where, gate_pixels=False) -> None:
    """`loop_fused_check`'s bars: 1e-3 absolute on every pixel and 2e-4
    relative per row on every tile; with `gate_pixels`, the needle scene's
    bars (all but NEEDLE_PIXELS_OFF of the pixels; the gate-stable tiles,
    all but GATE_UNSTABLE_TILES of them, and only where a pair lies at the
    gate at the forward's worst pixel)."""
    assert fwd["fill_table_exact"], f"fill_table at {where}'s shapes: {fwd}"
    if gate_pixels:
        assert fwd["share_of_pixels_off"] <= NEEDLE_PIXELS_OFF, \
            f"composite_fused at {where}'s shapes: {fwd}"
        assert fwd["gate_unstable_tiles"] <= GATE_UNSTABLE_TILES, \
            f"composite_fused at {where}'s shapes: too many tiles off the gate-stable bar: {fwd}"
        assert fwd["gate_unstable_tiles"] == 0 or fwd["near_gate_pairs_at_worst_pixel"] >= 1, \
            f"composite_fused at {where}'s shapes differs with no pair at the gate: {fwd}"
        assert bwd["rel_err"] <= 2e-4, f"composite_fused_bwd at {where}'s shapes: {bwd}"
    else:
        assert fwd["max_abs_err"] <= 1e-3, f"composite_fused at {where}'s shapes: {fwd}"
        assert bwd["rel_err_all_tiles"] <= 2e-4, f"composite_fused_bwd at {where}'s shapes: {bwd}"
    assert fwd["strip_cull"]["gated_strips_dropped"] == 0, f"strip cull at {where}: {fwd}"
    assert bwd["dGt_bitwise"] and bwd["dG_bitwise"], f"composite_fused_bwd not reproducible: {bwd}"


def slam_windowed_phase(device, frames, classic, n_warm=16, n_timed=8):
    """`SLAMPipeline.run` at the loop cell with `train_windowed=True` over the
    classic loop's first frames: every training step renders through
    `composite_windowed` and differentiates through
    `composite_windowed_bwd`; the overflow counters drive the windowed
    budgets. Then two backward passes of the windowed loss on the newest
    keyframe must give bitwise equal gradients (the slice-store fold-back
    included)."""
    import numpy as np
    import torch

    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.slam import step as slam_step
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.traj import ate_rmse

    n_frames = n_warm + n_timed
    cfg = slam_config(train_windowed=True)
    pipe = SLAMPipeline(cfg, point_budget=cfg.tracking.max_points, rng_seed=0,
                        device=device)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    warm = pipe.run(frames[:n_warm], post_train=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    timed = pipe.run(frames[n_warm:n_frames], post_train=0)
    end.record()
    torch.cuda.synchronize()
    frame_ms = start.elapsed_time(end) / n_timed
    launches = {k.symbol: k.launches for k in _build.kernels()}

    kf = pipe.keyframes[-1]
    state = pipe.state

    def one_step():
        nonlocal state
        state, _ = slam_step.slam_step(state, kf.camera, kf.image, kf.objects, pipe.cfg)

    step_ms = cuda_ms(one_step, 5)

    # two backward passes of the windowed loss at the loop's final state
    m, r = pipe.state.map, pipe.cfg.raster
    same, same_cls3d = gradients_bitwise(device, pipe, kf)
    with torch.no_grad():
        out = slam_step.render_map(m, kf.camera, pipe.cfg, windowed=True)
        occ = rz.windowed_occupancy(m.xyz, gm.get_opacity(m), gm.get_scaling(m),
                                    gm.get_rotation(m), kf.camera, r, active_mask=m.active)
    bwd = loop_bwd_check(device, pipe, kf.camera)

    poses = np.concatenate([warm.poses_est, timed.poses_est])
    gt = np.concatenate([warm.poses_gt, timed.poses_gt])
    ate, _ = ate_rmse(poses, gt, align=False)
    ate_classic, _ = ate_rmse(classic["poses"][:n_frames], gt, align=False)
    losses = np.asarray(timed.losses)
    third = max(1, len(losses) // 3)
    first_mean, last_mean = float(losses[:third].mean()), float(losses[-third:].mean())
    steps = timed.train_iters
    emit({"phase": "slam_windowed", "frames": n_frames, "train_iters": steps,
          "ms_per_frame": frame_ms, "ms_per_train_step": step_ms,
          "classic_ms_per_frame": classic["ms_per_frame"],
          "classic_ms_per_train_step": classic["ms_per_train_step"],
          "warm_seconds": warm_s, "ate_m": ate, "classic_ate_m_same_frames": ate_classic,
          "loss_first_third": first_mean, "loss_last_third": last_mean,
          "window_blocks": r.window_blocks, "max_tiles_per_gaussian": r.max_tiles_per_gaussian,
          "windowed_big_capacity": r.windowed_big_capacity, "tile_capacity": r.tile_capacity,
          "overflow": {f: int(getattr(out, f)) for f in (
              "overflow_tile", "overflow_rect", "overflow_window", "overflow_big",
              "overflow_tile_live", "tile_peak", "n_binned")},
          "live_slice_store_copies": int(occ["live_copies"]),
          "n_active": int(m.active.sum()), "launches": launches,
          "launches_per_frame": {k: v / n_frames for k, v in launches.items()},
          "gradients_bitwise_equal": same, "gradients_bitwise_equal_cls3d_step": same_cls3d,
          "composite_windowed_bwd_at_loop": bwd})
    assert np.isfinite(losses).all(), "non-finite loss"
    assert len(losses) == n_frames == steps, (len(losses), steps)
    assert last_mean < first_mean, (first_mean, last_mean)
    assert abs(ate - ate_classic) <= 0.01 * ate_classic, (ate, ate_classic)
    for sym in ("sags_composite_windowed", "sags_composite_windowed_bwd"):
        assert launches[sym] == steps, f"{sym}: {launches[sym]} launches, {steps} steps"
    for sym in ("sags_composite_fused", "sags_composite_fused_bwd"):
        assert launches[sym] == 0, f"{sym} launched in the windowed loop"
    assert all(same.values()), f"windowed gradients not bitwise reproducible: {same}"
    assert bwd["rel_err"] <= 2e-4, f"composite_windowed_bwd at the loop's shapes: {bwd}"
    fwd = bwd["composite_windowed"]
    assert fwd["bitwise"], f"composite_windowed at the loop's shapes: {fwd}"
    assert fwd["strip_cull"]["gated_strips_dropped"] == 0, \
        f"composite_windowed's cull at the loop's shapes: {fwd}"
    return launches, n_frames, bwd, pipe


def gradients_bitwise(device, pipe, kf):
    """Two backward passes of the step's loss on keyframe `kf` (its image
    and objects) at the loop's final state, without and with the cls3d
    term: whether each of the seven parameter groups' gradients is bitwise
    equal across the two. Returns (without, with)."""
    import numpy as np
    import torch

    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.models.classifier import ClassifierParams
    from sags_tpu_torch.slam import step as slam_step
    from sags_tpu_torch.utils.draws import ReplayDraws

    m = pipe.state.map
    clf = ClassifierParams(*(p.detach() for p in pipe.state.classifier))
    u = np.random.default_rng(0).uniform(size=m.capacity).astype(np.float32)

    def grads(use_cls3d):
        params = gm.Params(*(p.detach().requires_grad_(True) for p in gm.params_of(m)))
        with torch.enable_grad():
            loss, _ = slam_step._loss_fn(params, clf, m, kf.camera, kf.image, kf.objects,
                                         use_cls3d, ReplayDraws([u], device), pipe.cfg)
            return torch.autograd.grad(loss, tuple(params), allow_unused=True)

    def bitwise(use_cls3d):
        a, b = grads(use_cls3d), grads(use_cls3d)
        return {name: (x is None and y is None) or torch.equal(x, y)
                for name, x, y in zip(gm.Params._fields, a, b)}

    return bitwise(False), bitwise(True)


def loop_bwd_check(device, pipe, camera, mesh=None):
    """The windowed kernels at the shapes the windowed loop trains with (its
    final window, R, tile capacity and slice store) on the inputs
    `rasterize` prepares for `camera` (under `mesh`: this rank's tiles at
    its tile offset): `composite_windowed` bitwise equal to its plain
    version, with its strip cull's share and time; and
    `composite_windowed_bwd`, with seeded cotangents, to 2e-4 relative per
    output row, as at the kernel cell."""
    import torch

    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.ops import windowed as win
    from sags_tpu_torch.parallel.mesh import shard_tiles, tile_sharding

    m, rc = pipe.state.map, pipe.cfg.raster
    tiles_x, tiles_y = -(-camera.width // rc.tile), -(-camera.height // rc.tile)
    kw = rz._windowed_kw(rc)
    with torch.no_grad():
        pre = rz.preprocess(m.xyz, gm.get_opacity(m), gm.get_scaling(m), gm.get_rotation(m),
                            camera, rc, shs=gm.get_shs(m), sh_degree=pipe.cfg.map.sh_degree,
                            active_mask=m.active)
        G_s, _, tl, counts, b, d, n, *_ = rz._prepare_windowed(pre, m.obj_dc, tiles_x,
                                                               tiles_y, rc)
    toff = 0
    if mesh is not None:
        NT, R = counts.shape[0], kw["n_span"]
        _, toff, _ = tile_sharding(mesh, NT)
        tl, counts = shard_tiles(tl, mesh, -1), shard_tiles(counts, mesh)
        b, d, n = (shard_tiles(x.reshape(NT, R), mesh).reshape(-1) for x in (b, d, n))
        kw["tile_offset"] = toff
    fargs = (G_s, tl, counts, b, d, n, rc.tile, tiles_x)
    acc, T = win.composite_windowed(*fargs, **kw)
    acc_p, T_p = win.composite_windowed_plain(*fargs, **kw)
    torch.cuda.synchronize()
    rows = win.window_rows(tl, b, d, n, kw["n_span"])
    fwd = {"bitwise": torch.equal(acc, acc_p) and torch.equal(T, T_p),
           "max_abs_err": max(float((acc - acc_p).abs().max()), float((T - T_p).abs().max())),
           "strip_cull": cull_share(G_s, rows, counts, tiles_x, rc.alpha_min,
                                    tile_offset=toff),
           "ms": cuda_ms(lambda: win.composite_windowed(*fargs, **kw), 5)}
    del acc_p, T_p
    g = torch.Generator(device=device).manual_seed(2)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G_s, tl, counts, b, d, n, d_acc, d_T, T, rc.tile, tiles_x)
    dGt = win.composite_windowed_bwd(*bargs, **kw)
    dGt_p = win.composite_windowed_bwd_plain(*bargs, **kw)
    torch.cuda.synchronize()
    return {"rel_err": row_rel_err(dGt, dGt_p), "max_abs_err": float((dGt - dGt_p).abs().max()),
            "n_span": kw["n_span"], "chunk": kw["chunk"], "tile_capacity": rc.tile_capacity,
            "window_blocks": rc.window_blocks, "rows": int(G_s.shape[0]), "tile_offset": toff,
            "entries": int((tl >= 0).sum()),
            "ms": cuda_ms(lambda: win.composite_windowed_bwd(*bargs, **kw), 5),
            "composite_windowed": fwd}


def eval_frame_check(m, cam, rc, sh_degree, mode) -> dict:
    """One eval render's windowed compositor (`mode`: "windowed_host" or
    "windowed_kernel") bitwise against its plain version on the inputs the
    render prepares from map `m` for `cam` at raster config `rc`, its strip
    cull dropping no gated strip; on the host-table path also the render's
    own `fill_table` call exactly against its plain version on the inputs it
    was given. Returns its error, time and cull share."""
    import torch

    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import binning
    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.ops import windowed as win

    tables = []

    def kept_fill_table(*args):
        out = binning.fill_table(*args)
        tables.append((args, out))
        return out

    tiles_x, tiles_y = -(-cam.width // 16), -(-cam.height // 16)
    kw = dict(alpha_min=rc.alpha_min, t_min=rc.transmittance_min,
              chunk=rz._windowed_chunk(rc),
              n_span=int(round(rc.max_tiles_per_gaussian ** 0.5)))
    with torch.no_grad():
        pre = rz.preprocess(m.xyz, gm.get_opacity(m), gm.get_scaling(m),
                            gm.get_rotation(m), cam, rc, shs=gm.get_shs(m),
                            sh_degree=sh_degree, active_mask=m.active)
        if mode == "windowed_host":
            with swapped(rz, "fill_table", kept_fill_table):
                G_s, _, tl, counts, b, d, n, *_ = rz._prepare_windowed(
                    pre, m.obj_dc, tiles_x, tiles_y, rc)
            (t_args, t_out), = tables
            fill_exact = torch.equal(t_out, binning.fill_table_plain(*t_args))
            got = win.composite_windowed(G_s, tl, counts, b, d, n, 16, tiles_x, **kw)
            want = win.composite_windowed_plain(G_s, tl, counts, b, d, n, 16, tiles_x, **kw)
            rows = win.window_rows(tl, b, d, n, kw["n_span"])
            cnt = counts
            ms = cuda_ms(lambda: win.composite_windowed(G_s, tl, counts, b, d, n, 16,
                                                        tiles_x, **kw), 5)
        else:
            G_s, b, d, n, ss, se, *_ = rz._prepare_windowed(
                pre, m.obj_dc, tiles_x, tiles_y, rc, build_table=False)
            skw = dict(kw, w_blocks=rc.window_blocks, k_tile=rc.tile_capacity)
            got = win.composite_windowed_sorted(G_s, b, d, n, ss, se, 16, tiles_x, **skw)
            want = win.composite_windowed_sorted_plain(G_s, b, d, n, ss, se, 16, tiles_x,
                                                       **skw)
            assert torch.equal(got[2], want[2]), "eval frame: nv disagrees"
            keys = win.window_keys_plain(G_s, b, d, n, ss, se, 16, tiles_x, rc.alpha_min,
                                         kw["n_span"], rc.window_blocks)
            ids, nv = win.sorted_ids_plain(keys, rc.tile_capacity)
            rows = win.window_rows(ids, b, d, n, kw["n_span"])
            cnt = torch.clamp(nv, max=rc.tile_capacity)
            ms = cuda_ms(lambda: win.composite_windowed_sorted(G_s, b, d, n, ss, se, 16,
                                                               tiles_x, **skw), 5)
            fill_exact = None  # the in-kernel sort builds no table
        cull = cull_share(G_s, rows, cnt, tiles_x, rc.alpha_min)
    torch.cuda.synchronize()
    err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        f"{mode} eval frame: {err} from the plain version"
    assert fill_exact is not False, f"{mode} eval frame: fill_table differs from its plain version"
    assert cull["gated_strips_dropped"] == 0, f"{mode} eval frame's cull: {cull}"
    return {"max_abs_err": err, "fill_table_exact": fill_exact, "ms": ms, "strip_cull": cull,
            "window_blocks": rc.window_blocks, "tile_capacity": rc.tile_capacity,
            "max_tiles_per_gaussian": rc.max_tiles_per_gaussian}


def eval_phase(device, pipe, frames, poses):
    """`SLAMPipeline.evaluate` of the loop's map at the estimated poses, in
    three render modes; each windowed compositor checked on one frame."""
    import dataclasses

    import numpy as np
    import torch

    from sags_tpu_torch.eval.metrics import psnr
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam import step as slam_step

    base_cfg = pipe.cfg
    r = base_cfg.raster
    modes = {
        # the default: windowed, host table, budgets from the probe
        "windowed_host": (r, True),
        # the in-kernel sort takes at most 16 window blocks: its own budget
        "windowed_kernel": (dataclasses.replace(
            r, windowed_sort="kernel", window_blocks=16,
            tile_capacity=max(r.tile_capacity, r.tile_capacity_max)), False),
        "classic": (dataclasses.replace(r, windowed=False), False),
    }
    must_launch = {"windowed_host": ("sags_composite_windowed", "sags_fill_table"),
                   "windowed_kernel": ("sags_composite_windowed_sorted",),
                   "classic": ("sags_composite_fused", "sags_fill_table")}
    idx = list(range(0, len(frames), EVAL_EVERY))
    cams = [pipe._camera_for(frames[i], poses[i]) for i in idx]
    results, renders = {}, {}
    for mode, (raster, derive) in modes.items():
        pipe.cfg = base_cfg.replace(raster=raster)
        try:
            _build.reset_launch_counts()
            scores = pipe.evaluate(frames, every=EVAL_EVERY, poses=poses,
                                   derive_budgets=derive)
            torch.cuda.synchronize()
            launches = {k.symbol: k.launches for k in _build.kernels()}
            cfg = pipe.eval_config(derive)
        finally:
            pipe.cfg = base_cfg
        for sym in must_launch[mode]:
            assert launches[sym] > 0, f"{sym} never launched in the {mode} eval"
        with torch.no_grad():
            outs = [slam_step.render_map(pipe.state.map, c, cfg) for c in cams]
            ms = cuda_ms(lambda: [slam_step.render_map(pipe.state.map, c, cfg)
                                  for c in cams], 1) / len(cams)
        renders[mode] = [o.color for o in outs]
        counters = {f: float(np.mean([int(getattr(o, f)) for o in outs])) for f in (
            "overflow_tile", "overflow_rect", "overflow_window", "overflow_big",
            "tile_peak")}
        vals = {k: [s[k] for s in scores] for k in ("psnr", "ssim", "lpips",
                                                     "overflow_pairs", "n_binned")}
        assert all(np.isfinite(vals[k]).all() for k in ("psnr", "ssim", "lpips"))
        results[mode] = {
            "frames": len(scores), "psnr": float(np.mean(vals["psnr"])),
            "ssim": float(np.mean(vals["ssim"])), "lpips": float(np.mean(vals["lpips"])),
            "lpips_net": scores[0]["lpips_net"],
            "overflow_pairs": int(np.sum(vals["overflow_pairs"])),
            "overflow_pairs_per_frame": vals["overflow_pairs"],
            "n_binned_per_frame": float(np.mean(vals["n_binned"])),
            "ms_per_eval_render": ms,
            "launches": launches,
            "launches_per_frame": {k: v / len(scores) for k, v in launches.items()},
            "counters_per_frame": counters,
            "window_blocks": cfg.raster.window_blocks,
            "tile_capacity": cfg.raster.tile_capacity,
            "max_tiles_per_gaussian": cfg.raster.max_tiles_per_gaussian,
            "windowed_big_capacity": cfg.raster.windowed_big_capacity,
        }
    for mode in ("windowed_host", "windowed_kernel"):
        results[mode]["psnr_vs_classic"] = float(np.mean(
            [psnr(a, b, mask_zeros=False) for a, b in
             zip(renders[mode], renders["classic"])]))
    assert all(r["n_binned_per_frame"] > 0 for r in results.values())

    # one frame: the CUDA compositors against the plain functions on the
    # inputs the render prepared
    cam = cams[len(cams) // 2]
    checks = {}
    for mode in ("windowed_host", "windowed_kernel"):
        raster, derive = modes[mode]
        pipe.cfg = base_cfg.replace(raster=raster)
        try:
            rc = pipe.eval_config(derive).raster
        finally:
            pipe.cfg = base_cfg
        checks[mode] = eval_frame_check(pipe.state.map, cam, rc, base_cfg.map.sh_degree, mode)
    emit({"phase": "eval", "every": EVAL_EVERY, "modes": results, "frame_check": checks})
    return results, checks


def best_match_iou(gt, pred, min_area=50) -> float:
    """Mean over ground-truth instances of the IoU of the best-overlapping
    predicted label (`tests/test_semantics_quality.py:22`)."""
    import numpy as np

    ious = []
    for g in np.unique(gt):
        gm_ = gt == g
        if g == 0 or gm_.sum() < min_area:
            continue
        labels, counts = np.unique(pred[gm_], return_counts=True)
        pm = pred == labels[np.argmax(counts)]
        ious.append((gm_ & pm).sum() / max((gm_ | pm).sum(), 1))
    return float(np.mean(ious)) if ious else 0.0


def label_persistence(gts, masks, min_area=50) -> float:
    """The share of ground-truth instances, seen (≥ min_area px) in two
    consecutive keyframes, whose most frequent associated label is the same
    non-zero label in both."""
    import numpy as np

    def mode(a):
        v, c = np.unique(a, return_counts=True)
        return int(v[np.argmax(c)])

    kept = total = 0
    for (g0, m0), (g1, m1) in zip(zip(gts, masks), zip(gts[1:], masks[1:])):
        for g in np.unique(g0):
            a0, a1 = g0 == g, g1 == g
            if g == 0 or a0.sum() < min_area or a1.sum() < min_area:
                continue
            total += 1
            kept += int(mode(m0[a0]) == mode(m1[a1]) != 0)
    return kept / max(total, 1)


def fg_accuracy(state, cfg, camera, target) -> float:
    """Foreground pixel accuracy of argmax(classifier(rendered objects))
    against the label map `target` (pixels with a label > 0)."""
    import torch

    from sags_tpu_torch.models.classifier import apply_classifier
    from sags_tpu_torch.slam import step as slam_step

    with torch.no_grad():
        out = slam_step.render_map(state.map, camera, cfg)
        pred = torch.argmax(apply_classifier(state.classifier, out.objects), dim=0)
    fg = target > 0
    return float((pred[fg] == target[fg]).to(torch.float32).mean())


class RecordingAssociator:
    """Wraps a `DeviceInstanceAssociator`'s `associate`: keeps each call's
    inputs, label memory before and after, output and freed labels, and its
    host milliseconds (after a synchronise, so queued work is not counted)."""

    def __init__(self, assoc):
        self.assoc, self.calls, self._fn = assoc, [], assoc.associate
        assoc.associate = self

    def __call__(self, xyz, active, mask, pose, intrinsics, used_labels=None):
        import torch

        prev = self.assoc._prev_labels
        rec = {"xyz": xyz.clone(), "active": active.clone(), "mask": mask.clone(),
               "pose": torch.as_tensor(pose).clone(), "intrinsics": intrinsics,
               "used": set(used_labels), "prev": None if prev is None else prev.clone()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._fn(xyz, active, mask, pose, intrinsics, used_labels=used_labels)
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        rec.update(out=out.clone(), prev_after=self.assoc._prev_labels.clone(),
                   used_after=set(used_labels))
        self.calls.append(rec)
        return out


def associator_replay(rec, cfg) -> dict:
    """The recorded device association replayed by the same code on CPU
    copies of its inputs, keyframe after keyframe: the votes, the remapped
    mask, the label memory and the freed labels must be bitwise equal."""
    import torch

    from sags_tpu_torch.semantics.association import DeviceInstanceAssociator, _project_vote

    cpu = DeviceInstanceAssociator(cfg.semantics.overlap_threshold, lidar_axes=cfg.lidar_axes,
                                   num_classes=cfg.semantics.num_classes)
    same = {"votes": True, "mask": True, "label_memory": True, "freed_labels": True}
    n_votes = 0
    for r in rec.calls:
        c = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in r.items()}
        same["label_memory"] &= (r["prev"] is None) == (cpu._prev_labels is None) and (
            r["prev"] is None or torch.equal(cpu._prev_labels, c["prev"]))
        if r["prev"] is not None:
            H, W = r["mask"].shape
            vkw = (*r["intrinsics"], cpu.L, cpu.lidar_axes, W, H)
            v_dev, _ = _project_vote(r["xyz"], r["active"], r["prev"], r["mask"],
                                     r["pose"][:3, :3], r["pose"][:3, 3], *vkw)
            v_cpu, _ = _project_vote(c["xyz"], c["active"], c["prev"], c["mask"],
                                     c["pose"][:3, :3], c["pose"][:3, 3], *vkw)
            same["votes"] &= torch.equal(v_dev.cpu(), v_cpu)
            n_votes += int(v_cpu.sum())
        used = set(r["used"])
        out = cpu.associate(c["xyz"], c["active"], c["mask"], c["pose"], r["intrinsics"],
                            used_labels=used)
        same["mask"] &= torch.equal(out, c["out"])
        same["label_memory"] &= torch.equal(cpu._prev_labels, c["prev_after"])
        same["freed_labels"] &= used == r["used_after"]
    return dict(same, keyframes=len(rec.calls), votes_cast=n_votes)


def semantic_phase(device, frames, classic, n_warm=16, n_timed=8, n_post=100):
    """`SLAMPipeline.run` with the geometric mask generator (the CLI's
    default backend) over the classic loop's first frames: each keyframe is
    tracked and grown, its label map generated on the host and its IDs
    associated on the device, then trained on. Holds losses, ATE against
    the classic loop's, one metrics row a frame, the three training kernels
    launched and at this loop's shapes, bitwise gradients with the
    keyframe's real labels, and the device association against its CPU
    replay; reports the semantics quality, the classifier's after `n_post`
    more steps on the stored keyframes (`run(post_train=...)`: 24 steps
    move a classifier at Adam's 5e-4 too little to read)."""
    import numpy as np
    import torch

    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.semantics.geometric import GeometricMaskGenerator
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.traj import ate_rmse

    n_frames = n_warm + n_timed
    cfg = slam_config()
    gen = GeometricMaskGenerator(num_classes=cfg.semantics.num_classes)
    gen_ms, generate = [], gen.generate_objects

    def timed_generate(image, depth=None):
        t0 = time.perf_counter()
        out = generate(image, depth)
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    gen.generate_objects = timed_generate
    pipe = SLAMPipeline(cfg, mask_generator=gen, point_budget=cfg.tracking.max_points,
                        rng_seed=0, device=device)
    rec = RecordingAssociator(pipe.associator)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    warm = pipe.run(frames[:n_warm], post_train=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    timed = pipe.run(frames[n_warm:n_frames], post_train=0)
    end.record()
    torch.cuda.synchronize()
    frame_ms = start.elapsed_time(end) / n_timed
    launches = {k.symbol: k.launches for k in _build.kernels()}
    losses = np.array(timed.losses)  # every frame's; post-training appends more

    kf = pipe.keyframes[-1]
    fwd, bwd = loop_fused_check(device, pipe.state.map, pipe.cfg, kf.camera)
    same, same_cls3d = gradients_bitwise(device, pipe, kf)
    replay = associator_replay(rec, cfg)

    # the keyframes: every keyframe_freq-th frame of each run
    freq = cfg.keyframes.keyframe_freq
    kf_frames = [i for i in range(n_warm) if i % freq == 0] + \
        [n_warm + i for i in range(n_timed) if i % freq == 0]
    gts = [classic["dataset"].gt_objects(i) for i in kf_frames]
    masks = [k.objects.cpu().numpy() for k in pipe.keyframes]
    assert len(masks) == len(kf_frames) == len(rec.calls), (len(masks), kf_frames)
    ious = [best_match_iou(g, m) for g, m in zip(gts, masks)]
    t0 = time.perf_counter()
    post = pipe.run([], post_train=n_post)
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    assert post.train_iters == n_frames + n_post and np.isfinite(post.losses).all()
    target = kf.objects
    acc_sem = fg_accuracy(pipe.state, pipe.cfg, kf.camera, target)
    acc_classic = fg_accuracy(classic["pipe"].state, classic["pipe"].cfg, kf.camera, target)

    poses = np.concatenate([warm.poses_est, timed.poses_est])
    gt = np.concatenate([warm.poses_gt, timed.poses_gt])
    ate, _ = ate_rmse(poses, gt, align=False)
    ate_classic, _ = ate_rmse(classic["poses"][:n_frames], gt, align=False)
    third = max(1, len(losses) // 3)
    first_mean, last_mean = float(losses[:third].mean()), float(losses[-third:].mean())
    res = {"phase": "semantic", "frames": n_frames, "train_iters": timed.train_iters,
           "metrics_rows": len(losses), "keyframes": kf_frames,
           "ms_per_frame": frame_ms, "classic_ms_per_frame": classic["ms_per_frame"],
           "warm_seconds": warm_s,
           "host_ms_per_keyframe": {"generate_objects": float(np.mean(gen_ms)),
                                    "associate": float(np.mean([r["ms"] for r in rec.calls]))},
           "generate_objects_ms": gen_ms, "associate_ms": [r["ms"] for r in rec.calls],
           "ate_m": ate, "classic_ate_m_same_frames": ate_classic,
           "loss_first_third": first_mean, "loss_last_third": last_mean,
           "labels_per_keyframe": [int(len(np.unique(m))) for m in masks],
           "mean_best_match_iou": float(np.mean(ious)), "best_match_iou": ious,
           "label_persistence": label_persistence(gts, masks),
           "fg_pixel_accuracy": acc_sem, "classic_fg_pixel_accuracy": acc_classic,
           "post_train_steps": n_post, "post_train_seconds": post_s,
           "tile_capacity_final": pipe.cfg.raster.tile_capacity,
           "launches": launches, "launches_per_frame": {k: v / n_frames
                                                        for k, v in launches.items()},
           "composite_fused_at_loop": fwd, "composite_fused_bwd_at_loop": bwd,
           "gradients_bitwise_equal": same, "gradients_bitwise_equal_cls3d_step": same_cls3d,
           "associator_replay": replay}
    emit(res)
    assert np.isfinite(losses).all(), "non-finite loss"
    assert len(losses) == n_frames == timed.train_iters, (len(losses), timed.train_iters)
    assert last_mean < first_mean, (first_mean, last_mean)
    assert abs(ate - ate_classic) <= 0.01 * ate_classic, (ate, ate_classic)
    for sym in SLAM_KERNELS:
        assert launches[sym] > 0, f"{sym} never launched in the semantic loop"
    # this map holds a pair at the alpha gate (`loop_fused_check` reports
    # it: a gate-unstable tile, a near-gate pair at the worst pixel), so it
    # takes the needle scene's bars
    assert_loop_fused(fwd, bwd, "the semantic loop", gate_pixels=True)
    assert all(same.values()) and all(same_cls3d.values()), \
        f"gradients with the keyframe's labels not bitwise reproducible: {same} {same_cls3d}"
    assert all(v for k, v in replay.items() if isinstance(v, bool)), \
        f"device association differs from its CPU replay: {replay}"
    assert all(len(np.unique(m)) > 2 for m in masks), "a keyframe without instances"
    assert acc_sem > acc_classic, (acc_sem, acc_classic)
    return pipe, [frames[i].image for i in kf_frames[:3]], res


# SAM on the card against the CPU, float32 with TF32 off (first measured in
# this script's run; the sums of the matrix products run in another order)
SAM_FEATURE_ATOL, SAM_LOGIT_ATOL, SAM_LABELS_AGREE = 1e-4, 1e-3, 0.999


def instrument_predictor(gen, device) -> dict:
    """Time `gen`'s encoder (`set_image`) and decoder batches (`decode_boxes`
    + `postprocess_masks`) with a synchronise after each, keeping their
    outputs on the host."""
    import torch

    sync = (lambda: torch.cuda.synchronize()) if device.type == "cuda" else (lambda: None)
    p = gen.predictor
    rec = {"encoder_ms": [], "decoder_ms": [], "features": [], "low_res": []}
    set_image, decode, post = p.set_image, p.decode_boxes, p.postprocess_masks

    def timed_set(image):
        sync()
        t0 = time.perf_counter()
        out = set_image(image)
        sync()
        rec["encoder_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["features"].append(p.features.cpu())
        return out

    def timed_decode(boxes):
        sync()
        rec["_t0"] = time.perf_counter()
        low = decode(boxes)
        rec["low_res"].append(low.cpu())
        return low

    def timed_post(low):
        out = post(low)
        sync()
        rec["decoder_ms"].append((time.perf_counter() - rec.pop("_t0")) * 1e3)
        return out

    p.set_image, p.decode_boxes, p.postprocess_masks = timed_set, timed_decode, timed_post
    return rec


def sam_phase(device, images, frames, num_classes, n_loop=10):
    """SAM's `MaskGenerator` with the shipped weights on the card against
    the port's own CPU run on three keyframe images (encoder features, the
    decoder's low-res logits, the labels), timed; then a 10-frame loop with
    it."""
    import numpy as np
    import torch

    from sags_tpu_torch.models.sam import SAM, load_pretrained
    from sags_tpu_torch.semantics.masks import MaskGenerator
    from sags_tpu_torch.slam.pipeline import SLAMPipeline

    gens = {}
    for name in ("cuda", "cpu"):
        sam = SAM(device=device if name == "cuda" else "cpu")
        assert load_pretrained(sam), "SAM's shipped weights did not load"
        gens[name] = MaskGenerator(sam=sam, num_classes=num_classes)
    # warm the card's encoder and decoder without drawing from either stream
    p = gens["cuda"].predictor
    p.set_image(images[0].transpose(1, 2, 0))
    p.postprocess_masks(p.decode_boxes(np.array([[0, 0, 128, 128]], np.float32)))
    torch.cuda.synchronize()
    recs, labels, total_ms = {}, {}, {}
    for name, gen in gens.items():
        recs[name] = instrument_predictor(gen, torch.device(name))
        labels[name], total_ms[name] = [], []
        for img in images:
            t0 = time.perf_counter()
            labels[name].append(gen.generate_objects(img))
            total_ms[name].append((time.perf_counter() - t0) * 1e3)
    g, c = recs["cuda"], recs["cpu"]
    feat_err = max(float((a - b).abs().max()) for a, b in zip(g["features"], c["features"]))
    logit_err = max(float((a - b).abs().max()) for a, b in zip(g["low_res"], c["low_res"]))
    agree = [float((a == b).mean()) for a, b in zip(labels["cuda"], labels["cpu"])]
    encoder_ms, decoder_ms = list(g["encoder_ms"]), list(g["decoder_ms"])

    cfg = slam_config()
    pipe = SLAMPipeline(cfg, mask_generator=gens["cuda"], point_budget=cfg.tracking.max_points,
                        rng_seed=0, device=device)
    t0 = time.perf_counter()
    run = pipe.run(frames[:n_loop], post_train=0)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    losses = np.asarray(run.losses)
    res = {"phase": "sam", "images": len(images),
           "ms_per_generate_objects": float(np.mean(total_ms["cuda"])),
           "encoder_ms": encoder_ms, "decoder_batch_ms": decoder_ms,
           "decoder_batches": len(decoder_ms),
           "cpu_ms_per_generate_objects": float(np.mean(total_ms["cpu"])),
           "feature_max_abs_err": feat_err, "low_res_logit_max_abs_err": logit_err,
           "labels_agree": agree, "instances": [int(len(np.unique(x))) for x in labels["cuda"]],
           "loop_frames": n_loop, "loop_seconds": loop_s, "loop_losses": losses.tolist(),
           "loop_keyframe_labels": [int(len(torch.unique(k.objects))) for k in pipe.keyframes]}
    emit(res)
    assert feat_err <= SAM_FEATURE_ATOL, f"SAM encoder features, card against CPU: {feat_err}"
    assert logit_err <= SAM_LOGIT_ATOL, f"SAM low-res logits, card against CPU: {logit_err}"
    assert min(agree) >= SAM_LABELS_AGREE, f"SAM labels, card against CPU: {agree}"
    assert len(losses) == n_loop == run.train_iters and np.isfinite(losses).all(), losses
    res["train"] = sam_train_phase(device)
    return res


def sam_train_phase(device, steps=100, batch=16):
    """SAM training at the shipped model's size (embed 160, depth 4, 4 heads,
    256 canvas, 2 decoder blocks) from a random SAM (seed 0): the data built
    by `make_training_data` at its defaults on the card, `steps` steps of
    `train_sam` (lr 3e-4, jitter 4) timed by CUDA events, the loss trend,
    the float16 file read back, and two backward passes of one batch
    bitwise equal in every parameter."""
    import os
    import tempfile

    import numpy as np
    import torch

    from sags_tpu_torch.models import sam_train
    from sags_tpu_torch.models.sam import SAM, load_pretrained

    t0 = time.perf_counter()
    data = sam_train.make_training_data(device=device)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    sam = SAM(device=device, seed=0)
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sam_train.train_sam(sam, data, steps=steps, batch=batch, lr=3e-4, seed=0, jitter=4.0,
                        log_every=0, losses=losses)
    end.record()
    torch.cuda.synchronize()
    ms_per_step = start.elapsed_time(end) / steps
    L = torch.stack(losses).cpu().numpy()

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sam.pkl")
        sam_train.save_fp16(sam, path)
        back = SAM(device=device, seed=1)
        loaded = load_pretrained(back, path)
    want = {n: p.detach().half().float() for n, p in sam.state_dict().items()}
    roundtrip = loaded and all(torch.equal(p, want[n]) for n, p in back.state_dict().items())

    imgs = torch.as_tensor(np.stack([d[0] for d in data[:batch]]), device=device)
    boxes = torch.as_tensor(np.stack([d[1] for d in data[:batch]]), device=device)
    masks = torch.as_tensor(np.stack([d[2] for d in data[:batch]]), device=device)
    params = list(sam.parameters())

    def grads():
        with torch.enable_grad():
            return torch.autograd.grad(sam_train._loss_fn(sam, imgs, boxes, masks), params)

    g1, g2 = grads(), grads()
    differ = [n for (n, _), a, b in zip(sam.named_parameters(), g1, g2) if not torch.equal(a, b)]
    ups = {n: float(g.abs().max()) for (n, _), g in zip(sam.named_parameters(), g1)
           if ".up1." in n or ".up2." in n}
    assert len(ups) == 4 and min(ups.values()) > 0, ups
    res = {"phase": "sam_train", "examples": len(data), "data_seconds": data_s,
           "steps": steps, "batch": batch, "ms_per_step": ms_per_step,
           "loss_first_10": float(L[:10].mean()), "loss_last_10": float(L[-10:].mean()),
           "losses": L.tolist(), "save_load_bitwise": bool(roundtrip),
           "gradients_bitwise_over_two_passes": not differ,
           "gradients_not_bitwise": differ}
    emit(res)
    assert np.isfinite(L).all(), "non-finite SAM training loss"
    assert res["loss_last_10"] < res["loss_first_10"], (res["loss_first_10"],
                                                       res["loss_last_10"])
    assert roundtrip, "save_fp16 / load_pretrained did not give the float16 parameters"
    assert not differ, f"gradients differ over two passes: {differ}"
    return res


def structured_cloud(rng, n=2048):
    """Three walls and a floor with mild waviness (`tests/test_gicp.py`'s
    `make_structured_cloud`): a full 3D constraint set."""
    import numpy as np

    n4 = n // 4
    u = [rng.uniform(0, 4, (n4, 2)) for _ in range(3)] + [rng.uniform(0, 4, (n - 3 * n4, 2))]
    cloud = np.concatenate([
        np.stack([u[0][:, 0], u[0][:, 1], 0.05 * np.sin(3 * u[0][:, 0])], -1),
        np.stack([u[1][:, 0], 0.05 * np.sin(2 * u[1][:, 1]), u[1][:, 1]], -1),
        np.stack([0.05 * np.cos(2 * u[2][:, 0]), u[2][:, 0], u[2][:, 1]], -1),
        np.stack([u[3][:, 0], 4.0 + 0.04 * np.sin(u[3][:, 0] * 2), u[3][:, 1]], -1),
    ]).astype(np.float32)
    return cloud + rng.normal(0, 0.005, cloud.shape).astype(np.float32)


def pose_errors(T_est, T_gt):
    """(translation m, rotation deg) of T_gt⁻¹ T_est."""
    import numpy as np

    dT = np.linalg.inv(T_gt) @ T_est
    cos = (np.trace(dT[:3, :3]) - 1) / 2
    return float(np.linalg.norm(dT[:3, 3])), float(np.degrees(np.arccos(np.clip(cos, -1, 1))))


def registration_phase(device, scan):
    """The pygicp class API on the card on `tests/test_gicp.py`'s structured
    pair (a ~3.5° and 27 cm move): each align within 5 cm / 1° of the true
    transform (NDT P2D within `tests/test_ndt.py`'s 10 cm / 1.5°), timed
    warm (a first call beside it); and `build_voxel_map` twice on a loop
    scan, bitwise equal."""
    import dataclasses

    import numpy as np
    import torch

    from sags_tpu_torch.core.config import GICPConfig
    from sags_tpu_torch.core.transforms import se3_matrix, so3_exp
    from sags_tpu_torch.ops import gicp
    from sags_tpu_torch.ops import registration as reg

    target = structured_cloud(np.random.default_rng(5))
    T_gt = se3_matrix(so3_exp(torch.tensor([0.02, -0.03, 0.05])),
                      torch.tensor([0.15, -0.2, 0.1])).numpy()
    world = structured_cloud(np.random.default_rng(9))
    Ti = np.linalg.inv(T_gt)
    source = (world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    cfg = dataclasses.replace(GICPConfig(), voxel_resolution=0.5)

    def make(cls, **kw):
        def align():
            r = cls(cfg, device=device)
            for name, arg in kw.items():
                getattr(r, name)(*arg)
            r.set_input_target(target)
            r.set_input_source(source)
            return r.align(), r.has_converged()
        return align

    aligns = {
        "FastGICP": (make(reg.FastGICP), 0.05, 1.0),
        "FastGICPSingleThread": (make(reg.FastGICPSingleThread), 0.05, 1.0),
        "FastVGICP_direct1": (make(reg.FastVGICP), 0.05, 1.0),
        "FastVGICP_direct7": (make(reg.FastVGICP, set_neighbor_search_method=("DIRECT7",)),
                              0.05, 1.0),
        "NDTCuda_p2d": (make(reg.NDTCuda, set_resolution=(0.5,), set_distance_mode=("P2D",)),
                        0.10, 1.5),
        "align_points_VGICP": (lambda: (reg.align_points(target, source, method="VGICP",
                                                         voxel_resolution=0.5,
                                                         device=device), True), 0.05, 1.0),
    }
    out = {}
    for name, (fn, t_bar, r_bar) in aligns.items():
        ms = []
        for _ in range(2):  # first call, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T, converged = fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        te, re = pose_errors(T, T_gt)
        out[name] = {"ms": ms[1], "first_call_ms": ms[0], "trans_err_m": te, "rot_err_deg": re,
                     "converged": bool(converged), "gate": [t_bar, r_bar]}

    pts = torch.as_tensor(scan, device=device)
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    g = GICPConfig()
    covs = gicp.estimate_covariances(pts, mask, g.k_correspondences, g.knn_max_distance,
                                     g.regularization).covs
    maps = [gicp.build_voxel_map(pts, covs, mask, g.voxel_resolution, g.max_voxels)
            for _ in range(2)]
    vm_ms = cuda_ms(lambda: gicp.build_voxel_map(pts, covs, mask, g.voxel_resolution,
                                                 g.max_voxels), 5)
    bitwise = all(torch.equal(getattr(maps[0], f), getattr(maps[1], f))
                  for f in ("keys", "means", "covs", "num_points"))
    out["build_voxel_map"] = {"points": int(pts.shape[0]), "voxels": int(maps[0].n_voxels),
                              "bitwise_repeatable": bitwise, "ms": vm_ms}
    return out


def tracking_loop(device, frames, backend, n_warm, n_timed):
    """`SLAMPipeline.run` with tracking `backend` at its defaults over
    `frames[:n_warm + n_timed]` (timed: the last `n_timed`, CUDA events),
    then the three training kernels at this loop's shapes on its newest
    keyframe."""
    import numpy as np
    import torch

    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.traj import ate_rmse

    n_frames = n_warm + n_timed
    cfg = slam_config(tracking=backend)
    pipe = SLAMPipeline(cfg, point_budget=cfg.tracking.max_points, rng_seed=0, device=device)
    _build.reset_launch_counts()
    warm = pipe.run(frames[:n_warm], post_train=0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    timed = pipe.run(frames[n_warm:n_frames], post_train=0)
    end.record()
    torch.cuda.synchronize()
    frame_ms = start.elapsed_time(end) / n_timed
    launches = {k.symbol: k.launches for k in _build.kernels()}
    fwd, bwd = loop_fused_check(device, pipe.state.map, pipe.cfg,
                                pipe.keyframes[-1].camera)

    poses = np.concatenate([warm.poses_est, timed.poses_est])
    gt = np.concatenate([warm.poses_gt, timed.poses_gt])
    ate, err = ate_rmse(poses, gt, align=False)
    near = np.linalg.norm(gt[:, :3, 3] - gt[0, :3, 3], axis=-1) <= ATE_BAR_PATH_M
    ate_near, _ = ate_rmse(poses[near], gt[near], align=False)
    losses = np.asarray(timed.losses)  # the pipeline's log holds every frame
    third = max(1, len(losses) // 3)
    lm = np.asarray(pipe.lm_log, np.float64)
    return pipe, {
        "backend": backend, "frames": n_frames, "ms_per_frame": frame_ms, "ate_m": ate,
        f"ate_first_{ATE_BAR_PATH_M}m": ate_near, "frames_first_path": int(near.sum()),
        "error_m_per_frame": np.asarray(err).tolist(),
        "map_anchored": pipe._map_anchored, "anchored_at_frame": pipe.anchored_at,
        "lm_outer_per_frame": float(lm[:, 0].sum() / n_frames),
        "lm_inner_per_frame": float(lm[:, 1].sum() / n_frames),
        "lm_iterations": pipe.lm_log,
        "loss_first_third": float(losses[:third].mean()),
        "loss_last_third": float(losses[-third:].mean()), "losses_finite":
        bool(np.isfinite(losses).all()), "metrics_rows": len(losses),
        "launches": launches,
        "launches_per_frame": {k: launches[k] / n_frames for k in SLAM_KERNELS},
        "composite_fused_at_loop": fwd, "composite_fused_bwd_at_loop": bwd}


def tracking_phase(device, frames, classic, n_warm=16, n_timed=8):
    """The loop's first 16 + 8 frames under "vgicp" (scan-to-scan against the
    previous scan's voxel map; its ATE within 5% of the JAX package's on the
    same scans) and under "gicp_map" (scan-to-map once the map anchors;
    anchored, and within the 0.12 m bar over the first 0.75 m), each with
    finite, falling losses and the three training kernels launched and held
    at the loop's shapes; then the registration classes on the card."""
    import numpy as np

    from sags_tpu_torch.utils.traj import ate_rmse

    n_frames = n_warm + n_timed
    gt = np.stack([f.pose for f in frames[:n_frames]])
    ate_classic, _ = ate_rmse(classic["poses"][:n_frames], gt, align=False)
    loops = {}
    for backend in ("vgicp", "gicp_map"):
        pipe, loops[backend] = tracking_loop(device, frames, backend, n_warm, n_timed)
    m = loops["gicp_map"]
    relation = m["ate_m"] <= 1.05 * ate_classic + 1e-4  # `tests/test_pipeline.py:152-153`
    reg = registration_phase(device, frames[0].scan)
    res = {"phase": "tracking", "frames": n_frames,
           "classic_ms_per_frame": classic["ms_per_frame"],
           "classic_ate_m_same_frames": ate_classic,
           "classic_lm_outer_per_frame": float(np.sum(
               [x[0] for x in classic["lm_log"][:n_frames - 1]]) / n_frames),
           "classic_lm_inner_per_frame": float(np.sum(
               [x[1] for x in classic["lm_log"][:n_frames - 1]]) / n_frames),
           "reference_vgicp_ate_m": REFERENCE_VGICP_ATE_M,
           "gicp_map_ate_le_1.05_classic_plus_1e-4": "met" if relation else "not met",
           **loops, "registration": reg}
    emit(res)
    for backend, r in loops.items():
        assert r["losses_finite"], f"{backend}: non-finite loss"
        assert r["metrics_rows"] == n_frames, (backend, r["metrics_rows"])
        assert r["loss_last_third"] < r["loss_first_third"], (backend, r["loss_first_third"],
                                                              r["loss_last_third"])
        for sym in SLAM_KERNELS:
            assert r["launches"][sym] > 0, f"{sym} never launched in the {backend} loop"
        assert_loop_fused(r["composite_fused_at_loop"], r["composite_fused_bwd_at_loop"],
                          f"the {backend} loop")
    v = loops["vgicp"]
    assert v["ate_m"] <= 1.05 * REFERENCE_VGICP_ATE_M, \
        f"vgicp ATE {v['ate_m']} m, reference {REFERENCE_VGICP_ATE_M} m"
    assert m["map_anchored"], "gicp_map: the map never anchored"
    near = m[f"ate_first_{ATE_BAR_PATH_M}m"]
    assert near < ATE_BAR_M, f"gicp_map ATE {near} m over the first {ATE_BAR_PATH_M} m"
    for name, r in reg.items():
        if name == "build_voxel_map":
            assert r["bitwise_repeatable"], f"build_voxel_map not bitwise repeatable: {r}"
            continue
        t_bar, r_bar = r["gate"]
        assert r["trans_err_m"] < t_bar and r["rot_err_deg"] < r_bar, f"{name}: {r}"
    return res


class SyncCounter:
    """Counts the host syncs that `torch.cuda.set_sync_debug_mode("warn")`
    reports while it is entered, by frame (the pipeline's per-module frame
    calls, counted by wrapping `pipe._frame_modules`) and by stage: the
    innermost function of `STAGES` on the warning's stack, else "other"
    (the frame queue's thread among them), whose innermost lines of this
    repository are counted in `other_where`."""

    STAGES = ("_track_esikf", "_track", "slam_step", "_train_once", "add_frame_points",
              "_maybe_grow_map")

    def __init__(self, pipe):
        self.pipe = pipe
        self.frame = -1
        self.counts = {}
        self.other_where = {}

    def __enter__(self):
        import warnings

        import torch

        orig = self.pipe._frame_modules

        def frame_modules(*a, **k):
            self.frame += 1
            return orig(*a, **k)

        self.pipe._frame_modules = frame_modules
        self._orig = orig
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" not in str(message):
                return shown(message, category, filename, lineno, file, line)
            stack = traceback.extract_stack()[:-1]
            stage = next((f.name for f in reversed(stack) if f.name in self.STAGES), "other")
            per = self.counts.setdefault(self.frame, {})
            per[stage] = per.get(stage, 0) + 1
            if stage == "other":
                ours = [f for f in stack if "sags_tpu_torch" in f.filename
                        or f.filename.endswith("chip_smoke.py")]
                key = " < ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                                 for f in reversed(ours[-2:]))
                self.other_where[key] = self.other_where.get(key, 0) + 1

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        self.pipe._frame_modules = self._orig

    def per_frame(self, n_frames):
        return [self.counts.get(i, {}) for i in range(n_frames)]


def esikf_loop(device, frames, cfg, n_warm, n_timed):
    """`SLAMPipeline.run` of `cfg` over `frames[:n_warm + n_timed]`: host syncs
    counted over the warm frames, the last `n_timed` timed by CUDA events,
    the ESIKF updates' matches and photometric residuals recorded."""
    import numpy as np
    import torch

    from sags_tpu_torch.ops import _build, esikf
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.traj import ate_rmse

    n_frames = n_warm + n_timed
    pipe = SLAMPipeline(cfg, point_budget=cfg.tracking.max_points, rng_seed=0, device=device)
    scans, photos = [], []

    def keeping(fn, kept, field):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            kept.append(getattr(out, field))
            return out
        return wrapped

    _build.reset_launch_counts()
    with swapped(esikf, "scan_update", keeping(esikf.scan_update, scans, "n_matched")), \
            swapped(esikf, "photo_update", keeping(esikf.photo_update, photos, "n_used")):
        with SyncCounter(pipe) as syncs:
            warm = pipe.run(frames[:n_warm], post_train=0)
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        timed = pipe.run(frames[n_warm:n_frames], post_train=0)
        end.record()
        torch.cuda.synchronize()
    frame_ms = start.elapsed_time(end) / n_timed
    launches = {k.symbol: k.launches for k in _build.kernels()}
    poses = np.concatenate([warm.poses_est, timed.poses_est])
    gt = np.concatenate([warm.poses_gt, timed.poses_gt])
    ate, err = ate_rmse(poses, gt, align=False)
    losses = np.asarray(timed.losses)
    third = max(1, len(losses) // 3)
    res = {"backend": cfg.tracking.backend, "esikf_visual": cfg.tracking.esikf_visual,
           "per_module": not pipe._use_fused, "frames": n_frames,
           "ms_per_frame": frame_ms, "ate_m": ate, "error_m_per_frame": np.asarray(err).tolist(),
           "loss_first_third": float(losses[:third].mean()),
           "loss_last_third": float(losses[-third:].mean()),
           "losses_finite": bool(np.isfinite(losses).all()), "metrics_rows": len(losses),
           "host_syncs_per_warm_frame": syncs.per_frame(n_warm),
           "host_syncs_other_where": syncs.other_where,
           "lm_iterations": pipe.lm_log, "launches": launches,
           "launches_per_frame": {k: launches[k] / n_frames for k in SLAM_KERNELS}}
    if scans:
        res["n_matched_per_update"] = torch.stack(scans).tolist()
    if photos:
        res["n_used_per_update"] = torch.stack(photos).tolist()
    if pipe._track_map is not None:
        sm = pipe._track_map
        res["surfel_voxels"] = int((sm.keys < esikf._SURFEL_KEY_MAX).sum())
        res["surfel_capacity"] = int(sm.keys.shape[0])
        res["surfel_overflow"] = int(sm.overflow)
    return pipe, res


def surfel_fold_bitwise(pipe, frame) -> bool:
    """One fold of `frame`'s scan at the filter's pose into the loop's final
    surfel map, twice: every field bitwise equal."""
    import numpy as np
    import torch

    from sags_tpu_torch.ops import esikf

    dev = pipe.device
    scan = torch.as_tensor(frame.scan, device=dev)
    world = scan @ pipe._esikf.R.T + pipe._esikf.p
    mask = torch.ones(scan.shape[0], dtype=torch.bool, device=dev)
    intens = torch.as_tensor(np.asarray(frame.colors, np.float32).mean(-1), device=dev)
    a, b = (esikf.surfel_map_update(pipe._track_map, world, mask, intensity=intens)
            for _ in range(2))
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("keys", "n", "sum_p", "sum_pp", "sum_i", "overflow"))


def esikf_phase(device, frames, classic, n_warm=16, n_timed=8):
    """The per-module front-end at the tracking cell with IMU (loops (a)
    LiDAR-inertial ESIKF, (b) LiDAR-inertial-visual ESIKF, (c) per-module
    "gicp"); see the module docstring's phase 9. Returns each loop's
    launches."""
    import dataclasses

    import numpy as np

    from sags_tpu_torch.utils.traj import ate_rmse

    n_frames = n_warm + n_timed
    # the IMU samples draw nothing from the dataset's stream: these frames
    # are the ones `imu_substeps=IMU_SUBSTEPS` yields
    imu_ds = slam_dataset(device, len(frames), imu_substeps=IMU_SUBSTEPS)
    frames = [dataclasses.replace(f, imu=imu_ds.imu_between(i) if i else None)
              for i, f in enumerate(frames[:n_frames])]
    gt = np.stack([f.pose for f in frames])
    ate_classic, _ = ate_rmse(classic["poses"][:n_frames], gt, align=False)
    loops, pipes = {}, {}
    for name, cfg in (("esikf_li", slam_config(tracking="esikf")),
                      ("esikf_liv", slam_config(tracking="esikf", esikf_visual=True)),
                      ("gicp_per_module", slam_config(tracking="gicp", fused_frontend=False))):
        pipes[name], loops[name] = esikf_loop(device, frames, cfg, n_warm, n_timed)
    a = pipes["esikf_li"]
    fwd, bwd = loop_fused_check(device, a.state.map, a.cfg, a.keyframes[-1].camera)
    fold_bitwise = surfel_fold_bitwise(a, frames[-1])
    refs = {"esikf_li": REFERENCE_ESIKF_LI_ATE_M, "esikf_liv": REFERENCE_ESIKF_LIV_ATE_M,
            "gicp_per_module": REFERENCE_GICP_PER_MODULE_ATE_M}
    res = {"phase": "esikf", "frames": n_frames, "imu_substeps": IMU_SUBSTEPS,
           "classic_ms_per_frame": classic["ms_per_frame"],
           "classic_ate_m_same_frames": ate_classic,
           "reference_ate_m": refs, **loops, "surfel_fold_bitwise": fold_bitwise,
           "composite_fused_at_esikf_loop": fwd, "composite_fused_bwd_at_esikf_loop": bwd}
    emit(res)
    for name, r in loops.items():
        assert r["losses_finite"], f"{name}: non-finite loss"
        assert r["per_module"], f"{name} ran the fused front-end"
        assert r["metrics_rows"] == n_frames, (name, r["metrics_rows"])
        assert r["loss_last_third"] < r["loss_first_third"], (name, r["loss_first_third"],
                                                              r["loss_last_third"])
        for sym in SLAM_KERNELS:
            assert r["launches"][sym] > 0, f"{sym} never launched in the {name} loop"
        # one packed fetch a training step (every frame trains)
        for i, c in enumerate(r["host_syncs_per_warm_frame"]):
            assert c.get("_train_once", 0) == 1, (name, i, c)
    for name, ref in refs.items():
        r = loops[name]
        assert r["ate_m"] <= 1.05 * ref, f"{name} ATE {r['ate_m']} m, reference {ref} m"
    for name in ("esikf_li", "esikf_liv"):
        # steady state: the surfel map is live after frame 0, the bootstrap
        # runs on frame 1; from frame 2 on the tracker reads nothing
        for i, c in enumerate(loops[name]["host_syncs_per_warm_frame"][2:], start=2):
            assert c.get("_track_esikf", 0) == 0, (name, i, c)
    assert fold_bitwise, "surfel_map_update not bitwise repeatable"
    assert_loop_fused(fwd, bwd, "the esikf loop")
    return {name: r["launches"] for name, r in loops.items()}


OFFLINE_ITERS = 600  # densify at 300, 400, 500, 600; the opacity reset at 600
OFFLINE_SCENE_VIEWS, OFFLINE_SCENE_POINTS, OFFLINE_SCENE_ITERS = 12, 32768, 100


def offline_phase(device, frames, ds, iterations=OFFLINE_ITERS, cfg=None,
                  scene_views=OFFLINE_SCENE_VIEWS, scene_points=OFFLINE_SCENE_POINTS,
                  scene_iters=OFFLINE_SCENE_ITERS):
    """The offline trainer; see the module docstring's phase 10. Returns the
    launches of (a)'s run."""
    import numpy as np
    import torch

    from sags_tpu_torch.core.config import SLAMConfig
    from sags_tpu_torch.eval import metrics as eval_metrics
    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.slam import offline
    from sags_tpu_torch.slam.pipeline import camera_for

    cfg = cfg or SLAMConfig()
    # (a) frame replay, observed from outside: init (kNN scales) timed; at
    # each densify event the averaged view-space gradients it selects from,
    # its clone and split candidates, and after it the slots appended, the
    # drops (candidates not appended) and the active count; the opacities
    # each reset replaces (device tensors, read after the run)
    init_s, seen, reset_from = [], [], []
    real_init, real_densify, real_reset = (offline.init_from_points,
                                           offline.densify_event, gm.reset_opacity)

    def timed_init(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_init(*args, **kw)
        torch.cuda.synchronize()
        init_s.append(time.perf_counter() - t0)
        return out

    def seen_densify(state, cfg):
        m = state.map
        g = torch.where(m.active, m.xyz_grad_accum / torch.clamp(m.denom, min=1.0),
                        torch.zeros_like(m.denom))
        high = g >= cfg.opt.densify_grad_threshold
        small = (torch.amax(gm.get_scaling(m), dim=-1)
                 <= cfg.opt.percent_dense * cfg.scene_extent)
        out = real_densify(state, cfg)
        n_clone, n_split = (high & small).sum(), (high & ~small).sum()
        appended = out.map.count - m.count
        seen.append(torch.stack([g.max(), (m.denom > 0).sum(), n_clone, n_split, appended,
                                 n_clone + 2 * n_split - appended, gm.n_active(out.map),
                                 out.map.count]))
        return out

    def seen_reset(m, *args, **kw):
        reset_from.append(m.opacity_logit.clone())
        return real_reset(m, *args, **kw)

    with swapped(offline, "init_from_points", timed_init), \
            swapped(offline, "densify_event", seen_densify), \
            swapped(gm, "reset_opacity", seen_reset):
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        state, losses = offline.train_offline(frames, cfg, iterations, seed=0, device=device)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in _build.kernels()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    keys = ("grad_max", "gaussians_seen", "clone_candidates", "split_candidates", "appended", "drops",
            "n_active", "count")
    densify = [dict(zip(keys, [float(r[0])] + [int(x) for x in r[1:].tolist()]))
               for r in seen]
    L = np.asarray(losses)
    n_avg = min(100, len(L) // 2)
    first_mean, last_mean = float(L[:n_avg].mean()), float(L[-n_avg:].mean())
    m = state.map
    views = [0, len(frames) // 2, len(frames) - 1]

    def view_psnrs(m):
        out = []
        with torch.no_grad():
            for i in views:
                cam = camera_for(cfg, frames[i], frames[i].pose, device)
                r = rz.rasterize(m.xyz, gm.get_opacity(m), gm.get_scaling(m),
                                 gm.get_rotation(m), cam, cfg.raster, shs=gm.get_shs(m),
                                 sh_degree=cfg.map.sh_degree, active_mask=m.active,
                                 fused=False)
                out.append(eval_metrics.psnr(r.color, frames[i].image))
        return dict(zip(map(str, views), out))

    psnrs = view_psnrs(m)
    # a reset on the last iteration leaves every opacity at ≤ 0.01: the map
    # as trained is the one just before it
    psnrs_trained = (view_psnrs(m._replace(opacity_logit=reset_from[-1]))
                     if reset_from and iterations % cfg.opt.opacity_reset_interval == 0
                     else psnrs)
    cam = camera_for(cfg, frames[views[1]], frames[views[1]].pose, device)
    fwd, bwd = loop_fused_check(device, m, cfg, cam)
    n_init = int(sum(len(f.points) for f in frames))
    res_a = {"frames": len(frames), "init_points": n_init, "capacity": m.capacity,
             "iterations": iterations, "init_seconds": init_s[0], "run_seconds": run_s,
             "iterations_per_s": iterations / (run_s - init_s[0]),
             "peak_gb": peak_gb, "densify_threshold": cfg.opt.densify_grad_threshold,
             "densify_events": densify, "opacity_resets": len(reset_from),
             "n_active_final": int(gm.n_active(m)), "count_final": int(m.count),
             "loss_first_100": first_mean, "loss_last_100": last_mean,
             "loss_first": float(L[0]), "loss_last": float(L[-1]),
             "psnr_training_views": psnrs_trained,
             "psnr_training_views_after_last_reset": psnrs,
             "launches": launches,
             "composite_fused_at_offline_map": fwd, "composite_fused_bwd_at_offline_map": bwd}

    # (b) a COLMAP text model of `scene_views` of those frames
    res_b = colmap_scene_run(device, frames, ds, cfg, scene_views, scene_points,
                             scene_iters)
    # (c) the compacted map through PLY
    res_c = ply_round_trip(device, m)
    emit({"phase": "offline", "frame_replay": res_a, "colmap_scene": res_b, "ply": res_c})

    assert np.isfinite(L).all() and len(L) == iterations, "offline losses"
    assert last_mean < first_mean, (first_mean, last_mean)
    want = [s for s in range(1, iterations + 1)
            if cfg.opt.densify_from_iter <= s <= cfg.opt.densify_until_iter
            and s % cfg.opt.densification_interval == 0]
    assert len(densify) == len(want), (len(densify), want)
    assert len(reset_from) == iterations // cfg.opt.opacity_reset_interval, len(reset_from)
    for sym in SLAM_KERNELS:
        assert launches[sym] == iterations, f"{sym}: {launches[sym]} launches, {iterations} steps"
    for k in _build.kernels():
        if k.symbol not in SLAM_KERNELS:
            assert launches[k.symbol] == 0, f"{k.symbol} launched by the offline trainer"
    # the classic bars; a map holding a pair at the alpha gate (a tile off
    # 1e-3 with a near-gate pair at its worst pixel) takes the needle rule
    gate = fwd["max_abs_err"] > 1e-3 and fwd["near_gate_pairs_at_worst_pixel"] >= 1
    assert_loop_fused(fwd, bwd, "the offline map", gate_pixels=gate)
    assert res_b["losses_finite"] and res_b["loss_last_20"] < res_b["loss_first_20"], res_b
    assert res_b["train_views"] == scene_views and res_b["radius"] > 0, res_b
    for sym in SLAM_KERNELS:
        assert res_b["launches"][sym] == scene_iters, (sym, res_b["launches"])
    assert res_c["bitwise"], res_c
    return launches


def colmap_scene_run(device, frames, ds, cfg, n_views, n_points, iterations) -> dict:
    """Every (len(frames) // n_views)-th frame as a COLMAP text model (the
    dataset's own PINHOLE intrinsics and world→camera poses, `.npy` images)
    with a seeded `n_points` subsample of the world as points3D, in a
    temporary directory; `load_colmap_scene`, then `train_offline_scene`."""
    import math
    import os
    import tempfile

    import numpy as np

    from sags_tpu_torch.io.colmap import rotmat2qvec
    from sags_tpu_torch.io.colmap_scene import load_colmap_scene
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam import offline

    W, H = ds.width, ds.height
    fx = W / (2.0 * math.tan(ds.fovx / 2.0))
    fy = H / (2.0 * math.tan(ds.fovy / 2.0))
    idx = list(range(0, len(frames), max(len(frames) // n_views, 1)))[:n_views]
    pick = np.random.default_rng(0).choice(len(ds.world_xyz), n_points, replace=False)
    with tempfile.TemporaryDirectory() as root:
        sparse = os.path.join(root, "sparse", "0")
        os.makedirs(sparse)
        os.makedirs(os.path.join(root, "images"))
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write(f"1 PINHOLE {W} {H} {fx!r} {fy!r} {W / 2} {H / 2}\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            for k, i in enumerate(idx):
                V = ds.camera(i).world_view.cpu().numpy().astype(np.float64)
                q, t = rotmat2qvec(V[:3, :3]), V[:3, 3]
                f.write(f"{k + 1} " + " ".join(repr(float(x)) for x in (*q, *t))
                        + f" 1 view{i}.npy\n\n")
                np.save(os.path.join(root, "images", f"view{i}.npy"),
                        np.asarray(frames[i].image).transpose(1, 2, 0))
        rgb = np.round(ds.world_rgb[pick] * 255).astype(int)
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            for j, (p, c) in enumerate(zip(ds.world_xyz[pick], rgb)):
                f.write(f"{j + 1} " + " ".join(repr(float(x)) for x in p)
                        + f" {c[0]} {c[1]} {c[2]} 0.5\n")
        t0 = time.perf_counter()
        scene = load_colmap_scene(root, device=device)
        load_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses = offline.train_offline_scene(scene, cfg, iterations, seed=0, device=device)
    run_s = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in _build.kernels()}
    L = np.asarray(losses)
    n_avg = min(20, len(L) // 2)
    return {"train_views": len(scene.train_views), "points": len(scene.points),
            "radius": float(scene.radius), "load_seconds": load_s, "iterations": iterations,
            "run_seconds": run_s, "capacity": state.map.capacity,
            "losses_finite": bool(np.isfinite(L).all()),
            "loss_first_20": float(L[:n_avg].mean()), "loss_last_20": float(L[-n_avg:].mean()),
            "launches": launches}


def ply_round_trip(device, m) -> dict:
    """`save_map_ply` of the compacted map, `load_map_ply` back onto the
    card: every field of the active rows bitwise."""
    import os
    import tempfile

    import torch

    from sags_tpu_torch.io import ply
    from sags_tpu_torch.mapping import gaussian_map as gm

    c = gm.compact(m)
    n = int(c.count)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.ply")
        t0 = time.perf_counter()
        ply.save_map_ply(path, c)
        save_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 2 ** 20
        t0 = time.perf_counter()
        back = ply.load_map_ply(path, device=device)
        load_s = time.perf_counter() - t0
    same = {f: torch.equal(getattr(back, f)[:n], getattr(c, f)[:n]) for f in gm.PARAM_FIELDS}
    return {"gaussians": n, "file_mb": size_mb, "save_seconds": save_s,
            "load_seconds": load_s, "fields_bitwise": same,
            "bitwise": all(same.values()) and int(back.count) == n
            and int(back.active.sum()) == n}


# the keys of the JAX CLI's run-slam JSON line (`sags_tpu/cli/main.py:176-189`)
RUN_SLAM_KEYS = {"frames", "train_iters", "fps", "fps_steady", "ate_rmse", "mean_psnr",
                 "mean_ssim", "mean_lpips", "lpips_net", "eval_overflow_pairs",
                 "active_gaussians", "keyframes", "timed_out", "tracking"}
# the SLAM loop cell's dataset and map, as CLI flags
CLI_CELL = ["--width", str(SLICE_W), "--height", str(SLICE_H), "--world-points", "65536",
            "--scan-points", "4096", "--step", "0.075"]


def cli_main(argv, device):
    """`sags_tpu_torch.cli.main.main(argv)` in this process, its stdout's
    last lines echoed. Returns (its result, its JSON lines parsed)."""
    import contextlib
    import io

    from sags_tpu_torch.cli import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main([*argv, "--device", str(device)])
    text = buf.getvalue()
    print("\n".join("# cli: " + ln for ln in text.strip().splitlines()[-3:]), flush=True)
    return out, [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def read_png(path: str):
    """An 8-bit RGB PNG whose rows all use filter 0 (what the CLI's writer
    makes) as an [H, W, 3] uint8 array; stdlib and numpy only."""
    import struct
    import zlib

    import numpy as np

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, W = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            W, H, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2), (depth, ctype)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    assert (rows[:, 0] == 0).all(), "a row filter other than 0"
    return rows[:, 1:].reshape(H, W, 3)


def states_bitwise(a, b, generator=True) -> dict:
    """Two port `SLAMState`s compared bit for bit, leaf by leaf in the
    checkpoint's order (`checkpoint._leaves`; tensors moved to the CPU, so
    the two may live on different devices) and, with `generator`, their draw
    hooks' generator states. Returns the differing leaves' indices and
    whether the generators agree; `assert_states_bitwise` holds them."""
    import torch

    from sags_tpu_torch.slam import checkpoint

    def cpu(x):
        return torch.as_tensor(x).cpu()

    la, lb = checkpoint._leaves(a), checkpoint._leaves(b)
    differ = [i for i, (x, y) in enumerate(zip(la, lb))
              if cpu(x).dtype != cpu(y).dtype or not torch.equal(cpu(x), cpu(y))]
    out = {"leaves": len(la), "leaves_differing": differ}
    if generator:
        out["generator"] = torch.equal(a.rng.generator.get_state(),
                                       b.rng.generator.get_state())
    return out


def assert_states_bitwise(a, b, generator=True) -> None:
    """`states_bitwise` held: no leaf differs and (with `generator`) the
    generator states agree."""
    r = states_bitwise(a, b, generator)
    assert not r["leaves_differing"] and r.get("generator", True), r


def cli_phase(device, n_frames=24, post_train=20, cell=CLI_CELL, capacity=2 ** 18,
              train_frames=12, train_iters=100, mode_frames=8):
    """The port's CLI (`sags_tpu_torch.cli.main.main`) in this process on the
    card: (a) run-slam with the SLAM loop cell's dataset size and capacity
    with a checkpoint, the map and the trajectory written, launch counts
    zeroed just before and read just after, its kernels then held against
    their plain versions on its own map at its own configs; (b) the checkpoint read back bitwise, one `slam_step`
    from it and from the run's state bitwise, read on the CPU, and
    `--resume`; (c) run-slam under the other trackers and mask back-ends,
    train, render, eval, run-gicp in both modes, align, and serve feeding
    run-slam over the socket."""
    import os
    import socket
    import tempfile
    import threading

    import numpy as np
    import torch

    from sags_tpu_torch.core.config import SLAMConfig
    from sags_tpu_torch.io.datasets import SyntheticDataset
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam import checkpoint
    from sags_tpu_torch.slam import pipeline
    from sags_tpu_torch.slam import step as slam_step
    from sags_tpu_torch.slam.pipeline import camera_for

    work = tempfile.mkdtemp(prefix="sags_cli_")
    path = {k: os.path.join(work, k) for k in ("ck", "ck2", "map.ply", "traj.txt",
                                               "train.ply", "view.png", "gicp_scan.txt",
                                               "gicp_map.txt", "t.npy", "s.npy")}
    res = {"phase": "cli"}

    # (a) run-slam at the loop cell's size; its pipeline is kept from the
    # evaluate call for the kernel checks at its own configs
    seen = {}
    real_evaluate = pipeline.SLAMPipeline.evaluate

    def evaluate(self, *args, **kw):
        seen["pipe"] = self
        return real_evaluate(self, *args, **kw)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with swapped(pipeline.SLAMPipeline, "evaluate", evaluate):
        run, (line,) = cli_main(["run-slam", *cell, "--capacity", str(capacity),
                                 "--point-budget", "4096", "--tracking", "gicp",
                                 "--frames", str(n_frames), "--post-train", str(post_train),
                                 "--checkpoint", path["ck"], "--save", path["map.ply"],
                                 "--traj-out", path["traj.txt"]], device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in _build.kernels()}
    assert set(line) == RUN_SLAM_KEYS, sorted(set(line) ^ RUN_SLAM_KEYS)
    assert line["frames"] == n_frames and line["tracking"] == "gicp", line
    assert line["ate_rmse"] is not None and math.isfinite(line["ate_rmse"]), line
    iters = line["train_iters"]
    assert iters >= n_frames + post_train - 1, line
    # one launch of each an iteration; the forward's two also render each
    # frame's ground truth once (the dataset, classic path), and the eval
    # (every n_frames // 5-th frame, windowed host table) launches
    # fill_table and composite_windowed once a frame
    n_eval = len(range(0, n_frames, max(1, n_frames // 5)))
    want = {"sags_composite_fused_bwd": iters, "sags_composite_fused": iters + n_frames,
            "sags_fill_table": iters + n_frames + n_eval, "sags_composite_windowed": n_eval}
    assert {s: launches[s] for s in want} == want, (launches, want)
    traj = np.loadtxt(path["traj.txt"])
    assert traj.shape == (n_frames, 8) and np.isfinite(traj).all()
    res["run_slam"] = dict(line, wall_seconds=wall_s, ms_per_frame=1e3 / line["fps"],
                           ms_per_frame_steady=1e3 / line["fps_steady"],
                           launches={s: launches[s] for s in want})

    # its kernels against their plain versions on its own inputs: the
    # classic three at the training config it ended with, on its last
    # keyframe's view; the windowed host-table compositor at the eval
    # config, on the first eval frame's view (its estimated pose)
    pipe = seen["pipe"]
    cfg = pipe.cfg
    fwd, bwd = loop_fused_check(device, run.state.map, cfg, pipe.keyframes[-1].camera)
    flags = dict(zip(cell[::2], cell[1::2]))
    ds = SyntheticDataset(n_frames=1, width=int(flags["--width"]),
                          height=int(flags["--height"]), n_world=int(flags["--world-points"]),
                          pts_per_frame=int(flags["--scan-points"]),
                          step=float(flags["--step"]), clutter=0.35, imu_substeps=5,
                          device=device)
    f0 = next(iter(ds))
    eval_check = eval_frame_check(run.state.map, camera_for(cfg, f0, run.poses_est[0], device),
                                  pipe.eval_config(True).raster, cfg.map.sh_degree,
                                  "windowed_host")
    del pipe, seen
    res["run_slam"].update(composite_fused_at_run=fwd, composite_fused_bwd_at_run=bwd,
                           composite_windowed_at_eval=eval_check)
    assert_loop_fused(fwd, bwd, "the CLI's run-slam")

    # (b) the checkpoint: read back, a step from each, on the CPU, resumed
    t0 = time.perf_counter()
    back, cfg_back = checkpoint.load_state(path["ck"], device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert cfg_back == cfg, "the checkpoint's config is not the run's"
    t0 = time.perf_counter()
    checkpoint.save_state(path["ck2"], run.state, cfg)  # as the CLI's --checkpoint
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu, _ = checkpoint.load_state(path["ck"], device="cpu")
    load_cpu_s = time.perf_counter() - t0
    same = states_bitwise(run.state, back)
    same_cpu = states_bitwise(run.state, on_cpu, generator=False)
    nbytes = sum(os.path.getsize(os.path.join(path["ck"], f)) for f in os.listdir(path["ck"]))
    cam = camera_for(cfg, f0, np.asarray(f0.pose), device)
    img = torch.as_tensor(f0.image, device=device)
    objs = torch.zeros(img.shape[1:], dtype=torch.int32, device=device)
    s1, m1 = slam_step.slam_step(run.state, cam, img, objs, cfg)
    s2, m2 = slam_step.slam_step(back, cam, img, objs, cfg)
    stepped = dict(states_bitwise(s1, s2), loss=torch.equal(m1.loss, m2.loss))
    _, (line_r,) = cli_main(["run-slam", *cell, "--point-budget", "4096", "--frames", "4",
                             "--resume", path["ck"]], device)
    res["checkpoint"] = {"save_seconds": save_s, "load_seconds": load_s,
                         "load_cpu_seconds": load_cpu_s, "bytes": nbytes,
                         "capacity": int(run.state.map.capacity), "bitwise": same,
                         "cpu_bitwise": same_cpu, "step_bitwise": stepped,
                         "resumed": {k: line_r[k] for k in ("frames", "train_iters",
                                                            "tracking", "ate_rmse")}}
    for r in (same, same_cpu, stepped):
        assert not r["leaves_differing"] and r.get("generator", True) and r.get("loss", True), r
    assert line_r["tracking"] == "gicp" and line_r["frames"] == 4, line_r

    # (c) run-slam under the other trackers and with either mask back-end
    res["run_slam_modes"] = {}
    for name, flags in (("vgicp", ["--tracking", "vgicp"]),
                        ("gicp_map", ["--tracking", "gicp_map"]),
                        ("esikf", ["--tracking", "esikf"]),
                        ("semantics_geometric", ["--tracking", "gicp", "--semantics"]),
                        ("semantics_sam", ["--tracking", "gicp", "--semantics",
                                           "--mask-backend", "sam"])):
        _, (ln,) = cli_main(["run-slam", *cell, "--capacity", str(capacity),
                             "--point-budget", "4096", "--frames", str(mode_frames),
                             "--post-train", "0", *flags], device)
        res["run_slam_modes"][name] = {k: ln[k] for k in ("tracking", "ate_rmse",
                                                          "fps_steady", "keyframes",
                                                          "train_iters", "mean_psnr")}
        assert ln["frames"] == mode_frames and ln["tracking"] == flags[1], ln
        assert ln["ate_rmse"] is not None and math.isfinite(ln["ate_rmse"]), ln

    # the other subcommands
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    trained, (line_t,) = cli_main(["train", *cell, "--frames", str(train_frames), "--iters",
                                   str(train_iters), "--save", path["train.ply"]], device)
    torch.cuda.synchronize()
    train_launches = {k.symbol: k.launches for k in _build.kernels()}
    res["train"] = dict(line_t, wall_seconds=time.perf_counter() - t0,
                        launches={s: train_launches[s] for s in SLAM_KERNELS})
    assert math.isfinite(line_t["final_loss"]), line_t
    # one launch of each an iteration; the forward's two also render each of
    # the dataset's ground-truth images once (the classic path)
    assert train_launches["sags_composite_fused_bwd"] == train_iters, train_launches
    assert all(train_launches[s] == train_iters + train_frames
               for s in ("sags_fill_table", "sags_composite_fused")), train_launches
    # its kernels on its map at its config (the defaults), from frame 0's view;
    # the offline phase's bars
    fwd, bwd = loop_fused_check(device, trained.map, SLAMConfig(),
                                camera_for(SLAMConfig(), f0, np.asarray(f0.pose), device))
    res["train"].update(composite_fused_at_map=fwd, composite_fused_bwd_at_map=bwd)
    gate = fwd["max_abs_err"] > 1e-3 and fwd["near_gate_pairs_at_worst_pixel"] >= 1
    assert_loop_fused(fwd, bwd, "the CLI's train", gate_pixels=gate)

    img, _ = cli_main(["render", "--map", path["map.ply"], "--out", path["view.png"],
                       *cell[:4]], device)
    png_same = bool(np.array_equal(read_png(path["view.png"]), img))
    _, (line_e,) = cli_main(["eval", *cell, "--map", path["map.ply"], "--frames",
                             str(n_frames), "--every", str(EVAL_EVERY)], device)
    res["render"] = {"png_decodes_to_image": png_same, "mean": float(img.mean())}
    res["eval"] = line_e
    assert png_same and img.max() > 0
    assert line_e["n_eval"] == n_frames // EVAL_EVERY and math.isfinite(line_e["psnr"])

    res["run_gicp"] = {}
    for mode in ("scan", "map"):
        poses, (line_g,) = cli_main(["run-gicp", *cell, "--frames", str(n_frames),
                                     "--mode", mode, "--keyframe-every", "4",
                                     "--out-poses", path[f"gicp_{mode}.txt"]], device)
        kitti = np.loadtxt(path[f"gicp_{mode}.txt"])
        assert kitti.shape == (n_frames, 12), kitti.shape
        assert np.allclose(kitti, np.asarray(poses)[:, :3, :4].reshape(n_frames, 12),
                           atol=1e-6)
        assert line_g["ate_rmse"] is not None and math.isfinite(line_g["ate_rmse"])
        res["run_gicp"][mode] = line_g

    from sags_tpu_torch.core.transforms import se3_matrix, so3_exp

    target = structured_cloud(np.random.default_rng(5))
    T_gt = se3_matrix(so3_exp(torch.tensor([0.02, -0.03, 0.05])),
                      torch.tensor([0.15, -0.2, 0.1])).numpy()
    Ti = np.linalg.inv(T_gt)
    world = structured_cloud(np.random.default_rng(9))
    np.save(path["t.npy"], target)
    np.save(path["s.npy"], (world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32))
    # registration_phase's voxel size; its 5 cm / 1° gate for the GICP family,
    # NDT (at align_points' defaults) reported
    Ts, res["align"] = cli_main(["align", "--target", path["t.npy"], "--source",
                                 path["s.npy"], "--method", "all", "--n", "3",
                                 "--voxel-resolution", "0.5"], device)
    assert len(res["align"]) == 5, res["align"]
    for row, T in zip(res["align"], Ts):
        te, re_ = pose_errors(T, T_gt)
        row.update(trans_err_m=te, rot_err_deg=re_)
        assert np.isfinite(T).all(), row
        if row["method"] != "NDT_CUDA":
            assert te < 0.05 and re_ < 1.0, row

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = str(sk.getsockname()[1])
    from sags_tpu_torch.cli import main as cli

    # serve prints nothing on stdout: called directly, as cli_main's
    # redirection of stdout is the whole process's
    server = threading.Thread(target=cli.main, args=(["serve", *cell, "--frames", "4",
                                                      "--port", port, "--device",
                                                      str(device)],), daemon=True)
    server.start()
    _, (line_s,) = cli_main(["run-slam", "--dataset", "socket", "--port", port,
                             "--point-budget", "4096", "--capacity", str(capacity),
                             "--tracking", "gicp", "--post-train", "0"], device)
    server.join(60.0)
    res["serve_socket"] = {k: line_s[k] for k in ("frames", "timed_out", "train_iters",
                                                  "tracking")}
    assert not server.is_alive(), "serve did not finish"
    assert line_s["frames"] == 4 and not line_s["timed_out"], line_s
    emit(res)
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    return res, launches


# --- the sources phase: the dataset readers, bag replay, the viewer, the
# native host library and the profiler, through the CLI

def quantized(f, scale: float):
    """A frame's image as 8-bit RGB [H, W, 3] and its depth as uint16 at
    `scale` a metre, 0 (no depth) where it does not fit."""
    import numpy as np

    rgb = np.clip(np.round(f.image.transpose(1, 2, 0) * 255), 0, 255).astype(np.uint8)
    d = np.round(f.depth.astype(np.float64) * scale)
    return rgb, np.where((d > 0) & (d <= 65535), d, 0).astype(np.uint16)


def write_tum(root: str, frames, t0: float = 1000.0) -> None:
    """`frames` in the TUM RGB-D layout: rgb/ and depth/ PNGs (depth at 5000
    a metre), rgb.txt, depth.txt 3 ms and groundtruth.txt 2 ms off the rgb
    stamps, poses as position and xyzw quaternion."""
    import os

    import numpy as np

    from sags_tpu_torch.cli.main import write_png
    from sags_tpu_torch.utils.traj import _rotmat_to_quat_xyzw

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rows = {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    for f in frames:
        t = t0 + f.timestamp
        rgb, d16 = quantized(f, 5000.0)
        write_png(os.path.join(root, "rgb", f"{t:.6f}.png"), rgb)
        write_png(os.path.join(root, "depth", f"{t + 0.003:.6f}.png"), d16)
        rows["rgb.txt"].append(f"{t:.6f} rgb/{t:.6f}.png")
        rows["depth.txt"].append(f"{t + 0.003:.6f} depth/{t + 0.003:.6f}.png")
        q = _rotmat_to_quat_xyzw(f.pose[:3, :3].astype(np.float64))
        rows["groundtruth.txt"].append(
            f"{t - 0.002:.6f} " + " ".join(repr(float(v)) for v in (*f.pose[:3, 3], *q)))
    for name, lines in rows.items():
        with open(os.path.join(root, name), "w") as fh:
            fh.write(f"# {name}\n" + "\n".join(lines) + "\n")


def write_replica(root: str, frames) -> None:
    """`frames` in the Replica layout: results/frame%06d.png,
    results/depth%06d.png at 6553.5 a metre, traj.txt (16 floats a line)."""
    import os

    import numpy as np

    from sags_tpu_torch.cli.main import write_png

    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    for i, f in enumerate(frames):
        rgb, d16 = quantized(f, 6553.5)
        write_png(os.path.join(root, "results", f"frame{i:06d}.png"), rgb)
        write_png(os.path.join(root, "results", f"depth{i:06d}.png"), d16)
    np.savetxt(os.path.join(root, "traj.txt"),
               np.stack([f.pose.reshape(-1) for f in frames]), fmt="%.9g")


# a velodyne→cam0 extrinsic of KITTI's shape: an axis remap and a lever arm
KITTI_TR = ((0.0, -1.0, 0.0, -0.004), (0.0, 0.0, -1.0, -0.076), (1.0, 0.0, 0.0, -0.272))


def write_kitti(root: str, frames) -> dict:
    """`frames`' scans in the KITTI odometry layout: velodyne/%06d.bin (x, y,
    z, intensity), poses.txt in the cam0 frame through `KITTI_TR`
    (T_cam0 = Tr · T · Tr⁻¹, so the reader's Tr⁻¹ · T_cam0 · Tr gives T
    back), calib.txt with the `Tr:` line, times.txt. Returns the paths."""
    import os

    import numpy as np

    velo = os.path.join(root, "velodyne")
    os.makedirs(velo, exist_ok=True)
    Tr = np.eye(4)
    Tr[:3, :4] = np.asarray(KITTI_TR)
    for i, f in enumerate(frames):
        rec = np.concatenate([f.scan, np.full((len(f.scan), 1), 0.5, np.float32)], 1)
        rec.astype(np.float32).tofile(os.path.join(velo, f"{i:06d}.bin"))
    cam = Tr[None] @ np.stack([f.pose.astype(np.float64) for f in frames]) @ np.linalg.inv(Tr)
    paths = {k: os.path.join(root, k) for k in ("poses.txt", "calib.txt", "times.txt")}
    np.savetxt(paths["poses.txt"], cam[:, :3, :4].reshape(len(frames), 12), fmt="%.17g")
    with open(paths["calib.txt"], "w") as fh:
        fh.write("P0: " + " ".join(["0"] * 12) + "\n")
        fh.write("Tr: " + " ".join(f"{v:.17g}" for v in Tr[:3, :4].reshape(-1)) + "\n")
    np.savetxt(paths["times.txt"], [f.timestamp for f in frames], fmt="%.9f")
    return dict(paths, velodyne=velo)


def write_rosbag(path: str, frames, imu: bool = True, t0: float = 100.0) -> int:
    """`frames` as a ROS1 bag of the node's topics (`/rgb_img`,
    `/cloud_registered`, `/aft_mapped_to_init`, `/imu`), written with the
    port's encoders: the cloud's and the odometry's stamps 10 and 20 ms after
    the image's (within the synchronizer's slop); before each frame its IMU
    samples, stamped at the ends of their intervals, the bag's first one
    led by a sample at its interval's start (the reader gives a bag's first
    sample dt 0). Returns the file's size in bytes."""
    import os

    import numpy as np

    from sags_tpu_torch.io import rosbag as rb

    msgs, led = [], False
    for f in frames:
        t = t0 + f.timestamp
        if imu and f.imu is not None:
            dts = f.imu[:, 6].astype(np.float64)
            ends = t - (dts[::-1].cumsum()[::-1] - dts)
            if not led:
                start = float(ends[0] - dts[0])
                msgs.append(("/imu", "sensor_msgs/Imu", start,
                             rb.encode_imu(start, f.imu[0, :3], f.imu[0, 3:6])))
                led = True
            for te, row in zip(ends, f.imu):
                msgs.append(("/imu", "sensor_msgs/Imu", float(te),
                             rb.encode_imu(float(te), row[:3], row[3:6])))
        msgs += [("/rgb_img", "sensor_msgs/Image", t, rb.encode_image(t, f.image)),
                 ("/cloud_registered", "sensor_msgs/PointCloud2", t + 0.01,
                  rb.encode_pointcloud2(t + 0.01, f.points, f.colors)),
                 ("/aft_mapped_to_init", "nav_msgs/Odometry", t + 0.02,
                  rb.encode_odometry(t + 0.02, f.pose))]
    rb.write_bag(path, msgs)
    return os.path.getsize(path)


def sibr_request(cam) -> dict:
    """A SIBR viewer request for the port `Camera` `cam`: its matrices
    transposed (the wire's convention) with the y/z columns flipped as the
    viewer sends them."""
    V = cam.world_view.cpu().numpy().T.copy()
    PV = cam.full_proj.cpu().numpy().T.copy()
    V[:, 1:3] *= -1
    PV[:, 1] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height, "train": False,
            "fov_y": cam.fovy, "fov_x": cam.fovx, "z_near": cam.znear, "z_far": cam.zfar,
            "shs_python": False, "rot_scale_python": False, "keep_alive": True,
            "scaling_modifier": 1.0, "view_matrix": V.reshape(-1).tolist(),
            "view_projection_matrix": PV.reshape(-1).tolist()}


def unflip(msg):
    """A request's view and view-projection as `NetworkGUI.receive` hands
    them to `MiniCam`."""
    import numpy as np

    V = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    PV = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    V[:, 1:3] *= -1
    PV[:, 1] *= -1
    return V, PV


def viewer_client(port: int, requests, out: dict) -> None:
    """A SIBR viewer: each request sent, its RGB reply and verify string
    read, the milliseconds from send to reply kept."""
    import socket

    out["replies"], out["ms"] = [], []
    with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
        def exact(n):
            buf = b""
            while len(buf) < n:
                chunk = c.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("the viewer server closed")
                buf += chunk
            return buf

        for msg in requests:
            payload = json.dumps(msg).encode()
            t0 = time.perf_counter()
            c.sendall(len(payload).to_bytes(4, "little") + payload)
            img = exact(msg["resolution_x"] * msg["resolution_y"] * 3)
            verify = exact(int.from_bytes(exact(4), "little")).decode()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["replies"].append((img, verify))


def knn_bar(queries, d2):
    """The bar on a kNN fallback's squared distances [M, k] to `queries`'
    neighbours: 1e-5 plus the float32 rounding of |q|^2 + |p|^2 - 2 q.p
    (8 ulps of |q|^2 + |p|^2, with |p| <= |q| + sqrt(d2))."""
    import numpy as np

    qn = np.linalg.norm(queries.astype(np.float64), axis=1)[:, None]
    pn = qn + np.sqrt(np.maximum(d2.astype(np.float64), 0.0))
    return 1e-5 + 8 * float(np.finfo(np.float32).eps) * (qn ** 2 + pn ** 2)


def launch_counts() -> dict:
    from sags_tpu_torch.ops import _build

    return {k.symbol: k.launches for k in _build.kernels()}


PATH_KERNELS = SLAM_KERNELS + ("sags_composite_windowed",)


def sources_phase(device, cli_res, n_frames=24, post_train=20, cell=CLI_CELL,
                  capacity=2 ** 18, list_frames=8, esikf_frames=8, viewer_requests=4,
                  knn_k=10):
    """The port's other sources through its CLI in this process, at the CLI
    cell's stream (`cli_res` is the cli phase's result, whose synthetic runs
    are the references): (a) run-slam over a ROS1 bag of the stream's
    frames (launches exact, ATE against the synthetic run's, rows 1-3 held
    on its map at its training config, rows 4-5 at its eval config), 8
    frames of it under esikf, and the bag's decode cost alone; (b) TUM and
    Replica layouts of 8 frames read back exactly, run-slam on each
    (launches exact, rows 1-3 held on its map at its training config, rows
    1 and 4 exact on the first eval frame); (c) KITTI scans, run-gicp in
    both modes (ATE against the synthetic scans' within 1e-4 / 5e-4 m) and
    pose-less; (d) the viewer on the bag run's saved map, rows 1 and 4 exact
    at its config, replies bitwise `render_map`; (e) the native host library against its
    fallbacks on the card; (f) one `PhaseTimer` over (a)-(e), one `trace`
    of a one-frame bag. Returns (result, launches per source)."""
    import os
    import shutil
    import tempfile
    import threading
    import tracemalloc

    import numpy as np
    import torch

    from sags_tpu_torch.cli import main as cli
    from sags_tpu_torch.core.config import SLAMConfig
    from sags_tpu_torch.core.transforms import quat_to_rotmat
    from sags_tpu_torch.io import datasets as D
    from sags_tpu_torch.io import native
    from sags_tpu_torch.io.ply import load_map_ply
    from sags_tpu_torch.io.rosbag import RosbagDataset
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam import pipeline
    from sags_tpu_torch.slam.pipeline import camera_for
    from sags_tpu_torch.slam.step import render_map
    from sags_tpu_torch.utils.profiling import PhaseTimer, trace
    from sags_tpu_torch.viz.network_gui import MiniCam, NetworkGUI

    work = tempfile.mkdtemp(prefix="sags_sources_")
    path = {k: os.path.join(work, k) for k in ("seq.bag", "esikf.bag", "one.bag", "map.ply",
                                               "tum", "replica", "kitti", "trace")}
    flags = dict(zip(cell[::2], cell[1::2]))
    frames = list(D.SyntheticDataset(
        n_frames=n_frames, width=int(flags["--width"]), height=int(flags["--height"]),
        n_world=int(flags["--world-points"]), pts_per_frame=int(flags["--scan-points"]),
        step=float(flags["--step"]), clutter=0.35, imu_substeps=IMU_SUBSTEPS, device=device))
    run_flags = ["--capacity", str(capacity), "--point-budget", "4096", "--tracking", "gicp"]
    res = {"phase": "sources"}
    launches = {}
    timer = PhaseTimer()
    seen = {}

    def keep(name):
        """`SLAMPipeline.<name>` recording its pipeline in `seen`."""
        real = getattr(pipeline.SLAMPipeline, name)

        def wrapper(self, *args, **kw):
            seen["pipe"] = self
            return real(self, *args, **kw)
        return swapped(pipeline.SLAMPipeline, name, wrapper)

    # (a) the bag: written, decoded alone, replayed through run-slam
    with timer.phase("a_rosbag"):
        nbytes = write_rosbag(path["seq.bag"], frames)
        # the decode timed alone, then its peak host memory in a pass of its
        # own (tracemalloc hooks every allocation)
        decode = PhaseTimer()
        t0 = time.perf_counter()
        for _ in RosbagDataset(path["seq.bag"], imu_topic="/imu"):
            decode.record("frame", time.perf_counter() - t0)
            t0 = time.perf_counter()
        tracemalloc.start()
        for _ in RosbagDataset(path["seq.bag"], imu_topic="/imu"):
            pass
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with keep("run"):
            run, (line,) = cli_main(["run-slam", "--dataset", "rosbag", "--path", path["seq.bag"],
                                     "--imu-topic", "/imu", *run_flags, "--post-train",
                                     str(post_train), "--save", path["map.ply"]], device)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches["rosbag"] = launch_counts()
        pipe = seen.pop("pipe")
        iters = line["train_iters"]
        # a streamed source: no ground-truth render, no evaluation
        want = {"sags_composite_fused_bwd": iters, "sags_composite_fused": iters,
                "sags_fill_table": iters, "sags_composite_windowed": 0}
        got = {s: launches["rosbag"][s] for s in want}
        ate_syn = cli_res["run_slam"]["ate_rmse"]
        res["rosbag"] = dict(line, wall_seconds=wall_s, ms_per_frame=1e3 / line["fps"],
                             ms_per_frame_steady=1e3 / line["fps_steady"], bag_bytes=nbytes,
                             decode_host_ms_per_frame=decode.summary()["frame"]["mean_ms"],
                             decode_peak_host_mb=peak / 2 ** 20, launches=got,
                             synthetic_ate_rmse=ate_syn)
        assert set(line) == RUN_SLAM_KEYS, sorted(set(line) ^ RUN_SLAM_KEYS)
        assert line["frames"] == n_frames and line["mean_psnr"] is None, line
        assert iters >= n_frames + post_train - 1, line
        assert got == want, (got, want)
        assert line["ate_rmse"] is not None and line["ate_rmse"] <= 1.05 * ate_syn, \
            (line["ate_rmse"], ate_syn)
        fwd, bwd = loop_fused_check(device, run.state.map, pipe.cfg, pipe.keyframes[-1].camera)
        assert_loop_fused(fwd, bwd, "the rosbag run-slam")
        ev = type("EvalPipe", (), {"state": run.state, "cfg": pipe.eval_config(True)})
        win = loop_bwd_check(device, ev, pipe.keyframes[-1].camera)
        res["rosbag"].update(composite_fused_at_run=fwd, composite_fused_bwd_at_run=bwd,
                             windowed_at_eval_config=win)
        assert win["rel_err"] <= 2e-4 and win["composite_windowed"]["bitwise"], win
        assert win["composite_windowed"]["strip_cull"]["gated_strips_dropped"] == 0, win
        del pipe, ev
        write_rosbag(path["esikf.bag"], frames[:esikf_frames])
        _, (line_e,) = cli_main(["run-slam", "--dataset", "rosbag", "--path", path["esikf.bag"],
                                 "--imu-topic", "/imu", "--capacity", str(capacity),
                                 "--point-budget", "4096", "--post-train", "0",
                                 "--tracking", "esikf"], device)
        res["rosbag"]["esikf"] = {
            "frames": line_e["frames"], "ate_rmse": line_e["ate_rmse"],
            "synthetic_ate_rmse": cli_res["run_slam_modes"]["esikf"]["ate_rmse"]}
        assert line_e["frames"] == esikf_frames and line_e["ate_rmse"] is not None, line_e
        emit({"phase": "sources", "rosbag": res["rosbag"]})

    # (b) TUM and Replica: written, read back exactly, run through run-slam
    with timer.phase("b_tum_replica"):
        sub = frames[:list_frames]
        write_tum(path["tum"], sub)
        write_replica(path["replica"], sub)
        n_eval = len(range(0, list_frames, max(1, list_frames // 5)))
        for name, reader, scale in (("tum", D.TUMDataset, 5000.0),
                                    ("replica", D.ReplicaDataset, 6553.5)):
            t0 = time.perf_counter()
            back = list(reader(path[name]))
            read_ms = (time.perf_counter() - t0) * 1e3 / len(back)
            assert len(back) == list_frames, (name, len(back))
            for f, b in zip(sub, back):
                rgb, d16 = quantized(f, scale)
                assert np.array_equal(b.image, rgb.transpose(2, 0, 1).astype(np.float32) / 255.0)
                assert np.array_equal(b.depth, d16.astype(np.float32) / np.float32(scale))
                if name == "replica":
                    assert np.array_equal(b.pose, f.pose), name
                else:
                    assert np.abs(b.pose - f.pose).max() <= 1e-6, (b.pose, f.pose)
            if name == "tum":  # the reader's rotation is the port's of the written quaternion
                with open(os.path.join(path["tum"], "groundtruth.txt")) as fh:
                    gt = [list(map(float, ln.split()[1:])) for ln in fh if not ln.startswith("#")]
                for g, b in zip(gt, back):
                    R = quat_to_rotmat(torch.tensor(g[3:7], dtype=torch.float32)).numpy()
                    assert np.array_equal(b.pose[:3, :3], R)
            _build.reset_launch_counts()
            with keep("evaluate"):
                run_l, (line_l,) = cli_main(["run-slam", "--dataset", name, "--path", path[name],
                                             *run_flags, "--post-train", "0"], device)
            torch.cuda.synchronize()
            launches[name] = launch_counts()
            pipe = seen.pop("pipe")
            it = line_l["train_iters"]
            # images read from files: no ground-truth render; each eval
            # render (windowed host table) launches fill_table and
            # composite_windowed once
            want = {"sags_composite_fused_bwd": it, "sags_composite_fused": it,
                    "sags_fill_table": it + n_eval, "sags_composite_windowed": n_eval}
            got = {s: launches[name][s] for s in want}
            # rows 1-3 on its final map at its training config, from its
            # last keyframe; rows 1 and 4 on its first eval frame
            fwd, bwd = loop_fused_check(device, run_l.state.map, pipe.cfg,
                                        pipe.keyframes[-1].camera)
            assert_loop_fused(fwd, bwd, f"the {name} run-slam")
            check = eval_frame_check(run_l.state.map,
                                     camera_for(pipe.cfg, back[0], run_l.poses_est[0], device),
                                     pipe.eval_config(True).raster, pipe.cfg.map.sh_degree,
                                     "windowed_host")
            del pipe
            res[name] = dict(line_l, launches=got, read_host_ms_per_frame=read_ms,
                             composite_fused_at_run=fwd, composite_fused_bwd_at_run=bwd,
                             composite_windowed_at_eval=check)
            assert set(line_l) == RUN_SLAM_KEYS and line_l["frames"] == list_frames, line_l
            assert line_l["ate_rmse"] is not None and math.isfinite(line_l["ate_rmse"]), line_l
            assert math.isfinite(line_l["mean_psnr"]), line_l
            assert got == want, (name, got, want)
        emit({"phase": "sources", "tum": res["tum"], "replica": res["replica"]})

    # (c) KITTI: the stream's scans, run-gicp against the synthetic run's
    with timer.phase("c_kitti"):
        kp = write_kitti(path["kitti"], frames)
        res["kitti"] = {}
        for mode, atol in (("scan", 1e-4), ("map", 5e-4)):
            _, (line_k,) = cli_main(["run-gicp", "--dataset", "kitti", "--path", kp["velodyne"],
                                     "--poses", kp["poses.txt"], "--calib", kp["calib.txt"],
                                     "--times", kp["times.txt"], "--mode", mode,
                                     "--keyframe-every", "4"], device)
            ref = cli_res["run_gicp"][mode]["ate_rmse"]
            res["kitti"][mode] = dict(line_k, synthetic_ate_rmse=ref)
            assert line_k["frames"] == n_frames, line_k
            assert abs(line_k["ate_rmse"] - ref) <= atol, (mode, line_k["ate_rmse"], ref)
        _, (line_p,) = cli_main(["run-gicp", "--dataset", "kitti", "--path", kp["velodyne"],
                                 "--times", kp["times.txt"]], device)
        res["kitti"]["pose_less"] = line_p
        assert line_p["ate_rmse"] is None and line_p["frames"] == n_frames, line_p
        emit({"phase": "sources", "kitti": res["kitti"]})

    # (d) the viewer: the bag run's map served to a SIBR client
    with timer.phase("d_viewer"):
        cfg = SLAMConfig()
        m = load_map_ply(path["map.ply"], device=device)
        gui = NetworkGUI(port=0, device=device)
        picks = np.linspace(0, n_frames - 1, viewer_requests).astype(int)
        msgs = [sibr_request(camera_for(cfg, frames[i], frames[i].pose, device)) for i in picks]
        # rows 1 and 4 against their plain versions at the viewer's own
        # config (SLAMConfig().raster) on its first request's view
        view_check = eval_frame_check(
            m, MiniCam(msgs[0]["resolution_x"], msgs[0]["resolution_y"], msgs[0]["fov_y"],
                       msgs[0]["fov_x"], msgs[0]["z_near"], msgs[0]["z_far"], *unflip(msgs[0]),
                       device=device).camera,
            cfg.raster, cfg.map.sh_degree, "windowed_host")
        client, server = {}, {}
        # the server loop in a thread, the client here: a client that fails
        # raises instead of leaving the loop waiting for requests
        thread = threading.Thread(target=lambda: server.update(
            n=cli.serve_viewer(gui, m, cfg, requests=viewer_requests)), daemon=True)
        _build.reset_launch_counts()
        thread.start()
        try:
            viewer_client(gui.listener.getsockname()[1], msgs, client)
            thread.join(60.0)
        finally:
            gui.close()
        assert not thread.is_alive(), "the viewer loop did not return"
        served = server["n"]
        launches["viewer"] = launch_counts()
        same = []
        for (img, verify), msg in zip(client["replies"], msgs):
            cam = MiniCam(msg["resolution_x"], msg["resolution_y"], msg["fov_y"], msg["fov_x"],
                          msg["z_near"], msg["z_far"], *unflip(msg), device=device).camera
            with torch.no_grad():
                color = render_map(m, cam, cfg).color.cpu().numpy()
            want_img = np.clip(color * 255, 0, 255).astype(np.uint8).transpose(1, 2, 0)
            same.append(verify == "ok" and img == np.ascontiguousarray(want_img).tobytes())
        per = {s: launches["viewer"][s] / viewer_requests for s in PATH_KERNELS}
        res["viewer"] = {"requests": served, "replies_bitwise": same,
                         "median_ms_per_request": float(np.median(client["ms"])),
                         "client_ms": client["ms"], "gaussians": int(m.count),
                         "launches_per_request": per,
                         "composite_windowed_at_viewer_config": view_check}
        assert served == viewer_requests and all(same), res["viewer"]
        # SLAMConfig() renders on the windowed host-table path: rows 1 and 4
        assert per == {"sags_expand_pairs": 0, "sags_fill_table": 1, "sags_composite_fused": 0,
                       "sags_composite_fused_bwd": 0, "sags_composite_windowed": 1}, per
        emit({"phase": "sources", "viewer": res["viewer"]})

    # (e) the native host library against its fallbacks on the card
    with timer.phase("e_native"):
        assert native.available(), f"native library: {native.build_error}"
        scan = np.ascontiguousarray(frames[0].scan, np.float32)
        nat = {}

        def timed(key, fn, *args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            nat[key] = (time.perf_counter() - t0) * 1e3
            return out

        def fallback(fn, *args, **kw):
            with swapped(native, "_library", lambda: None):
                return fn(*args, **kw)

        res_m = 0.25  # a power of two: both sides put every point in the same voxel
        ds_n = timed("voxel_downsample_ms", native.voxel_downsample, scan, res_m)
        ds_f = timed("voxel_downsample_fallback_ms", fallback, native.voxel_downsample, scan,
                     res_m, device=device)
        order = lambda a: a[np.lexsort(np.floor(a / res_m).T)]
        ds_err = (float(np.abs(order(ds_n) - order(ds_f)).max())
                  if len(ds_n) == len(ds_f) else math.inf)
        d2_n, idx_n = timed("kdtree_knn_ms", native.KDTree(scan).knn, scan, knn_k)
        d2_f, idx_f = timed("kdtree_knn_fallback_ms", fallback,
                            lambda: native.KDTree(scan, device=device).knn(scan, knn_k))
        # the fallback computes |q|^2 + |p|^2 - 2 q.p in float32 (`ops.knn`,
        # the JAX package's formula), whose rounding grows with the squared
        # norms: the distances are held to 1e-5 plus that rounding bound
        bar = knn_bar(scan, d2_n)
        # float64 neighbours tell ties apart: a rank is held where its exact
        # distance is clear of the ranks beside it by twice the bar
        s64 = scan.astype(np.float64)
        exact = np.empty((len(scan), knn_k + 1))
        for lo in range(0, len(scan), 512):
            dd = ((s64[lo:lo + 512, None] - s64[None]) ** 2).sum(-1)
            exact[lo:lo + 512] = np.sort(np.partition(dd, knn_k, axis=1)[:, :knn_k + 1], 1)
        gap = np.diff(exact, axis=1)
        clear = gap[:, :knn_k] > 2 * bar.max(1, keepdims=True)
        clear[:, 1:] &= gap[:, :knn_k - 1] > 2 * bar.max(1, keepdims=True)
        raw = np.zeros((len(scan), 8), "<f4")
        raw[:, :3] = frames[0].points
        rgbu = (np.clip(frames[0].colors, 0, 1) * 255).astype(np.uint32)
        raw[:, 4] = ((rgbu[:, 0] << 16) | (rgbu[:, 1] << 8) | rgbu[:, 2]).view(np.float32)
        xyz_n, rgb_n = timed("decode_xyzrgb_ms", native.decode_xyzrgb, raw.tobytes(), 32)
        xyz_f, rgb_f = timed("decode_xyzrgb_fallback_ms", fallback, native.decode_xyzrgb,
                             raw.tobytes(), 32)
        res["native"] = dict(nat, built_with=native.built_with, points=len(scan),
                             voxels=[len(ds_n), len(ds_f)], voxel_max_abs_err=ds_err,
                             knn_k=knn_k, knn_d2_max_abs_err=float(np.abs(d2_n - d2_f).max()),
                             knn_d2_err_over_bar=float((np.abs(d2_n - d2_f) / bar).max()),
                             knn_ranks_held=int(clear.sum()),
                             knn_idx_equal_where_clear=bool((idx_n == idx_f)[clear].all()),
                             decode_bitwise=bool(np.array_equal(xyz_n, xyz_f)
                                                 and np.array_equal(rgb_n, rgb_f)))
        emit({"phase": "sources", "native": res["native"]})
        assert res["native"]["voxel_max_abs_err"] <= 1e-5, res["native"]
        assert res["native"]["knn_d2_err_over_bar"] <= 1.0, res["native"]
        assert res["native"]["knn_idx_equal_where_clear"], res["native"]
        assert res["native"]["decode_bitwise"], res["native"]

    # (f) the phases' report, and one traced frame
    print("\n".join("# sources: " + ln for ln in timer.report().splitlines()), flush=True)
    write_rosbag(path["one.bag"], frames[:1])
    t0 = time.perf_counter()
    with trace(path["trace"]):
        cli_main(["run-slam", "--dataset", "rosbag", "--path", path["one.bag"],
                  *run_flags, "--post-train", "0"], device)
    written = sorted(os.listdir(path["trace"]))
    res["trace"] = {"files": written, "seconds": time.perf_counter() - t0,
                    "bytes": sum(os.path.getsize(os.path.join(path["trace"], f))
                                 for f in written)}
    res["phase_seconds"] = {k: v["mean_ms"] / 1e3 for k, v in timer.summary().items()}
    assert written and res["trace"]["bytes"] > 0, res["trace"]
    emit({"phase": "sources", "trace": res["trace"], "phase_seconds": res["phase_seconds"]})
    shutil.rmtree(work, ignore_errors=True)
    return res, launches


MESH_FRAMES = 16  # the loop cell's first frames, for the pipeline runs
MESH_STEPS = 5  # slam_steps per training mode and rank
MESH_MODES = ("classic", "windowed")
MESH_TIMEOUT_S = 300  # a rank waiting longer in a collective fails the run
MESH_COMPOSITORS = {"classic": ("sags_composite_fused", "sags_composite_fused_bwd"),
                    "windowed": ("sags_composite_windowed", "sags_composite_windowed_bwd")}
ALLREDUCE_ROWS = 2 ** 18  # the classic dG of the loop cell's map: [2^18, 32] float32


def device_sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def state_digest(state) -> dict:
    """A state for comparing across processes: the sha256 of every leaf in
    the checkpoint's order (`checkpoint._leaves`, dtype and shape included)
    and of the generator state, and f_dc and xyz on the host."""
    import hashlib

    import torch

    from sags_tpu_torch.slam import checkpoint

    def digest(x):
        t = torch.as_tensor(x).detach().cpu().contiguous()
        return hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode()
                              + t.numpy().tobytes()).hexdigest()

    return {"leaves": [digest(x) for x in checkpoint._leaves(state)],
            "generator": digest(state.rng.generator.get_state()),
            "f_dc": state.map.f_dc.detach().cpu(), "xyz": state.map.xyz.detach().cpu()}


def mesh_inputs(root, pipes, frames) -> None:
    """What every rank starts from, under `root`: each loop's state and
    config (`checkpoint.save_state`) with its newest keyframe, one directory
    per training mode, and the frames of the pipeline runs."""
    import torch

    from sags_tpu_torch.slam import checkpoint

    for mode, pipe in pipes.items():
        path = os.path.join(root, mode)
        checkpoint.save_state(path, pipe.state, pipe.cfg)
        kf = pipe.keyframes[-1]
        torch.save({"camera": kf.camera, "image": kf.image, "objects": kf.objects},
                   os.path.join(path, "keyframe.pt"))
    torch.save(frames, os.path.join(root, "frames.pt"))


def mesh_steps(device, path, mesh):
    """MESH_STEPS `slam_step`s from the state, config and keyframe saved
    under `path`, the compositor sharded over `mesh` (None: unsharded), each
    step timed on the host clock up to a sync. Under a mesh, the mode's
    compositors are first held at this rank's tile offset against their
    plain versions on the loaded state (`loop_fused_check`,
    `loop_bwd_check`); then the launch counts are zeroed just before the
    steps and read just after."""
    import torch

    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam import checkpoint
    from sags_tpu_torch.slam import step as slam_step

    state, cfg = checkpoint.load_state(path, device=device)
    kf = torch.load(os.path.join(path, "keyframe.pt"), map_location=device,
                    weights_only=False)
    out = {}
    if mesh is not None:
        if cfg.raster.train_windowed:
            pipe = type("StepPipe", (), {"state": state, "cfg": cfg})
            out["kernels"] = loop_bwd_check(device, pipe, kf["camera"], mesh)
        else:
            fwd, bwd = loop_fused_check(device, state.map, cfg, kf["camera"], mesh)
            out["kernels"] = {"fwd": fwd, "bwd": bwd}
    losses, step_ms = [], []
    device_sync(device)
    _build.reset_launch_counts()
    for _ in range(MESH_STEPS):
        t0 = time.perf_counter()
        state, m = slam_step.slam_step(state, kf["camera"], kf["image"], kf["objects"],
                                       cfg, mesh)
        device_sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m.loss)
    out.update(launches=launch_counts(), losses=[float(x) for x in losses],
               step_ms=step_ms, state=state_digest(state))
    return out


def mesh_pipeline(device, frames, mesh) -> dict:
    """`SLAMPipeline(mesh=...).run` of the loop cell's config over `frames`,
    launch counts zeroed just before and read just after."""
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.slam.pipeline import SLAMPipeline

    cfg = slam_config()
    pipe = SLAMPipeline(cfg, point_budget=cfg.tracking.max_points, rng_seed=0,
                        device=device, mesh=mesh)
    device_sync(device)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe.run(frames, post_train=0)
    device_sync(device)
    return {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
            "poses": res.poses_est, "poses_gt": res.poses_gt, "losses": res.losses,
            "train_iters": res.train_iters, "state": state_digest(res.state)}


def allreduce_ms(mesh, rows=ALLREDUCE_ROWS, reps=5) -> dict:
    """The sharded step's dG all-reduce alone: a [rows, 32] float32 tensor,
    host clock over `reps` calls after one warm call."""
    import torch
    import torch.distributed as dist

    x = torch.ones((rows, 32), device=mesh.device)
    dist.all_reduce(x, group=mesh.group)
    device_sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(x, group=mesh.group)
    device_sync(mesh.device)
    return {"ms": (time.perf_counter() - t0) / reps * 1e3, "bytes": x.numel() * 4}


def mesh_rank(rank, n, root, backend, devices, pipeline) -> None:
    """One rank of a mesh-phase run, spawned: joins the group (`file://`
    rendezvous under `root`), runs `mesh_steps` in both training modes, the
    all-reduce alone and, with `pipeline`, `mesh_pipeline` over the saved
    frames, and writes its results under `root`."""
    import datetime

    import torch
    import torch.distributed as dist

    from sags_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group(backend, init_method=f"file://{root}/rendezvous-{backend}-{n}",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh(n, devices=devices)
        out = {mode: mesh_steps(mesh.device, os.path.join(root, mode), mesh)
               for mode in MESH_MODES}
        out["allreduce"] = allreduce_ms(mesh)
        if pipeline:
            frames = torch.load(os.path.join(root, "frames.pt"), weights_only=False)
            out["pipeline"] = mesh_pipeline(mesh.device, frames, mesh)
        torch.save(out, os.path.join(root, f"{backend}-{n}-rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(n, root, backend, devices, pipeline):
    """`mesh_rank` on n spawned processes; their results in rank order and
    the wall seconds. A rank that fails ends the others and raises."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, args=(n, root, backend, devices, pipeline), nprocs=n,
                       start_method="spawn")
    return ([torch.load(os.path.join(root, f"{backend}-{n}-rank{r}.pt"), weights_only=False)
             for r in range(n)], time.perf_counter() - t0)


def assert_digests_equal(a, b, where) -> None:
    assert a["leaves"] == b["leaves"] and a["generator"] == b["generator"], \
        (where, [i for i, (x, y) in enumerate(zip(a["leaves"], b["leaves"])) if x != y])


def check_mesh_steps(ranks, ref, where) -> dict:
    """One multi-rank run's `mesh_steps` held: every rank's state bitwise
    rank 0's; rank 0's losses (rtol 1e-5), f_dc (atol 1e-5) and xyz (atol
    1e-6) against the unsharded steps, `tests/test_parallel.py`'s bars; each
    compositor at its rank's offset within the loop bars; per rank and step
    exactly one launch of each of the mode's compositors and none of the
    other mode's. Returns the run's summary."""
    import numpy as np

    out = {}
    for mode in MESH_MODES:
        want, got = ref[mode], ranks[0][mode]
        for r, res in enumerate(ranks[1:], 1):
            assert_digests_equal(res[mode]["state"], got["state"], f"{where} {mode} rank {r}")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                   err_msg=f"{where} {mode} losses")
        np.testing.assert_allclose(got["state"]["f_dc"], want["state"]["f_dc"], atol=1e-5,
                                   rtol=0, err_msg=f"{where} {mode} f_dc")
        np.testing.assert_allclose(got["state"]["xyz"], want["state"]["xyz"], atol=1e-6,
                                   rtol=0, err_msg=f"{where} {mode} xyz")
        for r, res in enumerate(ranks):
            k = res[mode]["kernels"]
            if mode == "classic":
                assert_loop_fused(k["fwd"], k["bwd"], f"{where} rank {r}")
            else:
                assert k["rel_err"] <= 2e-4, (where, r, k)
                assert k["composite_windowed"]["bitwise"], (where, r, k)
                assert k["composite_windowed"]["strip_cull"]["gated_strips_dropped"] == 0, \
                    (where, r, k)
            other = MESH_COMPOSITORS["windowed" if mode == "classic" else "classic"]
            for sym in MESH_COMPOSITORS[mode]:
                assert res[mode]["launches"][sym] == MESH_STEPS, (where, mode, r, res[mode]["launches"])
            for sym in other:
                assert res[mode]["launches"][sym] == 0, (where, mode, r, res[mode]["launches"])
        out[mode] = {
            "losses": got["losses"], "unsharded_losses": want["losses"],
            "max_loss_rel_diff": float(np.max(np.abs(np.subtract(got["losses"], want["losses"]))
                                              / np.abs(want["losses"]))),
            "f_dc_max_abs_diff": float((got["state"]["f_dc"] - want["state"]["f_dc"]).abs().max()),
            "xyz_max_abs_diff": float((got["state"]["xyz"] - want["state"]["xyz"]).abs().max()),
            "ms_per_step": [float(np.median(r[mode]["step_ms"][1:])) for r in ranks],
            "tile_offsets": [(r[mode]["kernels"]["fwd"] if mode == "classic"
                              else r[mode]["kernels"])["tile_offset"] for r in ranks],
            "kernels": [r[mode]["kernels"] for r in ranks]}
    out["allreduce"] = [r["allreduce"] for r in ranks]
    return out


def check_mesh_pipeline(ranks, classic_ate, where) -> dict:
    """A multi-rank `SLAMPipeline(mesh=...)` run held: finite losses whose
    last third averages below the first, the ATE within 1% of the classic
    loop's over the same frames, every rank's final state bitwise rank 0's,
    and one launch of each classic compositor per training step on every
    rank."""
    import numpy as np

    from sags_tpu_torch.utils.traj import ate_rmse

    got = ranks[0]["pipeline"]
    losses = np.asarray(got["losses"])
    third = max(1, len(losses) // 3)
    first, last = float(losses[:third].mean()), float(losses[-third:].mean())
    ate, _ = ate_rmse(got["poses"], got["poses_gt"], align=False)
    assert np.isfinite(losses).all(), (where, losses)
    assert last < first, (where, first, last)
    assert abs(ate - classic_ate) <= 0.01 * classic_ate, (where, ate, classic_ate)
    for r, res in enumerate(ranks[1:], 1):
        assert_digests_equal(res["pipeline"]["state"], got["state"], f"{where} rank {r}")
    for r, res in enumerate(ranks):
        p = res["pipeline"]
        for sym in MESH_COMPOSITORS["classic"]:
            assert p["launches"][sym] == p["train_iters"], (where, r, p["launches"])
    return {"ate_m": ate, "classic_ate_m_same_frames": classic_ate,
            "loss_first_third": first, "loss_last_third": last,
            "train_iters": got["train_iters"], "seconds": [r["pipeline"]["seconds"] for r in ranks],
            "ms_per_frame": [r["pipeline"]["seconds"] * 1e3 / len(losses) for r in ranks]}


def mesh_phase(device, frames, classic, pipes):
    """Phase 13, the tile-sharded port: (a) `SLAMPipeline(mesh=make_mesh())`
    on one NCCL rank in this process over the loop cell's first frames,
    bitwise equal to `mesh=None`; (b) 2 and 3 gloo ranks on this card (3:
    1280 tiles padded to 1281), each running MESH_STEPS classic and windowed
    `slam_step`s from the slam and slam_windowed phases' states, configs
    and newest keyframes (`check_mesh_steps`); (c) a 2-rank
    `SLAMPipeline(mesh=...)` over the same frames (`check_mesh_pipeline`);
    (d) with several cards, (b) and (c) over NCCL, one rank per card.
    Returns each run's launch counts by kernel."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from sags_tpu_torch.parallel.mesh import make_mesh
    from sags_tpu_torch.utils.traj import ate_rmse

    t_phase = time.perf_counter()
    device = torch.device(device)
    frames = frames[:MESH_FRAMES]
    gt = np.stack([f.pose for f in frames])
    classic_ate, _ = ate_rmse(classic["poses"][:MESH_FRAMES], gt, align=False)
    res, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="sags_mesh_") as root:
        # (a) one rank: the slice is the whole grid, the collectives identities
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{root}/rendezvous-one",
                                rank=0, world_size=1)
        try:
            one = mesh_pipeline(device, frames,
                                make_mesh(devices=None if device.type == "cuda" else ["cpu"]))
        finally:
            dist.destroy_process_group()
        plain = mesh_pipeline(device, frames, None)
        assert_digests_equal(one["state"], plain["state"], f"{backend} one rank")
        assert np.array_equal(one["poses"], plain["poses"]) and one["losses"] == plain["losses"]
        launches[f"{backend}_1_rank_pipeline"] = one["launches"]
        res["one_rank"] = {"backend": backend, "bitwise": True,
                           "seconds": one["seconds"], "unsharded_seconds": plain["seconds"],
                           "launches": one["launches"]}

        # (b), (c): the ranks start from the saved states, keyframes and frames
        mesh_inputs(root, pipes, frames)
        ref = {mode: mesh_steps(device, os.path.join(root, mode), None) for mode in MESH_MODES}
        res["unsharded_ms_per_step"] = {m: float(np.median(ref[m]["step_ms"][1:]))
                                        for m in MESH_MODES}
        # gloo admits several ranks on one card (NCCL refuses them)
        card = f"cuda:{torch.cuda.current_device()}" if device.type == "cuda" else "cpu"
        runs = [("gloo", n, [card] * n, n == 2) for n in (2, 3)]
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if cards >= 2:
            runs.append(("nccl", cards, None, True))
        else:
            res["nccl_across_cards"] = f"skipped: {cards} card; NCCL runs one rank per card"
        for backend, n, devices, pipeline in runs:
            ranks, seconds = spawn_ranks(n, root, backend, devices, pipeline)
            key = f"{backend}_{n}_ranks"
            res[key] = check_mesh_steps(ranks, ref, key)
            res[key]["seconds"] = seconds
            launches[f"{key}_steps"] = [
                {s: sum(r[m]["launches"][s] for m in MESH_MODES) for s in r["classic"]["launches"]}
                for r in ranks]
            if pipeline:
                res[key]["pipeline"] = check_mesh_pipeline(ranks, classic_ate, key)
                launches[f"{key}_pipeline"] = [r["pipeline"]["launches"] for r in ranks]
    res["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "mesh", "frames": len(frames), "steps": MESH_STEPS, **res})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sags_tpu_torch import resolve_device
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.ops import binning, composite, sort, windowed  # noqa: F401  (register kernels)

    device = resolve_device("cuda")
    t0 = time.perf_counter()
    # the kernel sort ended after its keys and after its sort: its phase split
    stops = [windowed.SORTED.variant(f"-DSAGSW_STOP_AFTER={k}") for k in (1, 2)]
    _build.build_all(extra=stops)
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
    xres = expand_pairs_phase(device)
    thin = thin_scene_phase(device)
    thin_w = thin_windowed_phase(device)
    wres = windowed_kernel_phase(device, stops=stops)
    launches, pipe, frames, poses, classic = slam_phase(device)
    K_final = pipe.cfg.raster.tile_capacity
    if K_final not in kres:
        kres.update(kernel_phase(device, capacities=(K_final,)))
    eres, eres_frame = eval_phase(device, pipe, frames, poses)
    n_frames = len(frames)
    wlaunches, n_wframes, wloop, wpipe = slam_windowed_phase(device, frames,
                                                             dict(classic, poses=poses))
    mesh_launches = mesh_phase(device, frames, dict(classic, poses=poses),
                               {"classic": pipe, "windowed": wpipe})
    del wpipe
    _, kf_images, sem = semantic_phase(device, frames, dict(classic, poses=poses, pipe=pipe))
    sam_phase(device, kf_images, frames, pipe.cfg.semantics.num_classes)
    tracking_phase(device, frames, dict(classic, poses=poses, lm_log=pipe.lm_log))
    module_launches = esikf_phase(device, frames, dict(classic, poses=poses))
    offline_launches = offline_phase(device, frames, classic["dataset"])
    cli_res, cli_launches = cli_phase(device)
    _, sources_launches = sources_phase(device, cli_res)

    # (source, TPU kernel, C symbol, the path whose launches count, frames on it)
    src = {"fill_table": ("sags_tpu_torch/csrc/fill_table.cu",
                          "sags_tpu/ops/pallas_binning.py:75", "sags_fill_table"),
           "composite_fused": ("sags_tpu_torch/csrc/composite_fused.cu",
                               "sags_tpu/ops/pallas_composite.py:119",
                               "sags_composite_fused"),
           "composite_fused_bwd": ("sags_tpu_torch/csrc/composite_fused_bwd.cu",
                                   "sags_tpu/ops/pallas_composite.py:318",
                                   "sags_composite_fused_bwd"),
           "composite_windowed": ("sags_tpu_torch/csrc/composite_windowed.cu",
                                  "sags_tpu/ops/pallas_windowed.py:568",
                                  "sags_composite_windowed"),
           "composite_windowed_bwd": ("sags_tpu_torch/csrc/composite_windowed_bwd.cu",
                                      "sags_tpu/ops/pallas_windowed.py:489",
                                      "sags_composite_windowed_bwd"),
           "composite_windowed_sorted": ("sags_tpu_torch/csrc/composite_windowed_sorted.cu",
                                         "sags_tpu/ops/pallas_windowed.py:828",
                                         "sags_composite_windowed_sorted"),
           "sort_blocks": ("sags_tpu_torch/csrc/sort_blocks.cu",
                           "sags_tpu/ops/pallas_sort.py:89", "sags_sort_blocks"),
           # replaces no TPU kernel: the JAX package leaves it to XLA
           "expand_pairs": ("sags_tpu_torch/csrc/expand_pairs.cu", None,
                            "sags_expand_pairs")}
    path_of = {"expand_pairs": "slam", "fill_table": "slam", "composite_fused": "slam",
               "composite_fused_bwd": "slam", "composite_windowed": "windowed_host",
               "composite_windowed_bwd": "slam_windowed",
               "composite_windowed_sorted": "windowed_kernel",
               # its network runs inside composite_windowed_sorted; the
               # standalone kernel is the block sort's harness
               "sort_blocks": "windowed_kernel"}
    kernels = []
    rows = dict(wres, expand_pairs=xres[EXPAND_CASES[0]])
    for name, (path, replaces, sym) in src.items():
        r = kres[K_final][name] if name in kres[K_final] else rows[name]
        t_bytes = r["bytes"] / PEAK_BYTES_S * 1e3
        t_ops = r["ops"] / PEAK_FP32_S * 1e3
        on = path_of[name]
        if on == "slam":
            n, per = launches[sym], launches[sym] / n_frames
        elif on == "slam_windowed":
            n, per = wlaunches[sym], wlaunches[sym] / n_wframes
        else:
            n = eres[on]["launches"][sym]
            per = eres[on]["launches_per_frame"][sym]
        kernels.append({
            "name": name, "route": "cuda", "source": path, "replaces": replaces,
            "launches": n, "launches_per_frame": per, "path": on,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "stream_ms": r["stream_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r.get("library_ms"),
            "cli_launches": cli_launches[sym],
            "mesh_launches": {k: [r[sym] for r in v] if isinstance(v, list) else v[sym]
                              for k, v in mesh_launches.items()},
            "sources_launches": {k: v[sym] for k, v in sources_launches.items()},
            **({"empty_kernel_ms": r["empty_ms"],
                "torch_full_ms": r["full_ms"], "semantic_loop_launches": sem["launches"][sym]}
               if name == "fill_table" else {}),
            **({"per_module_loops_launches": {k: v[sym] for k, v in module_launches.items()},
                "offline_launches": offline_launches[sym]}
               if sym in SLAM_KERNELS else {}),
        })
    emit({"tile_capacity": K_final,
          "by_tile_capacity": {K: {n: {"ms": kres[K][n]["ms"], "plain_ms": kres[K][n]["plain_ms"]}
                                   for n in ("fill_table", "composite_fused",
                                             "composite_fused_bwd")} for K in kres},
          "scatter_ms": {K: kres[K]["scatter_ms"] for K in kres},
          "kept_pairs": {K: kres[K]["kept_pairs"] for K in kres},
          "live_pixel_pairs": {K: kres[K]["live_pixel_pairs"] for K in kres},
          "strip_cull": dict({K: kres[K]["strip_cull"] for K in kres}, **thin),
          "windowed": {k: v for k, v in wres.items() if not isinstance(v, dict)},
          "ms_per_eval_render": {m: e["ms_per_eval_render"] for m, e in eres.items()}})
    ws = wres["composite_windowed_sorted"]
    emit({"composite_windowed_sorted_phases": ws["phases"],
          "strip_cull_dropped_share": {
              "kernel_cell": {k: wres[k]["strip_cull"]["dropped_share"]
                              for k in ("composite_windowed", "composite_windowed_sorted")},
              "windowed_loop": wloop["composite_windowed"]["strip_cull"]["dropped_share"],
              "eval_frame": {m: c["strip_cull"]["dropped_share"]
                             for m, c in eres_frame.items()},
              "thin_scenes": {n: {e: {k: c["dropped_share"] for k, c in r[e].items()}
                                  for e in ("strip_cull:vpu", "strip_cull:quad")}
                              for n, r in thin_w.items()}}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
