#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`sags_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line):
  1. build the CUDA kernels from `sags_tpu_torch/csrc` (one nvcc per source,
     in parallel) and print the card's name and power limit;
  2. hold every kernel against its plain PyTorch version at the slice's
     shapes (640x512 → 1280 tiles, P = 2^18 Gaussians of a seeded random
     scene) and time each:
     - classic path, K = 512 and 1024: fill_table exactly, composite_fused to
       1e-3 absolute, composite_fused_bwd to 2e-4 relative per output row,
       and the scattered dG bitwise equal across two backward runs;
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
  3. drive `SLAMPipeline.run` (fused front-end, GICP tracking) at the
     pipeline bench's operating point for 32 warm + 16 timed frames and check
     finite, falling losses, the trajectory (ATE < 0.12 m over the first
     0.75 m of path, the bar of `tests/test_pipeline.py`, and within 5% of the
     JAX package's ATE on the same scans over the whole run), that its
     kernels launched, and composite_fused_bwd at the loop's own shapes on
     the newest keyframe: 2e-4 relative per output row of its plain version,
     dGt and the scattered dG bitwise equal over two launches;
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
     2e-4 relative per output row of its plain version.
Launch counts are zeroed just before each main path (each loop, each eval
mode) and read just after. The line before the last holds each kernel's
launches on its path, its time, its plain version's time, the library
call's time and its bound. The last stdout line is
`{"ok": true, "device": {...}}`. Imports no JAX.
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
SLAM_KERNELS = ("sags_fill_table", "sags_composite_fused", "sags_composite_fused_bwd")
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


def _sort_stages(n: int) -> int:
    """Compare-exchange stages of a bitonic network over n keys."""
    s = int(math.log2(n))
    return s * (s + 1) // 2


def windowed_kernel_phase(device, P=2 ** 18, width=SLICE_W, height=SLICE_H, K=1024):
    """The windowed compositors and the block sort against their plain
    versions at the kernel cell; the kernel sort against the host table."""
    import dataclasses

    import torch

    from sags_tpu_torch.core.camera import make_camera
    from sags_tpu_torch.core.config import RasterizeConfig
    from sags_tpu_torch.ops import composite, sort, windowed as win
    from sags_tpu_torch.ops import rasterize as rz

    xyz, opac, scales, quats, colors, objs = random_scene(P, device)
    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                      width, height, 2 * math.atan(width / (2 * 431.8)),
                      2 * math.atan(height / (2 * 431.8)))
    tiles_x, tiles_y = width // 16, height // 16
    NT = tiles_x * tiles_y
    base = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=K, windowed_chunk=512,
                           windowed_big_capacity=128)
    with torch.no_grad():
        occ = {k: v.cpu().numpy() for k, v in
               rz.windowed_occupancy(xyz, opac, scales, quats, cam, base).items()}
        cfg = rz.derive_windowed_budgets(base, occ, P)
        pre = rz.preprocess(xyz, opac, scales, quats, cam, cfg, colors=colors)
        (G_s, table, tl, counts, bases, dests, nblks, n_binned, ov_rect, ov_tile, ov_win,
         ov_big) = rz._prepare_windowed(pre, objs, tiles_x, tiles_y, cfg)
    chunk = rz._windowed_chunk(cfg)
    gate = dict(alpha_min=cfg.alpha_min, t_min=cfg.transmittance_min)
    kw = dict(gate, chunk=chunk, n_span=4)
    out = {"window_blocks": cfg.window_blocks, "rows": int(G_s.shape[0]),
           "n_binned": int(n_binned), "overflow_window": int(ov_win),
           "overflow_big": int(ov_big), "overflow_tile": int(ov_tile)}

    # -- composite_windowed: acc and T bitwise equal (the plain version takes
    # the kernel's float32 operations in its order)
    args = (G_s, tl, counts, bases, dests, nblks, 16, tiles_x)
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
    out["composite_windowed"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: win.composite_windowed(*args, **kw), 20),
        plain_ms=cuda_ms(lambda: win.composite_windowed_plain(*args, **kw), 2),
        # each composited row's 32 columns once, the kept work list, the
        # span plan and counts, acc + T out
        bytes=128 * n_rows + 4 * kept + 4 * NT * (1 + 3 * 4) + 4 * NT * 256 * 25,
        ops=FWD_OPS_PER_PIXEL_PAIR * pairs_px, live_pixel_pairs=pairs_px)
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
        ms=cuda_ms(lambda: win.composite_windowed_bwd(*bargs, **kw), 10),
        plain_ms=cuda_ms(lambda: win.composite_windowed_bwd_plain(*bargs, **kw), 2),
        # composite_windowed's reads plus d_acc, d_T and T_final in, dGt out
        bytes=128 * n_rows + 4 * kept + 4 * NT * (1 + 3 * 4) + 4 * NT * 256 * 26
        + 4 * NT * 32 * K,
        ops=BWD_OPS_PER_PIXEL_PAIR * pairs_px, live_pixel_pairs=pairs_px)
    del dG1, dG2

    # -- composite_windowed_sorted at the largest window it sorts (16 blocks)
    kcfg = dataclasses.replace(cfg, window_blocks=16, windowed_sort="kernel")
    with torch.no_grad():
        G2, b2, d2, n2, ss, se, _, ov_raw, _ = rz._prepare_windowed(
            pre, objs, tiles_x, tiles_y, kcfg, build_table=False)
    sargs = (G2, b2, d2, n2, ss, se, 16, tiles_x)
    skw = dict(kw, w_blocks=16, k_tile=K)
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
    n_comp = int(torch.unique(srows[srows >= 0]).numel())
    # rows the windows read (in a span and in an allocated block)
    delta = torch.zeros(G2.shape[0] + 1, dtype=torch.int64, device=device)
    lo = ss.long()
    hi = torch.minimum(se.long(), (b2.long() + n2.long()) * 128)
    live = hi > lo
    delta.index_add_(0, lo[live], torch.ones_like(lo[live]))
    delta.index_add_(0, hi[live], -torch.ones_like(hi[live]))
    n_span_rows = int((torch.cumsum(delta, 0)[:-1] > 0).sum())
    spairs = float(live_pixel_pairs(G2[:, :32], srows, scount, tiles_x, chunk, **gate))
    n_sort = 2048
    ce = NT * (n_sort // 2) * _sort_stages(n_sort)
    out["composite_windowed_sorted"] = dict(
        max_abs_err=err_s, nv_exact=True,
        ms=cuda_ms(lambda: win.composite_windowed_sorted(*sargs, **skw), 20),
        plain_ms=cuda_ms(lambda: win.composite_windowed_sorted_plain(*sargs, **skw), 2),
        # validity columns (11 floats) of every window row, the 24 features
        # of every composited row, the span plan, acc + T + nv out
        bytes=44 * n_span_rows + 96 * n_comp + 4 * NT * 5 * 4 + 4 * NT * (256 * 25 + 1),
        # compositing, ~40 operations of key math per slot, and the sort's
        # compare-exchanges (a min and a max each)
        ops=FWD_OPS_PER_PIXEL_PAIR * spairs + 40.0 * NT * n_sort + 2.0 * ce,
        live_pixel_pairs=spairs, compare_exchanges=ce, nv_total=int(nv.sum()),
        overflow_window_raw=int(ov_raw))

    variants = variant_checks(pre, objs, cfg, tiles_x, tiles_y, kw, acc, T, acc_s, sargs,
                              skw)

    # -- the kernel sort against the host table at the same 16-block budget:
    # the same bits on every tile whose spans all fit the window
    with torch.no_grad():
        h = rz._prepare_windowed(pre, objs, tiles_x, tiles_y,
                                 dataclasses.replace(cfg, window_blocks=16))
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
    out["sort_blocks"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: sort.sort_blocks(x), 50),
        plain_ms=cuda_ms(lambda: sort.sort_blocks_plain(x), 50),
        library_ms=cuda_ms(lambda: torch.sort(flat, dim=1), 50),
        bytes=8 * x.numel(), ops=2.0 * ce, compare_exchanges=ce)
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


def slam_config(points=4096, capacity=2 ** 18, train_windowed=False):
    """The pipeline bench's operating point (`bench.py:bench_pipeline`)."""
    from sags_tpu_torch.core.config import (KeyframeConfig, MapConfig,
                                            RasterizeConfig, SLAMConfig,
                                            TrackingConfig)

    return SLAMConfig(
        raster=RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=512, chunk=64,
                               train_windowed=train_windowed),
        map=MapConfig(initial_capacity=capacity),
        keyframes=KeyframeConfig(keyframe_freq=5, window=16),
        tracking=TrackingConfig(backend="gicp", max_points=points),
        post_train_iters=0, metrics_interval=5,
    )


def slam_setup(device, n_frames, width=SLICE_W, height=SLICE_H, n_world=65536,
               points=4096, capacity=2 ** 18, train_windowed=False):
    """The pipeline bench's operating point: (SLAMConfig, frames)."""
    from sags_tpu_torch.io.datasets import SyntheticDataset

    cfg = slam_config(points, capacity, train_windowed)
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
    bwd = loop_fused_bwd_check(device, pipe, kf.camera)

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
          "composite_fused_bwd_at_loop": bwd,
          "lm_iterations_per_frame": [list(x) for x in pipe.lm_log]})
    assert np.isfinite(losses).all(), "non-finite loss"
    assert bwd["rel_err"] <= 2e-4, f"composite_fused_bwd at the loop's shapes: {bwd}"
    assert bwd["dGt_bitwise"] and bwd["dG_bitwise"], f"composite_fused_bwd not reproducible: {bwd}"
    assert len(losses) == n_frames, len(losses)
    assert last_mean < first_mean, (first_mean, last_mean)
    assert ate_near < ATE_BAR_M, f"ATE {ate_near} m over the first {ATE_BAR_PATH_M} m"
    assert ate <= 1.05 * REFERENCE_ATE_M, f"ATE {ate} m, reference {REFERENCE_ATE_M} m"
    for sym in SLAM_KERNELS:
        assert launches[sym] > 0, f"{sym} never launched in the SLAM loop"
    return launches, pipe, frames, poses, {"ms_per_frame": frame_ms,
                                           "ms_per_train_step": step_ms, "ate_m": ate}


def loop_fused_bwd_check(device, pipe, camera):
    """`composite_fused_bwd` against its plain version at the shapes the
    classic loop trains with (its final tile capacity, R and chunk) on the
    inputs `rasterize` prepares for `camera`, with seeded cotangents: 2e-4
    relative per output row, as at the kernel cell; dGt and the scattered dG
    compared over two launches."""
    import torch

    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import composite
    from sags_tpu_torch.ops import rasterize as rz

    m, rc = pipe.state.map, pipe.cfg.raster
    tiles_x, tiles_y = -(-camera.width // rc.tile), -(-camera.height // rc.tile)
    kw = dict(alpha_min=rc.alpha_min, t_min=rc.transmittance_min, chunk=rc.chunk)
    with torch.no_grad():
        pre = rz.preprocess(m.xyz, gm.get_opacity(m), gm.get_scaling(m), gm.get_rotation(m),
                            camera, rc, shs=gm.get_shs(m), sh_degree=pipe.cfg.map.sh_degree,
                            active_mask=m.active)
        table, counts, *_ = rz.bin_gaussians(pre, tiles_x, tiles_y, rc)
        G = rz._pack_gaussians(pre, m.obj_dc).contiguous()
    acc, T = composite.composite_fused(G, table, counts, rc.tile, tiles_x, **kw)
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
    return {"rel_err": row_rel_err(dGt, dGt_p), "max_abs_err": float((dGt - dGt_p).abs().max()),
            "dGt_bitwise": torch.equal(dGt, dGt_2), "dG_bitwise": torch.equal(dG, dG_2),
            "chunk": rc.chunk, "tile_capacity": rc.tile_capacity,
            "max_tiles_per_gaussian": rc.max_tiles_per_gaussian,
            "pairs": int(counts.sum()), "deepest_tile": int(counts.max()),
            "ms": cuda_ms(lambda: composite.composite_fused_bwd(*bargs, **kw), 5)}


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
    from sags_tpu_torch.models.classifier import ClassifierParams
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.slam import step as slam_step
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.draws import ReplayDraws
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

    same = bitwise(False)
    same_cls3d = bitwise(True)
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
    return launches, n_frames


def loop_bwd_check(device, pipe, camera):
    """`composite_windowed_bwd` against its plain version at the shapes the
    windowed loop trains with (its final window, R, tile capacity and slice
    store) on the inputs `rasterize` prepares for `camera`, with seeded
    cotangents: 2e-4 relative per output row, as at the kernel cell."""
    import torch

    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.ops import windowed as win

    m, rc = pipe.state.map, pipe.cfg.raster
    tiles_x, tiles_y = -(-camera.width // rc.tile), -(-camera.height // rc.tile)
    kw = rz._windowed_kw(rc)
    with torch.no_grad():
        pre = rz.preprocess(m.xyz, gm.get_opacity(m), gm.get_scaling(m), gm.get_rotation(m),
                            camera, rc, shs=gm.get_shs(m), sh_degree=pipe.cfg.map.sh_degree,
                            active_mask=m.active)
        G_s, _, tl, counts, b, d, n, *_ = rz._prepare_windowed(pre, m.obj_dc, tiles_x,
                                                               tiles_y, rc)
    acc, T = win.composite_windowed(G_s, tl, counts, b, d, n, rc.tile, tiles_x, **kw)
    g = torch.Generator(device=device).manual_seed(2)
    d_acc = torch.randn(acc.shape, generator=g, device=device)
    d_T = torch.randn(T.shape, generator=g, device=device)
    bargs = (G_s, tl, counts, b, d, n, d_acc, d_T, T, rc.tile, tiles_x)
    dGt = win.composite_windowed_bwd(*bargs, **kw)
    dGt_p = win.composite_windowed_bwd_plain(*bargs, **kw)
    torch.cuda.synchronize()
    return {"rel_err": row_rel_err(dGt, dGt_p), "max_abs_err": float((dGt - dGt_p).abs().max()),
            "n_span": kw["n_span"], "chunk": kw["chunk"], "tile_capacity": rc.tile_capacity,
            "window_blocks": rc.window_blocks, "rows": int(G_s.shape[0]),
            "entries": int((tl >= 0).sum()),
            "ms": cuda_ms(lambda: win.composite_windowed_bwd(*bargs, **kw), 5)}


def eval_phase(device, pipe, frames, poses):
    """`SLAMPipeline.evaluate` of the loop's map at the estimated poses, in
    three render modes; each windowed compositor checked on one frame."""
    import dataclasses

    import numpy as np
    import torch

    from sags_tpu_torch.eval.metrics import psnr
    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.ops import rasterize as rz
    from sags_tpu_torch.ops import windowed as win
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
    m = pipe.state.map
    cam = cams[len(cams) // 2]
    tiles_x, tiles_y = -(-cam.width // 16), -(-cam.height // 16)
    checks = {}
    for mode in ("windowed_host", "windowed_kernel"):
        raster, derive = modes[mode]
        pipe.cfg = base_cfg.replace(raster=raster)
        try:
            rc = pipe.eval_config(derive).raster
        finally:
            pipe.cfg = base_cfg
        kw = dict(alpha_min=rc.alpha_min, t_min=rc.transmittance_min,
                  chunk=rz._windowed_chunk(rc),
                  n_span=int(round(rc.max_tiles_per_gaussian ** 0.5)))
        with torch.no_grad():
            pre = rz.preprocess(m.xyz, gm.get_opacity(m), gm.get_scaling(m),
                                gm.get_rotation(m), cam, rc, shs=gm.get_shs(m),
                                sh_degree=base_cfg.map.sh_degree, active_mask=m.active)
            if mode == "windowed_host":
                G_s, _, tl, counts, b, d, n, *_ = rz._prepare_windowed(
                    pre, m.obj_dc, tiles_x, tiles_y, rc)
                got = win.composite_windowed(G_s, tl, counts, b, d, n, 16, tiles_x, **kw)
                want = win.composite_windowed_plain(G_s, tl, counts, b, d, n, 16, tiles_x,
                                                    **kw)
            else:
                G_s, b, d, n, ss, se, *_ = rz._prepare_windowed(
                    pre, m.obj_dc, tiles_x, tiles_y, rc, build_table=False)
                skw = dict(kw, w_blocks=rc.window_blocks, k_tile=rc.tile_capacity)
                got = win.composite_windowed_sorted(G_s, b, d, n, ss, se, 16, tiles_x, **skw)
                want = win.composite_windowed_sorted_plain(G_s, b, d, n, ss, se, 16,
                                                           tiles_x, **skw)
                assert torch.equal(got[2], want[2]), "eval frame: nv disagrees"
        torch.cuda.synchronize()
        err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"{mode} eval frame: {err} from the plain version"
        checks[mode] = err
    emit({"phase": "eval", "every": EVAL_EVERY, "modes": results,
          "frame_check_max_abs_err": checks})
    return results


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
    wres = windowed_kernel_phase(device)
    launches, pipe, frames, poses, classic = slam_phase(device)
    K_final = pipe.cfg.raster.tile_capacity
    if K_final not in kres:
        kres.update(kernel_phase(device, capacities=(K_final,)))
    eres = eval_phase(device, pipe, frames, poses)
    n_frames = len(frames)
    wlaunches, n_wframes = slam_windowed_phase(device, frames, dict(classic, poses=poses))

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
                           "sags_tpu/ops/pallas_sort.py:89", "sags_sort_blocks")}
    path_of = {"fill_table": "slam", "composite_fused": "slam",
               "composite_fused_bwd": "slam", "composite_windowed": "windowed_host",
               "composite_windowed_bwd": "slam_windowed",
               "composite_windowed_sorted": "windowed_kernel",
               # its network runs inside composite_windowed_sorted; the
               # standalone kernel is the block sort's harness
               "sort_blocks": "windowed_kernel"}
    kernels = []
    for name, (path, replaces, sym) in src.items():
        r = kres[K_final][name] if name in kres[K_final] else wres[name]
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
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r.get("library_ms"),
        })
    emit({"tile_capacity": K_final,
          "by_tile_capacity": {K: {n: {"ms": kres[K][n]["ms"], "plain_ms": kres[K][n]["plain_ms"]}
                                   for n in ("fill_table", "composite_fused",
                                             "composite_fused_bwd")} for K in kres},
          "scatter_ms": {K: kres[K]["scatter_ms"] for K in kres},
          "kept_pairs": {K: kres[K]["kept_pairs"] for K in kres},
          "live_pixel_pairs": {K: kres[K]["live_pixel_pairs"] for K in kres},
          "windowed": {k: v for k, v in wres.items() if not isinstance(v, dict)},
          "ms_per_eval_render": {m: e["ms_per_eval_render"] for m, e in eres.items()}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
