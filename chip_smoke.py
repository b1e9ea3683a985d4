#!/usr/bin/env python3
"""The per-kernel table of the PyTorch + CUDA port (`sags_tpu_torch`) on one
NVIDIA card: each CUDA kernel timed alone against its bound and held against
its plain PyTorch version.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line):
  1. build the CUDA kernels from `sags_tpu_torch/csrc` (one nvcc per source,
     in parallel; the kernel sort's two phase-split variants too), print
     nvcc's register and spill report and the card's name and power limit;
  2. hold every kernel against its plain PyTorch version at the slice's
     shapes (640x512 → 1280 tiles, P = 2^18 Gaussians of a seeded random
     scene) and time each:
     - classic path, K = 512 and 1024: fill_table exactly (also on edge
       cases: counts of 0, below a vector, K and above K, every start
       residue mod 4, a segment ending at n_sorted), its time beside an
       empty kernel with its grid and torch.full of the same bytes,
       composite_fused to 1e-3 absolute, composite_fused_bwd to 2e-4
       relative per output row, and the scattered dG bitwise equal across
       two backward runs; the forward kernel's strip cull
       (`composite.strip_live`) drops no strip in which a pixel gates the
       pair, on that scene and on seeded scenes of large, thin, rotated
       splats centred off the image (4-8:1, where composite_fused is held
       to 1e-3 too, and 20-60:1, where the exponent's cancellation lets a
       few pixels in 10^5 differ); the share of (strip, pair) tests dropped
       is reported;
     - windowed path, K = 1024, windowed_chunk 512, R = 4, slice store on:
       composite_windowed and composite_windowed_sorted bitwise equal to
       their plain versions (nv exact), also on the thin-splat scenes under
       both EWA forms and the three feature tiers, composite_windowed_bwd
       to 2e-4 relative per output row with the scattered dG_s bitwise
       equal across two runs, each forward option (ewa_impl "quad",
       feature_precision "high" and "default", windowed_bf16) bitwise equal
       to its plain version and, against the float32 longhand render,
       different and within the JAX package's bars, sort_blocks on [1280,
       16, 128] random int32 (and on blocks of 2, 64, 256 and 8192 keys)
       exactly equal to torch.sort, and the kernel-sort compositor bitwise
       equal to the host-table one on every tile the 16-block window did
       not cut;
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
     - the GICP align (a kernel that replaces no TPU kernel) on a corridor
       scan pair at the stream's shape (4096 x 4096, ungated, the stream's
       GICP settings, from the identity): the same (outer, inner)
       iterations and convergence as its plain version (`lsq_align` on the
       card) and the pose within 2e-4 m at the farthest source point; its
       time beside the plain version's and its bound, the latency of its
       grid barriers (one a linearization and one a trial), with the
       nearest-neighbour pass's operations and bytes;
     - the preprocess kernel pair (a pair that replaces no TPU kernel) at the
       offline cell's 2^22 slots and at 2^20, on a seeded random scene at SH
       degree 0 with the densification probe: every output bit for bit the
       plain `preprocess`'s, every gradient within 1e-6 of its leaf's norm of
       autograd's through it; the forward's time and the pair's beside their
       byte bound and the plain version with its autograd backward.
The line before the last, `{"kernels": [...]}`, holds one row a kernel:
its `ms` and `library_ms`, device time from a CUDA graph of its launches
(`graph_ms`); its `stream_ms` and `plain_ms`, back-to-back launches from
Python (`cuda_ms`), which for a kernel of a few microseconds is the host's
launch rate; its bound (`bound_ms`, `bound_by`) and `max_abs_err` against
its plain version. Rows 1-3 are at tile capacity `TABLE_CAPACITY`. The last
stdout line is `{"ok": true, "device": {...}}`. Imports no JAX.
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
TABLE_CAPACITY = 1024  # the tile capacity of the table's rows 1-3


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
                 capacities=(512, TABLE_CAPACITY)):
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
    plain version stands in for a kernel."""

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


# the stream cells' scan-to-scan align: 4096 source and 4096 target points
GICP_SHAPE = (4096, 4096)
# float32 operations of one distance of the nearest-neighbour pass: the dot
# product (5), the norms' sum and the difference (2), the doubling (1) and
# the comparison (1)
NN_OPS = 9
# bytes of a point a linearization reads once: its position, mask and covariance
GICP_POINT_BYTES = 12 + 1 + 36


# slots of the preprocess kernel pair's cases: the offline cell's and a
# stream map's after two doublings
PREPROCESS_SIZES = (2 ** 22, 2 ** 20)
# bytes a slot the pair must move at SH degree 0 with the probe: the forward
# reads the centre, scales, quaternion, opacity, SH-0 (12 + 12 + 16 + 4 + 12),
# the active flag and the offset (1 + 8) and writes its 18 rows (72); the
# backward reads centre, scales, quaternion and SH-0 again (52) and 11 upstream
# gradients (44) and writes the centre's, scales', quaternion's, SH-0's and the
# offset's (60)
PREPROCESS_BYTES = 65 + 72 + 52 + 44 + 60
# float32 operations a slot of the pair, about, counted from the source (a
# division, square root or logarithm one each): the forward's ~335, of which
# the differentiable terms ~295 that the backward recomputes before its ~310
PREPROCESS_OPS = 940


def preprocess_phase(device, sizes=PREPROCESS_SIZES, width=SLICE_W, height=SLICE_H):
    """The preprocess kernel pair (`rasterize.preprocess_kernel`: a pair that
    replaces no TPU kernel) on a seeded random scene at SH degree 0 with 5%
    of the slots inactive and the densification probe, at each of `sizes`
    slots: every output bit for bit the plain `preprocess`'s on the card, and
    every input gradient within 1e-6 of the leaf's norm of autograd's through
    it (`max_abs_err`: the largest gap over its leaf's norm). Times: the
    forward alone (`fwd_ms`, a CUDA graph) and the pair, the forward and
    autograd's backward from given upstream gradients (`ms` from a CUDA graph,
    `stream_ms` from back-to-back launches), beside the byte bound and the
    plain version with its autograd backward (`plain_ms`). Returns each
    size's row."""
    import torch

    from sags_tpu_torch.core import sh as shlib
    from sags_tpu_torch.core.camera import make_camera
    from sags_tpu_torch.core.config import RasterizeConfig
    from sags_tpu_torch.ops import rasterize as rz

    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                      width, height, 2 * math.atan(width / (2 * 431.8)),
                      2 * math.atan(height / (2 * 431.8)))
    cfg = RasterizeConfig(max_tiles_per_gaussian=36, tile_capacity=1024)
    diff = ("mx", "my", "depth", "ca", "cb", "cc", "czx", "cyz", "color")
    results = {}
    for P in sizes:
        xyz, opac, scales, quats, colors, _ = random_scene(P, device, seed=P + 25)
        g = torch.Generator(device="cpu").manual_seed(P)
        active = (torch.rand(P, generator=g) > 0.05).to(device)
        shs = ((colors - 0.5) / shlib.C0)[:, :, None].contiguous()
        probe = torch.zeros((P, 2), device=device)
        leaves = [t.requires_grad_(True) for t in (xyz, scales, quats, shs, probe)]

        def run(fn):
            return fn(xyz, opac, scales, quats, cam, cfg, shs=shs, sh_degree=0,
                      active_mask=active, mean2d_offset=probe)

        got, want = run(rz.project), run(rz.preprocess)
        for name in rz.Preprocessed._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                f"the preprocess kernel's {name} differs from the plain version's at P = {P}"
        up = [torch.randn(getattr(want, k).shape, generator=g).to(device) for k in diff]

        def grads(o):
            return torch.autograd.grad([getattr(o, k) for k in diff], leaves, up)

        gap = max(float((a - b).abs().max()) / float(b.norm())
                  for a, b in zip(grads(got), grads(want)))
        assert gap <= 1e-6, f"the preprocess backward is {gap} of a leaf's norm off at P = {P}"
        del got, want

        def pair():
            return grads(run(rz.project))

        try:
            ms, graph_error = graph_ms(pair, reps=10, replays=3), None
        except RuntimeError as exc:
            ms, graph_error = None, str(exc).splitlines()[0]
        with torch.no_grad():
            fwd_ms = graph_ms(lambda: run(rz.project), reps=20, replays=3)
        n_bytes = PREPROCESS_BYTES * P
        r = {"ms": ms, "graph_error": graph_error, "stream_ms": cuda_ms(pair, 10),
             "fwd_ms": fwd_ms, "plain_ms": cuda_ms(lambda: grads(run(rz.preprocess)), 3),
             "bytes": n_bytes, "ops": PREPROCESS_OPS * P, "max_abs_err": gap,
             "bound_ms": n_bytes / PEAK_BYTES_S * 1e3}
        results[P] = r
        emit({"phase": "preprocess", "slots": P, "bitwise": True, **r})
    return results


def corridor_scans(seed: int, n_src: int, n_tgt: int, step: float = 0.075):
    """Two scans of a corridor (walls at x = ±2.5 m, the floor at y = -2 m,
    a wall across it at z = 11 m that fixes the motion along it, 30% of the
    world in 12 blobs), each in its sensor's frame: the source
    `step` metres on and 0.02 rad of yaw from the target's pose, as the
    stream's frames are. Returns (source [n_src,3], target [n_tgt,3])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = 65536
    wall = rng.integers(0, 4, n)
    t = rng.uniform(0, 20, n)
    h = rng.uniform(-2, 2, n)
    u = rng.uniform(-2.5, 2.5, n)
    world = np.stack([np.where(wall == 0, -2.5, np.where(wall == 1, 2.5, np.where(wall == 2, h, u))),
                      np.where(wall == 2, -2.0, h * 0.8), np.where(wall == 3, 11.0, t)], -1)
    world += rng.normal(0, 0.03, world.shape)
    n_cl = int(0.3 * n)
    centers = rng.uniform([-2.0, -1.6, 0.5], [2.0, 1.6, 19.5], (12, 3))
    world[:n_cl] = centers[rng.integers(0, 12, n_cl)] + rng.normal(0, 0.15, (n_cl, 3))

    def scan(z, yaw, k):
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        rel = (world - np.array([0.0, 0.0, z])) @ R
        vis = np.nonzero((rel[:, 2] > 0.5) & (np.linalg.norm(rel, axis=-1) < 8.0))[0]
        return rel[rng.choice(vis, k, replace=False)].astype(np.float32)

    return scan(5.0 + step, 0.02, n_src), scan(5.0, 0.0, n_tgt)


def grid_sync_ms(device, n_src: int, syncs: int = 2000) -> float:
    """Device ms of one grid-wide barrier on the align's grid for `n_src`
    points: a cooperative kernel of `syncs` barriers and nothing else, less
    one of none, over `syncs`."""
    import ctypes

    from sags_tpu_torch.ops import gicp
    from sags_tpu_torch.ops._build import stream_ptr

    fn = gicp.ALIGN.function("sags_gicp_grid_sync_probe",
                             [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)

    def probe(k):
        code = fn(n_src, k, stream_ptr(device))
        if code != 0:
            raise RuntimeError(f"sags_gicp_grid_sync_probe failed ({code})")

    return (cuda_ms(lambda: probe(syncs), 5) - cuda_ms(lambda: probe(0), 5)) / syncs


def gicp_align_phase(device, shape=GICP_SHAPE, seed=0) -> dict:
    """`gicp_align`'s kernel (`gicp_align_kernel`) against its plain version
    (`gicp_align_plain`: `lsq_align` on the card) on `corridor_scans` at
    `shape` from the identity, with the stream's GICP settings: the same
    (outer, inner) iterations and convergence, and the pose within 2e-4 m at
    the farthest source point (`max_abs_err`, m); its time from a CUDA graph
    (None where the graph cannot capture the cooperative launch) and from
    back-to-back launches, the plain version's; the bound: the grid
    barriers' latency (`grid_sync_ms`) times the barriers (one a
    linearization and one a trial), beside the nearest-neighbour pass's
    operations and bytes (each input read once a linearization)."""
    import torch

    from sags_tpu_torch.core.config import GICPConfig
    from sags_tpu_torch.ops import gicp

    n_src, n_tgt = shape
    src, tgt = (torch.as_tensor(a, device=device) for a in corridor_scans(seed, n_src, n_tgt))
    cfg = GICPConfig()
    smask = torch.ones(n_src, dtype=torch.bool, device=device)
    tmask = torch.ones(n_tgt, dtype=torch.bool, device=device)
    cov = lambda p, m: gicp.estimate_covariances(p, m, cfg.k_correspondences,
                                                 cfg.knn_max_distance, cfg.regularization).covs
    data = gicp.GICPData(src, smask, cov(src, smask), tgt, tmask, cov(tgt, tmask))
    T0 = torch.eye(4, device=device)
    got = gicp.gicp_align_kernel(data, T0, cfg)
    want = gicp.gicp_align_plain(data, T0, cfg)
    counts = (int(got.iterations), int(got.lm_iterations), bool(got.converged))
    assert counts == (want.iterations, want.lm_iterations, want.converged), \
        f"the align kernel's (outer, inner, converged) {counts} differ from its plain " \
        f"version's {(want.iterations, want.lm_iterations, want.converged)}"
    gap = float(torch.linalg.vector_norm((src @ got.T[:3, :3].T + got.T[:3, 3])
                                         - (src @ want.T[:3, :3].T + want.T[:3, 3]),
                                         dim=-1).max())
    assert gap <= 2e-4, f"the align kernel's pose is {gap} m from its plain version's"
    align = lambda: gicp.gicp_align_kernel(data, T0, cfg)
    try:
        ms = graph_ms(align, reps=20, replays=3)
    except RuntimeError as exc:
        ms, graph_error = None, str(exc).splitlines()[0]
    else:
        graph_error = None
    r = {"stream_ms": cuda_ms(align, 50),
         "plain_ms": cuda_ms(lambda: gicp.gicp_align_plain(data, T0, cfg), 3)}
    sync_ms = grid_sync_ms(device, n_src)
    ops = NN_OPS * n_src * n_tgt * counts[0]
    n_bytes = GICP_POINT_BYTES * (n_src + n_tgt) * counts[0]
    parts = {"grid barriers": sync_ms * (counts[0] + counts[1]),
             "operations": ops / PEAK_FP32_S * 1e3, "bytes": n_bytes / PEAK_BYTES_S * 1e3}
    by = max(parts, key=parts.get)
    r.update(ms=ms, graph_error=graph_error, ops=ops, bytes=n_bytes, bound_ms=parts[by],
             bound_by=by, bound_parts=parts, grid_sync_ms=sync_ms,
             grid=gicp._align_grid(n_src), max_abs_err=gap, iterations=counts[0],
             lm_iterations=counts[1], shape=list(shape))
    emit({"phase": "gicp_align", **r})
    return r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sags_tpu_torch import resolve_device
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.ops import binning, composite, gicp, rasterize, sort, windowed  # noqa: F401  (register kernels)

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
    gres = gicp_align_phase(device)
    pres = preprocess_phase(device)

    # (source, TPU kernel) of each row, in the table's order
    src = {"fill_table": ("sags_tpu_torch/csrc/fill_table.cu",
                          "sags_tpu/ops/pallas_binning.py:75"),
           "composite_fused": ("sags_tpu_torch/csrc/composite_fused.cu",
                               "sags_tpu/ops/pallas_composite.py:119"),
           "composite_fused_bwd": ("sags_tpu_torch/csrc/composite_fused_bwd.cu",
                                   "sags_tpu/ops/pallas_composite.py:318"),
           "composite_windowed": ("sags_tpu_torch/csrc/composite_windowed.cu",
                                  "sags_tpu/ops/pallas_windowed.py:568"),
           "composite_windowed_bwd": ("sags_tpu_torch/csrc/composite_windowed_bwd.cu",
                                      "sags_tpu/ops/pallas_windowed.py:489"),
           "composite_windowed_sorted": ("sags_tpu_torch/csrc/composite_windowed_sorted.cu",
                                         "sags_tpu/ops/pallas_windowed.py:828"),
           "sort_blocks": ("sags_tpu_torch/csrc/sort_blocks.cu",
                           "sags_tpu/ops/pallas_sort.py:89"),
           # replaces no TPU kernel: the JAX package leaves it to XLA
           "expand_pairs": ("sags_tpu_torch/csrc/expand_pairs.cu", None),
           # replaces no TPU kernel: the JAX package leaves the LM loop to XLA
           "gicp_align": ("sags_tpu_torch/csrc/gicp_align.cu", None),
           # replaces no TPU kernel: the JAX package leaves preprocess to XLA
           "preprocess": ("sags_tpu_torch/csrc/preprocess.cu", None)}
    rows = dict(kres[TABLE_CAPACITY], **wres, expand_pairs=xres[EXPAND_CASES[0]],
                gicp_align=gres, preprocess=pres[PREPROCESS_SIZES[0]])
    kernels = []
    for name, (path, replaces) in src.items():
        r = rows[name]
        t_bytes = r["bytes"] / PEAK_BYTES_S * 1e3
        t_ops = r["ops"] / PEAK_FP32_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": path, "replaces": replaces,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "stream_ms": r["stream_ms"], "plain_ms": r["plain_ms"],
            # the align's bound is its grid barriers' latency (`gicp_align_phase`)
            "bound_ms": r["bound_ms"] if "bound_by" in r else max(t_bytes, t_ops),
            "bound_by": r.get("bound_by", "bytes" if t_bytes >= t_ops else "operations"),
            "library_ms": r.get("library_ms"),
            **({"empty_kernel_ms": r["empty_ms"], "torch_full_ms": r["full_ms"]}
               if name == "fill_table" else {}),
        })
    emit({"tile_capacity": TABLE_CAPACITY,
          "by_tile_capacity": {K: {n: {"ms": kres[K][n]["ms"], "plain_ms": kres[K][n]["plain_ms"]}
                                   for n in ("fill_table", "composite_fused",
                                             "composite_fused_bwd")} for K in kres},
          "scatter_ms": {K: kres[K]["scatter_ms"] for K in kres},
          "kept_pairs": {K: kres[K]["kept_pairs"] for K in kres},
          "live_pixel_pairs": {K: kres[K]["live_pixel_pairs"] for K in kres},
          "strip_cull": dict({K: kres[K]["strip_cull"] for K in kres}, **thin),
          "windowed": {k: v for k, v in wres.items() if not isinstance(v, dict)},
          "expand_pairs": {f"{P}x{mt}": r for (P, mt), r in xres.items()},
          "preprocess": pres})
    emit({"composite_windowed_sorted_phases": wres["composite_windowed_sorted"]["phases"],
          "strip_cull_dropped_share": {
              "kernel_cell": {k: wres[k]["strip_cull"]["dropped_share"]
                              for k in ("composite_windowed", "composite_windowed_sorted")},
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
