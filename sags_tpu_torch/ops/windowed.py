"""Windowed compositing: CUDA kernels `csrc/composite_windowed.cu`,
`csrc/composite_windowed_sorted.cu` and `csrc/composite_windowed_bwd.cu` and
their plain PyTorch versions.

Port of `sags_tpu/ops/pallas_windowed.py` (`composite_windowed`,
`composite_windowed_sorted`, `composite_windowed_bwd`). The packed rows are
sorted by (anchor tile, depth), where the anchor is the rect-min tile of a
Gaussian's R×R binning window, so every row that can touch tile t lies in R
contiguous spans of the sorted store `G_s` (one per anchor tile row). Span j of tile t covers the
128-row blocks `bases[j] .. bases[j] + nblks[j] - 1` and is numbered
`dests[j]·128 ..` in the tile's window: the per-tile work list holds
window-local ids, and id `i` with `dests[j]·128 <= i < (dests[j] +
nblks[j])·128` is global row `bases[j]·128 + i - dests[j]·128`.

The TPU kernels copy each tile's window into VMEM (14 blocks of 32×128
floats at the default budget, more than a Hopper block's 227 KB of shared
memory). The port does not: it resolves each id through the ≤ R spans and
gathers the row straight from `G_s`, as `composite_fused` gathers its rows.
`G_s` stays row-major [P_all, 40]; the kernels read its first 32 columns
(geometry and features) and, for the in-kernel sort, the rect and depth
columns below.

Two sources for the depth-ordered work list:
  * the host pair sort and table (`composite_windowed`);
  * the kernel itself (`composite_windowed_sorted`): per window slot,
    validity (in its span, the tile inside the row's rect, the exact
    conic-q minimum under the alpha-gate level) and a `(dq << 11) | slot`
    key; the valid keys are bitonic-sorted per tile (the kernel sorts only
    those, `compacted_sort_plain`); the first `k_tile` composite, and `nv`
    counts the valid slots before that cut.
Compositing runs in chunks of `chunk` pairs (`windowed_chunk`): a pixel cut
by T·(1−α) < t_min stays cut to the end of its chunk. Empty slots (id −1)
read as zero rows and fail the alpha gate. Both forward kernels walk, per
warp of 16×2 pixels, only the entries their strip cull keeps
(`strip_live`), which changes no bit.

The forward compositors take the TPU kernels' options: `ewa_impl` ("vpu"
longhand, "quad" the six-monomial expansion on tile-local coordinates),
`feat_prec` ("highest" float32, "high" the bf16×2 split, "default" one bf16
product) for the feature sums, and `bf16_obj` (`windowed_bf16`: the 16 obj
channels read as bf16 from columns 40..47). The alpha and transmittance
math is float32 in every variant. The backward (`composite_windowed_bwd`)
is the TPU kernel's exact reverse sweep at full precision, longhand, with
the transmittance in log space inside a chunk.

`scan_impl` and `window_prefetch` are TPU formulations of the same
arithmetic (the JAX package documents them as bit-exact) and have no
counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from sags_tpu_torch.ops._build import CudaKernel, stream_ptr
from sags_tpu_torch.ops.binning import box_qmin, cull_c2, gate_level, tile_qmin
from sags_tpu_torch.ops.composite import (CULL_ABS, CULL_REL, STRIP_PIXELS, ewa_power,
                                          pair_grads, pair_grads_matrix, tile_pixel_coords)
from sags_tpu_torch.ops.sort import sort_blocks_network_plain

HDR = 8  # header rows (geometry); feature rows start here
OBJ0, N_OBJ = HDR + 3, 16  # the obj channels among the feature columns
# Packed-row extra columns of the windowed path (columns 32..39 of the
# 40-wide layout; columns 0..31 are `rasterize._pack_gaussians`'s).
COL_RMIN_X = 32
COL_RMIN_Y = 33
COL_RECT_W = 34
COL_RECT_H = 35
COL_DQ = 36
COL_RCULL2 = 37  # exact alpha-cull radius² (rasterize.preprocess)
COL_STORE = 38  # 1.0 marks a slice-store copy row (rasterize._prepare_windowed)
WIDE_CH = 40
COL_OBJ_BF16 = 40  # windowed_bf16: columns 40..47 pack the obj channels as bf16
BF16_CH = 48
KERNEL_CH = 32  # columns the compositors read: 8 header + 24 features

SORT_ROWS = 16  # in-kernel sort extent: 16×128 = 2048 window slots
IDX_BITS = 11  # low key bits carry the window slot
IDX_MASK = (1 << IDX_BITS) - 1
KEY_INVALID = 0x7FFFFFFF
MAX_SPAN = 8  # R ≤ 8: max_tiles_per_gaussian ≤ 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
WINDOWED = CudaKernel(
    "composite_windowed.cu", "sags_composite_windowed",
    [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I,
     _P, _P, _P])
SORTED = CudaKernel(
    "composite_windowed_sorted.cu", "sags_composite_windowed_sorted",
    [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
     _I, _P, _P, _P, _P])
BWD = CudaKernel(
    "composite_windowed_bwd.cu", "sags_composite_windowed_bwd",
    [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P, _P,
     _P, _P])
EWA = {"vpu": 0, "quad": 1}
PREC = {"highest": 0, "high": 1, "default": 2}
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block can use


def window_rows(ids: torch.Tensor, bases, dests, nblks, n_span: int) -> torch.Tensor:
    """Window-local ids [NT, K] → global rows of `G_s` (−1 where the id is
    −1 or lies in no span)."""
    NT = ids.shape[0]
    lid = ids.reshape(NT, -1).to(torch.int64)
    blk = torch.div(lid, 128, rounding_mode="floor")
    b2, d2, n2 = (x.reshape(NT, n_span).to(torch.int64) for x in (bases, dests, nblks))
    rows = torch.full_like(lid, -1)
    for j in range(n_span):
        d, n = d2[:, j:j + 1], n2[:, j:j + 1]
        hit = (lid >= 0) & (blk >= d) & (blk < d + n)
        rows = torch.where(hit, b2[:, j:j + 1] * 128 + lid - d * 128, rows)
    return rows


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → bfloat16 (round to nearest even) → float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def unpack_obj_bf16(G_s: torch.Tensor) -> torch.Tensor:
    """The 16 obj channels of `windowed_bf16`'s columns 40..47 [P, 8]
    (bf16 pairs in float32 bits, lo = channel 2c) → float32 [P, 16]."""
    bits = G_s[:, COL_OBJ_BF16:COL_OBJ_BF16 + N_OBJ // 2].contiguous().view(torch.int32)
    lo = (bits & 0xFFFF) << 16
    hi = (bits >> 16) << 16  # the arithmetic shift's sign bits are shifted out
    return torch.stack([lo, hi], dim=-1).reshape(-1, N_OBJ).view(torch.float32)


def _feat_term(w, f, feat_prec, bf16_obj):
    """One work-list entry's addend w·f to acc [NT, PIX, 24] at the TPU
    kernel's `_feat_dot` precision, rounded as the CUDA kernel rounds it:
    w [NT, PIX], f [NT, 24]. With `bf16_obj` the obj channels (already bf16
    values) take bf16(w)."""
    w, f = w[..., None], f[:, None, :]
    if feat_prec == "highest" and not bf16_obj:
        return w * f
    wh = bf16_round(w)
    if feat_prec == "default":
        term = wh * bf16_round(f)
    elif feat_prec == "high":
        fh = bf16_round(f)
        term = wh * fh + wh * bf16_round(f - fh) + bf16_round(w - wh) * fh
    else:
        term = w * f
    if bf16_obj:
        o0, o1 = OBJ0 - HDR, OBJ0 - HDR + N_OBJ
        term = torch.cat([term[..., :o0], wh * f[..., o0:o1], term[..., o1:]], dim=-1)
    return term


def _quad_power(Gc, tile, bx, by):
    """`ewa_impl="quad"`: the EWA exponent from six monomials of the
    tile-local pixel coordinates, before the clamp (the kernel's order of
    float32 operations). Gc [NT, k, ≥6]; bx, by [NT] tile origins."""
    lin = torch.arange(tile * tile, device=Gc.device)
    u = (lin % tile).to(torch.float32)[None, :, None]
    v = (lin // tile).to(torch.float32)[None, :, None]
    A, B, C = Gc[..., 2][:, None, :], Gc[..., 3][:, None, :], Gc[..., 4][:, None, :]
    mx = (Gc[..., 0] - bx[:, None])[:, None, :]
    my = (Gc[..., 1] - by[:, None])[:, None, :]
    c0 = -0.5 * (A * mx * mx + C * my * my) - B * mx * my
    p = c0 + (A * mx + B * my) * u
    p = p + (C * my + B * mx) * v
    p = p + (-0.5 * A) * (u * u)
    p = p + (-B) * (u * v)
    return p + (-0.5 * C) * (v * v)


def _alpha_gate(Gc, px, py, tile, ewa_impl, alpha_min):
    """(alpha, gate) [NT, PIX, k] of the rows Gc [NT, k, ≥6] in the loop's
    float32 arithmetic: the longhand exponent, or under "quad" the six
    monomials with power ∈ (0, 0.01] counted as 0."""
    if ewa_impl == "quad":
        p = _quad_power(Gc, tile, px[:, 0], py[:, 0])
        alpha = torch.clamp(Gc[..., 5][:, None, :] * torch.exp(torch.clamp(p, max=0.0)),
                            max=0.99)
        power = torch.where(p <= 0.01, torch.clamp(p, max=0.0), p)
    else:
        power = ewa_power(Gc, px, py)[2]
        alpha = torch.clamp(Gc[..., 5][:, None, :] * torch.exp(power), max=0.99)
    return alpha, (power <= 0.0) & (alpha >= alpha_min)


def _gather(G, r):
    """Rows G[r] for r [NT, k] (−1 = empty: a zero row)."""
    return torch.where((r >= 0)[..., None], G[torch.clamp(r, min=0)],
                       torch.zeros((), device=G.device))


def _composite_rows_plain(G_s, rows, count_max: int, tile, tiles_x, alpha_min,
                          t_min, chunk, tile_offset, ewa_impl="vpu",
                          feat_prec="highest", bf16_obj=False):
    """Front-to-back compositing of the rows `rows` [NT, K] (−1 = empty) in
    chunks of `chunk`, over the entries below `count_max`. The alpha math is
    vectorised over a chunk; the transmittance and the feature sums advance
    one entry at a time, T ← T·(1−α) and acc ← acc + w·f, which are the CUDA
    kernel's float32 operations in its order: both give the same bits in
    every precision tier. Returns (acc [NT, tile², 24], T [NT, tile²])."""
    NT, K = rows.shape
    G = _loop_rows(G_s, bf16_obj)
    px, py = tile_pixel_coords(NT, tiles_x, tile, tile_offset, G.device)
    T = torch.ones((NT, tile * tile), dtype=torch.float32, device=G.device)
    acc = torch.zeros((NT, tile * tile, KERNEL_CH - HDR), dtype=torch.float32,
                      device=G.device)
    zero = torch.zeros((), device=G.device)
    for c0 in range(0, min(K, count_max), chunk):
        r = rows[:, c0:min(c0 + chunk, count_max)]  # later entries are all empty
        Gc = _gather(G, r)
        alpha, gate = _alpha_gate(Gc, px, py, tile, ewa_impl, alpha_min)
        om = 1.0 - alpha
        cut = torch.zeros_like(gate[..., 0])  # T·(1−α) < t_min: cut to the chunk's end
        for k in range(r.shape[1]):
            test = T * om[..., k]
            live = gate[..., k] & ~cut
            ok = live & (test >= t_min)
            cut = cut | (live & ~ok)
            w = torch.where(ok, alpha[..., k] * T, zero)
            acc = acc + _feat_term(w, Gc[:, k, HDR:], feat_prec, bf16_obj)
            T = torch.where(ok, test, T)
    return acc, T


def _loop_rows(G_s, bf16_obj=False):
    """The 32 columns the loop reads: header and features, under `bf16_obj`
    the obj channels from their packed bf16 columns."""
    G = G_s[:, :KERNEL_CH]
    if bf16_obj:
        G = torch.cat([G[:, :OBJ0], unpack_obj_bf16(G_s), G[:, OBJ0 + N_OBJ:]], dim=1)
    return G


def strip_live(G_s, rows, counts, tiles_x, tile_offset=0, alpha_min=1.0 / 255.0,
               ewa_impl="vpu"):
    """The windowed loop's per-warp strip cull in plain PyTorch: bool
    [NT, 8, K], true where the warp of strip s (pixel rows 2s, 2s+1 of a
    16×16 tile) walks entry k of tile t, whose global row is rows[t, k]
    (−1: a zero row). The test of `composite.strip_live` in the kernel's
    float32 operations, and an entry whose opacity is below `alpha_min`
    (an empty slot among them) dropped; under `ewa_impl="quad"` the margin
    is relative to the magnitude of the six monomials the loop sums
    (`csrc/windowed.cuh`, `strip_keeps`): 0.5·(|a|X² + 2|b|XY + |c|Y²) with
    X = |mx − bx| + 15, Y = |my − by| + 15 about the tile origin (bx, by)."""
    NT, K = rows.shape
    tile, dev = 16, G_s.device
    below = torch.arange(K, device=dev)[None, :] < counts[:, None]
    hdr = _gather(G_s[:, :6], torch.where(below, rows, -1))
    ids = torch.arange(NT, device=dev) + int(tile_offset)
    bx = ((ids % tiles_x) * tile).to(torch.float32)[:, None, None]
    by = ((ids // tiles_x) * tile).to(torch.float32)[:, None, None]
    rows_per = STRIP_PIXELS // tile
    sy = by + rows_per * torch.arange(tile // rows_per, device=dev).to(torch.float32)[:, None]
    mx, my, a, b, c, op = (hdr[..., i][:, None, :] for i in range(6))
    x0, x1 = bx - mx, (bx + (tile - 1.0)) - mx
    y0, y1 = sy - my, (sy + (rows_per - 1.0)) - my
    qmin = box_qmin(a, b, c, x0, x1, y0, y1)
    if ewa_impl == "quad":
        X = (mx - bx).abs() + (tile - 1.0)
        Y = (my - by).abs() + (tile - 1.0)
    else:
        X = torch.maximum(x0.abs(), x1.abs())
        Y = torch.maximum(y0.abs(), y1.abs())
    mag = a.abs() * X * X + 2.0 * b.abs() * X * Y + c.abs() * Y * Y
    level = gate_level(op, alpha_min)
    bound = level + (CULL_REL * (mag + level) + CULL_ABS)
    drop = ((a > 0.0) & (c > 0.0) & (qmin > bound)) | (op < alpha_min)
    return ~drop & below[:, None, :]


def strip_gated(G_s, rows, counts, tiles_x, tile_offset=0, alpha_min=1.0 / 255.0,
                ewa_impl="vpu", chunk=64):
    """What `strip_live` must never drop, from the loop's own gate: bool
    [NT, 8, K], true where some pixel of strip s of tile t passes the alpha
    gate of entry k below the tile's count (`_alpha_gate`, `chunk` entries
    at a time)."""
    NT, K = rows.shape
    tile = 16
    G = G_s[:, :6]
    px, py = tile_pixel_coords(NT, tiles_x, tile, tile_offset, G.device)
    below = torch.arange(K, device=G.device)[None, :] < counts[:, None]
    out = []
    for c0 in range(0, K, chunk):
        r = torch.where(below[:, c0:c0 + chunk], rows[:, c0:c0 + chunk], -1)
        gate = _alpha_gate(_gather(G, r), px, py, tile, ewa_impl, alpha_min)[1]
        out.append(gate.reshape(NT, tile * tile // STRIP_PIXELS, STRIP_PIXELS, -1).any(dim=2))
    return torch.cat(out, dim=-1)


def composite_windowed_plain(G_s, table_local, counts, bases, dests, nblks, tile,
                             tiles_x, alpha_min=1.0 / 255.0, t_min=1e-4, chunk=512,
                             n_span=4, tile_offset=0, ewa_impl="vpu",
                             feat_prec="highest", bf16_obj=False):
    """Plain PyTorch version of `composite_windowed`."""
    rows = window_rows(table_local, bases, dests, nblks, n_span)
    count_max = int(counts.max()) if counts.numel() else 0
    return _composite_rows_plain(G_s, rows, count_max, tile, tiles_x, alpha_min,
                                 t_min, chunk, tile_offset, ewa_impl, feat_prec, bf16_obj)


def composite_windowed_bwd_plain(G_s, table_local, counts, bases, dests, nblks, d_acc,
                                 d_T, T_final, tile, tiles_x, alpha_min=1.0 / 255.0,
                                 t_min=1e-4, chunk=512, n_span=4, tile_offset=0,
                                 matrix_form=False):
    """Plain PyTorch version of `composite_windowed_bwd` (the Pallas
    `_bwd_kernel` math, vectorised over tiles): transmittance in log space
    inside a chunk (T_exc = T_entry·exp(exclusive Σ log1p(−α)), the next
    chunk entered at T_entry·exp(Σ_m log1p(−α))), the reverse sweep of
    `composite.pair_grads`. Returns dGt [NT, 32, K] in table order.
    `matrix_form` sums over a tile's pixels as the CUDA kernel does
    (`composite.pair_grads_matrix`): for the tests."""
    rows = window_rows(table_local, bases, dests, nblks, n_span)
    NT, K = rows.shape
    G = G_s[:, :KERNEL_CH]
    px, py = tile_pixel_coords(NT, tiles_x, tile, tile_offset, G.device)
    dGt = torch.zeros((NT, KERNEL_CH, K), dtype=torch.float32, device=G.device)
    count_max = int(counts.max()) if counts.numel() else 0
    chunks = list(range(0, min(K, count_max), chunk))
    zero = torch.zeros((), device=G.device)

    def quants(c0, T_entry):
        r = rows[:, c0:c0 + chunk]
        Gc = torch.where((r >= 0)[..., None], G[torch.clamp(r, min=0)], zero)
        dx, dy, power = ewa_power(Gc, px, py)
        raw = Gc[..., 5][:, None, :] * torch.exp(power)
        alpha = torch.clamp(raw, max=0.99)
        gate = (power <= 0.0) & (alpha >= alpha_min)  # empty slots read zero rows
        a = torch.where(gate, alpha, zero)
        om = 1.0 - a
        log_om = torch.log1p(-a)
        T_exc = T_entry[..., None] * torch.exp(torch.cumsum(log_om, dim=-1) - log_om)
        m = gate & (T_exc * om >= t_min)
        return Gc, dx, dy, raw, a, gate, om, log_om, T_exc, m

    T = torch.ones((NT, tile * tile), dtype=torch.float32, device=G.device)
    entries = []
    for c0 in chunks:  # forward sweep: chunk-entry transmittances
        entries.append(T)
        *_, log_om, _, m = quants(c0, T)
        T = T * torch.exp(torch.where(m, log_om, zero).sum(dim=-1))

    carry = T_final * d_T
    for c0, T_entry in reversed(list(zip(chunks, entries))):
        Gc, dx, dy, raw, a, gate, om, _, T_exc, m = quants(c0, T_entry)
        if matrix_form:
            hdr, dfeats, tot = pair_grads_matrix(Gc, px, py, raw, a, gate, om, T_exc, m,
                                                 d_acc, carry)
        else:
            hdr, dfeats, tot = pair_grads(Gc, dx, dy, raw, a, gate, om, T_exc, m, d_acc,
                                          carry)
        k = Gc.shape[1]
        dGt[:, 0:6, c0:c0 + k] = hdr
        dGt[:, HDR:, c0:c0 + k] = dfeats
        carry = carry + tot
    return dGt


def _check(G_s, tile, n_span, *ints, width=WIDE_CH):
    dev = G_s.device
    if dev.type != "cuda":
        raise ValueError(f"the windowed compositors take CUDA tensors, not {dev.type}")
    if G_s.dtype != torch.float32 or G_s.dim() != 2 or G_s.shape[1] < width:
        raise ValueError(f"the windowed compositors take float32 G_s [P, >= {width}]")
    if tile != 16:
        raise ValueError("the windowed compositors run 16x16 tiles (256 threads)")
    if not 1 <= n_span <= MAX_SPAN:
        raise ValueError(f"n_span {n_span} outside 1..{MAX_SPAN}")
    for x in ints:
        if x.dtype != torch.int32 or x.device != dev:
            raise TypeError("the plan and table tensors must be int32 on G_s's device")


def composite_windowed(G_s, table_local, counts, bases, dests, nblks, tile, tiles_x,
                       alpha_min=1.0 / 255.0, t_min=1e-4, chunk=512, n_span=4,
                       tile_offset=0, ewa_impl="vpu", feat_prec="highest",
                       bf16_obj=False):
    """Composite each tile's window-local work list `table_local`
    [NT, K/128, 128] (−1 padded) over `counts` [NT] entries, resolving ids
    through the span plan (`bases`, `dests`, `nblks`, [NT·n_span] each).
    Returns (acc [NT, tile², 24], T_final [NT, tile²]). CUDA tensors run the
    kernel, CPU tensors the plain version."""
    if G_s.device.type == "cpu":
        return composite_windowed_plain(G_s, table_local, counts, bases, dests, nblks,
                                        tile, tiles_x, alpha_min, t_min, chunk, n_span,
                                        tile_offset, ewa_impl, feat_prec, bf16_obj)
    _check(G_s, tile, n_span, table_local, counts, bases, dests, nblks,
           width=BF16_CH if bf16_obj else WIDE_CH)
    NT = counts.shape[0]
    K = table_local.numel() // max(NT, 1)
    if table_local.numel() != NT * K or bases.numel() != NT * n_span:
        raise ValueError("table_local must be [NT, K/128, 128] and the plan [NT*n_span]")
    G_s, table_local = G_s.contiguous(), table_local.contiguous()
    counts, bases, dests, nblks = (x.contiguous() for x in (counts, bases, dests, nblks))
    PIX = tile * tile
    acc = torch.empty((NT, PIX, KERNEL_CH - HDR), dtype=torch.float32, device=G_s.device)
    T = torch.empty((NT, PIX), dtype=torch.float32, device=G_s.device)
    WINDOWED.launch(G_s.data_ptr(), G_s.shape[1], G_s.shape[0], table_local.data_ptr(),
                    counts.data_ptr(), bases.data_ptr(), dests.data_ptr(),
                    nblks.data_ptr(), n_span, NT, K, tile, tiles_x, int(tile_offset),
                    float(alpha_min), float(t_min), int(chunk), EWA[ewa_impl],
                    PREC[feat_prec], int(bool(bf16_obj)), acc.data_ptr(), T.data_ptr(),
                    stream_ptr(G_s.device))
    return acc, T


def composite_windowed_bwd(G_s, table_local, counts, bases, dests, nblks, d_acc, d_T,
                           T_final, tile, tiles_x, alpha_min=1.0 / 255.0, t_min=1e-4,
                           chunk=512, n_span=4, tile_offset=0):
    """Per-pair gradients of `composite_windowed` (longhand, full precision)
    given the cotangents `d_acc` [NT, tile², 24] and `d_T`, and the
    forward's `T_final` [NT, tile²]. Returns dGt [NT, 32, K] in table order
    (row 6-7 zero). CUDA tensors run the kernel, CPU tensors the plain
    version."""
    if G_s.device.type == "cpu":
        return composite_windowed_bwd_plain(G_s, table_local, counts, bases, dests, nblks,
                                            d_acc, d_T, T_final, tile, tiles_x, alpha_min,
                                            t_min, chunk, n_span, tile_offset)
    _check(G_s, tile, n_span, table_local, counts, bases, dests, nblks)
    NT = counts.shape[0]
    K = table_local.numel() // max(NT, 1)
    PIX = tile * tile
    if table_local.numel() != NT * K or bases.numel() != NT * n_span:
        raise ValueError("table_local must be [NT, K/128, 128] and the plan [NT*n_span]")
    if d_acc.shape != (NT, PIX, KERNEL_CH - HDR) or d_T.shape != (NT, PIX) \
            or T_final.shape != (NT, PIX):
        raise ValueError("d_acc [NT, PIX, 24], d_T and T_final [NT, PIX] expected")
    for x in (d_acc, d_T, T_final):
        if x.dtype != torch.float32 or x.device != G_s.device:
            raise TypeError("d_acc, d_T and T_final must be float32 on G_s's device")
    smem = BWD.function("sags_composite_windowed_bwd_smem", [_I, _I],
                        ctypes.c_size_t)(K, int(chunk))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"tile_capacity {K} needs {smem} B of shared memory")
    G_s, table_local = G_s.contiguous(), table_local.contiguous()
    counts, bases, dests, nblks = (x.contiguous() for x in (counts, bases, dests, nblks))
    d_acc, d_T, T_final = d_acc.contiguous(), d_T.contiguous(), T_final.contiguous()
    dGt = torch.empty((NT, KERNEL_CH, K), dtype=torch.float32, device=G_s.device)
    BWD.launch(G_s.data_ptr(), G_s.shape[1], G_s.shape[0], table_local.data_ptr(),
               counts.data_ptr(), bases.data_ptr(), dests.data_ptr(), nblks.data_ptr(),
               n_span, NT, K, tile, tiles_x, int(tile_offset), float(alpha_min),
               float(t_min), int(chunk), d_acc.data_ptr(), d_T.data_ptr(),
               T_final.data_ptr(), dGt.data_ptr(), stream_ptr(G_s.device))
    return dGt


def _sort_width(w_blocks: int) -> int:
    """Slots the in-kernel sort orders: w_blocks·128 rounded up to a power
    of two (the slots past the window hold invalid keys, which sort last)."""
    n = 128
    while n < w_blocks * 128:
        n *= 2
    return n


def window_keys_plain(G_s, bases, dests, nblks, sstarts, sends, tile, tiles_x,
                      alpha_min, n_span, w_blocks, tile_offset=0) -> torch.Tensor:
    """The in-kernel sort's keys [NT, w_blocks·128]: `(dq << 11) | slot`
    for a valid slot, `KEY_INVALID` otherwise."""
    NT = bases.numel() // n_span
    dev = G_s.device
    S = w_blocks * 128
    slot = torch.arange(S, device=dev, dtype=torch.int64)
    blk, lane = slot // 128, slot % 128
    b2, d2, n2, s2, e2 = (x.reshape(NT, n_span).to(torch.int64)
                          for x in (bases, dests, nblks, sstarts, sends))
    in_any = torch.zeros((NT, S), dtype=torch.bool, device=dev)
    base_b = torch.zeros((NT, S), dtype=torch.int64, device=dev)
    s_b = torch.zeros_like(base_b)
    e_b = torch.zeros_like(base_b)
    for j in range(n_span):
        d, n = d2[:, j:j + 1], n2[:, j:j + 1]
        hit = (d <= blk) & (blk < d + n)
        base_b = torch.where(hit, b2[:, j:j + 1] + (blk - d), base_b)
        s_b = torch.where(hit, s2[:, j:j + 1], s_b)
        e_b = torch.where(hit, e2[:, j:j + 1], e_b)
        in_any = in_any | hit
    grow = base_b * 128 + lane
    ok = in_any & (grow >= s_b) & (grow < e_b)
    row = G_s[torch.clamp(grow, 0, max(G_s.shape[0] - 1, 0))].detach()
    tg = torch.arange(NT, device=dev) + int(tile_offset)
    tx = (tg % tiles_x).to(torch.int32)[:, None]
    ty = (tg // tiles_x).to(torch.int32)[:, None]
    rx, ry, rw, rh, dq = (row[..., c].to(torch.int32) for c in
                          (COL_RMIN_X, COL_RMIN_Y, COL_RECT_W, COL_RECT_H, COL_DQ))
    ok = ok & (rx <= tx) & (tx < rx + rw) & (ry <= ty) & (ty < ry + rh)
    qmin = tile_qmin(row[..., 2], row[..., 3], row[..., 4], row[..., 0], row[..., 1],
                     tx, ty, float(tile))
    ok = ok & (qmin <= cull_c2(row[..., 5], alpha_min))
    key = (dq << IDX_BITS) | slot.to(torch.int32)
    return torch.where(ok, key, torch.full_like(key, KEY_INVALID))


def sorted_ids_plain(keys, k_tile: int):
    """Keys [NT, S] of the in-kernel sort → (the first `k_tile` window-local
    ids in key order [NT, k_tile], −1 past the valid ones; nv [NT] int32)."""
    NT, S = keys.shape
    nv = (keys != KEY_INVALID).sum(dim=1).to(torch.int32)
    order = torch.sort(keys, dim=1).values[:, :k_tile]
    if S < k_tile:
        order = torch.cat([order, torch.full((NT, k_tile - S), KEY_INVALID,
                                             dtype=order.dtype, device=order.device)], 1)
    return torch.where(order != KEY_INVALID, order & IDX_MASK, torch.full_like(order, -1)), nv


def compacted_sort_plain(keys, k_tile: int, appended=None):
    """`sorted_ids_plain` as the kernel's key phase computes it, for the
    tests: each tile's valid keys appended densely (in the order `appended`
    [NT, S], a permutation of the slots per tile, gives; the kernel's warps
    append in an order their atomics choose), padded with KEY_INVALID to the
    next power of two ≥ nv and sorted by the kernel's bitonic network
    (`sort.sort_blocks_network_plain`); the first min(nv, k_tile) keys are
    the ids."""
    NT, S = keys.shape
    ids = torch.full((NT, k_tile), -1, dtype=torch.int32, device=keys.device)
    nv = torch.zeros(NT, dtype=torch.int32, device=keys.device)
    for t in range(NT):
        row = keys[t] if appended is None else keys[t, appended[t]]
        valid = row[row != KEY_INVALID]
        n = 1
        while n < valid.numel():
            n *= 2
        padded = torch.full((n,), KEY_INVALID, dtype=keys.dtype, device=keys.device)
        padded[:valid.numel()] = valid
        got = sort_blocks_network_plain(padded.reshape(1, 1, n))[0, 0]
        m = min(valid.numel(), k_tile)
        ids[t, :m] = got[:m] & IDX_MASK
        nv[t] = valid.numel()
    return ids, nv


def composite_windowed_sorted_plain(G_s, bases, dests, nblks, sstarts, sends, tile,
                                    tiles_x, alpha_min=1.0 / 255.0, t_min=1e-4,
                                    chunk=512, n_span=4, w_blocks=12, k_tile=512,
                                    tile_offset=0, ewa_impl="vpu", feat_prec="highest"):
    """Plain PyTorch version of `composite_windowed_sorted`."""
    keys = window_keys_plain(G_s, bases, dests, nblks, sstarts, sends, tile, tiles_x,
                             alpha_min, n_span, w_blocks, tile_offset)
    ids, nv = sorted_ids_plain(keys, k_tile)
    rows = window_rows(ids, bases, dests, nblks, n_span)
    count_max = min(int(nv.max()), k_tile) if keys.shape[0] else 0
    acc, T = _composite_rows_plain(G_s, rows, count_max, tile, tiles_x, alpha_min,
                                   t_min, chunk, tile_offset, ewa_impl, feat_prec)
    return acc, T, nv


def composite_windowed_sorted(G_s, bases, dests, nblks, sstarts, sends, tile, tiles_x,
                              alpha_min=1.0 / 255.0, t_min=1e-4, chunk=512, n_span=4,
                              w_blocks=12, k_tile=512, tile_offset=0, ewa_impl="vpu",
                              feat_prec="highest"):
    """Forward-only windowed compositor with in-kernel depth ordering.
    `sstarts`/`sends` [NT·n_span] bound each span's rows. Returns (acc
    [NT, tile², 24], T_final [NT, tile²], nv [NT] int32: each tile's valid
    candidates before the `k_tile` cut)."""
    if not 1 <= w_blocks <= SORT_ROWS or k_tile > SORT_ROWS * 128:
        raise ValueError(f"w_blocks {w_blocks} and k_tile {k_tile} must fit the "
                         f"{SORT_ROWS * 128}-slot sort")
    if G_s.device.type == "cpu":
        return composite_windowed_sorted_plain(G_s, bases, dests, nblks, sstarts, sends,
                                               tile, tiles_x, alpha_min, t_min, chunk,
                                               n_span, w_blocks, k_tile, tile_offset,
                                               ewa_impl, feat_prec)
    _check(G_s, tile, n_span, bases, dests, nblks, sstarts, sends)
    NT = bases.numel() // n_span
    G_s = G_s.contiguous()
    bases, dests, nblks, sstarts, sends = (
        x.contiguous() for x in (bases, dests, nblks, sstarts, sends))
    PIX = tile * tile
    acc = torch.empty((NT, PIX, KERNEL_CH - HDR), dtype=torch.float32, device=G_s.device)
    T = torch.empty((NT, PIX), dtype=torch.float32, device=G_s.device)
    nv = torch.empty((NT,), dtype=torch.int32, device=G_s.device)
    SORTED.launch(G_s.data_ptr(), G_s.shape[1], G_s.shape[0], bases.data_ptr(),
                  dests.data_ptr(), nblks.data_ptr(), sstarts.data_ptr(),
                  sends.data_ptr(), n_span, NT, w_blocks, _sort_width(w_blocks),
                  int(k_tile), tile, tiles_x, int(tile_offset), float(alpha_min),
                  float(t_min), int(chunk), EWA[ewa_impl], PREC[feat_prec],
                  acc.data_ptr(), T.data_ptr(), nv.data_ptr(), stream_ptr(G_s.device))
    return acc, T, nv
