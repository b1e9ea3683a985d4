"""The classic rasterizer's binning kernels, each with its plain PyTorch
version: the pair expansion (`csrc/expand_pairs.cu`) and the per-tile work
table fill (`csrc/fill_table.cu`); and the exact alpha cull that decides
which (Gaussian, tile) pairs are binned at all.

`fill_table` ports `sags_tpu/ops/pallas_binning.py:fill_table`. After the
(tile, depth) sort each tile's Gaussian ids form a contiguous segment of the
sorted list; row t of the table is that segment cut at `capacity`, padded
with -1. `expand_pairs` replaces no TPU kernel (the JAX package leaves the
expansion to XLA): it makes the (tile, depth, id) keys that sort.
"""

from __future__ import annotations

import ctypes

import torch

from sags_tpu_torch.ops._build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = CudaKernel("fill_table.cu", "sags_fill_table",
                    [_P, _I, _P, _I, _I, _P, _P])
EXPAND = CudaKernel("expand_pairs.cu", "sags_expand_pairs",
                    [_P] * 12 + [_I, _I, _I, _I, _F, _F, _P, _P, _P])


def box_qmin(a, b, c_, x0, x1, y0, y1):
    """Exact minimum of the conic quadratic a·x² + 2b·x·y + c·y² over the box
    [x0, x1] × [y0, y1] of offsets from the conic's centre.

    Every step is one rounded float32 operation in a fixed order, which
    `csrc/qmin.cuh` repeats with `__f*_rn` intrinsics."""
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    a_s = torch.clamp(a, min=1e-12)
    c_s = torch.clamp(c_, min=1e-12)

    def q_edge_x(xf):
        dy = torch.minimum(torch.maximum(-b * xf / c_s, y0), y1)
        return a * xf * xf + 2.0 * b * xf * dy + c_ * dy * dy

    def q_edge_y(yf):
        dx = torch.minimum(torch.maximum(-b * yf / a_s, x0), x1)
        return a * dx * dx + 2.0 * b * dx * yf + c_ * yf * yf

    qmin = torch.minimum(torch.minimum(q_edge_x(x0), q_edge_x(x1)),
                         torch.minimum(q_edge_y(y0), q_edge_y(y1)))
    return torch.where(inside, torch.zeros_like(qmin), qmin)


def tile_qmin(a, b, c_, mx, my, tx, ty, T):
    """Exact minimum of the conic quadratic over a tile's pixel box, with
    `box_qmin`'s fixed order of float32 operations: the in-kernel depth sort
    (`csrc/composite_windowed_sorted.cu`) must bin exactly the pairs the
    host sort bins."""
    return box_qmin(a, b, c_, tx * T - mx, tx * T + (T - 1.0) - mx,
                    ty * T - my, ty * T + (T - 1.0) - my)


def gate_level(opacities: torch.Tensor, alpha_min: float) -> torch.Tensor:
    """The alpha gate's level in conic-q units, before any margin:
    max(2·ln(op / α_min), 0); q above it means alpha < α_min. The divisor is
    a tensor: PyTorch divides a CUDA tensor by a Python scalar as a product
    with its reciprocal, one rounding away from the quotient."""
    op = opacities.detach()
    am = torch.full((), alpha_min, dtype=op.dtype, device=op.device)
    return torch.clamp(2.0 * torch.log(torch.clamp(op / am, min=1e-12)), min=0.0)


def cull_c2(opacities: torch.Tensor, alpha_min: float) -> torch.Tensor:
    """Alpha-gate level in conic-q units, with the binning's margin:
    q > c² ⟺ alpha < α_min."""
    return gate_level(opacities, alpha_min) * (1.0 + 1e-5) + 1e-6


def offset_window(max_tiles: int) -> int:
    """R of the R×R tile-offset window of `max_tiles` = R² offsets."""
    R = int(round(max_tiles ** 0.5))
    if R * R != max_tiles:
        raise ValueError("max_tiles_per_gaussian must be a perfect square")
    return R


def expand_pairs_plain(pre, dq: torch.Tensor, tiles_x: int, tiles_y: int, cfg):
    """The same function in plain PyTorch: a loop over the R×R offsets, the
    live keys kept in the loop's order (offset-major), so `keys` is exactly
    `n_live` long."""
    P = pre.mx.shape[0]
    dev = pre.mx.device
    MT = cfg.max_tiles_per_gaussian
    R = offset_window(MT)

    rect_w = pre.rmax_x - pre.rmin_x
    rect_h = pre.rmax_y - pre.rmin_y
    n_rect = rect_w * rect_h
    covered = torch.clamp(rect_w, max=R) * torch.clamp(rect_h, max=R)
    overflow_rect = torch.sum(torch.where(pre.valid, n_rect - covered,
                                          torch.zeros_like(n_rect))).to(torch.int32)

    T = float(cfg.tile)
    mx, my = pre.mx.detach(), pre.my.detach()
    qa, qb, qc = pre.ca.detach(), pre.cb.detach(), pre.cc.detach()
    c2 = cull_c2(pre.opacity, cfg.alpha_min)
    keys, live = [], []
    for j in range(MT):
        dx_j, dy_j = j % R, j // R
        ok = pre.valid & (dx_j < rect_w) & (dy_j < rect_h)
        tx = pre.rmin_x + dx_j
        ty = pre.rmin_y + dy_j
        live.append(ok & (tile_qmin(qa, qb, qc, mx, my, tx, ty, T) <= c2))
        keys.append(((ty * tiles_x + tx) << 16) | dq)
    key = torch.stack(keys, 0).reshape(-1).to(torch.int64)
    gid = torch.arange(P, device=dev, dtype=torch.int64).repeat(MT)
    live = torch.stack(live, 0).reshape(-1)
    keys = ((key << 32) | gid)[live]
    return keys, torch.sum(live, dtype=torch.int32), overflow_rect


def expand_pairs(pre, dq: torch.Tensor, tiles_x: int, tiles_y: int, cfg):
    """The classic binning's pairs over the static R×R tile-offset window
    (R² = `cfg.max_tiles_per_gaussian`) of every slot of `pre` (a
    `rasterize.Preprocessed`), `dq` its int32 [P] depth keys.

    Returns (keys int64, n_live int32 [], overflow_rect int32 []): the pair
    (slot g, offset j) is live when slot g is valid, tile = its rect's corner
    + (j % R, j // R) lies in its rect, and the slot's conic passes the alpha
    gate somewhere on the tile (`tile_qmin` ≤ `cull_c2`); `keys[:n_live]`
    holds the key ((tile << 16 | dq[g]) << 32) | g of every live pair, once,
    in no set order on the card (the kernel writes an [R²·P] buffer densely
    from the front), in the loop's order on the CPU; overflow_rect counts the
    valid rects' tiles beyond the window."""
    R = offset_window(cfg.max_tiles_per_gaussian)
    NT = tiles_x * tiles_y
    if NT >= (1 << 15):
        raise ValueError("tile<<16 key packing supports up to 32767 tiles")
    cols = (pre.mx, pre.my, pre.ca, pre.cb, pre.cc, pre.opacity,
            pre.rmin_x, pre.rmin_y, pre.rmax_x, pre.rmax_y, pre.valid, dq)
    P = pre.mx.shape[0]
    if any(t.shape != (P,) for t in cols):
        raise ValueError("expand_pairs: every column must be [P]")
    if R * R * P >= (1 << 31):
        raise ValueError("expand_pairs: R²·P keys must fit an int32 count")
    want = [torch.float32] * 6 + [torch.int32] * 4 + [torch.bool, torch.int32]
    if [t.dtype for t in cols] != want:
        raise TypeError("expand_pairs: expected float32 centre, conic and opacity, "
                        "int32 rect and dq, bool valid")
    dev = pre.mx.device
    if any(t.device != dev for t in cols):
        raise ValueError("expand_pairs: every column must be on one device")
    if dev.type == "cpu":
        return expand_pairs_plain(pre, dq, tiles_x, tiles_y, cfg)
    if dev.type != "cuda":
        raise ValueError(f"expand_pairs: no kernel for device {dev}")
    cols = [t.detach().contiguous() for t in cols]
    keys = torch.empty(R * R * P, dtype=torch.int64, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)  # overflow_rect, n_live
    EXPAND.launch(*(t.data_ptr() for t in cols), P, R, tiles_x, NT, float(cfg.tile),
                  float(cfg.alpha_min), keys.data_ptr(), counters.data_ptr(),
                  stream_ptr(dev))
    return keys, counters[1], counters[0]


def fill_table_plain(gid_sorted: torch.Tensor, starts: torch.Tensor,
                     num_tiles: int, capacity: int) -> torch.Tensor:
    """The same function in plain PyTorch (one gather)."""
    starts = starts.to(torch.int64)
    cnt = torch.clamp(starts[1:num_tiles + 1] - starts[:num_tiles], max=capacity)
    k = torch.arange(capacity, device=gid_sorted.device)
    idx = starts[:num_tiles, None] + k[None, :]
    keep = k[None, :] < cnt[:, None]
    n = gid_sorted.shape[0]
    vals = gid_sorted[torch.clamp(idx, max=max(n - 1, 0))] if n else \
        torch.zeros(idx.shape, dtype=torch.int32, device=gid_sorted.device)
    return torch.where(keep, vals, torch.full_like(vals, -1)).to(torch.int32)


def fill_table(gid_sorted: torch.Tensor, starts: torch.Tensor, num_tiles: int,
               capacity: int) -> torch.Tensor:
    """Returns the [num_tiles, capacity] int32 table, -1-padded beyond each
    tile's count. `gid_sorted` int32 [N], `starts` int32 [num_tiles+1]."""
    if gid_sorted.device.type == "cpu":
        return fill_table_plain(gid_sorted, starts, num_tiles, capacity)
    if gid_sorted.device.type != "cuda" or starts.device != gid_sorted.device:
        raise ValueError("fill_table: both inputs must be on one CUDA device")
    if gid_sorted.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("fill_table: gid_sorted and starts must be int32")
    if starts.shape != (num_tiles + 1,) or gid_sorted.dim() != 1:
        raise ValueError("fill_table: expected gid_sorted [N], starts [NT+1]")
    if capacity % 4:
        raise ValueError("fill_table: the kernel stores 16-byte vectors; "
                         f"capacity {capacity} is not a multiple of 4")
    gid_sorted = gid_sorted.contiguous()
    starts = starts.contiguous()
    out = torch.empty((num_tiles, capacity), dtype=torch.int32,
                      device=gid_sorted.device)
    KERNEL.launch(gid_sorted.data_ptr(), gid_sorted.shape[0], starts.data_ptr(),
                  num_tiles, capacity, out.data_ptr(),
                  stream_ptr(gid_sorted.device))
    return out


def fill_table_floor(num_tiles: int, capacity: int, device) -> None:
    """Launch an empty kernel with `fill_table`'s grid: the launch-to-end
    floor its time is measured against. Counts no launch of `fill_table`."""
    fn = KERNEL.function("sags_fill_table_empty", [_I, _I, _P], ctypes.c_int)
    code = fn(num_tiles, capacity, stream_ptr(device))
    if code != 0:
        raise RuntimeError(f"sags_fill_table_empty failed ({code})")
