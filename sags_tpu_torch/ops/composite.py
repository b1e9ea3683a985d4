"""Fused per-tile alpha compositing, forward and backward: CUDA kernels
`csrc/composite_fused.cu` / `csrc/composite_fused_bwd.cu` and their plain
PyTorch versions (the forward kernel's strip cull among them), plus the
deterministic scatter of per-pair gradients.

Port of `sags_tpu/ops/pallas_composite.py` (`composite_fused`,
`composite_fused_bwd`). Both take the packed rows `G` [P, 32] (header mx, my,
ca, cb, cc, op, pad, pad; 24 feature rows), the tile table [NT, K] and the
per-tile counts, and gather the rows themselves, so the [NT, 32, K] gather of
the TPU path is never materialised by the kernels. Compositing runs in chunks
of `chunk` pairs: a pixel whose T·(1−α) would fall under `t_min` is cut for
the rest of the chunk and resumes from the carried T in the next one — the
semantics of both the Pallas kernel and the XLA scan
(`rasterize._composite_core_xla`), whose chunk size the caller passes.
"""

from __future__ import annotations

import ctypes

import torch

from sags_tpu_torch.ops import binning
from sags_tpu_torch.ops._build import CudaKernel, stream_ptr

HDR = 8  # header rows (geometry); feature rows start here
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
FWD = CudaKernel("composite_fused.cu", "sags_composite_fused",
                 [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P, _P])
BWD = CudaKernel("composite_fused_bwd.cu", "sags_composite_fused_bwd",
                 [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P, _P, _P,
                  _P])
_KERNEL_CH = 32  # the kernels' row width: 16 obj channels (the SLAM feature set)
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block can use
_PAD_SEGMENT = 64  # rows per padding segment of the dG scatter
STRIP_PIXELS = 32  # a warp of `csrc/composite_fused.cu`: 16 x 2 pixels of a tile
# the strip cull's margin on the gate level, as in `csrc/composite_fused.cu`
CULL_REL = 1e-5
CULL_ABS = 1e-4


def tile_pixel_coords(num_tiles: int, tiles_x: int, tile: int,
                      tile_offset: int = 0, device=None):
    """Pixel-center coords [NT, tile²] of tiles tile_offset..+num_tiles."""
    ids = torch.arange(num_tiles, device=device) + int(tile_offset)
    base_x = ((ids % tiles_x) * tile)[:, None].to(torch.float32)
    base_y = ((ids // tiles_x) * tile)[:, None].to(torch.float32)
    lin = torch.arange(tile * tile, device=device)
    px = base_x + (lin % tile)[None, :].to(torch.float32)
    py = base_y + (lin // tile)[None, :].to(torch.float32)
    return px, py


def ewa_power(Gc, px, py):
    """Offsets and longhand EWA exponent [NT, PIX, k] of the rows Gc
    [NT, k, ≥5] at the pixels (px, py) [NT, PIX]."""
    dx = Gc[..., 0][:, None, :] - px[:, :, None]
    dy = Gc[..., 1][:, None, :] - py[:, :, None]
    ca = Gc[..., 2][:, None, :]
    cb = Gc[..., 3][:, None, :]
    cc = Gc[..., 4][:, None, :]
    return dx, dy, -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy


def _chunk_quants(Gc, vm, px, py, T_entry, alpha_min, t_min):
    """Per-(tile, pixel, pair) compositing quantities of one chunk."""
    dx, dy, power = ewa_power(Gc, px, py)
    raw = Gc[..., 5][:, None, :] * torch.exp(power)
    alpha = torch.clamp(raw, max=0.99)
    gate = (power <= 0.0) & (alpha >= alpha_min) & vm[:, None, :]
    a = torch.where(gate, alpha, torch.zeros_like(alpha))
    om = 1.0 - a
    cum = torch.cumprod(om, dim=-1)
    T_exc = T_entry[..., None] * torch.cat([torch.ones_like(cum[..., :1]),
                                            cum[..., :-1]], dim=-1)
    m = gate & (T_exc * om >= t_min)
    return dx, dy, raw, a, gate, om, T_exc, m


def _chunks(table, counts, chunk):
    K = table.shape[1]
    if K % chunk:
        raise ValueError(f"tile capacity {K} is not a multiple of chunk {chunk}")
    max_count = int(counts.max()) if counts.numel() else 0
    return [c0 for c0 in range(0, K, chunk) if c0 < max_count]


def composite_fused_plain(G, table, counts, tile, tiles_x, alpha_min=1.0 / 255.0,
                          t_min=1e-4, chunk=64, tile_offset=0):
    """Plain PyTorch compositor (`rasterize._composite_core_xla` semantics:
    a slot composites if it lies below its tile's count and holds an id, as
    the kernel reads a zero row, which fails the alpha gate, for id −1).
    Returns (acc [NT, tile², CF], T_final [NT, tile²])."""
    NT, K = table.shape
    CF = G.shape[1] - HDR
    px, py = tile_pixel_coords(NT, tiles_x, tile, tile_offset, G.device)
    T = torch.ones((NT, tile * tile), dtype=torch.float32, device=G.device)
    acc = torch.zeros((NT, tile * tile, CF), dtype=torch.float32, device=G.device)
    rank = torch.arange(K, device=G.device)
    for c0 in _chunks(table, counts, chunk):
        gid = table[:, c0:c0 + chunk]
        vm = (rank[None, c0:c0 + chunk] < counts[:, None]) & (gid >= 0)
        Gc = G[torch.clamp(gid, min=0).long()]
        _, _, _, a, _, om, T_exc, m = _chunk_quants(Gc, vm, px, py, T, alpha_min, t_min)
        w = torch.where(m, a * T_exc, torch.zeros_like(a))
        acc = acc + torch.einsum("tpk,tkc->tpc", w, Gc[..., HDR:])
        T = T * torch.prod(torch.where(m, om, torch.ones_like(om)), dim=-1)
    return acc, T


def strip_live(G, table, counts, tiles_x, tile_offset=0, alpha_min=1.0 / 255.0, tile=16):
    """The forward kernel's per-warp strip cull in plain PyTorch: bool
    [NT, strips, K], true where the warp of strip s (pixel rows 2s and 2s+1
    of a 16×16 tile) walks pair k of tile t. A pair is dropped only when the
    least value of its conic quadratic over the strip's pixel centres
    exceeds the alpha gate's level by a margin that covers the float32
    rounding of the kernel's exponent (relative to the magnitude of the
    quadratic's terms over the strip) and of exp and log (absolute), so no
    pixel of a dropped strip can gate the pair; a conic that is not convex
    along the strip's edges, and a NaN, keep it. Takes the kernel's float32
    operations in its order (`binning.box_qmin`, `binning.gate_level`)."""
    NT, K = table.shape
    dev = G.device
    below = torch.arange(K, device=dev)[None, :] < counts[:, None]
    hdr = torch.where((below & (table >= 0))[..., None],
                      G[torch.clamp(table, min=0).long(), :6],
                      torch.zeros((), device=dev))  # empty slots read zero rows
    rows_per = STRIP_PIXELS // tile
    ids = torch.arange(NT, device=dev) + int(tile_offset)
    bx = ((ids % tiles_x) * tile).to(torch.float32)[:, None, None]
    sy = ((ids // tiles_x) * tile)[:, None] + rows_per * torch.arange(tile // rows_per,
                                                                      device=dev)
    sy = sy.to(torch.float32)[:, :, None]
    mx, my, a, b, c, op = (hdr[..., i][:, None, :] for i in range(6))
    x0, x1 = bx - mx, (bx + (tile - 1.0)) - mx
    y0, y1 = sy - my, (sy + (rows_per - 1.0)) - my
    qmin = binning.box_qmin(a, b, c, x0, x1, y0, y1)
    X = torch.maximum(x0.abs(), x1.abs())
    Y = torch.maximum(y0.abs(), y1.abs())
    mag = a.abs() * X * X + 2.0 * b.abs() * X * Y + c.abs() * Y * Y
    level = binning.gate_level(op, alpha_min)
    bound = level + (CULL_REL * (mag + level) + CULL_ABS)
    drop = (a > 0.0) & (c > 0.0) & (qmin > bound)
    return ~drop & below[:, None, :]


def strip_gated(G, table, counts, tiles_x, tile_offset=0, alpha_min=1.0 / 255.0, tile=16,
                chunk=64):
    """What `strip_live` must never drop, from the gate itself: bool
    [NT, strips, K], true where some pixel of strip s of tile t passes the
    alpha gate of pair k (`_chunk_quants`, `chunk` pairs at a time)."""
    NT, K = table.shape
    px, py = tile_pixel_coords(NT, tiles_x, tile, tile_offset, G.device)
    rank = torch.arange(K, device=G.device)
    out = []
    for c0 in range(0, K, chunk):
        ids = table[:, c0:c0 + chunk]
        vm = (rank[None, c0:c0 + chunk] < counts[:, None]) & (ids >= 0)
        gate = _chunk_quants(G[torch.clamp(ids, min=0).long()], vm, px, py,
                             torch.ones_like(px), alpha_min, 0.0)[4]
        out.append(gate.reshape(NT, tile * tile // STRIP_PIXELS, STRIP_PIXELS, -1).any(dim=2))
    return torch.cat(out, dim=-1)


def composite_fused_bwd_plain(G, table, counts, d_acc, d_T, T_final, tile, tiles_x,
                              alpha_min=1.0 / 255.0, t_min=1e-4, chunk=64,
                              tile_offset=0, matrix_form=False):
    """Plain PyTorch backward (the Pallas `_bwd_kernel` math, vectorised over
    tiles). Returns dGt [NT, CH, K]. `matrix_form` sums over a tile's pixels
    as the CUDA kernel does (`pair_grads_matrix`): for the tests."""
    NT, K = table.shape
    CH = G.shape[1]
    px, py = tile_pixel_coords(NT, tiles_x, tile, tile_offset, G.device)
    rank = torch.arange(K, device=G.device)
    dGt = torch.zeros((NT, CH, K), dtype=torch.float32, device=G.device)
    chunks = _chunks(table, counts, chunk)

    def quants(c0, T_entry):
        gid = table[:, c0:c0 + chunk]
        vm = (rank[None, c0:c0 + chunk] < counts[:, None]) & (gid >= 0)
        Gc = G[torch.clamp(gid, min=0).long()]
        return (Gc,) + _chunk_quants(Gc, vm, px, py, T_entry, alpha_min, t_min)

    T = torch.ones((NT, tile * tile), dtype=torch.float32, device=G.device)
    entries = []
    for c0 in chunks:  # forward sweep: chunk-entry transmittances
        entries.append(T)
        om, m = quants(c0, T)[6::2]
        T = T * torch.prod(torch.where(m, om, torch.ones_like(om)), dim=-1)

    carry = T_final * d_T
    for c0, T_entry in reversed(list(zip(chunks, entries))):
        Gc, dx, dy, raw, a, gate, om, T_exc, m = quants(c0, T_entry)
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


def _pair_factors(Gc, raw, a, gate, om, T_exc, m, d_acc, carry):
    """One chunk's reverse sweep per (tile, pixel, pair) (the Pallas
    `_bwd_kernel` formula): the weight w = m·α·T_exc, dpow = ∂L/∂power
    (zero where the pair is not gated or α is clipped), and the chunk's total
    of w·s per pixel [NT, PIX], which the carry takes on."""
    zero = torch.zeros((), device=Gc.device)
    s = torch.einsum("tpc,tkc->tpk", d_acc, Gc[..., HDR:])
    w = torch.where(m, a * T_exc, zero)
    incl = torch.cumsum(w * s, dim=-1)
    tot = incl[..., -1:]
    B = tot - incl
    inv_om = 1.0 / om
    da = (torch.where(m, T_exc * s, zero)
          - torch.where(gate, inv_om, zero) * B
          - torch.where(m, inv_om, zero) * carry[..., None])
    live = gate & ~(raw >= 0.99)
    return w, torch.where(live, da * a, zero), tot[..., 0]


def pair_grads(Gc, dx, dy, raw, a, gate, om, T_exc, m, d_acc, carry):
    """One chunk's reverse sweep, shared by both compositors' backward:
    per-pair header gradients [NT, 6, k] (mx, my, ca, cb, cc, op), feature
    gradients [NT, CF, k], and the chunk's total of w·s per pixel."""
    w, dpow, tot = _pair_factors(Gc, raw, a, gate, om, T_exc, m, d_acc, carry)
    opac = Gc[..., 5][:, None, :]
    ca, cb, cc = (Gc[..., i][:, None, :] for i in (2, 3, 4))
    hdr = torch.stack([
        (dpow * (-(ca * dx + cb * dy))).sum(1),
        (dpow * (-(cc * dy + cb * dx))).sum(1),
        (dpow * (-0.5 * dx * dx)).sum(1),
        (dpow * (-dx * dy)).sum(1),
        (dpow * (-0.5 * dy * dy)).sum(1),
        (dpow / torch.clamp(opac, min=1e-12)).sum(1),
    ], dim=1)
    return hdr, torch.einsum("tpc,tpk->tck", d_acc, w), tot


def pair_grads_matrix(Gc, px, py, raw, a, gate, om, T_exc, m, d_acc, carry):
    """`pair_grads` with the sums over a tile's pixels as two float32 matrix
    products, the form `csrc/pair_grads.cuh` runs on the tensor cores:
    dfeats = wᵀ·dAcc, and six moments S = dpowᵀ·Φ with Φ = {1, u, v, u², uv,
    v²}, (u, v) the pixel's offset from the tile's centre. The geometry
    gradients follow per pair from S and the pair's centre relative to the
    same point (dx = mxc − u, dy = myc − v)."""
    w, dpow, tot = _pair_factors(Gc, raw, a, gate, om, T_exc, m, d_acc, carry)
    cx = 0.5 * (px.amin(dim=1) + px.amax(dim=1))
    cy = 0.5 * (py.amin(dim=1) + py.amax(dim=1))
    u, v = px - cx[:, None], py - cy[:, None]
    phi = torch.stack([torch.ones_like(u), u, v, u * u, u * v, v * v], dim=-1)
    S0, Su, Sv, Suu, Suv, Svv = torch.einsum("tpk,tpi->itk", dpow, phi)
    mxc, myc = Gc[..., 0] - cx[:, None], Gc[..., 1] - cy[:, None]
    ca, cb, cc, opac = (Gc[..., i] for i in (2, 3, 4, 5))
    sx, sy = mxc * S0 - Su, myc * S0 - Sv
    hdr = torch.stack([
        -(ca * sx + cb * sy),
        -(cc * sy + cb * sx),
        -0.5 * (mxc * (mxc * S0 - 2.0 * Su) + Suu),
        -(mxc * sy - myc * Su + Suv),
        -0.5 * (myc * (myc * S0 - 2.0 * Sv) + Svv),
        S0 / torch.clamp(opac, min=1e-12),
    ], dim=1)
    return hdr, torch.einsum("tpc,tpk->tck", d_acc, w), tot


def _check(G, table, counts, tile, *tensors):
    dev = G.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA compositor takes CUDA tensors, not {dev.type}")
    if G.dtype != torch.float32 or G.dim() != 2 or G.shape[1] != _KERNEL_CH:
        raise ValueError(f"composite kernels take float32 G [P, {_KERNEL_CH}]")
    if table.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("table and counts must be int32")
    if counts.shape != (table.shape[0],):
        raise ValueError("counts must be [NT]")
    if tile != 16:
        raise ValueError("the CUDA compositor runs 16x16 tiles (256 threads)")
    for x in (table, counts) + tensors:
        if x.device != dev:
            raise ValueError("all compositor inputs must be on one device")


def composite_fused(G, table, counts, tile, tiles_x, alpha_min=1.0 / 255.0,
                    t_min=1e-4, chunk=64, tile_offset=0):
    """Returns (acc [NT, tile², CF], T_final [NT, tile²]). CUDA tensors run
    the kernel; CPU tensors the plain version."""
    if G.device.type == "cpu":
        return composite_fused_plain(G, table, counts, tile, tiles_x, alpha_min,
                                     t_min, chunk, tile_offset)
    _check(G, table, counts, tile)
    G, table, counts = G.contiguous(), table.contiguous(), counts.contiguous()
    NT, K = table.shape
    PIX = tile * tile
    acc = torch.empty((NT, PIX, _KERNEL_CH - HDR), dtype=torch.float32, device=G.device)
    T = torch.empty((NT, PIX), dtype=torch.float32, device=G.device)
    FWD.launch(G.data_ptr(), table.data_ptr(), counts.data_ptr(), NT, K, tile,
               tiles_x, int(tile_offset), float(alpha_min), float(t_min),
               int(chunk), acc.data_ptr(), T.data_ptr(), stream_ptr(G.device))
    return acc, T


def composite_fused_bwd(G, table, counts, d_acc, d_T, T_final, tile, tiles_x,
                        alpha_min=1.0 / 255.0, t_min=1e-4, chunk=64,
                        tile_offset=0):
    """Returns dGt [NT, CH, K], the per-pair row gradients."""
    if G.device.type == "cpu":
        return composite_fused_bwd_plain(G, table, counts, d_acc, d_T, T_final,
                                         tile, tiles_x, alpha_min, t_min, chunk,
                                         tile_offset)
    _check(G, table, counts, tile, d_acc, d_T, T_final)
    NT, K = table.shape
    PIX = tile * tile
    if d_acc.shape != (NT, PIX, _KERNEL_CH - HDR) or d_T.shape != (NT, PIX) \
            or T_final.shape != (NT, PIX):
        raise ValueError("d_acc [NT, PIX, 24], d_T and T_final [NT, PIX] expected")
    smem = BWD.function("sags_composite_fused_bwd_smem", [_I, _I],
                        ctypes.c_size_t)(K, PIX)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"tile_capacity {K} needs {smem} B of shared memory")
    G, table, counts = G.contiguous(), table.contiguous(), counts.contiguous()
    d_acc, d_T, T_final = d_acc.contiguous(), d_T.contiguous(), T_final.contiguous()
    dGt = torch.empty((NT, _KERNEL_CH, K), dtype=torch.float32, device=G.device)
    BWD.launch(G.data_ptr(), table.data_ptr(), counts.data_ptr(), NT, K, tile,
               tiles_x, int(tile_offset), float(alpha_min), float(t_min),
               int(chunk), d_acc.data_ptr(), d_T.data_ptr(), T_final.data_ptr(),
               dGt.data_ptr(), stream_ptr(G.device))
    return dGt


def scatter_rows(dGt: torch.Tensor, table: torch.Tensor, num_rows: int) -> torch.Tensor:
    """dG [num_rows, CH] = Σ over table slots holding id g of dGt[t, :, k].

    Deterministic on every device: a stable sort by Gaussian id, then
    `segment_reduce`, which sums each id's contiguous run in a fixed order
    (no atomics, unlike `index_add_` on CUDA). Padding slots (-1) sort last
    and are cut into segments of at most `_PAD_SEGMENT` rows that are
    dropped: `segment_reduce` sums a segment serially, and one segment of
    all the padding (a third of the table at the slice's operating point)
    took it 40 ms on an H100. The lengths sum to the row count by
    construction, so the check that would sync the host is skipped; they
    are counted from the sorted ids by `searchsorted` (`bincount` reads its
    input's maximum on the host)."""
    NT, CH, K = dGt.shape
    flat = table.reshape(-1).long()
    gid = torch.where(flat >= 0, flat, torch.full_like(flat, num_rows))
    gid_s, order = torch.sort(gid, stable=True)
    rows = dGt.permute(0, 2, 1).reshape(-1, CH)[order]
    bounds = torch.searchsorted(gid_s, torch.arange(num_rows + 2, device=flat.device))
    lengths = bounds[1:] - bounds[:-1]
    n_pad_segments = -(-flat.numel() // _PAD_SEGMENT)
    pad = lengths[num_rows] - _PAD_SEGMENT * torch.arange(
        n_pad_segments, device=flat.device)
    lengths = torch.cat([lengths[:num_rows], torch.clamp(pad, 0, _PAD_SEGMENT)])
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                                unsafe=True)[:num_rows]
