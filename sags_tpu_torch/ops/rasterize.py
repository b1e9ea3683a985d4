"""Differentiable tiled Gaussian rasterizer — the classic path of
`sags_tpu.ops.rasterize` in PyTorch.

Stages, as in the JAX package:
  1. `preprocess`: frustum cull, Σ3D from (scale, quat), EWA projection with
     the +0.3 px low-pass, conic, 3σ radius, the tight alpha-cull tile rect,
     SH degree-0 colour — longhand over [P] columns so the arithmetic order
     (and the 16-bit depth keys) match the JAX package.
  2. `bin_gaussians`: R×R offset-window pair expansion, one (tile<<16 | dq,
     gid) sort, `searchsorted` segment starts, then the table fill — the
     CUDA kernel `fill_table` (`ops/binning.py`).
  3. `composite`: the fused compositor forward and backward (CUDA kernels in
     `ops/composite.py`) under a `torch.autograd.Function`, the per-pair
     gradients scattered into dG deterministically.

The windowed render path (`ops/pallas_windowed.py` on the TPU) belongs to a
later slice of the port: asking for it raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from sags_tpu_torch.core import sh as shlib
from sags_tpu_torch.core.camera import Camera, ndc2pix
from sags_tpu_torch.core.config import RasterizeConfig
from sags_tpu_torch.core.transforms import quat_normalize
from sags_tpu_torch.ops import composite as comp
from sags_tpu_torch.ops.binning import fill_table

_G_HDR = comp.HDR


class Preprocessed(NamedTuple):
    mx: torch.Tensor
    my: torch.Tensor
    depth: torch.Tensor
    ca: torch.Tensor
    cb: torch.Tensor
    cc: torch.Tensor
    czx: torch.Tensor
    cyz: torch.Tensor
    opacity: torch.Tensor
    color: torch.Tensor  # [P,3]
    radius: torch.Tensor  # [P] int32
    rmin_x: torch.Tensor
    rmin_y: torch.Tensor
    rmax_x: torch.Tensor
    rmax_y: torch.Tensor
    valid: torch.Tensor
    clamped: torch.Tensor  # [P,3]
    rcull2: torch.Tensor


@dataclasses.dataclass
class RenderOutput:
    """The JAX `RenderOutput` fields. `is_used` is computed when first read:
    eager PyTorch has no dead-code elimination, and training never reads
    it."""

    color: torch.Tensor  # [3,H,W]
    depth: torch.Tensor  # [1,H,W]
    objects: torch.Tensor  # [O,H,W]
    alpha: torch.Tensor  # [1,H,W]
    final_T: torch.Tensor  # [H,W]
    radii: torch.Tensor  # [P] int32
    n_binned: torch.Tensor
    overflow_rect: torch.Tensor
    overflow_tile: torch.Tensor
    overflow_window: torch.Tensor
    overflow_big: torch.Tensor
    tile_peak: torch.Tensor
    overflow_tile_live: torch.Tensor
    _is_used_fn: object = dataclasses.field(default=None, repr=False)
    _is_used: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    @property
    def is_used(self) -> torch.Tensor:
        if self._is_used is None:
            self._is_used = self._is_used_fn()
        return self._is_used


# ---------------------------------------------------------------------------
# Stage 1: preprocess
# ---------------------------------------------------------------------------


def preprocess(means3d, opacities, scales, quats, camera: Camera,
               cfg: RasterizeConfig, colors=None, shs=None, sh_degree: int = 0,
               active_mask=None) -> Preprocessed:
    """Per-Gaussian projection (`sags_tpu.ops.rasterize.preprocess`)."""
    P = means3d.shape[0]
    W, H = camera.width, camera.height
    tiles_x = -(-W // cfg.tile)
    tiles_y = -(-H // cfg.tile)
    x, y, z = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    V = camera.world_view
    M = camera.full_proj

    tvx = V[0, 0] * x + V[0, 1] * y + V[0, 2] * z + V[0, 3]
    tvy = V[1, 0] * x + V[1, 1] * y + V[1, 2] * z + V[1, 3]
    depth = V[2, 0] * x + V[2, 1] * y + V[2, 2] * z + V[2, 3]
    in_front = depth > cfg.near

    hx = M[0, 0] * x + M[0, 1] * y + M[0, 2] * z + M[0, 3]
    hy = M[1, 0] * x + M[1, 1] * y + M[1, 2] * z + M[1, 3]
    hw = M[3, 0] * x + M[3, 1] * y + M[3, 2] * z + M[3, 3]
    inv_w = 1.0 / (hw + 1e-7)
    mean_x = ndc2pix(hx * inv_w, W)
    mean_y = ndc2pix(hy * inv_w, H)

    q = quat_normalize(quats)
    qx, qy, qz, qw = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    m = cfg.scale_modifier
    v0 = (scales[:, 0] * m) ** 2
    v1 = (scales[:, 1] * m) ** 2
    v2 = (scales[:, 2] * m) ** 2
    s00 = r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2
    s01 = r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2
    s02 = r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2
    s11 = r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2
    s12 = r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2
    s22 = r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2

    S = ((s00, s01, s02), (s01, s11, s12), (s02, s12, s22))
    Rv = [[V[i, k] for k in range(3)] for i in range(3)]
    A = [[sum(Rv[i][k] * S[k][j] for k in range(3)) for j in range(3)]
         for i in range(3)]

    def centry(i, j):
        return sum(A[i][k] * Rv[j][k] for k in range(3))

    C00, C01, C02 = centry(0, 0), centry(0, 1), centry(0, 2)
    C11, C12, C22 = centry(1, 1), centry(1, 2), centry(2, 2)

    fx, fy = camera.focal_x, camera.focal_y
    safe_z = torch.where(torch.abs(depth) < 1e-6, torch.full_like(depth, 1e-6), depth)
    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    txc = torch.clamp(tvx / safe_z, -lim_x, lim_x) * depth
    tyc = torch.clamp(tvy / safe_z, -lim_y, lim_y) * depth
    inv_z = 1.0 / safe_z
    j00 = fx * inv_z
    j02 = -fx * txc * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyc * inv_z * inv_z

    cxx = j00 * j00 * C00 + 2 * j00 * j02 * C02 + j02 * j02 * C22 + cfg.low_pass
    cyy = j11 * j11 * C11 + 2 * j11 * j12 * C12 + j12 * j12 * C22 + cfg.low_pass
    cxy = j00 * (j11 * C01 + j12 * C02) + j02 * (j11 * C12 + j12 * C22)
    czx = j00 * C02 + j02 * C22
    cyz = j11 * C12 + j12 * C22

    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    ca = cyy * inv_det
    cb = -cxy * inv_det
    cc = cxx * inv_det

    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))
    rcull2 = 2.0 * lam * torch.log(torch.clamp(opacities / cfg.alpha_min, min=1e-12))
    rcull2 = torch.clamp(rcull2, min=0.0)

    t = float(cfg.tile)

    def tile_bound(v, lo):
        return torch.clamp(torch.floor(v), 0, lo).to(torch.int32)

    if getattr(cfg, "tight_rect", True):
        c2 = rcull2 / torch.clamp(lam, min=1e-12)
        w_x = torch.sqrt(c2 * torch.clamp(cxx, min=0.0))
        w_y = torch.sqrt(c2 * torch.clamp(cyy, min=0.0))
        rmin_x = tile_bound((mean_x - w_x) / t, tiles_x)
        rmin_y = tile_bound((mean_y - w_y) / t, tiles_y)
        rmax_x = torch.clamp(torch.floor((mean_x + w_x) / t) + 1, 0, tiles_x).to(torch.int32)
        rmax_y = torch.clamp(torch.floor((mean_y + w_y) / t) + 1, 0, tiles_y).to(torch.int32)
    else:
        rmin_x = tile_bound((mean_x - radius) / t, tiles_x)
        rmin_y = tile_bound((mean_y - radius) / t, tiles_y)
        rmax_x = tile_bound((mean_x + radius + t - 1) / t, tiles_x)
        rmax_y = tile_bound((mean_y + radius + t - 1) / t, tiles_y)
    tiles_touched = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    valid = in_front & det_ok & (tiles_touched > 0)
    if active_mask is not None:
        valid = valid & active_mask

    if colors is not None:
        color = colors
        clamped = torch.zeros((P, 3), dtype=torch.bool, device=means3d.device)
    elif shs is not None:
        if sh_degree == 0:
            raw = shlib.C0 * shs[:, :, 0] + 0.5
            clamped = raw < 0.0
            color = torch.clamp(raw, min=0.0)
        else:
            color, clamped = shlib.sh_to_color(sh_degree, shs, means3d,
                                               camera.cam_center)
    else:
        color = torch.ones((P, 3), dtype=means3d.dtype, device=means3d.device)
        clamped = torch.zeros((P, 3), dtype=torch.bool, device=means3d.device)

    return Preprocessed(
        mx=mean_x, my=mean_y, depth=depth, ca=ca, cb=cb, cc=cc,
        czx=czx, cyz=cyz, opacity=opacities, color=color,
        radius=torch.where(valid, radius, torch.zeros_like(radius)).to(torch.int32),
        rmin_x=rmin_x, rmin_y=rmin_y, rmax_x=rmax_x, rmax_y=rmax_y,
        valid=valid, clamped=clamped, rcull2=rcull2,
    )


# ---------------------------------------------------------------------------
# Stage 2: binning
# ---------------------------------------------------------------------------


def _depth_quant(pre: Preprocessed) -> torch.Tensor:
    """16-bit depth quantization over the valid depth range."""
    depth = pre.depth.detach()
    big = torch.tensor(3e38, dtype=torch.float32, device=depth.device)
    dmin = torch.min(torch.where(pre.valid, depth, big))
    dmax = torch.max(torch.where(pre.valid, depth, -big))
    return torch.clamp(
        (depth - dmin) / torch.clamp(dmax - dmin, min=1e-9) * 65535.0, 0.0, 65535.0
    ).to(torch.int32)


def _tile_qmin(a, b, c_, mx, my, tx, ty, T):
    """Exact minimum of the conic quadratic over a tile's pixel box."""
    x0 = tx * T - mx
    x1 = tx * T + (T - 1.0) - mx
    y0 = ty * T - my
    y1 = ty * T + (T - 1.0) - my
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


def _cull_c2(opacities, cfg):
    """Alpha-gate level in conic-q units: q > c² ⟺ alpha < α_min."""
    return (torch.clamp(
        2.0 * torch.log(torch.clamp(opacities.detach() / cfg.alpha_min, min=1e-12)),
        min=0.0) * (1.0 + 1e-5) + 1e-6)


def sort_pairs(pre: Preprocessed, tiles_x: int, tiles_y: int, cfg: RasterizeConfig):
    """Pair expansion over the static R×R offset window and the one
    (tile<<16 | dq, gid) sort. Returns (gid_sorted int32 [MT·P], starts
    int32 [NT+1], overflow_rect)."""
    P = pre.mx.shape[0]
    dev = pre.mx.device
    MT = cfg.max_tiles_per_gaussian
    R = int(round(MT ** 0.5))
    if R * R != MT:
        raise ValueError("max_tiles_per_gaussian must be a perfect square")
    NT = tiles_x * tiles_y
    if NT >= (1 << 15):
        raise ValueError("tile<<16 key packing supports up to 32767 tiles")

    rect_w = pre.rmax_x - pre.rmin_x
    rect_h = pre.rmax_y - pre.rmin_y
    n_rect = rect_w * rect_h
    covered = torch.clamp(rect_w, max=R) * torch.clamp(rect_h, max=R)
    overflow_rect = torch.sum(torch.where(pre.valid, n_rect - covered,
                                          torch.zeros_like(n_rect))).to(torch.int32)

    dq = _depth_quant(pre)
    T = float(cfg.tile)
    mx, my = pre.mx.detach(), pre.my.detach()
    qa, qb, qc = pre.ca.detach(), pre.cb.detach(), pre.cc.detach()
    c2 = _cull_c2(pre.opacity, cfg)
    keys = []
    for j in range(MT):
        dx_j, dy_j = j % R, j // R
        ok = pre.valid & (dx_j < rect_w) & (dy_j < rect_h)
        tx = pre.rmin_x + dx_j
        ty = pre.rmin_y + dy_j
        ok = ok & (_tile_qmin(qa, qb, qc, mx, my, tx, ty, T) <= c2)
        tile_id = ty * tiles_x + tx
        keys.append(torch.where(ok, (tile_id << 16) | dq,
                                torch.full_like(dq, NT << 16)))
    key = torch.stack(keys, 0).reshape(-1).to(torch.int64)
    gid = torch.arange(P, device=dev, dtype=torch.int64).repeat(MT)
    # ties in (tile, dq) break by Gaussian id: one sort of the combined key
    combined, _ = torch.sort((key << 32) | gid)
    key_s = (combined >> 32).to(torch.int32)
    gid_s = (combined & 0xFFFFFFFF).to(torch.int32)
    bounds = torch.arange(NT + 1, device=dev, dtype=torch.int32) << 16
    starts = torch.searchsorted(key_s, bounds, out_int32=True)
    return gid_s, starts, overflow_rect


def bin_gaussians(pre: Preprocessed, tiles_x: int, tiles_y: int, cfg: RasterizeConfig):
    """Depth-ordered per-tile work table. Returns (table [NT,K] int32,
    counts [NT] int32, n_binned, overflow_rect, overflow_tile, seg [NT])."""
    NT = tiles_x * tiles_y
    K = cfg.tile_capacity
    gid_s, starts, overflow_rect = sort_pairs(pre, tiles_x, tiles_y, cfg)
    seg = starts[1:] - starts[:-1]
    overflow_tile = torch.sum(torch.clamp(seg - K, min=0)).to(torch.int32)
    counts = torch.clamp(seg, max=K).to(torch.int32)
    table = fill_table(gid_s, starts, NT, K)
    return table, counts, starts[NT], overflow_rect, overflow_tile, seg


# ---------------------------------------------------------------------------
# Stage 3: compositing
# ---------------------------------------------------------------------------


def _pack_gaussians(pre: Preprocessed, obj_features: torch.Tensor) -> torch.Tensor:
    """[P, 32] rows: mx my ca cb cc op 0 0 | rgb obj(O) dz0 A B 1 | pad."""
    O = obj_features.shape[-1]
    width = _G_HDR + 3 + O + 4
    width = -(-width // 8) * 8
    A = pre.czx * pre.ca + pre.cyz * pre.cb
    B = pre.czx * pre.cb + pre.cyz * pre.cc
    dz0 = pre.depth - A * pre.mx - B * pre.my
    zero = torch.zeros_like(dz0)
    cols = [pre.mx, pre.my, pre.ca, pre.cb, pre.cc, pre.opacity, zero, zero,
            pre.color[:, 0], pre.color[:, 1], pre.color[:, 2]]
    cols += [obj_features[:, i] for i in range(O)]
    cols += [dz0, A, B, torch.ones_like(dz0)]
    cols += [zero] * (width - len(cols))
    return torch.stack(cols, dim=-1)


class _CompositeFn(torch.autograd.Function):
    """Fused compositor: forward kernel, backward kernel + deterministic
    scatter-add of the per-pair gradients by Gaussian id (the custom VJP of
    `sags_tpu/ops/rasterize.py:581-647`)."""

    @staticmethod
    def forward(ctx, G, table, counts, n_feat, tiles_x, cfg, tile_offset):
        acc, T = comp.composite_fused(
            G, table, counts, cfg.tile, tiles_x, alpha_min=cfg.alpha_min,
            t_min=cfg.transmittance_min, chunk=cfg.chunk, tile_offset=tile_offset)
        ctx.save_for_backward(G, table, counts, T)
        ctx.meta = (n_feat, tiles_x, cfg, tile_offset, acc.shape[-1])
        return acc[..., :n_feat], T

    @staticmethod
    def backward(ctx, d_acc, d_T):
        G, table, counts, T = ctx.saved_tensors
        n_feat, tiles_x, cfg, tile_offset, CF = ctx.meta
        NT, PIX = T.shape
        d_acc_full = torch.zeros((NT, PIX, CF), dtype=torch.float32, device=G.device)
        if d_acc is not None:
            d_acc_full[..., :n_feat] = d_acc
        if d_T is None:
            d_T = torch.zeros_like(T)
        dGt = comp.composite_fused_bwd(
            G, table, counts, d_acc_full, d_T.contiguous(), T, cfg.tile, tiles_x,
            alpha_min=cfg.alpha_min, t_min=cfg.transmittance_min, chunk=cfg.chunk,
            tile_offset=tile_offset)
        dG = comp.scatter_rows(dGt, table, G.shape[0])
        return dG, None, None, None, None, None, None


def composite(table, counts, G, n_feat, tiles_x, tiles_y, cfg: RasterizeConfig,
              tile_offset: int = 0):
    """Front-to-back compositing over all tiles. Returns
    (accum [NT, tile², n_feat], T_final [NT, tile²], px, py)."""
    px, py = comp.tile_pixel_coords(tiles_x * tiles_y, tiles_x, cfg.tile, 0, G.device)
    accum, T_final = _CompositeFn.apply(G, table, counts, n_feat, tiles_x, cfg,
                                        tile_offset)
    return accum, T_final, px, py


def contribution_mask(pre: Preprocessed, tiles_x: int, tiles_y: int,
                      cfg: RasterizeConfig, table=None, counts=None) -> torch.Tensor:
    """Per-Gaussian `is_used`: True iff the Gaussian passes the alpha gate at
    ≥1 pixel while that pixel's transmittance is above the floor
    (`forward.cu:274`). Feature-free transmittance scan over the table."""
    if table is None:
        table, counts = bin_gaussians(pre, tiles_x, tiles_y, cfg)[:2]
    NT, K_TILE = table.shape
    P = pre.mx.shape[0]
    dev = pre.mx.device
    px, py = comp.tile_pixel_coords(NT, tiles_x, cfg.tile, 0, dev)
    cols = torch.stack([pre.mx, pre.my, pre.ca, pre.cb, pre.cc, pre.opacity], -1).detach()
    T = torch.ones((NT, cfg.tile * cfg.tile), dtype=torch.float32, device=dev)
    used = torch.zeros(P, dtype=torch.int32, device=dev)
    rank = torch.arange(K_TILE, device=dev)
    K = cfg.chunk
    for c0 in comp._chunks(table, counts, K):
        gids = torch.clamp(table[:, c0:c0 + K], min=0).long()
        vm = rank[None, c0:c0 + K] < counts[:, None]
        _, _, _, _, gate, om, T_exc, m = comp._chunk_quants(
            cols[gids], vm, px, py, T, cfg.alpha_min, cfg.transmittance_min)
        slot_used = torch.any(m, dim=1)
        used.scatter_reduce_(0, gids.reshape(-1), slot_used.reshape(-1).to(torch.int32),
                             "amax")
        T = T * torch.prod(torch.where(m, om, torch.ones_like(om)), dim=-1)
    return used > 0


def _untile(x, tiles_x: int, tiles_y: int, tile: int, W: int, H: int):
    C = x.shape[-1]
    img = x.reshape(tiles_y, tiles_x, tile, tile, C)
    img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * tile, tiles_x * tile, C)
    return img[:H, :W]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def rasterize(means3d, opacities, scales, quats, camera: Camera,
              cfg: RasterizeConfig = RasterizeConfig(), *, colors=None, shs=None,
              sh_degree: int = 0, obj_features=None, bg_color=None,
              active_mask=None, windowed: Optional[bool] = None) -> RenderOutput:
    """Render Gaussians (the classic path of `sags_tpu.ops.rasterize`).
    Differentiable w.r.t. means3d, opacities, scales, quats, colors/shs and
    obj_features. Runs where its inputs live; CUDA tensors go through the
    CUDA kernels."""
    use_windowed = cfg.windowed if windowed is None else windowed
    if use_windowed:
        raise NotImplementedError(
            "the windowed render path (pallas_windowed kernels) is not ported "
            "yet: it is a later slice of the port; pass windowed=False")
    P = means3d.shape[0]
    dev = means3d.device
    W, H = camera.width, camera.height
    tiles_x = -(-W // cfg.tile)
    tiles_y = -(-H // cfg.tile)
    if obj_features is None:
        obj_features = torch.zeros((P, cfg.num_objects), dtype=means3d.dtype, device=dev)
    if bg_color is None:
        bg_color = torch.zeros(3, dtype=means3d.dtype, device=dev)
    O = obj_features.shape[-1]

    pre = preprocess(means3d, opacities, scales, quats, camera, cfg,
                     colors=colors, shs=shs, sh_degree=sh_degree,
                     active_mask=active_mask)
    n_feat = 3 + O + 4
    table, counts, n_binned, ov_rect, ov_tile, seg = bin_gaussians(
        pre, tiles_x, tiles_y, cfg)
    G = _pack_gaussians(pre, obj_features)
    accum, T_final, px, py = composite(table, counts, G, n_feat, tiles_x, tiles_y, cfg)

    # transmittance-aware overflow accounting (see the JAX package)
    saturated = torch.all(T_final.detach() < 10.0 * cfg.transmittance_min, dim=1)
    truncated = seg > cfg.tile_capacity
    over = torch.clamp(seg - cfg.tile_capacity, min=0)
    ov_tile_live = torch.sum(torch.where(~saturated, over, torch.zeros_like(over)))
    need_known = torch.where(saturated & truncated, torch.zeros_like(seg), seg)
    tile_peak = torch.max(need_known)

    rgb = accum[..., :3]
    obj = accum[..., 3:3 + O]
    dz, wA, wB, acc_alpha = (accum[..., 3 + O], accum[..., 4 + O],
                             accum[..., 5 + O], accum[..., 6 + O])
    rgb = rgb + T_final[..., None] * bg_color[None, None, :]
    depth = dz + px * wA + py * wB + T_final * cfg.bg_depth

    def untile(x):
        return _untile(x, tiles_x, tiles_y, cfg.tile, W, H)

    color_img = untile(rgb)
    obj_img = untile(obj)
    depth_img = untile(depth[..., None])
    alpha_img = untile(acc_alpha[..., None])
    T_img = untile(T_final[..., None])

    if cfg.is_used_mode == "contrib":
        def is_used_fn():
            return contribution_mask(pre, tiles_x, tiles_y, cfg, table, counts)
    else:
        def is_used_fn():
            return pre.valid

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return RenderOutput(
        color=color_img.permute(2, 0, 1),
        depth=depth_img.permute(2, 0, 1),
        objects=obj_img.permute(2, 0, 1),
        alpha=alpha_img.permute(2, 0, 1),
        final_T=T_img[..., 0],
        radii=pre.radius,
        n_binned=n_binned,
        overflow_rect=ov_rect,
        overflow_tile=ov_tile,
        overflow_window=zero,
        overflow_big=zero,
        tile_peak=tile_peak.to(torch.int32),
        overflow_tile_live=ov_tile_live.to(torch.int32),
        _is_used_fn=is_used_fn,
    )
