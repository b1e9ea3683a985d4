"""Differentiable tiled Gaussian rasterizer — `sags_tpu.ops.rasterize` in
PyTorch.

Stages, as in the JAX package:
  1. `preprocess`: frustum cull, Σ3D from (scale, quat), EWA projection with
     the +0.3 px low-pass, conic, 3σ radius, the tight alpha-cull tile rect,
     SH degree-0 colour — longhand over [P] columns so the arithmetic order
     (and the 16-bit depth keys) match the JAX package. The renders call it
     through `project`, which on the card takes the CUDA kernel pair
     `preprocess_kernel` instead (`csrc/preprocess.cu`: the same outputs bit
     for bit, one forward and one backward launch).
  2. Binning and compositing, by one of two paths:
     * classic (training): `bin_gaussians` expands pairs over the R×R offset
       window and fills the table with the CUDA kernels `expand_pairs` and
       `fill_table` (`ops/binning.py`), sorting the live (tile<<16 | dq,
       gid) keys once between them; `composite` runs the fused compositor
       forward and backward (CUDA kernels in `ops/composite.py`) under a
       `torch.autograd.Function`, the per-pair gradients scattered into dG
       deterministically;
     * windowed (rendering, the default when the shapes allow it, and
       training under `train_windowed`):
       `_prepare_windowed` sorts the packed rows by (anchor tile, depth),
       adds slice-store copies of wide Gaussians, and either builds the
       window-local work list from a tiered pair sort (`windowed_sort =
       "host"`, CUDA kernels `fill_table` and `composite_windowed`) or
       leaves the depth order to the kernel (`"kernel"`,
       `composite_windowed_sorted`); see `ops/windowed.py`.

The host-table windowed path is differentiable: its backward is the CUDA
kernel `composite_windowed_bwd` (per-pair gradients in table order) and the
deterministic scatter by sorted-row id, from which autograd folds the
slice-store copies' gradients back onto their parents; under
`windowed_bf16` or `pallas_backward=False` it is the exact recompute through
the classic compositor, as in the JAX package. `ewa_impl`,
`feature_precision` and `windowed_bf16` select the windowed forward's
variants; `scan_impl` and `window_prefetch` are accepted and have no effect
(TPU formulations of the same arithmetic); `window_ablate` (a TPU timing
diagnostic) raises.

Under a mesh (`parallel/mesh.py`) both differentiable compositors run
sharded over the ranks' tiles; see `rasterize`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch

from sags_tpu_torch.core import sh as shlib
from sags_tpu_torch.core.camera import Camera, ndc2pix
from sags_tpu_torch.core.config import RasterizeConfig
from sags_tpu_torch.core.transforms import quat_normalize
from sags_tpu_torch.ops import composite as comp
from sags_tpu_torch.ops._build import CudaKernel, stream_ptr
from sags_tpu_torch.ops import windowed as win
from sags_tpu_torch.ops.binning import cull_c2, expand_pairs, fill_table, tile_qmin
from sags_tpu_torch.utils.profiling import count, host_read, span
from sags_tpu_torch.parallel.mesh import (gather_tiles, replicated, shard_tiles,
                                          tile_sharding)

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
               cov3d_precomp=None, active_mask=None, mean2d_offset=None) -> Preprocessed:
    """Per-Gaussian projection (`sags_tpu.ops.rasterize.preprocess`).
    `cov3d_precomp` ([P,3,3], or [P,6] packed upper-triangular) replaces Σ3D
    from (scale, quat). `mean2d_offset` [P,2] (zeros) is the densification
    probe: d(loss)/d(offset) is the view-space positional gradient (the
    reference's `viewspace_points.retain_grad()`)."""
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
    if mean2d_offset is not None:
        mean_x = mean_x + mean2d_offset[:, 0]
        mean_y = mean_y + mean2d_offset[:, 1]

    if cov3d_precomp is not None:
        c = cov3d_precomp
        if c.dim() == 3:
            s00, s01, s02 = c[:, 0, 0], c[:, 0, 1], c[:, 0, 2]
            s11, s12, s22 = c[:, 1, 1], c[:, 1, 2], c[:, 2, 2]
        else:  # packed [P,6] upper-triangular, the CUDA layout
            s00, s01, s02, s11, s12, s22 = (c[:, i] for i in range(6))
    else:
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


# The kernel pair (`csrc/preprocess.cu`), built without fused multiply-adds so
# the forward rounds each operation where PyTorch does
_VP = ctypes.c_void_p
_I = ctypes.c_int
PREPROCESS = CudaKernel("preprocess.cu", "sags_preprocess", [_VP] * 10 + [_I] * 5 + [_VP] * 2,
                        flags=("-fmad=false",))
PREPROCESS_BWD = CudaKernel("preprocess.cu", "sags_preprocess_bwd",
                            [_VP] * 9 + [_I] * 2 + [_VP] * 6, flags=("-fmad=false",))
_PRE_ROWS = 18  # [18, P] float32: 9 float rows, the colour [P,3], 5 int32 rows, the flags


def _preprocess_consts(camera: Camera, cfg: RasterizeConfig):
    """The kernel pair's scalars in `Consts`' order, each Python number
    rounded to float32 as PyTorch rounds it; a divisor as its reciprocal,
    taken in double and then rounded, which PyTorch's CUDA division by a
    Python scalar multiplies by."""
    return (ctypes.c_float * 13)(
        camera.width, camera.height, camera.focal_x, camera.focal_y,
        1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy, cfg.near, cfg.low_pass,
        cfg.scale_modifier, 1.0 / cfg.alpha_min, float(cfg.tile), 1.0 / cfg.tile, shlib.C0)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


class _PreprocessFn(torch.autograd.Function):
    """`preprocess` as one forward and one backward kernel. The outputs are
    rows of one [18, P] buffer; the colour is an output only when `shs` is
    given. The backward saves only the inputs and recomputes the rest a slot
    at a time."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, shs, mean2d_offset, opacities, active_mask,
                V, M, meta):
        P, sh_stride, tiles_x, tiles_y, tight, consts = meta
        dev = means3d.device
        buf = torch.empty((_PRE_ROWS, P), dtype=torch.float32, device=dev)
        PREPROCESS.launch(*(_ptr(t) for t in (means3d, scales, quats, opacities, shs,
                                              active_mask, mean2d_offset, V, M)),
                          consts, P, sh_stride, tiles_x, tiles_y, int(tight), buf.data_ptr(),
                          stream_ptr(dev))
        ints = buf[12:17].view(torch.int32)
        flags = buf[17].view(torch.uint8).view(torch.bool)
        valid, clamped = flags[:P], flags[P:].view(P, 3)
        nondiff = (buf[8], *ints, valid, clamped)
        ctx.mark_non_differentiable(*nondiff)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, scales, quats, shs, V, M)
        ctx.meta = meta
        color = None if shs is None else buf[9:12].view(P, 3)
        return (*buf[:8], color, *nondiff)

    @staticmethod
    def backward(ctx, *grads):
        means3d, scales, quats, shs, V, M = ctx.saved_tensors
        P, sh_stride, _, _, _, consts = ctx.meta
        dev = means3d.device
        with span("raster.preprocess_bwd", device=dev):
            ptrs, strides = [], []
            for g in grads[:8]:  # mx my depth ca cb cc czx cyz: [P]
                ptrs.append(_ptr(g))
                strides.append(0 if g is None else g.stride(0))
            g_color = grads[8]  # [P, 3], or None without `shs`
            for c in range(3):
                ptrs.append(None if g_color is None
                            else g_color.data_ptr() + 4 * c * g_color.stride(1))
                strides.append(0 if g_color is None else g_color.stride(0))
            need = ctx.needs_input_grad
            d_means = torch.empty_like(means3d) if need[0] else None
            d_scales = torch.empty_like(scales) if need[1] else None
            d_quats = torch.empty_like(quats) if need[2] else None
            d_shs = None
            if need[3]:  # the kernel writes the degree-0 coefficients only
                d_shs = torch.zeros_like(shs) if sh_stride > 1 else torch.empty_like(shs)
            d_off = torch.empty((P, 2), dtype=torch.float32, device=dev) if need[4] else None
            PREPROCESS_BWD.launch(*(_ptr(t) for t in (means3d, scales, quats, shs, V, M)),
                                  consts, (_VP * 11)(*ptrs), (ctypes.c_longlong * 11)(*strides),
                                  P, sh_stride, *(_ptr(t) for t in (d_means, d_scales, d_quats,
                                                                    d_shs, d_off)),
                                  stream_ptr(dev))
        return d_means, d_scales, d_quats, d_shs, d_off, None, None, None, None, None


def preprocess_kernel(means3d, opacities, scales, quats, camera: Camera,
                      cfg: RasterizeConfig, colors=None, shs=None, sh_degree: int = 0,
                      cov3d_precomp=None, active_mask=None, mean2d_offset=None) -> Preprocessed:
    """`preprocess` on the card, with the plain version's arguments: the CUDA
    kernel pair (`csrc/preprocess.cu`) for Σ3D from (scale, quat), the
    projection and, from `shs` at SH degree 0, the colour. The colour of a
    call without that is made beside it as the plain version makes it:
    `colors` as given, `shs` above degree 0 through `sh.sh_to_color` (its
    gradient by autograd), ones without either. The outputs are the plain
    version's on the card bit for bit; the backward gives autograd's gradients
    of means3d, scales, quats, shs and `mean2d_offset`. `opacity` passes
    through as the same tensor. Raises on what the kernel does not take: a
    precomputed Σ3D, a camera that takes gradients, and any input tensor that
    is not CUDA float32 and contiguous."""
    if cov3d_precomp is not None:
        raise ValueError("preprocess_kernel: takes no cov3d_precomp; call preprocess")
    P = means3d.shape[0]
    sh0 = shs if colors is None and sh_degree == 0 else None
    V, M = camera.world_view, camera.full_proj
    cols = [("means3d", means3d, (P, 3)), ("opacities", opacities, (P,)),
            ("scales", scales, (P, 3)), ("quats", quats, (P, 4)),
            ("world_view", V, (4, 4)), ("full_proj", M, (4, 4))]
    if sh0 is not None:
        cols.append(("shs", sh0, (P, 3, sh0.shape[-1] if sh0.dim() == 3 else -1)))
    if mean2d_offset is not None:
        cols.append(("mean2d_offset", mean2d_offset, (P, 2)))
    for name, t, shape in cols:
        if t.dtype != torch.float32:
            raise TypeError(f"preprocess_kernel: {name} must be float32, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"preprocess_kernel: {name} must be {list(shape)}, "
                             f"not {list(t.shape)}")
    if active_mask is not None:
        if active_mask.dtype != torch.bool:
            raise TypeError("preprocess_kernel: active_mask must be bool")
        if tuple(active_mask.shape) != (P,):
            raise ValueError(f"preprocess_kernel: active_mask must be [{P}]")
        cols.append(("active_mask", active_mask, (P,)))
    for name, t, _ in cols:
        if not t.is_contiguous():
            raise ValueError(f"preprocess_kernel: {name} must be contiguous")
    if V.requires_grad or M.requires_grad:
        raise ValueError("preprocess_kernel: gives no gradient of the camera")
    dev = means3d.device
    if not means3d.is_cuda or any(t.device != dev for _, t, _ in cols):
        raise ValueError("preprocess_kernel: every input must be on one CUDA device")
    meta = (P, 1 if sh0 is None else sh0.shape[-1], -(-camera.width // cfg.tile),
            -(-camera.height // cfg.tile), cfg.tight_rect, _preprocess_consts(camera, cfg))
    (mx, my, depth, ca, cb, cc, czx, cyz, color, rcull2, radius, rmin_x, rmin_y, rmax_x,
     rmax_y, valid, clamped) = _PreprocessFn.apply(means3d, scales, quats, sh0, mean2d_offset,
                                                   opacities, active_mask, V, M, meta)
    if colors is not None:
        color = colors
    elif shs is not None and sh0 is None:
        color, clamped = shlib.sh_to_color(sh_degree, shs, means3d, camera.cam_center)
    elif shs is None:
        color = torch.ones((P, 3), dtype=torch.float32, device=dev)
    return Preprocessed(
        mx=mx, my=my, depth=depth, ca=ca, cb=cb, cc=cc, czx=czx, cyz=cyz,
        opacity=opacities, color=color, radius=radius, rmin_x=rmin_x, rmin_y=rmin_y,
        rmax_x=rmax_x, rmax_y=rmax_y, valid=valid, clamped=clamped, rcull2=rcull2)


def project(means3d, opacities, scales, quats, camera: Camera, cfg: RasterizeConfig,
            colors=None, shs=None, sh_degree: int = 0, cov3d_precomp=None,
            active_mask=None, mean2d_offset=None) -> Preprocessed:
    """Stage 1 as the renders run it: `preprocess_kernel` for tensors on the
    card, the plain `preprocess` for CPU tensors."""
    fn = preprocess_kernel if means3d.is_cuda else preprocess
    return fn(means3d, opacities, scales, quats, camera, cfg, colors=colors, shs=shs,
              sh_degree=sh_degree, cov3d_precomp=cov3d_precomp, active_mask=active_mask,
              mean2d_offset=mean2d_offset)


# ---------------------------------------------------------------------------
# Stage 2: binning
# ---------------------------------------------------------------------------


def _depth_quant(pre: Preprocessed) -> torch.Tensor:
    """16-bit depth quantization over the valid depth range."""
    depth = pre.depth.detach()
    big = torch.full((), 3e38, dtype=torch.float32, device=depth.device)
    dmin = torch.min(torch.where(pre.valid, depth, big))
    dmax = torch.max(torch.where(pre.valid, depth, -big))
    return torch.clamp(
        (depth - dmin) / torch.clamp(dmax - dmin, min=1e-9) * 65535.0, 0.0, 65535.0
    ).to(torch.int32)


def sort_pairs(pre: Preprocessed, tiles_x: int, tiles_y: int, cfg: RasterizeConfig):
    """Pair expansion over the static R×R offset window (`binning.expand_pairs`:
    one CUDA kernel on the card) and the one (tile<<16 | dq, gid) sort of
    the live pairs alone, their count read by the host (one sync).
    Returns (gid_sorted int32 [n_binned], starts int32 [NT+1], overflow_rect)."""
    dev = pre.mx.device
    NT = tiles_x * tiles_y
    dq = _depth_quant(pre)
    keys, n_live, overflow_rect = expand_pairs(pre, dq, tiles_x, tiles_y, cfg)
    n = host_read(int, n_live)
    count("bin.pairs", n)
    count("bin.slots", cfg.max_tiles_per_gaussian * pre.mx.shape[0])
    # ties in (tile, dq) break by Gaussian id: one sort of the combined key
    combined, _ = torch.sort(keys[:n])
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
    with span("raster.bin", device=pre.mx.device):
        gid_s, starts, overflow_rect = sort_pairs(pre, tiles_x, tiles_y, cfg)
        seg = starts[1:] - starts[:-1]
        overflow_tile = torch.sum(torch.clamp(seg - K, min=0)).to(torch.int32)
        counts = torch.clamp(seg, max=K).to(torch.int32)
        table = fill_table(gid_s, starts, NT, K)
    return table, counts, starts[NT], overflow_rect, overflow_tile, seg


# ---------------------------------------------------------------------------
# Stage 3: compositing
# ---------------------------------------------------------------------------


def _pack_gaussians(pre: Preprocessed, obj_features: torch.Tensor,
                    extras: bool = False, pack_obj_bf16: bool = False) -> torch.Tensor:
    """[P, 32] rows: mx my ca cb cc op 0 0 | rgb obj(O) dz0 A B 1 | pad.
    `extras` appends the windowed path's columns 32..39 (`ops/windowed.py`
    COL_*): rect min x/y, rect w/h and dq as exact small floats, rcull2,
    two zero columns; gradient-free. `pack_obj_bf16` (with `extras` and 16
    obj channels) appends columns 40..47: the obj channels rounded to bf16,
    in pairs (lo = channel 2c, hi = 2c+1) bit-cast into float32;
    gradient-free."""
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
    if extras:
        cols += [x.detach().to(torch.float32) for x in (
            pre.rmin_x, pre.rmin_y, pre.rmax_x - pre.rmin_x, pre.rmax_y - pre.rmin_y,
            _depth_quant(pre), pre.rcull2)]
        cols += [zero.detach(), zero.detach()]
        if pack_obj_bf16 and O == 16:
            u16 = obj_features.detach().to(torch.bfloat16).view(torch.int16).to(torch.int32)
            packed = ((u16[:, 1::2] << 16) | (u16[:, 0::2] & 0xFFFF)).view(torch.float32)
            cols += [packed[:, i] for i in range(8)]
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
        with span("raster.composite_bwd", device=G.device):
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


def _composite_sharded(G, table, counts, n_feat, tiles_x, cfg: RasterizeConfig, mesh):
    """Multi-device compositing (`sags_tpu/ops/rasterize.py:650-691`): each
    rank runs the fused forward and backward on its contiguous tile slice at
    its tile offset (padded tiles: an empty table and counts 0), the slices
    are all-gathered, and each rank's dG scatter is summed over the ranks.
    `G` stays replicated."""
    NT = table.shape[0]
    _, lo, _ = tile_sharding(mesh, NT)
    acc, T = _CompositeFn.apply(replicated(G, mesh), shard_tiles(table, mesh, -1),
                                shard_tiles(counts, mesh), n_feat, tiles_x, cfg, lo)
    return gather_tiles(acc, mesh, NT), gather_tiles(T, mesh, NT)


def composite(table, counts, G, n_feat, tiles_x, tiles_y, cfg: RasterizeConfig,
              mesh=None):
    """Front-to-back compositing over all tiles, sharded over the tiles of
    `mesh` when one is given. Returns
    (accum [NT, tile², n_feat], T_final [NT, tile²], px, py)."""
    px, py = comp.tile_pixel_coords(tiles_x * tiles_y, tiles_x, cfg.tile, 0, G.device)
    if mesh is None:
        accum, T_final = _CompositeFn.apply(G, table, counts, n_feat, tiles_x, cfg, 0)
    else:
        accum, T_final = _composite_sharded(G, table, counts, n_feat, tiles_x, cfg, mesh)
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


# ---------------------------------------------------------------------------
# Windowed path: anchor-sorted rows, span plan, window-local work list
# ---------------------------------------------------------------------------


def _stable_first(first: torch.Tensor) -> torch.Tensor:
    """Indices with the `first` rows leading, each group in index order: the
    JAX package's one-key sort of (where(first, 0, 1), iota)."""
    return torch.sort(torch.where(first, 0, 1).to(torch.int32), stable=True).indices


def _set_cols(x: torch.Tensor, col: int, vals) -> torch.Tensor:
    """`x` with columns col, col+1, ... replaced by the [N] tensors `vals`."""
    new = torch.stack([v.to(x.dtype) for v in vals], dim=-1)
    return torch.cat([x[:, :col], new, x[:, col + len(vals):]], dim=1)


def _spans(rowstart: torch.Tensor, tiles_x: int, NT: int, R: int, NB=None):
    """The per-tile span plan: for anchor tile row j (tile rows ty-R+1 .. ty,
    columns tx-R+1 .. tx) the span's rows [s, e) of the anchor-sorted store,
    its 128-aligned first block, the blocks it needs and, under a window
    budget of NB blocks, the blocks it gets and its first block in the
    window. Yields (s, e, base, need, nblk, dest), one tuple per j."""
    t = torch.arange(NT, device=rowstart.device, dtype=torch.int32)
    ty, tx = t // tiles_x, t % tiles_x
    col0 = torch.clamp(tx - (R - 1), min=0)
    dest = torch.zeros_like(t)
    for j in range(R):
        row = ty - (R - 1) + j
        rvalid = row >= 0
        rowc = torch.clamp(row, min=0)
        s = torch.where(rvalid, rowstart[(rowc * tiles_x + col0).long()], 0)
        e = torch.where(rvalid, rowstart[(rowc * tiles_x + tx + 1).long()], 0)
        base = torch.div(s, 128, rounding_mode="floor")
        need = torch.where(e > s, -torch.div(base * 128 - e, 128, rounding_mode="floor"), 0)
        nblk = need if NB is None else torch.minimum(need, NB - dest)
        yield s, e, base, need, nblk, dest
        dest = dest + nblk


def _flat(cols) -> torch.Tensor:
    """[NT] tensors, one per span → [NT·R] int32, tile-major."""
    return torch.stack(cols, dim=1).reshape(-1).to(torch.int32)


def _prepare_windowed(pre: Preprocessed, obj_features: torch.Tensor, tiles_x: int,
                      tiles_y: int, cfg: RasterizeConfig, build_table: bool = True):
    """Anchor-sort the packed rows (plus slice-store copies of wide
    Gaussians), build the depth-ordered per-tile work list in window-local
    ids, and the per-tile span plan (`sags_tpu.ops.rasterize.
    _prepare_windowed`, every counter included).

    Returns (G_s, table_global, table_local [NT, K/128, 128], counts, bases,
    dests, nblks, n_binned, overflow_rect, overflow_tile, overflow_window,
    overflow_big). With `build_table=False` (the in-kernel sort) there is
    no pair expansion, pair sort or table: returns (G_s, bases, dests,
    nblks, sstarts, sends, overflow_rect, overflow_window_raw, overflow_big),
    where overflow_window_raw counts the span rows the block budget cut
    (before the rect and alpha tests)."""
    P = pre.mx.shape[0]
    dev = pre.mx.device
    MT = cfg.max_tiles_per_gaussian
    R = int(round(MT ** 0.5))
    if R * R != MT:
        raise ValueError("max_tiles_per_gaussian must be a perfect square")
    NB = cfg.window_blocks
    K = cfg.tile_capacity
    NT = tiles_x * tiles_y
    if NT >= (1 << 15):
        raise ValueError("tile<<16 key packing supports up to 32767 tiles")
    i32 = torch.int32

    rect_w_all = pre.rmax_x - pre.rmin_x
    rect_h_all = pre.rmax_y - pre.rmin_y
    dq = _depth_quant(pre)
    G = _pack_gaussians(pre, obj_features, extras=True,
                        pack_obj_bf16=bool(cfg.windowed_bf16))

    # --- slice store: a Gaussian whose rect exceeds the R×R window is
    # replicated as copy rows anchored every R tiles, each copy's rect
    # columns patched to its ≤R×R slice; copies are ordinary rows of the
    # anchor-sorted store
    K_BIG = int(cfg.windowed_big_capacity)
    R_STORE = int(cfg.windowed_store_max_rect)
    use_store = K_BIG > 0 and R_STORE > R
    parent_excl = torch.zeros(P, dtype=torch.bool, device=dev)
    cover_side = torch.full((P,), R, dtype=i32, device=dev)
    copy_rows, copy_keys = [], []
    overflow_big0 = torch.zeros((), dtype=torch.int64, device=dev)
    if use_store:
        maxside = torch.maximum(rect_w_all, rect_h_all)
        prev_cap = R
        for cap_t, frac_t in cfg.windowed_store_fracs:
            if cap_t <= R:
                continue
            cap_t = min(cap_t, R_STORE)
            sel = pre.valid & (maxside > prev_cap) & (maxside <= cap_t)
            prev_cap = cap_t
            PBUF = min(max(int(P * frac_t) // 128 * 128, 128), P)
            rank = torch.cumsum(sel.to(i32), 0) - 1
            fits = sel & (rank < PBUF)
            parent_excl = parent_excl | fits
            cover_side = torch.where(fits, cap_t, cover_side)
            # saturated parents fall back to R×R coverage; the pairs the tier
            # would have covered count as big-tier overflow
            lost = (torch.clamp(rect_w_all, max=cap_t) * torch.clamp(rect_h_all, max=cap_t)
                    - torch.clamp(rect_w_all, max=R) * torch.clamp(rect_h_all, max=R))
            overflow_big0 = overflow_big0 + torch.sum(torch.where(sel & ~fits, lost, 0))
            idx = _stable_first(fits)[:PBUF]
            rows = _set_cols(G[idx], win.COL_STORE, [torch.ones(PBUF, device=dev)])
            bvalid = torch.arange(PBUF, device=dev) < torch.clamp(fits.sum(), max=PBUF)
            rx, ry = pre.rmin_x[idx], pre.rmin_y[idx]
            rw, rh = rect_w_all[idx], rect_h_all[idx]
            dqi = dq[idx]
            for gy in range(-(-cap_t // R)):
                for gx in range(-(-cap_t // R)):
                    vx, vy = gx * R, gy * R
                    cval = bvalid & (vx < rw) & (vy < rh)
                    copy_rows.append(_set_cols(rows, win.COL_RMIN_X, [
                        rx + vx, ry + vy, torch.clamp(rw - vx, 0, R),
                        torch.clamp(rh - vy, 0, R)]))
                    anchor_c = torch.where(cval, (ry + vy) * tiles_x + (rx + vx), NT)
                    copy_keys.append((anchor_c << 16) | dqi)
        G = torch.cat([G] + copy_rows, dim=0)

    # rect coverage of the parents (copies are the coverage); pairs already
    # counted as big-tier overflow are not counted twice
    covered = (torch.minimum(rect_w_all, cover_side) * torch.minimum(rect_h_all, cover_side))
    overflow_rect = torch.sum(torch.where(pre.valid, rect_w_all * rect_h_all - covered, 0)) \
        - overflow_big0

    # --- anchor sort: rows grouped by rect-min tile, depth-ordered within;
    # parents replaced by their copies sort past rowstart[NT] like culled rows
    P_all = G.shape[0]
    anchor = torch.where(pre.valid & ~parent_excl, pre.rmin_y * tiles_x + pre.rmin_x, NT)
    akey = torch.cat([(anchor << 16) | dq] + copy_keys).to(i32)
    akey_s, perm = torch.sort(akey, stable=True)
    G_s = G[perm]
    bounds = torch.arange(NT + 1, device=dev, dtype=i32) << 16
    rowstart = torch.searchsorted(akey_s, bounds, out_int32=True)

    if not build_table:
        plan = [[] for _ in range(5)]
        ov_raw = torch.zeros((), dtype=torch.int64, device=dev)
        for s, e, base, _, nblk, dest in _spans(rowstart, tiles_x, NT, R, NB):
            cov = torch.minimum(torch.clamp((base + nblk) * 128 - s, min=0), e - s)
            ov_raw = ov_raw + torch.sum((e - s) - cov)
            for lst, v in zip(plan, (base, dest, nblk, s, e)):
                lst.append(v)
        return (G_s, *(_flat(c) for c in plan), overflow_rect.to(i32), ov_raw.to(i32),
                overflow_big0.to(i32))

    # --- pair expansion over the sorted rows (payload = sorted row id).
    # Tiers: a 2×2 window for every row, the 5 extra 3×3-ring offsets for
    # MID rows (rect 3) from a windowed_mid_frac·P buffer, the R×R−4 extra
    # offsets for BIG rows from a windowed_big_frac·P buffer, and a ring tier
    # for slice-store copies; only the first windowed_expand_frac·P_all rows
    # (live rows sort first) expand. Every cut is counted in overflow_big.
    ef = float(cfg.windowed_expand_frac)
    PE = P_all if ef >= 1.0 else min(-(-int(P_all * ef) // 128) * 128, P_all)
    ex = G_s[:PE].detach()
    iota = torch.arange(PE, device=dev, dtype=i32)

    def icol(x, c):
        return x[:, c].to(i32)

    rminx, rminy = icol(ex, win.COL_RMIN_X), icol(ex, win.COL_RMIN_Y)
    rectw, recth = icol(ex, win.COL_RECT_W), icol(ex, win.COL_RECT_H)
    dq_s = icol(ex, win.COL_DQ)
    valid_s = iota < rowstart[NT]
    TT = float(cfg.tile)
    overflow_big = overflow_big0
    if PE < P_all:
        exT = G_s[PE:].detach()
        vT = torch.arange(PE, P_all, device=dev) < rowstart[NT]
        overflow_big = overflow_big + torch.sum(torch.where(
            vT, icol(exT, win.COL_RECT_W) * icol(exT, win.COL_RECT_H), 0))

    def tier_keys(offs, exb, rx, ry, rw, rh, dqb, vmask):
        mx, my = exb[:, 0], exb[:, 1]
        qa, qb, qc = exb[:, 2], exb[:, 3], exb[:, 4]
        c2 = cull_c2(exb[:, 5], cfg.alpha_min)
        ks = []
        for dx_j, dy_j in offs:
            ok = vmask & (dx_j < rw) & (dy_j < rh)
            tx = rx + dx_j
            ty = ry + dy_j
            ok = ok & (tile_qmin(qa, qb, qc, mx, my, tx, ty, TT) <= c2)
            ks.append(torch.where(ok, ((ty * tiles_x + tx) << 16) | dqb, NT << 16))
        return ks

    is_copy = (ex[:, win.COL_STORE] > 0.0) if use_store else torch.zeros(
        PE, dtype=torch.bool, device=dev)
    keys, gids = [], []

    def tier(sel_mask, offs, PBUF, cover_cap, base_cap=2, row_cap=None):
        nonlocal overflow_big
        PBUF = min(PBUF, PE)
        cap = PBUF if row_cap is None else min(int(row_cap), PBUF)
        rank = torch.cumsum(sel_mask.to(i32), 0) - 1
        cov = torch.clamp(rectw, max=cover_cap) * torch.clamp(recth, max=cover_cap)
        base2 = torch.clamp(rectw, max=base_cap) * torch.clamp(recth, max=base_cap)
        overflow_big = overflow_big + torch.sum(
            torch.where(sel_mask & (rank >= cap), cov - base2, 0))
        idx = _stable_first(sel_mask)[:PBUF]
        exb = ex[idx]
        bvalid = torch.arange(PBUF, device=dev) < torch.clamp(sel_mask.sum(), max=cap)
        keys.extend(tier_keys(offs, exb, icol(exb, win.COL_RMIN_X),
                              icol(exb, win.COL_RMIN_Y), icol(exb, win.COL_RECT_W),
                              icol(exb, win.COL_RECT_H), icol(exb, win.COL_DQ), bvalid))
        gids.extend([idx.to(i32)] * len(offs))

    RA = min(R, 2)
    split_frac = float(cfg.windowed_base_split_frac)
    if RA == 2 and split_frac > 0.0:
        # every row gets its rect-min tile; the other three 2×2 offsets ride
        # a compacted tier of the rows spanning more than one tile
        keys.extend(tier_keys([(0, 0)], ex, rminx, rminy, rectw, recth, dq_s, valid_s))
        gids.append(iota)
        need2 = valid_s & ((rectw > 1) | (recth > 1))
        PR = max(int(P_all * split_frac) // 128 * 128, 128)
        tier(need2, [(1, 0), (0, 1), (1, 1)], PR, 2, base_cap=1)
    else:
        offs_a = [(x, y) for y in range(RA) for x in range(RA)]
        keys.extend(tier_keys(offs_a, ex, rminx, rminy, rectw, recth, dq_s, valid_s))
        gids.extend([iota] * len(offs_a))

    n_copies = P_all - P
    if R > 2:
        beyond2 = valid_s & ((rectw > 2) | (recth > 2)) & ~is_copy
        offs_m = [(x, y) for y in range(min(R, 3)) for x in range(min(R, 3))
                  if not (x < 2 and y < 2)]
        offs_b = [(x, y) for y in range(R) for x in range(R) if not (x < 2 and y < 2)]
        PM = max(int(P * cfg.windowed_mid_frac) // 128 * 128, 128)
        if R > 3:
            tier(beyond2 & (rectw <= 3) & (recth <= 3), offs_m, PM, 3)
            is_big = valid_s & ((rectw > 3) | (recth > 3)) & ~is_copy
            PB = max(int(P * cfg.windowed_big_frac) // 128 * 128, 128)
            tier(is_big, offs_b, PB, R)
        else:  # R == 3: the mid ring is full coverage
            tier(beyond2, offs_m, PM, 3)
        if n_copies:
            crf = float(cfg.windowed_copy_ring_frac)
            NC_CAP = n_copies if crf >= 1.0 else max(int(n_copies * crf), 1)
            tier(valid_s & is_copy & ((rectw > 2) | (recth > 2)),
                 offs_b if R > 3 else offs_m, -(-NC_CAP // 128) * 128, R,
                 row_cap=NC_CAP)

    key = torch.cat([k.reshape(-1) for k in keys]).to(i32)
    gid = torch.cat([g.reshape(-1) for g in gids]).to(i32)
    if cfg.windowed_pair_sort == "stable":
        key_s, order = torch.sort(key, stable=True)
        idx_s = gid[order]
    else:  # "lex": ties in (tile, dq) break by sorted-row id
        combined = torch.sort((key.to(torch.int64) << 32) | gid.to(torch.int64)).values
        key_s = (combined >> 32).to(i32)
        idx_s = (combined & 0xFFFFFFFF).to(i32)
    starts = torch.searchsorted(key_s, bounds, out_int32=True)
    seg = starts[1:] - starts[:-1]
    overflow_tile = torch.sum(torch.clamp(seg - K, min=0)).to(i32)
    counts = torch.clamp(seg, max=K).to(i32)
    table = fill_table(idx_s, starts, NT, K)

    # --- window-local translation: the spans share one budget of NB blocks
    # per tile, allocated by span length and numbered back to back
    local = torch.full_like(table, -1)
    matched = torch.zeros_like(table, dtype=torch.bool)
    plan = [[] for _ in range(3)]
    for s, e, base, _, nblk, dest in _spans(rowstart, tiles_x, NT, R, NB):
        offs = table - base[:, None] * 128
        m = (table >= s[:, None]) & (table < e[:, None]) & (offs < nblk[:, None] * 128)
        local = torch.where(m, dest[:, None] * 128 + offs, local)
        matched = matched | m
        for lst, v in zip(plan, (base, dest, nblk)):
            lst.append(v)
    overflow_window = torch.sum((table >= 0) & ~matched).to(i32)
    table_local = local.reshape(NT, K // 128, 128)
    return (G_s, table, table_local, counts, *(_flat(c) for c in plan), starts[NT],
            overflow_rect.to(i32), overflow_tile, overflow_window, overflow_big.to(i32))


def windowed_occupancy(means3d, opacities, scales, quats, camera: Camera,
                       cfg: RasterizeConfig, active_mask=None) -> dict:
    """How many rows each windowed-path buffer needs for this scene and
    camera (`sags_tpu.ops.rasterize.windowed_occupancy`): the selection of
    `_prepare_windowed` without rows, pair sorts or features. Returns a dict
    of int32 device scalars ("store" a [n_store_tiers] vector)."""
    P = means3d.shape[0]
    dev = means3d.device
    tiles_x = -(-camera.width // cfg.tile)
    tiles_y = -(-camera.height // cfg.tile)
    NT = tiles_x * tiles_y
    R = int(round(cfg.max_tiles_per_gaussian ** 0.5))
    if R * R != cfg.max_tiles_per_gaussian:
        raise ValueError("max_tiles_per_gaussian must be a perfect square")
    i32 = torch.int32
    pre = project(means3d, opacities, scales, quats, camera, cfg,
                  active_mask=active_mask)
    rw = pre.rmax_x - pre.rmin_x
    rh = pre.rmax_y - pre.rmin_y
    maxside = torch.maximum(rw, rh)
    use_store = int(cfg.windowed_big_capacity) > 0 and int(cfg.windowed_store_max_rect) > R

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    excl = torch.zeros(P, dtype=torch.bool, device=dev)
    n_store, n_copy, n_ring, anchors = [], zero, zero, []
    prev_cap = R
    if use_store:
        for cap_t, _ in cfg.windowed_store_fracs:
            if cap_t <= R:
                continue
            cap_t = min(cap_t, int(cfg.windowed_store_max_rect))
            sel = pre.valid & (maxside > prev_cap) & (maxside <= cap_t)
            prev_cap = cap_t
            n_store.append(sel.sum())
            excl = excl | sel
            for gy in range(-(-cap_t // R)):
                for gx in range(-(-cap_t // R)):
                    vx, vy = gx * R, gy * R
                    cval = sel & (vx < rw) & (vy < rh)
                    n_copy = n_copy + cval.sum()
                    sw = torch.clamp(rw - vx, 0, R)
                    sh = torch.clamp(rh - vy, 0, R)
                    n_ring = n_ring + (cval & ((sw > 2) | (sh > 2))).sum()
                    anc = (pre.rmin_y + vy) * tiles_x + (pre.rmin_x + vx)
                    anchors.append(torch.where(cval, anc, NT))
    pv = pre.valid & ~excl
    n_mid = (pv & ((rw > 2) | (rh > 2)) & (rw <= 3) & (rh <= 3)).sum()
    n_big = (pv & ((rw > 3) | (rh > 3))).sum()
    anchors.append(torch.where(pv, pre.rmin_y * tiles_x + pre.rmin_x, NT))
    hist = torch.bincount(torch.cat(anchors).long(), minlength=NT + 1)
    rowstart = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(hist[:NT], 0)])
    need_total = sum(need for _, _, _, need, _, _ in _spans(rowstart, tiles_x, NT, R))
    return {
        "live_parents": pv.sum().to(i32),
        "live_copies": n_copy.to(i32),
        "n_mid": n_mid.to(i32),
        "n_big": n_big.to(i32),
        "n_ring": n_ring.to(i32),
        "store": (torch.stack(n_store) if n_store else torch.zeros(0, device=dev)).to(i32),
        "window_blocks_need": need_total.max().to(i32),
        # widest live rect (tiles): the R the classic path needs
        "max_rect_side": torch.where(pre.valid, maxside, 0).max().to(i32),
    }


def derive_windowed_budgets(cfg: RasterizeConfig, occ: dict, P: int,
                            margin: float = 1.05) -> RasterizeConfig:
    """A config whose windowed buffers hold ceil(margin × measured need) rows
    (128-aligned where the buffer is) of a fetched `windowed_occupancy`
    (`sags_tpu.ops.rasterize.derive_windowed_budgets`)."""
    R = int(round(cfg.max_tiles_per_gaussian ** 0.5))
    R_STORE = int(cfg.windowed_store_max_rect)
    use_store = int(cfg.windowed_big_capacity) > 0 and R_STORE > R

    def _need(n, align=128):
        return max(-(-int(round(int(n) * margin)) // align) * align, align)

    store = [int(x) for x in occ["store"]]
    fracs, n_copies_static, si = [], 0, 0
    for cap_t, frac_t in cfg.windowed_store_fracs:
        if cap_t <= R or not use_store:
            fracs.append((cap_t, frac_t))
            continue
        need = min(_need(store[si]), P)
        si += 1
        fracs.append((cap_t, (need + 0.5) / P))
        side = -(-min(cap_t, R_STORE) // R)
        n_copies_static += side * side * need
    P_all = P + n_copies_static
    pe_need = min(_need(int(occ["live_parents"]) + int(occ["live_copies"])), P_all)
    ring_need = min(int(round(int(occ["n_ring"]) * margin)) + 1, max(n_copies_static, 1))
    # R == 3 has no big tier: the mid tier takes every rect > 2 row
    mid_need = int(occ["n_mid"]) + (int(occ["n_big"]) if R == 3 else 0)
    return dataclasses.replace(
        cfg,
        windowed_store_fracs=tuple(fracs),
        windowed_mid_frac=(min(_need(mid_need), P) + 0.5) / P,
        windowed_big_frac=(min(_need(occ["n_big"]), P) + 0.5) / P,
        windowed_copy_ring_frac=(min((ring_need + 0.5) / n_copies_static, 1.0)
                                 if n_copies_static else cfg.windowed_copy_ring_frac),
        windowed_expand_frac=min(pe_need / max(P_all, 1), 1.0),
        window_blocks=max(int(occ["window_blocks_need"]), 2 * R),
    )


def _windowed_chunk(cfg: RasterizeConfig) -> int:
    """`windowed_chunk`, clamped to a multiple of 128 dividing tile_capacity."""
    K_TILE = cfg.tile_capacity
    K_chunk = int(cfg.windowed_chunk)
    if K_chunk % 128 != 0 or K_TILE % K_chunk != 0:
        K_chunk = 256 if K_TILE % 256 == 0 else 128
    return min(K_chunk, K_TILE)


def _check_windowed_options(cfg: RasterizeConfig) -> None:
    if cfg.ewa_impl not in win.EWA:
        raise ValueError(f"ewa_impl {cfg.ewa_impl!r} is not one of {sorted(win.EWA)}")
    if cfg.feature_precision not in win.PREC:
        raise ValueError(f"feature_precision {cfg.feature_precision!r} is not one of "
                         f"{sorted(win.PREC)}")
    if cfg.window_ablate:
        raise NotImplementedError(
            f"window_ablate={cfg.window_ablate!r} (a TPU timing diagnostic of the "
            "windowed render) is not ported: ROADMAP.md A.8")


def _windowed_kw(cfg: RasterizeConfig) -> dict:
    return dict(alpha_min=cfg.alpha_min, t_min=cfg.transmittance_min,
                chunk=_windowed_chunk(cfg),
                n_span=int(round(cfg.max_tiles_per_gaussian ** 0.5)))


class _CompositeWindowedFn(torch.autograd.Function):
    """Windowed compositor over the host-built work list (the custom VJP of
    `sags_tpu/ops/rasterize.py:1283-1417`). Backward: the windowed backward
    kernel, then the deterministic scatter of the per-pair gradients by
    global sorted-row id (`table_rows`); under `windowed_bf16` or
    `pallas_backward=False`, the exact recompute through the classic
    compositor (forward at `cfg.chunk` for its own T_final, backward) over
    the entries the window kept. Columns 32.. of dG_s are zero. The tiles
    are `tile_offset`.. of the grid, in every route."""

    @staticmethod
    def forward(ctx, G_s, table_rows, table_local, counts, bases, dests, nblks, n_feat,
                tiles_x, cfg, tile_offset):
        bf16_obj = bool(cfg.windowed_bf16) and G_s.shape[1] >= win.BF16_CH
        acc, T = win.composite_windowed(
            G_s, table_local, counts, bases, dests, nblks, cfg.tile, tiles_x,
            tile_offset=tile_offset, ewa_impl=cfg.ewa_impl,
            feat_prec=cfg.feature_precision, bf16_obj=bf16_obj, **_windowed_kw(cfg))
        ctx.save_for_backward(G_s, table_rows, table_local, counts, bases, dests, nblks, T)
        ctx.meta = (n_feat, tiles_x, cfg, bf16_obj, acc.shape[-1], tile_offset)
        return acc[..., :n_feat], T

    @staticmethod
    def backward(ctx, d_acc, d_T):
        with span("raster.composite_bwd", device=ctx.saved_tensors[0].device):
            return _CompositeWindowedFn._backward(ctx, d_acc, d_T)

    @staticmethod
    def _backward(ctx, d_acc, d_T):
        G_s, table_rows, table_local, counts, bases, dests, nblks, T = ctx.saved_tensors
        n_feat, tiles_x, cfg, bf16_obj, CF, toff = ctx.meta
        NT, PIX = T.shape
        d_acc_full = torch.zeros((NT, PIX, CF), dtype=torch.float32, device=G_s.device)
        if d_acc is not None:
            d_acc_full[..., :n_feat] = d_acc
        d_T = torch.zeros_like(T) if d_T is None else d_T.contiguous()
        P_all = G_s.shape[0]
        if bf16_obj or not cfg.pallas_backward:
            # only the entries the windowed forward composited: a slot the
            # window dropped (table_local −1) takes no gradient
            table = torch.where(table_local.reshape(NT, -1) >= 0, table_rows, -1)
            G32 = G_s[:, :win.KERNEL_CH].contiguous()
            _, T_re = comp.composite_fused(G32, table, counts, cfg.tile, tiles_x,
                                           alpha_min=cfg.alpha_min,
                                           t_min=cfg.transmittance_min, chunk=cfg.chunk,
                                           tile_offset=toff)
            dGt = comp.composite_fused_bwd(G32, table, counts, d_acc_full, d_T, T_re,
                                           cfg.tile, tiles_x, alpha_min=cfg.alpha_min,
                                           t_min=cfg.transmittance_min, chunk=cfg.chunk,
                                           tile_offset=toff)
        else:
            table = table_rows
            dGt = win.composite_windowed_bwd(G_s, table_local, counts, bases, dests, nblks,
                                             d_acc_full, d_T, T, cfg.tile, tiles_x,
                                             tile_offset=toff, **_windowed_kw(cfg))
        dG = comp.scatter_rows(dGt, table, P_all)
        dG_s = torch.cat([dG, dG.new_zeros((P_all, G_s.shape[1] - dG.shape[1]))], dim=1)
        return dG_s, None, None, None, None, None, None, None, None, None, None


def _composite_windowed_sharded(G_s, table_rows, table_local, counts, bases, dests,
                                nblks, n_feat, tiles_x, cfg: RasterizeConfig, mesh):
    """Multi-device windowed compositing (`sags_tpu/ops/rasterize.py:1465-1517`):
    each rank runs the windowed kernels on its contiguous tile slice at its
    tile offset. The anchor-sorted store `G_s` stays replicated (every
    rank's spans index the one global store) and the per-tile plan is
    sharded; padded tiles have counts 0, empty tables and no spans. Each
    rank's dG_s scatter is summed over the ranks, before autograd folds the
    slice-store copies back onto their parents."""
    NT = table_rows.shape[0]
    R = bases.numel() // NT
    _, lo, _ = tile_sharding(mesh, NT)
    b, d, n = (shard_tiles(x.reshape(NT, R), mesh).reshape(-1) for x in (bases, dests, nblks))
    acc, T = _CompositeWindowedFn.apply(
        replicated(G_s, mesh), shard_tiles(table_rows, mesh, -1),
        shard_tiles(table_local, mesh, -1), shard_tiles(counts, mesh), b, d, n, n_feat,
        tiles_x, cfg, lo)
    return gather_tiles(acc, mesh, NT), gather_tiles(T, mesh, NT)


class _CompositeWindowedSortedFn(torch.autograd.Function):
    """Windowed compositor with the depth order built in the kernel: a
    render path, not differentiable (as in the JAX package)."""

    @staticmethod
    def forward(ctx, G_s, bases, dests, nblks, sstarts, sends, n_feat, tiles_x, cfg):
        acc, T, nv = win.composite_windowed_sorted(
            G_s, bases, dests, nblks, sstarts, sends, cfg.tile, tiles_x,
            w_blocks=cfg.window_blocks, k_tile=cfg.tile_capacity, ewa_impl=cfg.ewa_impl,
            feat_prec=cfg.feature_precision, **_windowed_kw(cfg))
        ctx.mark_non_differentiable(nv)
        return acc[..., :n_feat], T, nv

    @staticmethod
    def backward(ctx, d_acc, d_T, d_nv):
        raise NotImplementedError(
            "windowed_sort='kernel' renders only (not differentiable); "
            "train with windowed=False")


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
              cov3d_precomp=None, active_mask=None, mean2d_offset=None, mesh=None,
              fused: Optional[bool] = None,
              windowed: Optional[bool] = None) -> RenderOutput:
    """Render Gaussians (`sags_tpu.ops.rasterize`). `windowed=None` follows
    `cfg.windowed`; the windowed path runs when the shapes allow it (tile
    capacity a multiple of 128, a square R×R window, 16 object channels),
    else the classic one. Both are differentiable w.r.t. means3d, opacities,
    scales, quats, colors/shs, obj_features and `mean2d_offset` (see
    `preprocess`), except the windowed path with `windowed_sort="kernel"`,
    which renders only. Runs where its inputs live; CUDA tensors go through
    the CUDA kernels.

    `fused=False` forces the classic path, as in the JAX package. There it
    also swaps the Pallas forward for the XLA scan, because its Pallas
    forward's VJP recomputes through XLA, so a training step would pay for
    both. Here the classic forward kernel has a backward kernel of its own,
    so the classic path launches `composite_fused` and `composite_fused_bwd`
    on CUDA tensors whatever `fused` says.

    `mesh` (`parallel.mesh.make_mesh`) shards the compositor's tiles over its
    ranks (`_composite_sharded`, `_composite_windowed_sharded`); everything
    else runs replicated on every rank. Under a mesh `windowed_sort="kernel"`
    renders through the host table, as the JAX package does
    (`sags_tpu/ops/rasterize.py:1765`): that is the reference's behaviour
    there, not a fallback."""
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

    with span("raster.preprocess"):
        pre = project(means3d, opacities, scales, quats, camera, cfg,
                      colors=colors, shs=shs, sh_degree=sh_degree,
                      cov3d_precomp=cov3d_precomp, active_mask=active_mask,
                      mean2d_offset=mean2d_offset)
    n_feat = 3 + O + 4
    R = int(round(cfg.max_tiles_per_gaussian ** 0.5))
    use_windowed = bool(
        (cfg.windowed if windowed is None else windowed)
        and fused is not False
        and cfg.tile_capacity % 128 == 0
        and R * R == cfg.max_tiles_per_gaussian
        and cfg.tile * cfg.tile >= 8
        # the windowed row layout is the SLAM feature set's: 16 obj channels
        and O == 16)
    use_kernel_sort = (use_windowed and cfg.windowed_sort == "kernel" and mesh is None
                       and not cfg.windowed_bf16 and cfg.window_blocks <= 16
                       and cfg.tile_capacity <= 16 * 128)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ov_win = ov_big = zero
    table = counts = None
    if use_windowed:
        _check_windowed_options(cfg)
    if use_kernel_sort:
        with span("raster.prepare_windowed"):
            (G_s, bases, dests, nblks, sstarts, sends, ov_rect, ov_win,
             ov_big) = _prepare_windowed(pre, obj_features, tiles_x, tiles_y, cfg,
                                         build_table=False)
        with span("raster.composite", device=dev):
            accum, T_final, nv = _CompositeWindowedSortedFn.apply(
                G_s, bases, dests, nblks, sstarts, sends, n_feat, tiles_x, cfg)
        ov_tile = torch.sum(torch.clamp(nv - cfg.tile_capacity, min=0))
        n_binned = torch.sum(nv)
        tile_peak = torch.max(nv)  # the unclamped need
        ov_tile_live = ov_tile  # render path: no live/dead split
    elif use_windowed:
        with span("raster.prepare_windowed"):
            (G_s, wtable, table_local, wcounts, bases, dests, nblks, n_binned, ov_rect,
             ov_tile, ov_win, ov_big) = _prepare_windowed(pre, obj_features, tiles_x,
                                                          tiles_y, cfg)
        with span("raster.composite", device=dev):
            if mesh is None:
                accum, T_final = _CompositeWindowedFn.apply(
                    G_s, wtable, table_local, wcounts, bases, dests, nblks, n_feat,
                    tiles_x, cfg, 0)
            else:
                accum, T_final = _composite_windowed_sharded(
                    G_s, wtable, table_local, wcounts, bases, dests, nblks, n_feat,
                    tiles_x, cfg, mesh)
        tile_peak = torch.max(wcounts)
        ov_tile_live = ov_tile  # as in the JAX package: no live/dead split
    else:
        table, counts, n_binned, ov_rect, ov_tile, seg = bin_gaussians(
            pre, tiles_x, tiles_y, cfg)
        with span("raster.composite", device=dev):
            G = _pack_gaussians(pre, obj_features)
            accum, T_final, px, py = composite(table, counts, G, n_feat, tiles_x, tiles_y,
                                               cfg, mesh)
        # transmittance-aware overflow accounting (see the JAX package)
        saturated = torch.all(T_final.detach() < 10.0 * cfg.transmittance_min, dim=1)
        truncated = seg > cfg.tile_capacity
        over = torch.clamp(seg - cfg.tile_capacity, min=0)
        ov_tile_live = torch.sum(torch.where(~saturated, over, torch.zeros_like(over)))
        need_known = torch.where(saturated & truncated, torch.zeros_like(seg), seg)
        tile_peak = torch.max(need_known)
    if use_windowed:
        px, py = comp.tile_pixel_coords(tiles_x * tiles_y, tiles_x, cfg.tile, 0, dev)

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
        # the classic binning's table; the windowed paths bin anew, as
        # `contribution_mask(pre, ...)` does in the JAX package
        def is_used_fn():
            return contribution_mask(pre, tiles_x, tiles_y, cfg, table, counts)
    else:
        def is_used_fn():
            return pre.valid

    return RenderOutput(
        color=color_img.permute(2, 0, 1),
        depth=depth_img.permute(2, 0, 1),
        objects=obj_img.permute(2, 0, 1),
        alpha=alpha_img.permute(2, 0, 1),
        final_T=T_img[..., 0],
        radii=pre.radius,
        n_binned=n_binned.to(torch.int32),
        overflow_rect=ov_rect.to(torch.int32),
        overflow_tile=ov_tile.to(torch.int32),
        overflow_window=ov_win.to(torch.int32),
        overflow_big=ov_big.to(torch.int32),
        tile_peak=tile_peak.to(torch.int32),
        overflow_tile_live=ov_tile_live.to(torch.int32),
        _is_used_fn=is_used_fn,
    )


def mark_visible(means3d: torch.Tensor, camera: Camera, near: float = 0.2) -> torch.Tensor:
    """`markVisible` (`rasterize_points.cu:218-237`): view depth above `near`."""
    V = camera.world_view
    z = means3d @ V[2, :3] + V[2, 3]
    return z > near
