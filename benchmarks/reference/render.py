"""Plain PyTorch Gaussian-splat rendering: the semantics the port's
rasterizer states, written out without its tables' tricks, kernels or
culls beyond the configuration's own caps.

Per Gaussian: the EWA projection with the 0.3-pixel low-pass, the conic,
and the tile rectangle in which its alpha can reach `alpha_min` (the
configuration's `tight_rect`). Per tile: every Gaussian whose rectangle
covers it within the R×R window from the rectangle's first tile
(`max_tiles_per_gaussian` = R²) and whose alpha can reach the gate in the
tile, in (16-bit depth bucket, Gaussian id) order, cut at `tile_capacity`.
Per pixel: front-to-back alpha blending in chunks of `chunk` pairs; a pair
whose blend would take the pixel's transmittance under `transmittance_min`
is skipped, and the next chunk starts from the transmittance carried so
far. The feature sums are batched matrix products, so the TF32 control
(`torch.backends.cuda.matmul.allow_tf32`) rounds them as a TF32 program
would.

Imports nothing of the port. Every function takes and returns tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

C0 = 0.28209479177387814  # degree-0 spherical harmonic


class Precision:
    """`tf32` rounds every matrix product's inputs to TF32 (10 mantissa
    bits, to nearest), as TF32 tensor cores do, the products accumulating in
    float32: the control. cuBLAS may keep a float32 product on its FFMA path
    whatever the TF32 switches say, so the rounding is written out."""

    tf32 = False


def mm_in(x: torch.Tensor) -> torch.Tensor:
    """A matrix product's input as the configured precision takes it (the
    backward's products stay float32)."""
    if not Precision.tf32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()  # the gradient passes as through float32


@dataclasses.dataclass(frozen=True)
class Raster:
    """The configuration's caps and constants (a cell's `raster` block)."""

    tile: int = 16
    max_tiles_per_gaussian: int = 36
    tile_capacity: int = 1024
    chunk: int = 64
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4
    low_pass: float = 0.3
    near: float = 0.2
    bg_depth: float = 15.0

    @classmethod
    def from_config(cls, raster: dict) -> "Raster":
        return cls(**{f.name: raster[f.name] for f in dataclasses.fields(cls)})


class Cam(NamedTuple):
    width: int
    height: int
    fovx: float
    fovy: float
    view: torch.Tensor  # [4,4] world → view
    proj: torch.Tensor  # [4,4] projection @ view


def camera(pose: torch.Tensor, width: int, height: int, fx: float, fy: float,
           znear: float = 0.01, zfar: float = 100.0) -> Cam:
    """Pinhole camera of a camera-to-world pose; focal lengths in pixels at
    this width and height; OpenGL-style projection with z in [0, 1]."""
    fovx = 2.0 * math.atan(width / (2.0 * fx))
    fovy = 2.0 * math.atan(height / (2.0 * fy))
    R, t = pose[:3, :3], pose[:3, 3]
    V = torch.eye(4, dtype=torch.float32, device=pose.device)
    V[:3, :3] = R.T
    V[:3, 3] = -(R.T @ t)
    top = math.tan(fovy / 2.0) * znear
    right = math.tan(fovx / 2.0) * znear
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P = torch.as_tensor(P, device=pose.device)
    return Cam(width, height, fovx, fovy, V, P @ V)


class Projected(NamedTuple):
    mx: torch.Tensor
    my: torch.Tensor
    depth: torch.Tensor
    ca: torch.Tensor
    cb: torch.Tensor
    cc: torch.Tensor
    czx: torch.Tensor
    cyz: torch.Tensor
    rect: torch.Tensor  # [P,4] int64 x0, y0, x1, y1 (tiles, end exclusive)
    valid: torch.Tensor


def project(xyz, opacity, scales, quats, cam: Cam, r: Raster) -> Projected:
    """EWA projection of every Gaussian. `quats` xyzw, unit length.
    Written element by element: the tile rectangles and depth buckets are
    step functions of these values, so their rounding is the rounding of
    the formula as stated."""
    W, H = cam.width, cam.height
    tx_n, ty_n = -(-W // r.tile), -(-H // r.tile)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    V, M = cam.view, cam.proj
    tvx = V[0, 0] * x + V[0, 1] * y + V[0, 2] * z + V[0, 3]
    tvy = V[1, 0] * x + V[1, 1] * y + V[1, 2] * z + V[1, 3]
    depth = V[2, 0] * x + V[2, 1] * y + V[2, 2] * z + V[2, 3]
    hx = M[0, 0] * x + M[0, 1] * y + M[0, 2] * z + M[0, 3]
    hy = M[1, 0] * x + M[1, 1] * y + M[1, 2] * z + M[1, 3]
    hw = M[3, 0] * x + M[3, 1] * y + M[3, 2] * z + M[3, 3]
    inv_w = 1.0 / (hw + 1e-7)
    mx = ((hx * inv_w + 1.0) * W - 1.0) * 0.5
    my = ((hy * inv_w + 1.0) * H - 1.0) * 0.5

    qx, qy, qz, qw = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    Rm = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
          [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
          [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)]]
    v = [scales[:, i] ** 2 for i in range(3)]

    def s3(i, j):  # Σ3D = R diag(s²) Rᵀ
        return Rm[i][0] * Rm[j][0] * v[0] + Rm[i][1] * Rm[j][1] * v[1] + Rm[i][2] * Rm[j][2] * v[2]

    S = [[s3(i, j) for j in range(3)] for i in range(3)]
    Rv = [[V[i, k] for k in range(3)] for i in range(3)]
    A = [[sum(Rv[i][k] * S[k][j] for k in range(3)) for j in range(3)] for i in range(3)]

    def c3(i, j):  # view-space Σ = Rv Σ3D Rvᵀ
        return sum(A[i][k] * Rv[j][k] for k in range(3))

    C00, C01, C02, C11, C12, C22 = c3(0, 0), c3(0, 1), c3(0, 2), c3(1, 1), c3(1, 2), c3(2, 2)
    fx = W / (2.0 * math.tan(cam.fovx * 0.5))
    fy = H / (2.0 * math.tan(cam.fovy * 0.5))
    safe_z = torch.where(torch.abs(depth) < 1e-6, torch.full_like(depth, 1e-6), depth)
    lim_x, lim_y = 1.3 * math.tan(cam.fovx * 0.5), 1.3 * math.tan(cam.fovy * 0.5)
    txc = torch.clamp(tvx / safe_z, -lim_x, lim_x) * depth
    tyc = torch.clamp(tvy / safe_z, -lim_y, lim_y) * depth
    inv_z = 1.0 / safe_z
    j00, j02 = fx * inv_z, -fx * txc * inv_z * inv_z
    j11, j12 = fy * inv_z, -fy * tyc * inv_z * inv_z
    cxx = j00 * j00 * C00 + 2 * j00 * j02 * C02 + j02 * j02 * C22 + r.low_pass
    cyy = j11 * j11 * C11 + 2 * j11 * j12 * C12 + j12 * j12 * C22 + r.low_pass
    cxy = j00 * (j11 * C01 + j12 * C02) + j02 * (j11 * C12 + j12 * C22)
    czx = j00 * C02 + j02 * C22
    cyz = j11 * C12 + j12 * C22
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    ca, cb, cc = cyy * inv_det, -cxy * inv_det, cxx * inv_det

    # the rectangle of tiles where op·exp(-q/2) ≥ alpha_min can hold
    with torch.no_grad():
        mid = 0.5 * (cxx + cyy)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        c2 = torch.clamp(2.0 * lam * torch.log(torch.clamp(opacity / r.alpha_min, min=1e-12)),
                         min=0.0) / torch.clamp(lam, min=1e-12)
        w_x = torch.sqrt(c2 * torch.clamp(cxx, min=0.0))
        w_y = torch.sqrt(c2 * torch.clamp(cyy, min=0.0))
        t = float(r.tile)
        x0 = torch.clamp(torch.floor((mx - w_x) / t), 0, tx_n)
        y0 = torch.clamp(torch.floor((my - w_y) / t), 0, ty_n)
        x1 = torch.clamp(torch.floor((mx + w_x) / t) + 1, 0, tx_n)
        y1 = torch.clamp(torch.floor((my + w_y) / t) + 1, 0, ty_n)
        rect = torch.stack([x0, y0, x1, y1], -1).to(torch.int64)
        valid = (depth > r.near) & det_ok & ((x1 - x0) * (y1 - y0) > 0)
    return Projected(mx, my, depth, ca, cb, cc, czx, cyz, rect, valid)


def _box_qmin(a, b, c, x0, x1, y0, y1):
    """Least a·x² + 2b·xy + c·y² over the box of offsets [x0,x1]×[y0,y1]."""
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    a_s, c_s = torch.clamp(a, min=1e-12), torch.clamp(c, min=1e-12)

    def edge_x(xf):
        dy = torch.minimum(torch.maximum(-b * xf / c_s, y0), y1)
        return a * xf * xf + 2.0 * b * xf * dy + c * dy * dy

    def edge_y(yf):
        dx = torch.minimum(torch.maximum(-b * yf / a_s, x0), x1)
        return a * dx * dx + 2.0 * b * dx * yf + c * yf * yf

    q = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                      torch.minimum(edge_y(y0), edge_y(y1)))
    return torch.where(inside, torch.zeros_like(q), q)


def bin_tiles(pr: Projected, opacity, W: int, H: int, r: Raster):
    """Per-tile depth-ordered Gaussian ids under the caps.
    Returns (table [NT,K] int64, -1 padded; counts [NT]; binned pairs before
    the capacity cut [NT])."""
    P = pr.mx.shape[0]
    dev = pr.mx.device
    tx_n, ty_n = -(-W // r.tile), -(-H // r.tile)
    NT, K = tx_n * ty_n, r.tile_capacity
    R = int(round(math.sqrt(r.max_tiles_per_gaussian)))
    with torch.no_grad():
        depth = pr.depth
        big = torch.full((), 3e38, device=dev)
        dmin = torch.min(torch.where(pr.valid, depth, big))
        dmax = torch.max(torch.where(pr.valid, depth, -big))
        dq = torch.clamp((depth - dmin) / torch.clamp(dmax - dmin, min=1e-9) * 65535.0,
                         0.0, 65535.0).to(torch.int64)
        am = torch.full((), r.alpha_min, device=dev)
        level = torch.clamp(2.0 * torch.log(torch.clamp(opacity.detach() / am, min=1e-12)),
                            min=0.0) * (1.0 + 1e-5) + 1e-6
        x0, y0, x1, y1 = pr.rect.unbind(-1)
        a, b, c = pr.ca.detach(), pr.cb.detach(), pr.cc.detach()
        mx, my = pr.mx.detach(), pr.my.detach()
        T = float(r.tile)
        keys = []
        for j in range(R * R):
            dx, dy = j % R, j // R
            tx, ty = x0 + dx, y0 + dy
            ok = pr.valid & (tx < x1) & (ty < y1)
            txf, tyf = tx.to(torch.float32), ty.to(torch.float32)
            q = _box_qmin(a, b, c, txf * T - mx, txf * T + (T - 1.0) - mx,
                          tyf * T - my, tyf * T + (T - 1.0) - my)
            ok = ok & (q <= level)
            keys.append(torch.where(ok, (ty * tx_n + tx) << 16 | dq,
                                    torch.full_like(dq, NT << 16)))
        key = torch.stack(keys).reshape(-1)
        gid = torch.arange(P, device=dev).repeat(R * R)
        order = torch.sort((key << 32) | gid).values
        tile_s = order >> 48
        gid_s = order & 0xFFFFFFFF
        starts = torch.searchsorted(tile_s, torch.arange(NT + 1, device=dev))
        seg = starts[1:] - starts[:-1]
        counts = torch.clamp(seg, max=K)
        k = torch.arange(K, device=dev)
        idx = starts[:NT, None] + k[None, :]
        keep = k[None, :] < counts[:, None]
        table = torch.where(keep, gid_s[torch.clamp(idx, max=max(len(gid_s) - 1, 0))],
                            torch.full_like(idx, -1))
    return table, counts, seg


def pack(pr: Projected, opacity, colors, obj):
    """[P, 6 + 23] rows: mx my ca cb cc op | rgb obj dz0 A B 1."""
    A = pr.czx * pr.ca + pr.cyz * pr.cb
    B = pr.czx * pr.cb + pr.cyz * pr.cc
    dz0 = pr.depth - A * pr.mx - B * pr.my
    one = torch.ones_like(dz0)
    return torch.cat([torch.stack([pr.mx, pr.my, pr.ca, pr.cb, pr.cc, opacity], -1),
                      colors, obj, torch.stack([dz0, A, B, one], -1)], -1)


def pixel_coords(tiles, tx_n: int, tile: int):
    """Pixel-centre coordinates [n, tile²] of the given tile ids."""
    lin = torch.arange(tile * tile, device=tiles.device)
    px = ((tiles % tx_n) * tile)[:, None] + (lin % tile)[None, :]
    py = ((tiles // tx_n) * tile)[:, None] + (lin // tile)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def composite_tiles(G, table, counts, tiles, tx_n: int, r: Raster, count_live=False):
    """Blend the tiles `tiles` (ids [n]); `table`, `counts` their rows.
    Returns (acc [n, tile², 23], T [n, tile²]) and, with `count_live`, the
    number of live (pixel, Gaussian) pairs: those blended."""
    n, K = table.shape
    px, py = pixel_coords(tiles, tx_n, r.tile)
    T = torch.ones_like(px)
    acc = torch.zeros((n, px.shape[1], G.shape[1] - 6), device=G.device)
    rank = torch.arange(K, device=G.device)
    live = torch.zeros((), dtype=torch.int64, device=G.device)
    top = int(counts.max()) if n else 0
    for c0 in range(0, top, r.chunk):
        gid = table[:, c0:c0 + r.chunk]
        vm = (rank[None, c0:c0 + r.chunk] < counts[:, None]) & (gid >= 0)
        Gc = G[torch.clamp(gid, min=0)]  # [n, k, 29]
        dx = Gc[:, None, :, 0] - px[:, :, None]
        dy = Gc[:, None, :, 1] - py[:, :, None]
        ca, cb, cc = (Gc[:, None, :, i] for i in (2, 3, 4))
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(Gc[:, None, :, 5] * torch.exp(power), max=0.99)
        gate = (power <= 0.0) & (alpha >= r.alpha_min) & vm[:, None, :]
        a = torch.where(gate, alpha, torch.zeros_like(alpha))
        om = 1.0 - a
        cum = torch.cumprod(om, dim=-1)
        T_exc = T[..., None] * torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], -1)
        m = gate & (T_exc * om >= r.transmittance_min)
        w = torch.where(m, a * T_exc, torch.zeros_like(a))
        acc = acc + torch.bmm(mm_in(w), mm_in(Gc[..., 6:]))
        T = T * torch.prod(torch.where(m, om, torch.ones_like(om)), dim=-1)
        if count_live:
            live = live + m.sum()
    return (acc, T, live) if count_live else (acc, T)


def untile(x, tx_n: int, ty_n: int, tile: int, W: int, H: int):
    """[NT, tile², C] → [C, H, W]."""
    C = x.shape[-1]
    img = x.reshape(ty_n, tx_n, tile, tile, C).permute(0, 2, 1, 3, 4)
    return img.reshape(ty_n * tile, tx_n * tile, C)[:H, :W].permute(2, 0, 1)


class Gaussians(NamedTuple):
    """Activated parameters of the Gaussians to render."""

    xyz: torch.Tensor
    opacity: torch.Tensor  # [P] in (0, 1)
    scales: torch.Tensor  # [P,3]
    quats: torch.Tensor  # [P,4] xyzw, unit
    colors: torch.Tensor  # [P,3]
    obj: torch.Tensor  # [P,16]
    active: torch.Tensor  # [P] bool


def activate(xyz, f_dc, log_scales, quats, opacity_logit, obj_dc, active) -> Gaussians:
    """The map's stored parameters → what is rendered: sigmoid opacity,
    exp scales, unit quaternions, degree-0 colour C0·f_dc + 0.5 floored at 0."""
    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True).clamp(min=1e-12)
    return Gaussians(xyz, torch.sigmoid(opacity_logit), torch.exp(log_scales), q,
                     torch.clamp(C0 * f_dc + 0.5, min=0.0), obj_dc, active)


class Frame(NamedTuple):
    color: torch.Tensor  # [3,H,W]
    objects: torch.Tensor  # [O,H,W]
    depth: torch.Tensor  # [1,H,W]
    alpha: torch.Tensor  # [1,H,W]
    live_pairs: int
    binned_pairs: int  # after the capacity cut
    gaussians_binned: int  # distinct Gaussians in the tables


def _prepare(g: Gaussians, cam: Cam, r: Raster):
    pr = project(g.xyz, g.opacity, g.scales, g.quats, cam, r)
    pr = pr._replace(valid=pr.valid & g.active)
    table, counts, _ = bin_tiles(pr, g.opacity, cam.width, cam.height, r)
    return pr, table, counts


def _assemble(acc, T, cam: Cam, r: Raster, n_obj: int):
    tx_n, ty_n = -(-cam.width // r.tile), -(-cam.height // r.tile)
    NT = tx_n * ty_n
    px, py = pixel_coords(torch.arange(NT, device=acc.device), tx_n, r.tile)
    un = lambda x: untile(x, tx_n, ty_n, r.tile, cam.width, cam.height)
    o = 3 + n_obj
    depth = acc[..., o] + px * acc[..., o + 1] + py * acc[..., o + 2] + T * r.bg_depth
    return (un(acc[..., :3]), un(acc[..., 3:o]), un(depth[..., None]),
            un(acc[..., o + 3:o + 4]))


def render(g: Gaussians, cam: Cam, r: Raster, block: int = 64,
           count_live: bool = False) -> Frame:
    """The image of `g` at `cam` (black background), tiles in blocks of
    `block` so that the pair tensors fit. No gradient."""
    with torch.no_grad():
        pr, table, counts = _prepare(g, cam, r)
        G = pack(pr, g.opacity, g.colors, g.obj)
        acc, T, live = _blocks(G, table, counts, cam, r, block, count_live)
        color, obj, depth, alpha = _assemble(acc, T, cam, r, g.obj.shape[1])
        used = table[table >= 0]
        return Frame(color, obj, depth, alpha, int(live), int(used.numel()),
                     int(torch.unique(used).numel()))


def _blocks(G, table, counts, cam: Cam, r: Raster, block: int, count_live: bool):
    tx_n = -(-cam.width // r.tile)
    NT = table.shape[0]
    accs, Ts, live = [], [], 0
    for t0 in range(0, NT, block):
        tiles = torch.arange(t0, min(t0 + block, NT), device=G.device)
        out = composite_tiles(G, table[t0:t0 + block], counts[t0:t0 + block], tiles,
                              tx_n, r, count_live)
        accs.append(out[0])
        Ts.append(out[1])
        if count_live:
            live += int(out[2])
    return torch.cat(accs), torch.cat(Ts), live


def render_with_grad(g: Gaussians, cam: Cam, r: Raster, loss_fn, block: int = 64):
    """Render, evaluate `loss_fn(color, objects)` and back-propagate into
    the leaves of `g` (whatever requires grad), a block of tiles at a time:
    the blend is recomputed per block with the image's cotangent. Returns
    (loss, color)."""
    pr, table, counts = _prepare(g, cam, r)
    G = pack(pr, g.opacity, g.colors, g.obj)
    Gd = G.detach().requires_grad_(True)
    with torch.no_grad():
        acc, T, _ = _blocks(Gd, table, counts, cam, r, block, False)
    acc_l = acc.requires_grad_(True)
    T_l = T.requires_grad_(True)
    with torch.enable_grad():
        color, obj, _, _ = _assemble(acc_l, T_l, cam, r, g.obj.shape[1])
        loss = loss_fn(color, obj)
        d_acc, d_T = torch.autograd.grad(loss, (acc_l, T_l), allow_unused=True)
        if d_T is None:
            d_T = torch.zeros_like(T)
        tx_n = -(-cam.width // r.tile)
        for t0 in range(0, table.shape[0], block):
            tiles = torch.arange(t0, min(t0 + block, table.shape[0]), device=G.device)
            a_b, T_b = composite_tiles(Gd, table[t0:t0 + block], counts[t0:t0 + block],
                                       tiles, tx_n, r)
            if a_b.requires_grad:  # a block no Gaussian touches has no graph
                torch.autograd.backward([a_b, T_b], [d_acc[t0:t0 + block], d_T[t0:t0 + block]])
        G.backward(Gd.grad)
    return loss.detach(), color.detach()
