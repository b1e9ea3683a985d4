"""Error-state iterated Kalman filter (ESIKF) for LiDAR-inertial(-visual)
odometry (`sags_tpu.ops.esikf` in torch): the FAST-LIO2-style 18-state filter

    x = (R ∈ SO(3), p, v, bg, ba, g),   error state δx ∈ R¹⁸

with IMU mean and covariance propagation, an iterated point-to-plane LiDAR
update against a surfel voxel map, a photometric update against the map's
intensity anchors, and the incremental surfel map itself (per-voxel moment
accumulators on a fixed world grid, folded by one sort and segment sum).

The JAX `lax.scan`s over IMU samples and over the fixed update count are
Python loops of fixed trip count. Nothing here reads a value on the host:
the 18×18 inverse and solve are `inv_ex` / `solve_ex` (no error check), and
the map fold sums each voxel's run of the stably sorted keys in order
(`segment_reduce` over `searchsorted` offsets; not `index_add_`, whose float
sums on CUDA are not deterministic).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sags_tpu_torch import device_constant, resolve_device
from sags_tpu_torch.core.transforms import skew, so3_exp, so3_log
from sags_tpu_torch.ops.gicp import (VoxelMap, _voxel_coords, lookup_voxels,
                                     neighbor_offsets, sym_eig3)

# error-state layout: [dθ(3), dp(3), dv(3), dbg(3), dba(3), dg(3)]
_DIM = 18
_SURFEL_KEY_MAX = 2 ** 31 - 1


class ESIKFState(NamedTuple):
    R: torch.Tensor  # [3,3] body→world
    p: torch.Tensor  # [3]
    v: torch.Tensor  # [3]
    bg: torch.Tensor  # [3] gyro bias
    ba: torch.Tensor  # [3] accel bias
    g: torch.Tensor  # [3] gravity in world (≈ [0,0,-9.81])
    P: torch.Tensor  # [18,18] error covariance


def init_state(R=None, p=None, g=None, P0_rot=1e-4, P0_pos=1e-4, P0_vel=1e-2,
               P0_bias=1e-4, P0_grav=1e-6, device=None) -> ESIKFState:
    dev = resolve_device(device)
    f = lambda x: torch.full((3,), x, dtype=torch.float32, device=dev)
    P = torch.diag(torch.cat([f(P0_rot), f(P0_pos), f(P0_vel), f(P0_bias), f(P0_bias),
                              f(P0_grav)]))
    z = torch.zeros(3, device=dev)
    return ESIKFState(
        R=torch.eye(3, device=dev) if R is None else R,
        p=z if p is None else p, v=z, bg=z, ba=z,
        g=torch.tensor([0.0, 0.0, -9.81], device=dev) if g is None else g, P=P)


def propagate(state: ESIKFState, gyro: torch.Tensor, accel: torch.Tensor,
              dts: torch.Tensor, gyro_noise: float = 1e-3, accel_noise: float = 1e-2,
              bias_gyro_noise: float = 1e-5, bias_accel_noise: float = 1e-4) -> ESIKFState:
    """Mean and covariance propagation over an IMU batch ([M,3] rad/s,
    [M,3] m/s² body specific force, [M] s): forward Euler on the manifold,
    first-order F (the FAST-LIO formulation)."""
    s = state
    dev = s.P.device
    I3 = torch.eye(3, device=dev)
    for k in range(gyro.shape[0]):
        w, a, dt = gyro[k], accel[k], dts[k]
        w_u = w - s.bg
        a_u = a - s.ba
        R_new = s.R @ so3_exp(w_u * dt)
        acc_w = s.R @ a_u + s.g
        p_new = s.p + s.v * dt + 0.5 * acc_w * dt * dt
        v_new = s.v + acc_w * dt

        F = torch.eye(_DIM, device=dev)
        # dθ' = exp(-w dt) dθ − dt·dbg
        F[0:3, 0:3] = so3_exp(-w_u * dt)
        F[0:3, 9:12] = -I3 * dt
        # dp' = dp + dt·dv
        F[3:6, 6:9] = I3 * dt
        # dv' = −R[a]× dθ dt + dv − R dt dba + dt dg
        F[6:9, 0:3] = -s.R @ skew(a_u) * dt
        F[6:9, 12:15] = -s.R * dt
        F[6:9, 15:18] = I3 * dt

        Q = torch.zeros((_DIM, _DIM), device=dev)
        Q[0:3, 0:3] = I3 * gyro_noise ** 2 * dt * dt
        Q[6:9, 6:9] = I3 * accel_noise ** 2 * dt * dt
        Q[9:12, 9:12] = I3 * bias_gyro_noise ** 2 * dt
        Q[12:15, 12:15] = I3 * bias_accel_noise ** 2 * dt

        P_new = F @ s.P @ F.T + Q
        s = s._replace(R=R_new, p=p_new, v=v_new, P=P_new)
    return s


def _prior_inverse(P: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(P + 1e-9 * torch.eye(_DIM, device=P.device))[0]


def _iterate(R0, p0, v0, bg0, ba0, g0, Pinv, rows, inv_r: float, num_iters: int):
    """The fixed-count iterated update shared by the LiDAR and the visual leg:
    `rows(R, p)` gives (r [N], w [N], H [N,18]); each iterate solves the
    information form (Pinv + HᵀWH) dx = HᵀWr + Pinv·(x ⊟ x₀) and applies the
    full error-state correction (the prior couples v/bg/ba/g to R, p). Returns
    the final (R, p, v, bg, ba, g) and the last iterate's (Σw, mean |r|)."""
    R, p, v, bg, ba, g = R0, p0, v0, bg0, ba0, g0
    n_w = mean_r = None
    for _ in range(num_iters):
        r, w, H = rows(R, p)
        Hw = H * (w * inv_r)[:, None]
        A = Pinv + H.T @ Hw
        dtheta = so3_log(R0.T @ R)
        dx_prior = torch.cat([dtheta, p - p0, v - v0, bg - bg0, ba - ba0, g - g0])
        rhs = Hw.T @ r + Pinv @ dx_prior
        dx = torch.linalg.solve_ex(A, rhs)[0]
        R = R @ so3_exp(-dx[0:3])
        p = p - dx[3:6]
        v = v - dx[6:9]
        bg = bg - dx[9:12]
        ba = ba - dx[12:15]
        g = g - dx[15:18]
        n_w = torch.sum(w)
        mean_r = torch.sum(torch.abs(r) * w) / torch.clamp(n_w, min=1.0)
    return (R, p, v, bg, ba, g), n_w, mean_r


def _posterior(Pinv, rows, R, p, inv_r: float) -> torch.Tensor:
    """Covariance update with the final linearization."""
    _, w, H = rows(R, p)
    Hw = H * (w * inv_r)[:, None]
    return torch.linalg.inv_ex(Pinv + H.T @ Hw)[0]


class ScanUpdateResult(NamedTuple):
    state: ESIKFState
    n_matched: torch.Tensor
    mean_residual: torch.Tensor


def scan_update(state: ESIKFState, points_body: torch.Tensor, mask: torch.Tensor,
                vm: VoxelMap, meas_noise: float = 0.05, num_iters: int = 4,
                gate: float = 0.5, min_planarity: float = 0.5) -> ScanUpdateResult:
    """Iterated point-to-plane update against the voxel surfel map: residual
    rᵢ = nᵢ · (R qᵢ + p − cᵢ), rows over (dθ, dp), the plane of each point the
    one of smallest |r| in its 7-voxel neighbourhood (normal: the smallest
    eigenvector of the voxel covariance)."""
    N = points_body.shape[0]
    dev = points_body.device
    evals, evecs = sym_eig3(vm.covs)  # descending: the smallest is column 2
    normals_all = evecs[..., 2]
    planarity_all = 1.0 - evals[:, 2] / torch.clamp(evals[:, 1], min=1e-9)
    offsets = device_constant("direct7", lambda: np.asarray(neighbor_offsets("direct7"),
                                                            np.int32), dev)
    S = skew(points_body)
    zeros = torch.zeros((N, _DIM - 6), device=dev)

    def best_plane(q_w):
        coords = _voxel_coords(q_w, vm.resolution)
        c_off = (coords[:, None, :] + offsets[None]).reshape(-1, 3)
        vidx, found = lookup_voxels(vm, c_off)
        vidx = vidx.reshape(N, -1)
        found = found.reshape(N, -1)
        c = vm.means[vidx]  # [N,7,3]
        n = normals_all[vidx]
        r_all = torch.einsum("nfi,nfi->nf", n, q_w[:, None] - c)
        cand_ok = found & (planarity_all[vidx] > min_planarity) & (vm.num_points[vidx] >= 3)
        score = torch.where(cand_ok, torch.abs(r_all), float("inf"))
        best = torch.argmin(score, dim=-1)  # an all-inf row gives 0, ties the first
        r = torch.gather(r_all, 1, best[:, None])[:, 0]
        n_b = torch.gather(n, 1, best[:, None, None].expand(N, 1, 3))[:, 0]
        ok = torch.gather(cand_ok, 1, best[:, None])[:, 0] & (torch.abs(r) < gate) & mask
        return r, n_b, ok

    def rows(R, p):
        q_w = points_body @ R.T + p
        r, n, ok = best_plane(q_w)
        # dθ rows −n·(R [q]×), dp rows n
        Hrot = -torch.einsum("ni,ij,njk->nk", n, R, S)
        return r, ok.to(torch.float32), torch.cat([Hrot, n, zeros], dim=-1)

    Pinv = _prior_inverse(state.P)
    inv_r = 1.0 / (meas_noise ** 2)
    (R_f, p_f, v_f, bg_f, ba_f, g_f), n_m, res = _iterate(
        state.R, state.p, state.v, state.bg, state.ba, state.g, Pinv, rows, inv_r,
        num_iters)
    P_new = _posterior(Pinv, rows, R_f, p_f, inv_r)
    new_state = state._replace(R=R_f, p=p_f, v=v_f, bg=bg_f, ba=ba_f, g=g_f, P=P_new)
    return ScanUpdateResult(state=new_state, n_matched=n_m, mean_residual=res)


def _bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [H,W] at pixel coordinates (u → W, v → H)."""
    H, W = img.shape
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 2)
    fu = torch.clamp(u - u0, 0.0, 1.0)
    fv = torch.clamp(v - v0, 0.0, 1.0)
    g = lambda dy, dx: img[v0 + dy, u0 + dx]
    return ((1 - fv) * ((1 - fu) * g(0, 0) + fu * g(0, 1))
            + fv * ((1 - fu) * g(1, 0) + fu * g(1, 1)))


class PhotoUpdateResult(NamedTuple):
    state: ESIKFState
    n_used: torch.Tensor
    mean_residual: torch.Tensor


def photo_update(state: ESIKFState, points_world: torch.Tensor, intensity: torch.Tensor,
                 ok: torch.Tensor, image: torch.Tensor, fx: float, fy: float, cx: float,
                 cy: float, meas_noise: float = 0.15, num_iters: int = 2, gate: float = 0.4,
                 grad_min: float = 1e-3, R_ext: Optional[torch.Tensor] = None,
                 t_ext: Optional[torch.Tensor] = None) -> PhotoUpdateResult:
    """Photometric iterated update, the "V" of LIVO: per-anchor residuals
    rᵢ = I(π(Eᵀ(Rᵀ(qᵢ − p) − t_e))) − cᵢ on the gray image, rows over
    (dθ, dp) from the bilinearly sampled central-difference gradient.
    `R_ext` / `t_ext` are the camera axes and centre in the body frame (None:
    body == camera). With q_b = Rᵀ(q − p) and g the pinhole-chained image
    gradient in the camera frame, dr/dδθ = ((E·g) × q_b)ᵀ and
    dr/dδp = −(R·E·g)ᵀ."""
    gray = image.mean(dim=0)
    Himg, Wimg = gray.shape
    gx = torch.zeros_like(gray)
    gx[:, 1:-1] = (gray[:, 2:] - gray[:, :-2]) * 0.5
    gy = torch.zeros_like(gray)
    gy[1:-1, :] = (gray[2:, :] - gray[:-2, :]) * 0.5
    M = points_world.shape[0]
    zeros = torch.zeros((M, _DIM - 6), device=points_world.device)

    def rows(R, p):
        q_b = (points_world - p) @ R  # Rᵀ(q − p), body frame
        q_c = q_b if t_ext is None else q_b - t_ext[None, :]
        if R_ext is not None:
            q_c = q_c @ R_ext  # Eᵀ(·), camera frame
        zc = q_c[:, 2]
        z_safe = torch.where(zc > 1e-3, zc, 1.0)
        u = fx * q_c[:, 0] / z_safe + cx
        v_pix = fy * q_c[:, 1] / z_safe + cy
        inb = (ok & (zc > 0.2) & (u >= 1.0) & (u <= Wimg - 2.0)
               & (v_pix >= 1.0) & (v_pix <= Himg - 2.0))
        r = _bilinear(gray, u, v_pix) - intensity
        gxi = _bilinear(gx, u, v_pix)
        gyi = _bilinear(gy, u, v_pix)
        zero = torch.zeros_like(zc)
        gvec = (gxi[:, None] * torch.stack([fx / z_safe, zero, -fx * q_c[:, 0] / z_safe ** 2], -1)
                + gyi[:, None] * torch.stack([zero, fy / z_safe, -fy * q_c[:, 1] / z_safe ** 2], -1))
        # textureless or gated anchors contribute nothing
        w = (inb & (torch.abs(r) < gate)
             & (torch.sum(gvec * gvec, -1) > grad_min ** 2)).to(torch.float32)
        g_body = gvec if R_ext is None else gvec @ R_ext.T
        Hrot = torch.linalg.cross(g_body, q_b)
        Hp = -(g_body @ R.T)
        return r, w, torch.cat([Hrot, Hp, zeros], dim=-1)

    Pinv = _prior_inverse(state.P)
    inv_r = 1.0 / (meas_noise ** 2)
    (R_f, p_f, v_f, bg_f, ba_f, g_f), n_u, res = _iterate(
        state.R, state.p, state.v, state.bg, state.ba, state.g, Pinv, rows, inv_r,
        num_iters)
    P_new = _posterior(Pinv, rows, R_f, p_f, inv_r)
    new_state = state._replace(R=R_f, p=p_f, v=v_f, bg=bg_f, ba=ba_f, g=g_f, P=P_new)
    return PhotoUpdateResult(state=new_state, n_used=n_u, mean_residual=res)


# ---------------------------------------------------------------------------
# The incremental surfel map: per-voxel moments (n, Σq, Σqqᵀ, Σi) over a fixed
# world grid, q = p − voxel centre (anchoring at the centre keeps |q| ≤ ~one
# voxel, so the moment subtraction stays well-conditioned in float32 far from
# the origin). A scan is folded in by one stable sort of (map keys ++ scan
# keys) and an in-order sum of each key's run.
# ---------------------------------------------------------------------------


class SurfelMap(NamedTuple):
    keys: torch.Tensor  # [V] sorted unique voxel keys (int32, _SURFEL_KEY_MAX pad)
    n: torch.Tensor  # [V] points accumulated per voxel
    sum_p: torch.Tensor  # [V,3] Σ(p − voxel centre)
    sum_pp: torch.Tensor  # [V,3,3] Σ(p − voxel centre)(p − voxel centre)ᵀ
    sum_i: torch.Tensor  # [V] Σ intensity (the photometric anchor)
    overflow: torch.Tensor  # points dropped: out of the grid or past capacity
    mins: torch.Tensor  # [3] int32 grid origin (voxel coords)
    dims: torch.Tensor  # [3] int32 grid dims
    resolution: float


def surfel_map_init(resolution: float = 0.3, capacity: int = 8192,
                    world_extent: float = 128.0, device=None) -> SurfelMap:
    """A fixed grid centred at the origin (±world_extent/2 a side). Raises
    when the flattened key space exceeds int32, where keys would wrap."""
    half = int(world_extent / (2 * resolution)) + 2
    dim = 2 * half + 1
    if dim ** 3 >= 2 ** 31:
        max_dim = int((2.0 ** 31) ** (1.0 / 3.0))
        raise ValueError(f"surfel grid {dim}^3 overflows the int32 key space "
                         f"(max ~{max_dim} cells per axis)")
    dev = resolve_device(device)
    return SurfelMap(
        keys=torch.full((capacity,), _SURFEL_KEY_MAX, dtype=torch.int32, device=dev),
        n=torch.zeros(capacity, device=dev),
        sum_p=torch.zeros((capacity, 3), device=dev),
        sum_pp=torch.zeros((capacity, 3, 3), device=dev),
        sum_i=torch.zeros(capacity, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        mins=torch.full((3,), -half, dtype=torch.int32, device=dev),
        dims=torch.full((3,), dim, dtype=torch.int32, device=dev),
        resolution=resolution)


def _surfel_encode(sm: SurfelMap, coords: torch.Tensor) -> torch.Tensor:
    rel = coords - sm.mins
    inside = torch.all((rel >= 0) & (rel < sm.dims), dim=-1)
    key = (rel[..., 0] * sm.dims[1] + rel[..., 1]) * sm.dims[2] + rel[..., 2]
    return torch.where(inside, key, _SURFEL_KEY_MAX)


def surfel_map_update(sm: SurfelMap, points: torch.Tensor, mask: torch.Tensor,
                      intensity: Optional[torch.Tensor] = None) -> SurfelMap:
    """Fold a world-frame scan into the map. `intensity` [N] (optional)
    accumulates the photometric anchor. Points outside the grid and voxels
    past capacity are counted in `overflow`."""
    V = sm.keys.shape[0]
    dev = points.device
    coords = _voxel_coords(points, sm.resolution)
    keys_new = torch.where(mask, _surfel_encode(sm, coords), _SURFEL_KEY_MAX)
    valid = keys_new < _SURFEL_KEY_MAX
    dropped = torch.sum((mask & ~valid).to(torch.int32))
    if intensity is None:
        intensity = torch.zeros(points.shape[0], device=dev)

    q = points - (coords.to(torch.float32) + 0.5) * sm.resolution
    qq = q[:, :, None] * q[:, None, :]
    vf = valid[:, None]
    new_rows = torch.cat([valid.to(torch.float32)[:, None], torch.where(vf, q, 0.0),
                          torch.where(vf, qq.reshape(-1, 9), 0.0),
                          torch.where(valid, intensity, 0.0)[:, None]], dim=-1)
    old_rows = torch.cat([sm.n[:, None], sm.sum_p, sm.sum_pp.reshape(-1, 9),
                          sm.sum_i[:, None]], dim=-1)
    keys_all = torch.cat([sm.keys, keys_new])
    rows_all = torch.cat([old_rows, new_rows])

    ks, order = torch.sort(keys_all, stable=True)
    live = ks < _SURFEL_KEY_MAX
    is_new = torch.ones_like(live)
    is_new[1:] = ks[1:] != ks[:-1]
    is_new &= live
    vid = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(live & (vid < V), vid, V).long()
    n_unique = torch.clamp(vid[-1] + 1, min=0)
    overflow = sm.overflow + torch.clamp(n_unique - V, min=0) + dropped

    key_buf = torch.full((V + 1,), _SURFEL_KEY_MAX, dtype=torch.int32, device=dev)
    key_buf.scatter_(0, slot, torch.where(slot < V, ks, _SURFEL_KEY_MAX))
    # slot never decreases along the sorted rows: voxel v is the v-th run,
    # summed in order (old moments first, then the scan's points)
    offsets = torch.searchsorted(slot, torch.arange(V + 2, device=dev))
    sums = torch.segment_reduce(rows_all[order], "sum", offsets=offsets, axis=0,
                                unsafe=True)[:V]
    return sm._replace(keys=key_buf[:V], n=sums[:, 0], sum_p=sums[:, 1:4],
                       sum_pp=sums[:, 4:13].reshape(-1, 3, 3), sum_i=sums[:, 13],
                       overflow=overflow)


def surfel_map_voxels(sm: SurfelMap) -> VoxelMap:
    """The accumulators as the `VoxelMap` that `scan_update` reads (its
    `mins` one less, so both encodings give the same key)."""
    n = torch.clamp(sm.n, min=1.0)
    live = sm.keys < _SURFEL_KEY_MAX
    rel2 = sm.keys % sm.dims[2]
    t = torch.div(sm.keys, sm.dims[2], rounding_mode="floor")
    rel = torch.stack([torch.div(t, sm.dims[1], rounding_mode="floor"), t % sm.dims[1],
                       rel2], dim=-1)
    center = torch.where(live[:, None],
                         ((rel + sm.mins).to(torch.float32) + 0.5) * sm.resolution, 0.0)
    qbar = sm.sum_p / n[:, None]
    means = center + qbar
    covs = sm.sum_pp / n[:, None, None] - qbar[:, :, None] * qbar[:, None, :]
    covs = covs + 1e-6 * torch.eye(3, device=covs.device)  # finite eigh when empty
    return VoxelMap(keys=sm.keys, means=means, covs=covs, num_points=torch.trunc(sm.n),
                    n_voxels=torch.sum(live.to(torch.int32)), overflow=sm.overflow,
                    mins=sm.mins + 1, dims=sm.dims, resolution=sm.resolution)


def surfel_map_anchors(sm: SurfelMap):
    """Photometric anchors for `photo_update`: (voxel mean positions, mean
    intensity, validity: live voxels of at least two points)."""
    vm = surfel_map_voxels(sm)
    live = sm.keys < _SURFEL_KEY_MAX
    n = torch.clamp(sm.n, min=1.0)
    return vm.means, sm.sum_i / n, live & (sm.n >= 2.0)
