"""Incremental Gaussian map in fixed-capacity buffers with an active mask —
`sags_tpu.mapping.gaussian_map` in torch.

`count` is the allocation high-water mark; adds (new points, and the clones
and splits of densification) append at `[count, count+B)`, prunes clear
`active` bits, `compact` gathers active slots to the front and `grow` pads
every buffer — both carrying the per-group Adam moments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sags_tpu_torch.core import sh as shlib
from sags_tpu_torch.core.config import MapConfig, OptimizationConfig, expon_lr
from sags_tpu_torch.core.transforms import quat_normalize, quat_to_rotmat
from sags_tpu_torch.utils.adam import AdamState, adam_init, adam_update
from sags_tpu_torch.utils.profiling import host_read


class GaussianMap(NamedTuple):
    xyz: torch.Tensor  # [N,3]
    f_dc: torch.Tensor  # [N,3]
    f_rest: torch.Tensor  # [N,R,3]
    log_scales: torch.Tensor  # [N,3]
    quats: torch.Tensor  # [N,4] xyzw
    opacity_logit: torch.Tensor  # [N]
    obj_dc: torch.Tensor  # [N,O]
    active: torch.Tensor  # [N] bool
    trackable: torch.Tensor  # [N] bool
    keyframe_id: torch.Tensor  # [N] int32
    count: torch.Tensor  # 0-dim int32
    max_radii2d: torch.Tensor  # [N]
    xyz_grad_accum: torch.Tensor  # [N]
    denom: torch.Tensor  # [N]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "log_scales", "quats", "opacity_logit", "obj_dc")


class Params(NamedTuple):
    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logit: torch.Tensor
    obj_dc: torch.Tensor


def params_of(m: GaussianMap) -> Params:
    return Params(*(getattr(m, f) for f in PARAM_FIELDS))


def with_params(m: GaussianMap, p: Params) -> GaussianMap:
    return m._replace(**p._asdict())


def init_map(capacity: int, cfg: MapConfig, device) -> GaussianMap:
    R = (cfg.sh_degree + 1) ** 2 - 1

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    quats = z(capacity, 4)
    quats[:, 3] = 1.0
    return GaussianMap(
        xyz=z(capacity, 3), f_dc=z(capacity, 3), f_rest=z(capacity, R, 3),
        log_scales=z(capacity, 3), quats=quats, opacity_logit=z(capacity),
        obj_dc=z(capacity, cfg.num_objects), active=z(capacity, dtype=torch.bool),
        trackable=z(capacity, dtype=torch.bool),
        keyframe_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        count=z(dtype=torch.int32), max_radii2d=z(capacity),
        xyz_grad_accum=z(capacity), denom=z(capacity),
    )


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def get_scaling(m: GaussianMap) -> torch.Tensor:
    return torch.exp(m.log_scales)


def get_opacity(m: GaussianMap) -> torch.Tensor:
    return torch.sigmoid(m.opacity_logit)


def get_rotation(m: GaussianMap) -> torch.Tensor:
    return quat_normalize(m.quats)


def get_shs(m: GaussianMap) -> torch.Tensor:
    """[N, 3, (deg+1)^2], DC first."""
    dc = m.f_dc[:, :, None]
    if m.f_rest.shape[1] == 0:
        return dc
    return torch.cat([dc, m.f_rest.transpose(1, 2)], dim=-1)


def _masked_append(count: torch.Tensor, mask: torch.Tensor, N: int):
    """Plan a masked append of a [B]-row batch at `count + rank`, below
    capacity N, without a host read. Returns (put, kept [B] bool, n_added,
    n_dropped); `put(buf, val)` writes the kept rows of `val` into `buf` in
    place. The j-th kept row (in batch order) goes to slot count + j (at
    most N rows can be kept). Every j names a distinct slot, (count + j) mod
    N; a j past the kept rows rewrites its slot with the slot's own value (a
    wrapped one lies below count, never on a kept row). `val` is gathered
    before the write, so it may be `buf`."""
    B = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    ok = mask & (count + rank < N)
    n_added = torch.sum(ok, dtype=torch.int32)  # keeps `count` int32
    J = min(B, N)
    src = torch.argsort((~ok).to(torch.int32), stable=True)[:J]
    j = torch.arange(J, device=mask.device)
    live = j < n_added
    dst = (count + j) % N

    def put(buf, val):
        v = val[src] if val.dim() and val.shape[0] == B else val
        keep = live.reshape((J,) + (1,) * (buf.dim() - 1))
        buf[dst] = torch.where(keep, v, buf[dst])
        return buf

    return put, ok, n_added, torch.sum(mask, dtype=torch.int32) - n_added


def add_points(m: GaussianMap, points, colors, mask, draws, quats=None,
               scales=None, z_vals=None, trackable=None,
               initial_scale: float = 0.01, initial_opacity: float = 0.1,
               keyframe_id: int = -1) -> Tuple[GaussianMap, torch.Tensor]:
    """Append a masked batch (`add_from_pcd2_tensor`, `gaussian_model.py:180-229`):
    RGB→SH0, random obj embedding RGB2SH(U[0,1)) from `draws`, scales
    divided by max(2 z^1.5, 1), opacity logit of 0.1. Returns (map, n_dropped).
    Updates the buffers in place."""
    B = points.shape[0]
    N = m.capacity
    dev = points.device
    if quats is None:
        quats = torch.zeros((B, 4), dtype=points.dtype, device=dev)
        quats[:, 3] = 1.0
    if scales is None:
        scales = torch.full((B, 3), initial_scale, dtype=points.dtype, device=dev)
    if z_vals is not None:
        zc = torch.clamp((z_vals ** 1.5) * 2.0, min=1.0)
        scales = scales / zc[:, None]
    log_scales = torch.log(torch.clamp(scales, min=1e-12))
    f_dc = shlib.rgb_to_sh(colors)
    obj_dc = shlib.rgb_to_sh(draws.uniform((B, m.obj_dc.shape[1])))
    opl = inverse_sigmoid(torch.full((), initial_opacity, dtype=torch.float32, device=dev))
    if trackable is None:
        trackable = torch.zeros(B, dtype=torch.bool, device=dev)

    put, ok, n_added, n_dropped = _masked_append(m.count, mask, N)
    R = m.f_rest.shape[1]
    m = m._replace(
        xyz=put(m.xyz, points),
        f_dc=put(m.f_dc, f_dc),
        f_rest=put(m.f_rest, torch.zeros((B, R, 3), device=dev)),
        log_scales=put(m.log_scales, log_scales),
        quats=put(m.quats, quats),
        opacity_logit=put(m.opacity_logit, opl),
        obj_dc=put(m.obj_dc, obj_dc),
        active=put(m.active, ok),
        trackable=put(m.trackable, trackable & ok),
        keyframe_id=put(m.keyframe_id,
                        torch.full((B,), int(keyframe_id), dtype=torch.int32, device=dev)),
        count=m.count + n_added,
        max_radii2d=put(m.max_radii2d, torch.zeros(B, device=dev)),
        xyz_grad_accum=put(m.xyz_grad_accum, torch.zeros(B, device=dev)),
        denom=put(m.denom, torch.zeros(B, device=dev)),
    )
    return m, n_dropped


def prune_large_and_transparent(m: GaussianMap, min_opacity: float,
                                extent: Optional[float]) -> GaussianMap:
    """SLAM-mode prune: opacity < ε or max scale > 0.1·extent."""
    prune = get_opacity(m) < min_opacity
    if extent is not None:
        prune = prune | (torch.amax(get_scaling(m), dim=-1) > 0.1 * extent)
    return m._replace(active=m.active & ~prune)


def prune_large_and_transparent2(m: GaussianMap, min_opacity: float,
                                 scaling_threshold: float,
                                 visibility: torch.Tensor) -> GaussianMap:
    """`prune_large_and_transparent2` (`gaussian_model.py:639-651`): shrink
    large Gaussians to 0.1× instead of deleting them; erase transparent
    visible ones."""
    scal = get_scaling(m)
    large = torch.amax(scal, dim=-1) > scaling_threshold
    new_ls = torch.where(large[:, None], torch.log(torch.clamp(scal * 0.1, min=1e-12)),
                         m.log_scales)
    transparent = visibility & (get_opacity(m) < min_opacity)
    return m._replace(log_scales=new_ls, active=m.active & ~transparent)


def add_densification_stats(m: GaussianMap, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianMap:
    """Accumulate ‖∇mean2D‖ of the visible Gaussians and their largest
    screen radius (`gaussian_model.py:659-661`). `mean2d_grad` [N,2]."""
    vis = radii > 0
    norm = torch.linalg.vector_norm(mean2d_grad, dim=-1)
    zero = torch.zeros_like(norm)
    return m._replace(
        xyz_grad_accum=m.xyz_grad_accum + torch.where(vis, norm, zero),
        denom=m.denom + vis.to(torch.float32),
        max_radii2d=torch.maximum(m.max_radii2d, torch.where(vis, radii.to(torch.float32),
                                                             zero)))


def densify_and_clone_split(m: GaussianMap, grad_threshold: float, scene_extent: float,
                            draws, percent_dense: float = 0.01,
                            n_split: int = 2) -> Tuple[GaussianMap, torch.Tensor]:
    """Classic 3DGS densification (`gaussian_model.py:536-623`): high-gradient
    Gaussians no larger than `percent_dense·scene_extent` are cloned; larger
    ones are split into `n_split` copies offset by R·(z ⊙ s), z ~ N(0, I)
    from `draws` (one [N,3] draw a copy), with scales divided by
    0.8·n_split, and the originals deactivated. Appends are masked at
    `count + rank`, what does not fit is dropped and counted; the gradient
    stats are zeroed. Returns (map, drops), updating the buffers in place
    with no host read."""
    grads = m.xyz_grad_accum / torch.clamp(m.denom, min=1.0)
    high = (grads >= grad_threshold) & m.active
    scal = get_scaling(m)
    small = torch.amax(scal, dim=-1) <= percent_dense * scene_extent
    clone_m = high & small
    split_m = high & ~small
    N = m.capacity

    def append_masked(m, sel, xyz, log_scales):
        put, ok, n_added, dropped = _masked_append(m.count, sel, N)
        zero = torch.zeros(N, device=m.xyz.device)
        m = m._replace(
            xyz=put(m.xyz, xyz), f_dc=put(m.f_dc, m.f_dc), f_rest=put(m.f_rest, m.f_rest),
            log_scales=put(m.log_scales, log_scales), quats=put(m.quats, m.quats),
            opacity_logit=put(m.opacity_logit, m.opacity_logit),
            obj_dc=put(m.obj_dc, m.obj_dc), active=put(m.active, ok),
            trackable=put(m.trackable, m.trackable & ok),
            keyframe_id=put(m.keyframe_id, m.keyframe_id), count=m.count + n_added,
            max_radii2d=put(m.max_radii2d, zero), xyz_grad_accum=put(m.xyz_grad_accum, zero),
            denom=put(m.denom, zero))
        return m, dropped

    m, drops = append_masked(m, clone_m, m.xyz, m.log_scales)
    R = quat_to_rot_cached(m.quats)
    new_ls = torch.log(torch.clamp(scal / (0.8 * n_split), min=1e-12))
    for _ in range(n_split):
        noise = draws.normal((N, 3)) * scal
        new_xyz = m.xyz + torch.einsum("nij,nj->ni", R, noise)
        m, d = append_masked(m, split_m, new_xyz, new_ls)
        drops = drops + d
    m = m._replace(active=m.active & ~split_m,
                   xyz_grad_accum=torch.zeros_like(m.xyz_grad_accum),
                   denom=torch.zeros_like(m.denom))
    return m, drops


def quat_to_rot_cached(quats: torch.Tensor) -> torch.Tensor:
    return quat_to_rotmat(quat_normalize(quats))


def _opacity_logit(op: torch.Tensor) -> torch.Tensor:
    return inverse_sigmoid(torch.clamp(op, 1e-6, 1 - 1e-6))


def reset_opacity(m: GaussianMap, ceiling: float = 0.01) -> GaussianMap:
    """`reset_opacity` (`gaussian_model.py:312-315`): opacity ≤ ceiling."""
    return m._replace(opacity_logit=_opacity_logit(
        torch.clamp(get_opacity(m), max=ceiling)))


def reset_unreliable_opacity(m: GaussianMap, flt: torch.Tensor,
                             ceiling: float = 0.01) -> GaussianMap:
    """`reset_unreliable_opacity` (`gaussian_model.py:317-322`): the ceiling
    on the `flt` subset only."""
    op = get_opacity(m)
    return m._replace(opacity_logit=_opacity_logit(
        torch.where(flt, torch.clamp(op, max=ceiling), op)))


def reset_visible_opacity(m: GaussianMap, visibility: torch.Tensor,
                          large_scale: float = 0.03) -> GaussianMap:
    """`reset_visible_opacity` (`gaussian_model.py:324-360`): opacity of the
    large visible Gaussians decays to min(x, log(1+x))."""
    op = get_opacity(m)
    large = torch.amax(get_scaling(m), dim=-1) > large_scale
    mask = visibility & large & m.active
    return m._replace(opacity_logit=_opacity_logit(
        torch.where(mask, torch.minimum(op, torch.log1p(op)), op)))


# ---------------------------------------------------------------------------
# Optimizer: per-group Adam
# ---------------------------------------------------------------------------


def lr_tree(opt: OptimizationConfig, step: int, spatial_lr_scale: float) -> Params:
    xyz_lr = expon_lr(step, opt.position_lr_init * spatial_lr_scale,
                      opt.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=opt.position_lr_delay_mult,
                      max_steps=opt.position_lr_max_steps)
    return Params(xyz=xyz_lr, f_dc=opt.feature_lr, f_rest=opt.feature_lr / 20.0,
                  log_scales=opt.scaling_lr, quats=opt.rotation_lr,
                  opacity_logit=opt.opacity_lr, obj_dc=opt.feature_lr)


def optimizer_init(params: Params) -> AdamState:
    return adam_init(params)


def optimizer_update(opt: OptimizationConfig, grads: Params, state: AdamState,
                     step: int, spatial_lr_scale: float):
    """Adam(eps=1e-15) per group, xyz on the exponential schedule. Returns
    (updates −lr·û as Params, new state)."""
    upd, state = adam_update(grads, state, opt.adam_b1, opt.adam_b2, opt.adam_eps)
    lrs = lr_tree(opt, step, spatial_lr_scale)
    return Params(*(-lr * u for u, lr in zip(upd, lrs))), state


def apply_updates(params: Params, updates: Params, active: torch.Tensor) -> Params:
    """Apply updates only to active slots."""
    out = []
    for p, u in zip(params, updates):
        mask = active.reshape((-1,) + (1,) * (p.dim() - 1))
        out.append(p + torch.where(mask, u, torch.zeros_like(u)))
    return Params(*out)


# ---------------------------------------------------------------------------
# Compaction & growth
# ---------------------------------------------------------------------------


def _per_slot(x, N) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == N


def compact(m: GaussianMap, opt_state: Optional[AdamState] = None):
    """Gather active slots to the front (the reference's physical row removal
    + `_prune_optimizer`), carrying the Adam moments."""
    N = m.capacity
    idx = host_read(torch.nonzero, m.active).reshape(-1)
    n = idx.shape[0]

    def gather(buf):
        out = torch.zeros_like(buf)
        out[:n] = buf[idx]
        return out

    new = m._replace(
        **{f: gather(getattr(m, f)) for f in PARAM_FIELDS},
        active=torch.arange(N, device=m.active.device) < n,
        trackable=gather(m.trackable), keyframe_id=gather(m.keyframe_id),
        count=host_read(torch.tensor, n, dtype=torch.int32, device=m.count.device),
        max_radii2d=gather(m.max_radii2d), xyz_grad_accum=gather(m.xyz_grad_accum),
        denom=gather(m.denom),
    )
    if opt_state is None:
        return new
    return new, AdamState(opt_state.count, tuple(gather(x) for x in opt_state.mu),
                          tuple(gather(x) for x in opt_state.nu))


def grow(m: GaussianMap, new_capacity: int, opt_state: Optional[AdamState] = None):
    """Pad every per-Gaussian buffer to `new_capacity` (fresh slots zero,
    identity quats)."""
    N = m.capacity
    pad = new_capacity - N
    if pad <= 0:
        raise ValueError("grow needs a larger capacity")

    def padbuf(buf):
        if not _per_slot(buf, N):
            return buf
        return torch.cat([buf, torch.zeros((pad,) + buf.shape[1:], dtype=buf.dtype,
                                           device=buf.device)])

    new = GaussianMap(*(padbuf(x) for x in m))
    new.quats[N:, 3] = 1.0
    if opt_state is None:
        return new
    return new, AdamState(opt_state.count, tuple(padbuf(x) for x in opt_state.mu),
                          tuple(padbuf(x) for x in opt_state.nu))


def n_active(m: GaussianMap) -> torch.Tensor:
    return torch.sum(m.active.to(torch.int32))


def gaussians_from_keyframes(m: GaussianMap, min_keyframe_id):
    """(xyz, rotation, scaling, mask) of the active Gaussians spawned at or
    after keyframe `min_keyframe_id` (`get_target_gaussians`)."""
    sel = m.active & (m.keyframe_id >= min_keyframe_id)
    return m.xyz, get_rotation(m), get_scaling(m), sel


def get_trackable_gaussians(m: GaussianMap, opacity_th: float):
    sel = (get_opacity(m) > opacity_th) & m.trackable & m.active
    return m.xyz, get_rotation(m), get_scaling(m), sel


def trackable_subset(m: GaussianMap, opacity_th: float, budget: int):
    """Fixed-budget scan-to-map target (points, regularized covariances,
    mask, n_sel): the newest trackable high-opacity Gaussians first."""
    from sags_tpu_torch.core.transforms import quat_scale_to_cov
    from sags_tpu_torch.ops.gicp import sym_eig3

    xyz, rot, scal, sel = get_trackable_gaussians(m, opacity_th)
    cap = xyz.shape[0]
    iota = torch.arange(cap, device=xyz.device)
    # selected first, newest first within each group
    order = torch.argsort(torch.where(sel, 0, 1) * cap + (cap - 1 - iota))
    idx = order[:budget]
    n_sel = torch.sum(sel.to(torch.int32))
    mask = torch.arange(min(budget, cap), device=xyz.device) < torch.clamp(n_sel, max=budget)
    covs = quat_scale_to_cov(scal[idx], rot[idx])
    evals, U = sym_eig3(covs)
    sv = torch.clamp(evals, min=0.0)
    mid = sv[:, 1:2]
    vals = torch.where(mid == 0.0, torch.full_like(sv, 1e-9),
                       torch.clamp(sv / torch.where(mid == 0.0, torch.ones_like(mid), mid),
                                   min=1e-3))
    covs = torch.einsum("nij,nj,nkj->nik", U, vals, U)
    eye = torch.eye(3, device=xyz.device).expand_as(covs)
    covs = torch.where(mask[:, None, None], covs, eye)
    return xyz[idx], covs, mask, n_sel
