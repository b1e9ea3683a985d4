"""Incremental Gaussian map in fixed-capacity buffers with an active mask —
`sags_tpu.mapping.gaussian_map` in torch.

`count` is the allocation high-water mark; adds append at `[count, count+B)`,
prunes clear `active` bits, `compact` gathers active slots to the front and
`grow` pads every buffer — both carrying the per-group Adam moments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sags_tpu_torch.core import sh as shlib
from sags_tpu_torch.core.config import MapConfig, OptimizationConfig, expon_lr
from sags_tpu_torch.core.transforms import quat_normalize
from sags_tpu_torch.utils.adam import AdamState, adam_init, adam_update


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
    opl = inverse_sigmoid(torch.tensor(initial_opacity, dtype=torch.float32, device=dev))
    if trackable is None:
        trackable = torch.zeros(B, dtype=torch.bool, device=dev)

    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    slot = m.count + rank
    ok = mask & (slot < N)
    n_added = torch.sum(ok.to(torch.int32))
    n_dropped = torch.sum(mask.to(torch.int32)) - n_added
    idx = slot[ok].long()

    def put(buf, val):
        buf[idx] = val[ok] if val.dim() and val.shape[0] == B else val
        return buf

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
    idx = torch.nonzero(m.active).reshape(-1)
    n = idx.shape[0]

    def gather(buf):
        out = torch.zeros_like(buf)
        out[:n] = buf[idx]
        return out

    new = m._replace(
        **{f: gather(getattr(m, f)) for f in PARAM_FIELDS},
        active=torch.arange(N, device=m.active.device) < n,
        trackable=gather(m.trackable), keyframe_id=gather(m.keyframe_id),
        count=torch.tensor(n, dtype=torch.int32, device=m.count.device),
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
