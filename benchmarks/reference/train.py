"""Plain PyTorch training steps: the SLAM map step (photometric L1 + SSIM,
the object cross-entropy through the classifier head, per-group Adam) and
the offline 3DGS step (L1 + SSIM, per-group Adam), the classic 3DGS scale
init from the mean squared distance to the 3 nearest points, and the
surfel covariances of a scan. Imports nothing of the port.

The parameters are the map's stored leaves, in this order: xyz, f_dc,
f_rest, log_scales, quats, opacity_logit, obj_dc (`LEAVES`).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmarks.reference import render as rr

LEAVES = ("xyz", "f_dc", "f_rest", "log_scales", "quats", "opacity_logit", "obj_dc")


class Adam(NamedTuple):
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam(grads, st: Adam, b1: float, b2: float, eps: float):
    """optax's `scale_by_adam`: returns (m̂ / (√v̂ + eps) per leaf, state)."""
    n = st.count + 1
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, st.mu)]
    nu = [(1 - b2) * g * g + b2 * v for g, v in zip(grads, st.nu)]
    bc1, bc2 = 1.0 - b1 ** n, 1.0 - b2 ** n
    return [(m / bc1) / (torch.sqrt(v / bc2) + eps) for m, v in zip(mu, nu)], Adam(n, mu, nu)


def xyz_lr(opt: dict, step: int, extent: float) -> float:
    """The position schedule: log-linear from init to final over
    `position_lr_max_steps` (no delay steps)."""
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    lo, hi = opt["position_lr_init"] * extent, opt["position_lr_final"] * extent
    return math.exp(math.log(lo) * (1 - t) + math.log(hi) * t)


def leaf_lrs(opt: dict, step: int, extent: float) -> List[float]:
    f = opt["feature_lr"]
    return [xyz_lr(opt, step, extent), f, f / 20.0, opt["scaling_lr"],
            opt["rotation_lr"], opt["opacity_lr"], f]


def _gauss_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return (g / g.sum()).to(torch.float32).to(device)


def ssim(img, gt, window: int = 11, sigma: float = 1.5):
    """Mean SSIM with an 11-tap σ = 1.5 Gaussian, zero padded, computed
    where gt is not 0 (the image is zeroed elsewhere, as the loss states)."""
    img = torch.where(gt != 0, img, torch.zeros_like(img))
    C = img.shape[0]
    g = _gauss_window(window, sigma, img.device)
    kx = g.reshape(1, 1, 1, -1).repeat(C, 1, 1, 1)
    ky = g.reshape(1, 1, -1, 1).repeat(C, 1, 1, 1)
    pad = window // 2

    def blur(x):
        x = F.conv2d(rr.mm_in(x)[None], rr.mm_in(kx), padding=(0, pad), groups=C)
        return F.conv2d(rr.mm_in(x), rr.mm_in(ky), padding=(pad, 0), groups=C)[0]

    mu1, mu2 = blur(img), blur(gt)
    s11 = blur(img * img) - mu1 * mu1
    s22 = blur(gt * gt) - mu2 * mu2
    s12 = blur(img * gt) - mu1 * mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2))
    return m.mean()


def rgb_loss(color, gt, lambda_dssim: float):
    """(1−λ)·L1 + λ·(1−SSIM), L1 over the pixels where gt is not 0."""
    l1 = torch.where(gt != 0, torch.abs(color - gt), torch.zeros_like(gt)).mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(color, gt))


def object_ce(objects, labels, W, b, num_classes: int):
    """Per-pixel cross-entropy of the 1×1 classifier over the rendered object
    channels, over log(num_classes)."""
    logits = torch.einsum("ohw,ko->khw", rr.mm_in(objects), rr.mm_in(W)) + b[:, None, None]
    logp = torch.log_softmax(logits, dim=0)
    picked = torch.gather(logp, 0, labels[None].long())[0]
    return -picked.mean() / math.log(num_classes)


class Step(NamedTuple):
    loss: float
    grads: List[torch.Tensor]  # per leaf
    params: List[torch.Tensor]  # after the step
    adam: Adam
    extra: Dict[str, object]


def _gaussians(p, active):
    return rr.activate(p[0], p[1], p[3], p[4], p[5], p[6], active)


def slam_step(params, active, adam_in: Adam, clf, clf_adam: Adam, step: int,
              cam: rr.Cam, gt, labels, cfg: dict, raster: Optional[rr.Raster] = None,
              block: int = 64) -> Step:
    """One SLAM map step without the every-Nth 3D-consistency term and the
    prune (`step` must not be a multiple of either interval).
    `clf` = [W [K,O], b [K]]; `raster`: the caps of the step as it ran
    (default: the configuration's)."""
    opt, sem = cfg["opt"], cfg["semantics"]
    if step % sem["cls3d_interval"] == 0 or step % cfg["map"]["prune_interval"] == 0:
        raise ValueError(f"step {step} carries the cls3d term or a prune")
    r = raster or rr.Raster.from_config(cfg["raster"])
    p = [x.detach().clone().requires_grad_(True) for x in params]
    c = [x.detach().clone().requires_grad_(True) for x in clf]
    lam = opt["lambda_dssim"]

    def loss_fn(color, objects):
        lr_ = rgb_loss(color, gt, lam)
        lo = object_ce(objects, labels, c[0], c[1], sem["num_classes"])
        return sem["loss_rgb_weight"] * lr_ + sem["loss_obj_weight"] * lo

    loss, _ = rr.render_with_grad(_gaussians(p, active), cam, r, loss_fn, block)
    grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in p]
    upd, st = adam(grads, adam_in, opt["adam_b1"], opt["adam_b2"], opt["adam_eps"])
    out = []
    for x, u, lr in zip(params, upd, leaf_lrs(opt, step, cfg["scene_extent"])):
        keep = active.reshape((-1,) + (1,) * (x.dim() - 1))
        out.append(x + torch.where(keep, -lr * u, torch.zeros_like(u)))
    cg = [torch.zeros_like(x) if x.grad is None else x.grad for x in c]
    cu, cst = adam(cg, clf_adam, 0.9, 0.999, 1e-8)
    new_clf = [x - sem["classifier_lr"] * u for x, u in zip(clf, cu)]
    return Step(float(loss), grads, out, st, {"clf": new_clf, "clf_grads": cg})


def offline_step(params, active, adam_in: Adam, step: int, cam: rr.Cam, gt, cfg: dict,
                 block: int = 64) -> Step:
    """One offline 3DGS step: L1 + SSIM on the colour, object channels 0."""
    opt = cfg["opt"]
    r = rr.Raster.from_config(cfg["raster"])
    p = [x.detach().clone().requires_grad_(True) for x in params]
    g = _gaussians(p, active)
    g = g._replace(obj=torch.zeros_like(g.obj))
    loss, _ = rr.render_with_grad(g, cam, r, lambda color, _: rgb_loss(
        color, gt, opt["lambda_dssim"]), block)
    grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in p]
    upd, st = adam(grads, adam_in, opt["adam_b1"], opt["adam_b2"], opt["adam_eps"])
    out = []
    for x, u, lr in zip(params, upd, leaf_lrs(opt, step, cfg["scene_extent"])):
        keep = active.reshape((-1,) + (1,) * (x.dim() - 1))
        out.append(x + torch.where(keep, -lr * u, torch.zeros_like(u)))
    return Step(float(loss), grads, out, st, {})


class tf32:
    """The reference's matrix products in TF32 while entered (inputs
    rounded to TF32, `render.mm_in`): the control, the nearest precision
    under the configuration's float32 with TF32 off."""

    def __enter__(self):
        self.old = rr.Precision.tf32
        rr.Precision.tf32 = True

    def __exit__(self, *exc):
        rr.Precision.tf32 = self.old


def knn_sqdist(queries, points, k: int, chunk: int = 1024, exclude_self=False):
    """Squared distances to the k nearest points, by ‖a‖² + ‖b‖² − 2a·b per
    chunk of queries (the 3DGS `distCUDA2` contract: exact nearest sets
    up to that formula's float32 rounding). Returns (d² [M,k], idx [M,k])."""
    kk = k + 1 if exclude_self else k
    psq = (points * points).sum(-1)
    ds, ids = [], []
    for q0 in range(0, queries.shape[0], chunk):
        q = queries[q0:q0 + chunk]
        d2 = (q * q).sum(-1)[:, None] + psq[None, :] - 2.0 * (rr.mm_in(q) @ rr.mm_in(points).T)
        neg, idx = torch.topk(-d2, kk, dim=-1)
        ds.append(torch.clamp(-neg, min=0.0))
        ids.append(idx)
    d2, idx = torch.cat(ds), torch.cat(ids)
    return (d2[:, 1:], idx[:, 1:]) if exclude_self else (d2, idx)


def scale_init(points) -> torch.Tensor:
    """log √(mean of the 3 nearest squared distances, floored at 1e-7)."""
    d2, _ = knn_sqdist(points, points, 3, exclude_self=True)
    return torch.log(torch.sqrt(torch.clamp(d2.mean(-1), min=1e-7)))


def surfel_cov(points, k: int = 10, max_d2: float = 0.5) -> torch.Tensor:
    """fast_gicp's per-point covariance over the k nearest points, the ones
    within `max_d2` (all k when fewer than 3 are), divided by k. [N,3,3]."""
    d2, idx = knn_sqdist(points, points, k)
    rel = d2 < max_d2
    rel = rel | (rel.sum(-1) < 3)[:, None]
    n = rel.sum(-1).clamp(min=1)
    nbr = points[idx]
    mean = torch.where(rel[..., None], nbr, 0.0).sum(1) / n[:, None]
    d = torch.where(rel[..., None], nbr - mean[:, None], 0.0)
    return torch.einsum("nki,nkj->nij", d, d) / float(k)


def quat_rot(q) -> torch.Tensor:
    """Unit xyzw quaternions → rotation matrices [N,3,3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1).reshape(-1, 3, 3)


def norm_gap(prog: List[torch.Tensor], ref: List[torch.Tensor],
             floor_of: Optional[List[torch.Tensor]] = None, rule: float = 1e-3):
    """The worst leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖, the median leaf's
    ‖ref‖). Leaves whose `floor_of` norm (default: ref) is under `rule` ×
    the median leaf's are left out (gradients nought to rounding).
    Returns (gap, {leaf index: gap})."""
    rn = [float(torch.linalg.vector_norm(x)) for x in ref]
    pn = [float(torch.linalg.vector_norm(x)) for x in prog]
    fn = rn if floor_of is None else [float(torch.linalg.vector_norm(x)) for x in floor_of]
    live = [i for i, x in enumerate(ref) if x.numel()]
    med = sorted(fn[i] for i in live)[len(live) // 2]
    rmed = sorted(rn[i] for i in live)[len(live) // 2]
    gaps = {i: abs(pn[i] - rn[i]) / max(rn[i], rmed, 1e-30)
            for i in live if fn[i] >= rule * med}
    return max(gaps.values()), gaps
