"""Offline 3DGS training, the classic densify / clone / split loop
(`sags_tpu.slam.offline` in torch).

The reference's offline path (`Scene` + `GaussianModel` driven by a 3DGS
training script, configs #2-#3 of BASELINE.json): Gaussians start from a
point cloud with kNN-distance scales, then random training views are
iterated with

  * L1 + λ·(1−SSIM) photometric loss, through the classic rasterizer
    (`fused=False`; on CUDA tensors its kernels `fill_table`,
    `composite_fused` and `composite_fused_bwd`),
  * the view-space positional gradient from the `mean2d_offset` probe,
    accumulated by `add_densification_stats`,
  * gradient-threshold clone/split every `densification_interval` steps in
    `[densify_from_iter, densify_until_iter]`, then the opacity prune,
  * the opacity reset every `opacity_reset_interval` steps.

Densification changes no shapes (masked appends inside the fixed-capacity
map) and reads nothing on the host; the schedule is host integers. Each
step's loss stays on the device until the run ends (or a `log_every` line
prints it).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.camera import Camera
from sags_tpu_torch.core.config import SLAMConfig
from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.ops import rasterize as rz
from sags_tpu_torch.ops.knn import scale_init_from_points
from sags_tpu_torch.slam.pipeline import camera_for
from sags_tpu_torch.utils.adam import AdamState
from sags_tpu_torch.utils.draws import TorchDraws
from sags_tpu_torch.utils.losses import rgb_loss
from sags_tpu_torch.utils.profiling import span


class OfflineState(NamedTuple):
    map: gm.GaussianMap
    opt_state: AdamState
    step: int  # iterations taken, on the host
    draws: object  # draw hook (utils/draws.py): obj embeddings, split offsets


def init_from_points(points, colors, cfg: SLAMConfig, capacity: Optional[int] = None,
                     seed: int = 0, device=None, draws=None) -> OfflineState:
    """`create_from_pcd`-style init: kNN-distance scales, the configured
    initial opacity, a random obj embedding from `draws` (default: a
    generator seeded with `seed`). Capacity defaults to
    max(next_pow2(n), 1024)·4."""
    device = resolve_device(device)
    draws = TorchDraws(seed, device) if draws is None else draws
    n = len(points)
    capacity = capacity or max(1 << (n - 1).bit_length(), 1024) * 4
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    m = gm.init_map(capacity, cfg.map, device)
    log_s = scale_init_from_points(pts)
    m, _ = gm.add_points(m, pts, cols, torch.ones(n, dtype=torch.bool, device=device),
                         draws, scales=torch.exp(log_s),
                         initial_opacity=cfg.map.initial_opacity)
    return OfflineState(map=m, opt_state=gm.optimizer_init(gm.params_of(m)), step=0,
                        draws=draws)


def train_step(state: OfflineState, camera: Camera, gt_image: torch.Tensor,
               cfg: SLAMConfig):
    """One photometric iteration with densification-stat accumulation.
    Returns (state, loss as a 0-dim device tensor)."""
    with span("train", device=gt_image.device, unit=state.step):
        return _train_step(state, camera, gt_image, cfg)


def _train_step(state: OfflineState, camera: Camera, gt_image: torch.Tensor,
                cfg: SLAMConfig):
    m = state.map
    params = gm.Params(*(p.detach().requires_grad_(True) for p in gm.params_of(m)))
    probe = torch.zeros((m.capacity, 2), dtype=torch.float32, device=m.xyz.device,
                        requires_grad=True)
    with torch.enable_grad():
        with span("step.forward"):
            mm = gm.with_params(m, params)
            out = rz.rasterize(mm.xyz, gm.get_opacity(mm), gm.get_scaling(mm),
                               gm.get_rotation(mm), camera, cfg.raster, shs=gm.get_shs(mm),
                               sh_degree=cfg.map.sh_degree, active_mask=mm.active,
                               mean2d_offset=probe, fused=False)
            loss = rgb_loss(out.color, gt_image, cfg.opt.lambda_dssim)
        with span("step.backward"):
            grads = torch.autograd.grad(loss, tuple(params) + (probe,), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, tuple(params) + (probe,))]
    gmap, gprobe = gm.Params(*grads[:7]), grads[7]
    with span("step.adam", device=gt_image.device):
        updates, opt_state = gm.optimizer_update(cfg.opt, gmap, state.opt_state, state.step,
                                                 cfg.scene_extent)
        new_params = gm.apply_updates(gm.params_of(m), updates, m.active)
        m = gm.with_params(m, gm.Params(*(p.detach() for p in new_params)))
    m = gm.add_densification_stats(m, gprobe, out.radii)
    return OfflineState(m, opt_state, state.step + 1, state.draws), loss.detach()


def densify_event(state: OfflineState, cfg: SLAMConfig) -> OfflineState:
    """Clone/split by the gradient threshold, then the opacity prune."""
    with span("offline.densify"):
        m, _ = gm.densify_and_clone_split(
            state.map, cfg.opt.densify_grad_threshold, cfg.scene_extent, state.draws,
            percent_dense=cfg.opt.percent_dense)
        m = gm.prune_large_and_transparent(m, cfg.map.prune_min_opacity, None)
    return state._replace(map=m)


def _optimize(state: OfflineState, cams, imgs, cfg: SLAMConfig, iterations: int,
              seed: int, log_every: int):
    """The random-view loop both entry points share: step, densify window,
    opacity resets."""
    rng = np.random.default_rng(seed)
    opt = cfg.opt
    losses: List[torch.Tensor] = []
    for it in range(iterations):
        i = rng.integers(len(cams))
        state, loss = train_step(state, cams[i], imgs[i], cfg)
        losses.append(loss)
        step = it + 1
        if (opt.densify_from_iter <= step <= opt.densify_until_iter
                and step % opt.densification_interval == 0):
            state = densify_event(state, cfg)
        if step % opt.opacity_reset_interval == 0:
            state = state._replace(map=gm.reset_opacity(state.map))
        if log_every and step % log_every == 0:
            print(f"iter {step}: loss={float(loss):.4f} "
                  f"active={int(gm.n_active(state.map))}")
    out = torch.stack(losses).tolist() if losses else []
    return state, [float(x) for x in out]


def train_offline(frames, cfg: SLAMConfig, iterations: int,
                  capacity: Optional[int] = None, seed: int = 0, log_every: int = 0,
                  device=None, draws=None):
    """Offline optimization over a replayed frame set (`Frame`s with image,
    points, colors and a camera-to-world pose): every frame's points seed
    the map, every frame is a training view. Returns (state, losses)."""
    device = resolve_device(device)
    pts = np.concatenate([f.points for f in frames])
    cols = np.concatenate([f.colors for f in frames])
    state = init_from_points(pts, cols, cfg, capacity, seed, device, draws)
    cams = [camera_for(cfg, f, np.asarray(f.pose), device) for f in frames]
    imgs = [torch.as_tensor(np.asarray(f.image, np.float32), device=device)
            for f in frames]
    return _optimize(state, cams, imgs, cfg, iterations, seed, log_every)


def train_offline_scene(scene, cfg: SLAMConfig, iterations: int,
                        capacity: Optional[int] = None, seed: int = 0,
                        log_every: int = 0, device=None, draws=None):
    """Offline optimization of an assembled COLMAP scene
    (`io.colmap_scene.load_colmap_scene`), the `readColmapSceneInfo` →
    `Scene` → training-loop path of the reference. The NeRF++ radius is the
    scene extent (spatial learning-rate scale, split threshold), as
    `Scene.__init__` sets it. The cameras stay where the scene built them;
    `device` must be theirs."""
    views = [v for v in scene.train_views if v.image is not None]
    if not views:
        raise ValueError("COLMAP scene has no views with images")
    device = resolve_device(device)
    cfg = cfg.replace(scene_extent=float(scene.radius))
    state = init_from_points(scene.points, scene.colors, cfg, capacity, seed, device,
                             draws)
    cams = [v.camera for v in views]
    imgs = [torch.as_tensor(np.asarray(v.image, np.float32), device=device)
            for v in views]
    return _optimize(state, cams, imgs, cfg, iterations, seed, log_every)
