"""The SLAM map-optimization step (`sags_tpu.slam.step` in torch): render →
masked L1 + SSIM + semantic CE (+ cls3d KL every Nth step) → backward →
per-group Adam → periodic prune.

The step counter is a host integer, so the cls3d and prune decisions cost no
device sync. The map buffers are updated in place. A mesh
(`parallel.mesh.make_mesh`) shards the render's compositor over its ranks'
tiles; the rest of the step is replicated, and every rank ends it with the
same state.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.camera import Camera
from sags_tpu_torch.core.config import SLAMConfig
from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.models.classifier import (ClassifierParams, apply_classifier,
                                              apply_classifier_features,
                                              init_classifier)
from sags_tpu_torch.ops import rasterize as rz
from sags_tpu_torch.semantics.losses import loss_cls_3d, object_ce_loss
from sags_tpu_torch.utils.adam import AdamState, adam_init, adam_update
from sags_tpu_torch.utils.draws import TorchDraws
from sags_tpu_torch.utils.losses import l1_loss, ssim
from sags_tpu_torch.utils.profiling import span

_CLS_B1, _CLS_B2, _CLS_EPS = 0.9, 0.999, 1e-8  # optax.adam defaults


class SLAMState(NamedTuple):
    map: gm.GaussianMap
    opt_state: AdamState
    classifier: ClassifierParams
    cls_opt_state: AdamState
    step: int  # train_iter, on the host
    rng: object  # draw hook (utils/draws.py)


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    loss_rgb: torch.Tensor
    loss_obj: torch.Tensor
    loss_obj_3d: torch.Tensor
    n_active: torch.Tensor
    n_binned: torch.Tensor
    overflow_tile: torch.Tensor
    overflow_rect: torch.Tensor
    overflow_window: torch.Tensor
    overflow_big: torch.Tensor
    tile_peak: torch.Tensor
    overflow_tile_live: torch.Tensor


# the scalars the host reads after a step, in their column order: one row a
# step (`host_row`), fetched at once by the per-module front-end and leading
# each row of the fused front-end's metrics ring
HOST_FIELDS = ("loss", "n_binned", "overflow_tile", "overflow_rect", "overflow_window",
               "overflow_big", "tile_peak", "overflow_tile_live")
HOST_COL = {name: i for i, name in enumerate(HOST_FIELDS)}


def host_row(m: StepMetrics, *extra: torch.Tensor) -> torch.Tensor:
    """`HOST_FIELDS` of `m`, then the scalars `extra`, as one float32 row
    (one stack)."""
    return torch.stack([x.to(torch.float32).reshape(())
                        for x in (*(getattr(m, f) for f in HOST_FIELDS), *extra)])


def init_state(cfg: SLAMConfig, seed: int = 0, capacity: Optional[int] = None,
               device=None, draws=None) -> SLAMState:
    """Empty map, zeroed Adam moments, a freshly drawn classifier. `draws`
    defaults to a `torch.Generator` seeded with `seed` on the device."""
    device = resolve_device(device)
    draws = TorchDraws(seed, device) if draws is None else draws
    capacity = capacity or cfg.map.initial_capacity
    m = gm.init_map(capacity, cfg.map, device)
    clf = init_classifier(draws, cfg.semantics.num_objects, cfg.semantics.num_classes)
    return SLAMState(map=m, opt_state=gm.optimizer_init(gm.params_of(m)),
                     classifier=clf, cls_opt_state=adam_init(clf), step=0, rng=draws)


def render_map(m: gm.GaussianMap, camera: Camera, cfg: SLAMConfig, bg_color=None,
               mesh=None, training_stage: int = 0, windowed=None) -> rz.RenderOutput:
    """`render_4` equivalent; `training_stage` divides the resolution by 2·stage."""
    if training_stage:
        d = 2 * training_stage
        camera = Camera(camera.width // d, camera.height // d, camera.fovx,
                        camera.fovy, camera.world_view, camera.full_proj,
                        camera.cam_center, camera.znear, camera.zfar)
    return rz.rasterize(m.xyz, gm.get_opacity(m), gm.get_scaling(m),
                        gm.get_rotation(m), camera, cfg.raster, shs=gm.get_shs(m),
                        sh_degree=cfg.map.sh_degree, obj_features=m.obj_dc,
                        bg_color=bg_color, active_mask=m.active, mesh=mesh,
                        windowed=windowed)


def _loss_fn(params: gm.Params, clf: ClassifierParams, m: gm.GaussianMap,
             camera: Camera, gt_image, gt_objects, use_cls3d: bool, draws,
             cfg: SLAMConfig, mesh=None):
    m = gm.with_params(m, params)
    # `train_windowed` trains through the windowed render only with the
    # windowed backward kernel; `pallas_backward=False` pins the classic
    # path, as in the JAX package (`fused=False` disables its windowed path)
    windowed = bool(cfg.raster.train_windowed and cfg.raster.pallas_backward)
    out = render_map(m, camera, cfg, mesh=mesh, windowed=windowed)
    _, l1 = l1_loss(out.color, gt_image)
    _, s = ssim(out.color, gt_image)
    loss_rgb = (1.0 - cfg.opt.lambda_dssim) * l1 + cfg.opt.lambda_dssim * (1.0 - s)
    logits = apply_classifier(clf, out.objects)
    loss_obj = object_ce_loss(logits, gt_objects, cfg.semantics.num_classes)
    if use_cls3d:
        prob3d = torch.softmax(apply_classifier_features(clf, m.obj_dc), dim=-1)
        sem = cfg.semantics
        loss_obj_3d = loss_cls_3d(m.xyz.detach(), prob3d,
                                  draws.uniform((m.capacity,)), m.active,
                                  k=sem.cls3d_k, lambda_val=sem.cls3d_lambda,
                                  sample_size=sem.cls3d_sample)
    else:
        loss_obj_3d = torch.zeros((), device=gt_image.device)
    sem = cfg.semantics
    loss = (sem.loss_rgb_weight * loss_rgb + sem.loss_obj_weight * loss_obj
            + sem.loss_obj_3d_weight * loss_obj_3d)
    return loss, (loss_rgb, loss_obj, loss_obj_3d, out)


def slam_step(state: SLAMState, camera: Camera, gt_image: torch.Tensor,
              gt_objects: torch.Tensor, cfg: SLAMConfig,
              mesh=None) -> Tuple[SLAMState, StepMetrics]:
    """One map-optimization iteration, its compositor sharded over `mesh`."""
    with span("train", device=gt_image.device, unit=state.step):
        return _slam_step(state, camera, gt_image, gt_objects, cfg, mesh)


def _slam_step(state: SLAMState, camera: Camera, gt_image: torch.Tensor,
               gt_objects: torch.Tensor, cfg: SLAMConfig, mesh):
    m = state.map
    use_cls3d = state.step % cfg.semantics.cls3d_interval == 0
    params = gm.Params(*(p.detach().requires_grad_(True) for p in gm.params_of(m)))
    clf = ClassifierParams(*(p.detach().requires_grad_(True) for p in state.classifier))
    with torch.enable_grad():
        with span("step.forward"):
            loss, (loss_rgb, loss_obj, loss_obj_3d, out) = _loss_fn(
                params, clf, m, camera, gt_image, gt_objects, use_cls3d, state.rng, cfg, mesh)
        with span("step.backward"):
            grads = torch.autograd.grad(loss, tuple(params) + tuple(clf), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, tuple(params) + tuple(clf))]
    gmap, gclf = gm.Params(*grads[:7]), grads[7:]

    with span("step.adam", device=gt_image.device):
        updates, opt_state = gm.optimizer_update(cfg.opt, gmap, state.opt_state,
                                                 state.step, cfg.scene_extent)
        new_params = gm.apply_updates(gm.params_of(m), updates, m.active)
        m = gm.with_params(m, gm.Params(*(p.detach() for p in new_params)))

        cupd, cls_opt_state = adam_update(gclf, state.cls_opt_state, _CLS_B1, _CLS_B2,
                                          _CLS_EPS)
        lr = cfg.semantics.classifier_lr
        new_clf = ClassifierParams(*(p.detach() - lr * u
                                     for p, u in zip(state.classifier, cupd)))

    if state.step % cfg.map.prune_interval == 0:
        m = gm.prune_large_and_transparent(m, cfg.map.prune_min_opacity,
                                           cfg.map.prune_extent)

    new_state = SLAMState(map=m, opt_state=opt_state, classifier=new_clf,
                          cls_opt_state=cls_opt_state, step=state.step + 1,
                          rng=state.rng)
    metrics = StepMetrics(
        loss=loss.detach(), loss_rgb=loss_rgb.detach(), loss_obj=loss_obj.detach(),
        loss_obj_3d=loss_obj_3d.detach(), n_active=gm.n_active(m),
        n_binned=out.n_binned, overflow_tile=out.overflow_tile,
        overflow_rect=out.overflow_rect, overflow_window=out.overflow_window,
        overflow_big=out.overflow_big, tile_peak=out.tile_peak,
        overflow_tile_live=out.overflow_tile_live,
    )
    return new_state, metrics


def make_slam_step(cfg: SLAMConfig, mesh=None):
    """`slam_step` with the config and mesh bound: fn(state, camera,
    gt_image, gt_objects) → (state, metrics)."""
    return functools.partial(slam_step, cfg=cfg, mesh=mesh)


def add_frame_points(state: SLAMState, points, colors, mask, cfg: SLAMConfig,
                     quats=None, scales=None, z_vals=None, trackable=None,
                     keyframe_id: int = -1) -> Tuple[SLAMState, torch.Tensor]:
    """Per-frame map growth: z_vals default ‖p‖/5000; scan points are
    trackable by default."""
    if z_vals is None:
        z_vals = torch.linalg.vector_norm(points, dim=-1) / 5000.0
    if trackable is None:
        trackable = mask
    m, dropped = gm.add_points(
        state.map, points, colors, mask, state.rng, quats=quats, scales=scales,
        z_vals=z_vals, trackable=trackable, initial_scale=cfg.map.initial_scale,
        initial_opacity=cfg.map.initial_opacity, keyframe_id=keyframe_id)
    return state._replace(map=m), dropped
