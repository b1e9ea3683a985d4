"""Copies of what the program's timed path computed, taken where the
benchmark wraps a program function, and their translation into the
reference's terms (activated Gaussians, a camera built from a pose)."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from benchmarks.reference import render as rr
from benchmarks.reference import train as rt


def leaves(m) -> List[torch.Tensor]:
    """A port map's parameter leaves in `reference.train.LEAVES` order,
    copied."""
    return [getattr(m, f).detach().clone() for f in rt.LEAVES]


def gaussians(m) -> rr.Gaussians:
    """The port map's Gaussians as the reference renders them."""
    p = [getattr(m, f).detach() for f in rt.LEAVES]
    return rr.activate(p[0], p[1], p[3], p[4], p[5], p[6], m.active.detach().clone())


def pose_of(camera) -> torch.Tensor:
    """Camera-to-world pose of a port `Camera`."""
    V = camera.world_view.detach()
    pose = torch.eye(4, dtype=torch.float32, device=V.device)
    pose[:3, :3] = V[:3, :3].T
    pose[:3, 3] = camera.cam_center.detach()
    return pose


def ref_camera(pose: torch.Tensor, slam: dict, width: int, height: int) -> rr.Cam:
    """The reference's camera at `pose` with the configuration's
    intrinsics scaled to the image."""
    c = slam["camera"]
    return rr.camera(pose, width, height, c["fx"] * width / c["width"],
                     c["fy"] * height / c["height"])


def raster_of(cfg) -> rr.Raster:
    """The caps of a port `SLAMConfig` at the moment of the call (the
    pipeline adapts the tile capacity and the binning window)."""
    r = cfg.raster
    return rr.Raster(tile=r.tile, max_tiles_per_gaussian=r.max_tiles_per_gaussian,
                     tile_capacity=r.tile_capacity, chunk=r.chunk,
                     alpha_min=r.alpha_min, transmittance_min=r.transmittance_min,
                     low_pass=r.low_pass, near=r.near, bg_depth=r.bg_depth)


class Wrap:
    """Swap `owner.attr` for `fn(orig, *args, **kw)` while entered."""

    def __init__(self, owner, attr: str, fn: Callable):
        self.owner, self.attr, self.fn = owner, attr, fn

    def __enter__(self):
        orig = self.orig = getattr(self.owner, self.attr)
        setattr(self.owner, self.attr, lambda *a, **k: self.fn(orig, *a, **k))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)


def unit_record(m, camera, cfg, kernels, ssim: bool) -> dict:
    """A unit's inputs for the work count (`harness/work.py`)."""
    return {"g": gaussians(m), "cam": ref_camera(pose_of(camera), _slam_dict(cfg),
                                                 camera.width, camera.height),
            "raster": raster_of(cfg), "kernels": kernels, "ssim": ssim}


def _slam_dict(cfg) -> dict:
    c = cfg.camera
    return {"camera": {"width": c.width, "height": c.height, "fx": c.fx, "fy": c.fy}}


def adam_leaves(st) -> List[List[torch.Tensor]]:
    return [[x.detach().clone() for x in st.mu], [x.detach().clone() for x in st.nu]]


def slam_step_capture(want: Callable[[int], bool], out: Dict[int, dict], most: int = 1 << 30):
    """A wrapper for `slam.step.slam_step` that copies the inputs and
    outputs, and the raster caps of the call, of the first `most` steps
    whose number `want` takes into `out[step]`."""

    def fn(orig, state, camera, gt_image, gt_objects, cfg, mesh=None):
        k = state.step
        if not want(k) or len(out) >= most:
            return orig(state, camera, gt_image, gt_objects, cfg, mesh)
        rec = {"params_in": leaves(state.map), "active": state.map.active.clone(),
               "adam_in": adam_leaves(state.opt_state),
               "adam_count": state.opt_state.count,
               "clf_in": [x.detach().clone() for x in state.classifier],
               "clf_adam_in": adam_leaves(state.cls_opt_state),
               "clf_adam_count": state.cls_opt_state.count,
               "pose": pose_of(camera), "hw": (camera.height, camera.width),
               "raster": raster_of(cfg),
               "gt": gt_image.detach().clone(), "labels": gt_objects.detach().clone()}
        new, metrics = orig(state, camera, gt_image, gt_objects, cfg, mesh)
        rec.update(params_out=leaves(new.map), adam_out=adam_leaves(new.opt_state),
                   clf_out=[x.detach().clone() for x in new.classifier],
                   clf_adam_out=adam_leaves(new.cls_opt_state),
                   loss=metrics.loss.detach().clone())
        out[k] = rec
        return new, metrics

    return fn


def align_capture(out: List[dict]):
    """A wrapper for `ops.gicp.gicp_align` that copies each call's initial
    pose and the pose it returned into `out`."""

    def fn(orig, source, target, source_mask, target_mask, init_T, *a, **k):
        res = orig(source, target, source_mask, target_mask, init_T, *a, **k)
        out.append({"init": init_T.detach().clone(), "T": res.T.detach().clone()})
        return res

    return fn
