"""Traffic `replay`: the offline trainer over a replayed stretch of the
route. Set-up builds the map with `offline.init_from_points` from the
`n_views` frames' points and runs `warm_iters` iterations; the window runs
iterations until it ends, then syncs. The loop is `slam/offline.py`'s
`_optimize` schedule written out here: a seeded random view each
iteration, a densify event every `densification_interval` iterations
inside the densify range, the opacity reset every `opacity_reset_interval`.
The reference follows the first three iterations from the initial map.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.data import frames as fd
from benchmarks.harness import capture, spec, trace, work
from benchmarks.reference import train as rt

CHECK_STEPS = 3


class Session:
    def __init__(self, cell: spec.Cell, seed: int, device):
        from sags_tpu_torch.io.datasets import Frame
        from sags_tpu_torch.slam import offline
        from sags_tpu_torch.slam.pipeline import camera_for

        self.device = torch.device(device)
        self.slam = cell.config["slam"]
        p = cell.params
        st = fd.StreamSpec.from_config(cell.config["stream"], self.slam["camera"])
        n = cell.config["offline"]["n_views"]
        self.pool = fd.make_pool(st, n, seed, self.device)
        self.cfg = spec.slam_config(cell)
        self.points = np.concatenate([self.pool.points(i) for i in range(n)])
        colors = np.concatenate([self.pool.colors(i) for i in range(n)])
        self.state = offline.init_from_points(self.points, colors, self.cfg, seed=seed,
                                              device=self.device)
        self.init = capture.leaves(self.state.map)
        self.active = self.state.map.active.clone()
        self.cams = [camera_for(self.cfg, Frame(self.pool.images[i], None, None, None, 0.0),
                                self.pool.poses[i], self.device) for i in range(n)]
        self.imgs = [torch.as_tensor(self.pool.images[i], device=self.device)
                     for i in range(n)]
        self.rng = np.random.default_rng(seed)
        self.it = 0
        self.views: List[int] = []
        self.losses: List[torch.Tensor] = []
        self.after: Dict[int, dict] = {}
        for _ in range(p["warm_iters"]):
            self._iterate()
            if self.it <= CHECK_STEPS:
                self.after[self.it] = {"params": capture.leaves(self.state.map),
                                       "mu": [x.clone() for x in self.state.opt_state.mu]}
        trace.sync(self.device)

    def _iterate(self) -> None:
        from sags_tpu_torch.mapping import gaussian_map as gm
        from sags_tpu_torch.slam import offline

        opt = self.cfg.opt
        i = int(self.rng.integers(len(self.cams)))
        self.views.append(i)
        self.state, loss = offline.train_step(self.state, self.cams[i], self.imgs[i], self.cfg)
        self.losses.append(loss)
        self.it += 1
        step = self.it
        if (opt.densify_from_iter <= step <= opt.densify_until_iter
                and step % opt.densification_interval == 0):
            self.state = offline.densify_event(self.state, self.cfg)
        if step % opt.opacity_reset_interval == 0:
            self.state = self.state._replace(map=gm.reset_opacity(self.state.map))

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        end, n = t0 + seconds, 0
        while time.perf_counter() < end:
            self._iterate()
            n += 1
        trace.sync(self.device)
        wall = time.perf_counter() - t0
        return {"metrics": {"iter_ms": wall / n * 1e3}, "attempted": n, "failed": 0}

    def after_window(self) -> None:
        """Nothing: the check follows the first iterations, copied in set-up."""

    def stretches(self, n: int) -> dict:
        from sags_tpu_torch.ops import rasterize as rz
        from sags_tpu_torch.slam import offline

        spans = trace.Spans()
        spans.wrap(rz, "bin_gaussians")
        spans.wrap(rz, "rasterize")
        units: List[dict] = []

        def grab(orig, state, camera, gt_image, cfg):
            units.append(capture.unit_record(
                state.map, camera, cfg, ["composite_fwd_kernel", "composite_bwd_kernel"],
                ssim=True))
            return orig(state, camera, gt_image, cfg)

        def run():
            for _ in range(n):
                self._iterate()
            return n

        try:
            with capture.Wrap(offline, "train_step", grab):
                spans.annotate = True
                a = trace.profiled(run, self.device)
                a.captured, units = units, []
                spans.annotate = False
                spans.reset()
                b = trace.counted(run, self.device)
                b.captured = units
                b.spans = dict(spans.seconds)
        finally:
            spans.restore()
        for s in (a, b):
            for u in s.captured:  # the offline step renders no object channels
                u["g"] = u["g"]._replace(obj=torch.zeros_like(u["g"].obj))
            s.work = work.count(s.captured, self.device)
            s.captured = []
        return {"profiled": a, "counted": b}

    def release(self) -> None:
        self.state = None
        self.cams = self.imgs = None  # the check reads the pool's images
        trace.free(self.device)

    def check(self, control: bool = False) -> Dict[str, float]:
        """The kNN scale init, then the first three iterations followed by
        the reference from the initial map (the program's, whose scales the
        first number checks): each loss, the first gradient as Adam took it,
        the parameters' change after three."""
        pts = torch.as_tensor(self.points, device=self.device)
        ref_ls = rt.scale_init(pts)
        if control:
            with rt.tf32():
                prog_ls = rt.scale_init(pts)
        else:
            prog_ls = self.init[3][:len(pts), 0]
        out = {"knn_scale_gap": float((prog_ls - ref_ls).abs().max())}
        out.update(self._steps(control))
        return out

    def _steps(self, control: bool) -> Dict[str, float]:
        b1 = self.slam["opt"]["adam_b1"]
        zeros = [torch.zeros_like(x) for x in self.init]
        r_params = c_params = self.init
        r_adam = c_adam = rt.Adam(0, zeros, [z.clone() for z in zeros])
        loss_gaps = []
        for k in range(CHECK_STEPS):
            v = self.views[k]
            gt = torch.as_tensor(self.pool.images[v], device=self.device)
            H, W = gt.shape[1:]
            cam = capture.ref_camera(torch.as_tensor(self.pool.poses[v], device=self.device),
                                     self.slam, W, H)
            ref = rt.offline_step(r_params, self.active, r_adam, k, cam, gt, self.slam)
            if k == 0:
                r_grad = ref.grads
            r_params, r_adam = ref.params, ref.adam
            if control:
                with rt.tf32():
                    prog = rt.offline_step(c_params, self.active, c_adam, k, cam, gt, self.slam)
                c_params, c_adam = prog.params, prog.adam
                p_loss = prog.loss
                if k == 0:
                    p_grad = prog.grads
            else:
                p_loss = float(self.losses[k])
                if k == 0:
                    p_grad = [m / (1 - b1) for m in self.after[1]["mu"]]
            loss_gaps.append(abs(p_loss - ref.loss) / abs(ref.loss))
        p_end = c_params if control else self.after[CHECK_STEPS]["params"]
        return {"loss_gap": max(loss_gaps), "grad_gap": rt.norm_gap(p_grad, r_grad)[0],
                "update_gap": rt.norm_gap([a - b for a, b in zip(p_end, self.init)],
                                          [a - b for a, b in zip(r_params, self.init)],
                                          floor_of=r_grad)[0]}


def setup(cell: spec.Cell, seed: int, device) -> Session:
    return Session(cell, seed, device)
