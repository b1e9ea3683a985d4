"""Traffic `stream`: one sensor stream into `SLAMPipeline.run`, closed
loop (each frame handed over as soon as `run` takes it), along the pool's
route and back, as a patrol drives it, so the window never runs dry.

Set-up makes the pool and runs `warm_frames` frames, which bring the
tile-capacity adaptation and the first map doublings; the first training
step is copied as it runs, for the Gaussians frame 0 added. The window is
one `run` call over as many frames as it takes, ended by a sync. After it,
`after_window` runs `CHECK_FRAMES` more frames through `run`, at the map
size and raster caps the window left, and copies each frame's GICP align
and the first `CHECK_STEPS` training steps that carry neither the every-Nth
cls3d term nor a prune (the reference leaves both out).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.data import frames as fd
from benchmarks.harness import capture, spec, trace, work
from benchmarks.reference import render as rr
from benchmarks.reference import track as rtrack
from benchmarks.reference import train as rt

CHECK_STEPS = 3
CHECK_FRAMES = 4  # of 4 steps in a row, at most one carries cls3d (every 5th) or a prune


class Session:
    def __init__(self, cell: spec.Cell, seed: int, device):
        from sags_tpu_torch.io.datasets import Frame
        from sags_tpu_torch.slam import step as step_mod
        from sags_tpu_torch.slam.pipeline import SLAMPipeline

        self.device = torch.device(device)
        self.slam = cell.config["slam"]
        p = cell.params
        st = fd.StreamSpec.from_config(cell.config["stream"], self.slam["camera"])
        self.pool = fd.make_pool(st, p["pool_frames"], seed, self.device)
        pool = self.pool
        self.frames = [Frame(image=pool.images[i], points=pool.points(i), colors=pool.colors(i),
                             pose=pool.poses[i], timestamp=0.0, scan=pool.scan(i))
                       for i in range(len(pool))]
        self.k = 0  # frames handed over so far
        self.cfg = spec.slam_config(cell)
        self.pipe = SLAMPipeline(self.cfg, point_budget=cell.config["stream"]["point_budget"],
                                 rng_seed=seed, device=self.device)
        self.steps: Dict[int, dict] = {}  # step 0, as set-up ran it
        self.checked: Dict[int, dict] = {}  # the steps after the window
        self.aligns: List[dict] = []  # the aligns after the window, with their frames
        with capture.Wrap(step_mod, "slam_step",
                          capture.slam_step_capture(lambda k: k == 0, self.steps)):
            self._run(self._stream(p["warm_frames"]))
        trace.sync(self.device)

    def _stream(self, n=None, deadline=None):
        from sags_tpu_torch.io.datasets import Frame

        end = None if n is None else self.k + n
        while (end is None or self.k < end) and (deadline is None
                                                 or time.perf_counter() < deadline):
            f = self.frames[fd.patrol(self.k, len(self.frames))]
            yield Frame(image=f.image, points=f.points, colors=f.colors, pose=f.pose,
                        timestamp=self.k * fd.FRAME_DT, scan=f.scan)
            self.k += 1

    def _run(self, gen) -> int:
        """Run `gen` through the pipeline; the number of frames it took."""
        return len(self.pipe.run(gen, post_train=0).poses_est)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = self._run(self._stream(deadline=t0 + seconds))
        trace.sync(self.device)
        wall = time.perf_counter() - t0
        return {"metrics": {"frame_ms": wall / n * 1e3}, "attempted": n, "failed": 0}

    def after_window(self) -> None:
        """`CHECK_FRAMES` frames on from where the window stopped, through
        the same `run`, copying what the check compares."""
        from sags_tpu_torch.ops import gicp as gicp_ops
        from sags_tpu_torch.slam import step as step_mod

        sem, mp = self.slam["semantics"], self.slam["map"]
        plain = lambda k: k % sem["cls3d_interval"] != 0 and k % mp["prune_interval"] != 0
        k0 = self.k
        with capture.Wrap(step_mod, "slam_step", capture.slam_step_capture(
                plain, self.checked, CHECK_STEPS)), \
                capture.Wrap(gicp_ops, "gicp_align", capture.align_capture(self.aligns)):
            self._run(self._stream(CHECK_FRAMES))
        n = len(self.pool)
        for j, a in enumerate(self.aligns):  # frame k0 + j against the one before it
            a["source"], a["target"] = fd.patrol(k0 + j, n), fd.patrol(k0 + j - 1, n)
        trace.sync(self.device)

    def stretches(self, n: int) -> dict:
        """The traced run's two stretches of `n` frames each."""
        from sags_tpu_torch.ops import rasterize as rz
        from sags_tpu_torch.slam import fused
        from sags_tpu_torch.slam import step as step_mod

        spans = trace.Spans()
        spans.wrap(rz, "bin_gaussians")
        spans.wrap(rz, "rasterize")
        for name in ("_track", "_add", "_train_and_metrics"):
            spans.wrap(fused.FusedFrontend, name)
        units: List[dict] = []

        def grab(orig, state, camera, gt_image, gt_objects, cfg, mesh=None):
            units.append(capture.unit_record(
                state.map, camera, cfg, ["composite_fwd_kernel", "composite_bwd_kernel"],
                ssim=True))
            return orig(state, camera, gt_image, gt_objects, cfg, mesh)

        def run():
            self._run(self._stream(n))
            return n

        try:
            with capture.Wrap(step_mod, "slam_step", grab):
                spans.annotate = True
                a = trace.profiled(run, self.device)
                a.captured, units = units, []
                spans.annotate = False
                spans.reset()
                lm0 = len(self.pipe.lm_log)
                b = trace.counted(run, self.device)
                b.captured = units
                b.spans = dict(spans.seconds)
                lm = self.pipe.lm_log[lm0:]
        finally:
            spans.restore()
        for s in (a, b):
            s.work = work.count(s.captured, self.device)
            s.captured = []
        return {"profiled": a, "counted": b,
                "lm_inner": sum(int(x[1]) for x in lm)}

    def release(self) -> None:
        self.pipe = None
        trace.free(self.device)

    # -- the check ----------------------------------------------------------
    def check(self, control: bool = False) -> Dict[str, float]:
        """The Gaussians frame 0 added against the reference's; the GICP
        aligns and the training steps after the window, each followed by
        the reference from the program's state before it. `control` puts
        the reference computed with TF32 in the program's place."""
        out = {"map_add_gap": self._map_add_gap(control),
               "track_gap": self._track_gap(control)}
        out.update(self._steps(control))
        return out

    def fault_readings(self) -> Dict[str, float]:
        """What a tracker that leaves its pose where it was (the identity
        increment) would read: the upper reading of `track_gap`."""
        return {"track_gap.unchanged": self._track_gap(False, unchanged=True)}

    def _track_gap(self, control: bool, unchanged: bool = False):
        """Each align after the window against the reference's GICP from the
        same initial pose on the pool's two scans: how far apart the two
        poses place the source scan's points, at the farthest, metres."""
        if not self.aligns:
            return None
        gaps = []
        for a in self.aligns:
            src = torch.as_tensor(self.pool.scan(a["source"]), device=self.device)
            tgt = torch.as_tensor(self.pool.scan(a["target"]), device=self.device)
            ref = rtrack.align(src, tgt, a["init"], self.slam["gicp"])
            if control:
                with rt.tf32():
                    prog = rtrack.align(src, tgt, a["init"], self.slam["gicp"])
            else:
                prog = torch.eye(4, device=self.device) if unchanged else a["T"]
            gaps.append(rtrack.pose_gap(prog, ref, src))
        return max(gaps)

    def _map_add_gap(self, control: bool) -> float:
        """Frame 0's Gaussians as step 0 found them: positions, colours,
        opacities and the set of active slots exactly, and each surfel
        covariance (R S² Rᵀ of its stored rotation and scales) against the
        reference's, relative (Frobenius)."""
        rec = self.steps[0]
        n = len(self.pool.sel[0])
        pts = torch.as_tensor(self.pool.points(0), device=self.device)
        cols = torch.as_tensor(self.pool.colors(0), device=self.device)
        p = rec["params_in"]
        xyz, f_dc, ls, q, opl = p[0][:n], p[1][:n], p[3][:n], p[4][:n], p[5][:n]
        gaps = [float((xyz - pts).abs().max()),
                float((f_dc - (cols - 0.5) / rr.C0).abs().max()),
                float((opl - np.log(0.1 / 0.9)).abs().max()),
                float((~rec["active"][:n]).sum()) + float(rec["active"][n:].sum())]
        g = self.slam["gicp"]
        cov_r = rt.surfel_cov(pts, g["k_correspondences"], g["knn_max_distance"])
        if control:
            with rt.tf32():
                cov_p = rt.surfel_cov(pts, g["k_correspondences"], g["knn_max_distance"])
            gaps = []
        else:
            Rm = rt.quat_rot(q)
            cov_p = Rm @ torch.diag_embed(torch.exp(2 * ls)) @ Rm.transpose(1, 2)
        den = torch.linalg.matrix_norm(cov_r).clamp(min=1e-12)
        gaps.append(float((torch.linalg.matrix_norm(cov_p - cov_r) / den).max()))
        return max(gaps)

    def _steps(self, control: bool) -> Dict[str, float]:
        loss_gaps, grad_gaps, upd_gaps = [], [], []
        b1 = self.slam["opt"]["adam_b1"]
        if len(self.checked) < CHECK_STEPS:  # fewer steps than were due
            return {"loss_gap": None, "grad_gap": None, "update_gap": None}
        for k, rec in sorted(self.checked.items()):
            H, W = rec["hw"]
            cam = capture.ref_camera(rec["pose"], self.slam, W, H)
            args = (rec["params_in"], rec["active"],
                    rt.Adam(rec["adam_count"], *rec["adam_in"]),
                    rec["clf_in"], rt.Adam(rec["clf_adam_count"], *rec["clf_adam_in"]),
                    k, cam, rec["gt"], rec["labels"], self.slam, rec["raster"])
            ref = rt.slam_step(*args)
            if control:
                with rt.tf32():
                    prog = rt.slam_step(*args)
                p_loss, p_grads = prog.loss, prog.grads + prog.extra["clf_grads"]
                p_out = prog.params + prog.extra["clf"]
            else:
                p_loss = float(rec["loss"])
                p_grads = [(mo - b1 * mi) / (1 - b1) for mo, mi in zip(
                    rec["adam_out"][0] + rec["clf_adam_out"][0],
                    rec["adam_in"][0] + rec["clf_adam_in"][0])]
                p_out = rec["params_out"] + rec["clf_out"]
            r_grads = ref.grads + ref.extra["clf_grads"]
            r_out = ref.params + ref.extra["clf"]
            p_in = rec["params_in"] + rec["clf_in"]
            loss_gaps.append(abs(p_loss - ref.loss) / abs(ref.loss))
            grad_gaps.append(rt.norm_gap(p_grads, r_grads)[0])
            upd_gaps.append(rt.norm_gap([o - i for o, i in zip(p_out, p_in)],
                                        [o - i for o, i in zip(r_out, p_in)],
                                        floor_of=r_grads)[0])
        return {"loss_gap": max(loss_gaps), "grad_gap": max(grad_gaps),
                "update_gap": max(upd_gaps)}


def setup(cell: spec.Cell, seed: int, device) -> Session:
    return Session(cell, seed, device)
