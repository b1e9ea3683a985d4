"""Online SLAM pipeline, fused front-end (`sags_tpu.slam.pipeline` in torch):
frame stream → track → map growth → keyframing → one training step per
frame, with the metrics ring drained every `metrics_interval` frames and the
overflow-adaptive tile capacity.

Not ported yet (later slices): the per-module path (`fused_frontend=False`,
the esikf tracker), the mask generator and ID association, `evaluate`, and
the windowed budget probe.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.camera import Camera
from sags_tpu_torch.core.config import SLAMConfig
from sags_tpu_torch.io.datasets import Frame
from sags_tpu_torch.io.queue import FrameQueue
from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.slam import fused as fused_mod
from sags_tpu_torch.slam import step as slam_step_mod


@dataclasses.dataclass
class Keyframe:
    camera: Camera
    image: torch.Tensor  # [3,H,W]
    objects: torch.Tensor  # [H,W] int32
    pose: torch.Tensor


@dataclasses.dataclass
class PipelineResult:
    poses_est: np.ndarray  # [F,4,4]
    poses_gt: np.ndarray  # [F,4,4]
    n_keyframes: int
    train_iters: int
    losses: List[float]
    state: slam_step_mod.SLAMState
    timed_out: bool = False
    frame_times: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _HostMetrics:
    loss: float
    n_binned: int
    overflow_tile: int
    overflow_rect: int
    overflow_window: int
    overflow_big: int
    tile_peak: int = 0
    overflow_tile_live: int = 0


def _lattice256(peak) -> int:
    """1.25× headroom over a peak need, rounded up to the 256-lattice."""
    return -(-int(peak * 1.25) // 256) * 256


class SLAMPipeline:
    # frames a metrics snapshot ages before it is read
    _DRAIN_LAG = 2

    def __init__(self, cfg: SLAMConfig, mask_generator=None, mesh=None,
                 point_budget: int = 4096, rng_seed: int = 0, device=None,
                 draws=None):
        if mask_generator is not None:
            raise NotImplementedError(
                "mask generation and ID association are not ported yet "
                "(the semantics slice)")
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported yet")
        if not cfg.fused_frontend:
            raise NotImplementedError("only the fused front-end is ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.point_budget = point_budget
        self.state = slam_step_mod.init_state(cfg, rng_seed, device=self.device,
                                              draws=draws)
        self.keyframes: List[Keyframe] = []
        self.losses: List[float] = []
        self.train_iter = 0
        self._kf_rng = np.random.default_rng(rng_seed)
        self._overflow_strikes = 0
        self._quiet_shrink = 0
        self._count_ub: Optional[int] = None
        self._fused: Optional[fused_mod.FusedFrontend] = None
        self.track: Optional[fused_mod.TrackState] = None
        self._zeros_objects = None
        self._fused_first = True
        self._host_mi = 0
        self._drained_mi = 0
        # (mi, host copy, event): each frame's metrics ring copied to host
        # memory behind an event, so a lagged drain reads a finished copy
        self._met_snaps: List = []
        self.lm_log: List[tuple] = []  # (outer, inner) LM iterations per align

    # ------------------------------------------------------------------
    def _maybe_grow_map(self, incoming: int) -> None:
        """Grow by doubling before an add could hit capacity; compact first
        when pruned holes free enough room."""
        if self._count_ub is None:
            self._count_ub = int(self.state.map.count)
        cap = self.state.map.capacity
        if self._count_ub + incoming <= cap:
            self._count_ub += incoming
            return
        self._count_ub = int(self.state.map.count)
        if self._count_ub + incoming <= cap:
            self._count_ub += incoming
            return
        n_act = int(gm.n_active(self.state.map))
        if cap - n_act >= max(incoming, cap // 4):
            new_map, new_opt = gm.compact(self.state.map, self.state.opt_state)
            self.state = self.state._replace(map=new_map, opt_state=new_opt)
            self._count_ub = n_act
            if self._count_ub + incoming <= cap:
                self._count_ub += incoming
                return
        new_cap = cap
        need = self._count_ub + incoming
        while new_cap < need and new_cap < self.cfg.map.max_capacity:
            new_cap = min(new_cap * 2, self.cfg.map.max_capacity)
        self._count_ub += incoming
        if new_cap == cap:
            return
        new_map, new_opt = gm.grow(self.state.map, new_cap, self.state.opt_state)
        self.state = self.state._replace(map=new_map, opt_state=new_opt)

    def _rederive_windowed(self, r):
        raise NotImplementedError(
            "windowed budget derivation belongs to the windowed-path slice")

    def _rebuild_frontend(self) -> None:
        if self._fused is not None:
            self._fused = fused_mod.FusedFrontend(
                self.cfg, self._fused.H, self._fused.W,
                sensor_frame=self._fused.sensor_frame)
            self._fused.lm_log = self.lm_log

    def _maybe_grow_capacity(self, metrics: _HostMetrics) -> None:
        """Overflow-adaptive tile capacity and binning window (classic path:
        overflow_window and overflow_big are always 0)."""
        binned = max(int(metrics.n_binned), 1)
        thresh = 0.001 * binned
        over = {
            "tile": int(metrics.overflow_tile_live) > thresh,
            "rect": int(metrics.overflow_rect) > thresh,
            "window": int(metrics.overflow_window) > thresh,
            "big": int(metrics.overflow_big) > thresh,
        }
        self._overflow_strikes = self._overflow_strikes + 1 if any(over.values()) else 0
        if self._overflow_strikes < 3:
            return
        r = self.cfg.raster
        kw = {}
        if over["tile"] and r.tile_capacity < r.tile_capacity_max:
            need = _lattice256(metrics.tile_peak)
            if need > r.tile_capacity:
                kw["tile_capacity"] = min(need, r.tile_capacity_max)
        if over["rect"]:
            R = int(round(r.max_tiles_per_gaussian ** 0.5)) + 1
            if R * R <= 64:
                kw["max_tiles_per_gaussian"] = R * R
            if r.windowed and r.windowed_big_capacity < 1024:
                kw["windowed_big_capacity"] = (r.windowed_big_capacity * 2
                                               if r.windowed_big_capacity else 128)
        if over["window"] or over["big"]:
            kw.update(self._rederive_windowed(r))
        self._overflow_strikes = 0
        if not kw:
            return
        self.cfg = self.cfg.replace(raster=dataclasses.replace(r, **kw))
        self._rebuild_frontend()

    def _maybe_shrink_capacity(self, peak: int, overflow_free: bool,
                               units: int = 1) -> None:
        """One 256-lattice step down after 4·metrics_interval quiet trained
        frames, never below 1.25× the observed peak."""
        r = self.cfg.raster
        target = max(256, _lattice256(peak), r.tile_capacity - 256)
        if not (overflow_free and target < r.tile_capacity):
            self._quiet_shrink = 0
            return
        self._quiet_shrink += max(units, 1)
        if self._quiet_shrink < 4 * max(self.cfg.metrics_interval, 1):
            return
        self._quiet_shrink = 0
        self.cfg = self.cfg.replace(raster=dataclasses.replace(r, tile_capacity=target))
        self._rebuild_frontend()

    # -- fused front-end ------------------------------------------------
    def _fused_setup(self, df, frame: Frame) -> None:
        H, W = frame.image.shape[1:]
        self._fused = fused_mod.FusedFrontend(self.cfg, H, W,
                                              sensor_frame=df.sensor_frame)
        self._fused.lm_log = self.lm_log
        if self.track is None:
            self.track = fused_mod.init_track_state(
                self.cfg.tracking.max_points,
                max(self.cfg.metrics_interval, 4) + self._DRAIN_LAG + 2, self.device)
        if self._zeros_objects is None:
            self._zeros_objects = torch.zeros((H, W), dtype=torch.int32,
                                              device=self.device)

    def _snapshot(self) -> None:
        m = self.track.metrics
        if m.device.type == "cuda":
            host = torch.empty(m.shape, dtype=m.dtype, pin_memory=True)
            host.copy_(m, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            host, ev = m.clone(), None
        self._met_snaps.append((self._host_mi, host, ev))

    def _frame_fused(self, df, frame: Frame, frame_idx: int):
        """One frame through the fused front-end. Returns the device pose."""
        cfg = self.cfg
        if self._fused is None:
            self._fused_setup(df, frame)
        self._maybe_grow_map(self.point_budget)
        mode = cfg.tracking.backend
        first = self._fused_first and mode != "none"
        scan, smask = df.scan, df.scan_mask
        if scan is None:
            scan, smask = self.track.prev_scan, self.track.prev_mask
        common = (self.state, self.track, scan, smask, df.points, df.colors,
                  df.mask, df.pose)
        if frame_idx % cfg.keyframes.keyframe_freq == 0:
            objects = self._zeros_objects
            self.state, self.track, T, cam = self._fused.track_add_train_self(
                *common, df.image, objects, first=first)
            self.keyframes.append(Keyframe(camera=cam, image=df.image,
                                           objects=objects, pose=T))
            if len(self.keyframes) > cfg.keyframes.window:
                self.keyframes.pop(0)
        elif cfg.keyframes.replay and self.keyframes:
            kf = self.keyframes[self._kf_rng.integers(len(self.keyframes))]
            self.state, self.track, T = self._fused.track_add_train_stored(
                *common, kf.camera, kf.image, kf.objects)
        else:
            self.state, self.track, T = self._fused.track_add(*common, first=first)
        self._fused_first = False
        self._host_mi += 1
        self._snapshot()
        self._maybe_drain_lagged()
        return T

    def _maybe_drain_lagged(self) -> None:
        interval = self.cfg.metrics_interval
        target = self._drained_mi + interval
        if self._host_mi < target + self._DRAIN_LAG:
            return
        snap = next(((h, ev) for mi, h, ev in self._met_snaps if mi == target), None)
        self._drain_metrics(snapshot=snap, upto_mi=target if snap is not None else None)
        self._met_snaps = [s for s in self._met_snaps if s[0] > self._drained_mi]

    def _train_once_fused(self, kf: Keyframe):
        self.state, self.track = self._fused.train_only(
            self.state, self.track, kf.camera, kf.image, kf.objects)
        self._host_mi += 1
        self._snapshot()
        self._maybe_drain_lagged()

    def _drain_metrics(self, snapshot=None, upto_mi: Optional[int] = None) -> None:
        """Read the metrics rows of every frame since the last drain → loss log
        and overflow adaptation."""
        if self.track is None:
            return
        end_mi = self._host_mi if upto_mi is None else upto_mi
        k = end_mi - self._drained_mi
        if k <= 0:
            return
        if snapshot is None:
            buf = self.track.metrics.cpu().numpy()
        else:
            host, ev = snapshot
            if ev is not None:
                ev.synchronize()
            buf = host.numpy()
        M = buf.shape[0]
        if k > M:
            raise RuntimeError(f"metrics drain fell {k} rows behind a ring of {M}")
        start = self._drained_mi % M
        peak, overflow_free, trained_rows = 0, True, 0
        for j in range(k):
            r = buf[(start + j) % M]
            if r[fused_mod.MET_TRAINED] > 0.5:
                self.losses.append(float(r[fused_mod.MET_LOSS]))
                self.train_iter += 1
                trained_rows += 1
                peak = max(peak, int(r[fused_mod.MET_TILE_PEAK]))
                overflow_free &= (int(r[fused_mod.MET_OV_TILE_LIVE]) == 0
                                  and int(r[fused_mod.MET_OV_RECT]) == 0
                                  and int(r[fused_mod.MET_OV_WINDOW]) == 0
                                  and int(r[fused_mod.MET_OV_BIG]) == 0)
                self._maybe_grow_capacity(_HostMetrics(
                    loss=float(r[fused_mod.MET_LOSS]),
                    n_binned=int(r[fused_mod.MET_N_BINNED]),
                    overflow_tile=int(r[fused_mod.MET_OV_TILE]),
                    overflow_rect=int(r[fused_mod.MET_OV_RECT]),
                    overflow_window=int(r[fused_mod.MET_OV_WINDOW]),
                    overflow_big=int(r[fused_mod.MET_OV_BIG]),
                    tile_peak=int(r[fused_mod.MET_TILE_PEAK]),
                    overflow_tile_live=int(r[fused_mod.MET_OV_TILE_LIVE]),
                ))
        if trained_rows:
            self._maybe_shrink_capacity(peak, overflow_free, units=trained_rows)
        self._drained_mi = end_mi

    # ------------------------------------------------------------------
    def run(self, frames: Iterable[Frame], post_train: Optional[int] = None) -> PipelineResult:
        """Consume a frame stream, then post-train on random keyframes."""
        cfg = self.cfg
        poses_est, poses_gt = [], []
        scan_budget = cfg.tracking.max_points if cfg.tracking.backend != "none" else None
        q = FrameQueue(frames, self.point_budget, self.device, prefetch=2,
                       timeout_s=cfg.timeout_s, scan_budget=scan_budget)
        frame_times: List[float] = []
        try:
            for frame_idx, (df, frame) in enumerate(q):
                t_frame = time.perf_counter()
                poses_est.append(self._frame_fused(df, frame, frame_idx))
                poses_gt.append(np.full((4, 4), np.nan, np.float32) if frame.pose is None
                                else np.asarray(frame.pose))
                frame_times.append(time.perf_counter() - t_frame)
        finally:
            q.close()
        n_post = cfg.post_train_iters if post_train is None else post_train
        for _ in range(n_post):
            if not self.keyframes:
                break
            self._train_once_fused(self.keyframes[self._kf_rng.integers(len(self.keyframes))])
        self._drain_metrics()
        self._met_snaps.clear()
        poses_np = (torch.stack(poses_est).cpu().numpy() if poses_est
                    else np.zeros((0, 4, 4)))
        return PipelineResult(
            poses_est=poses_np.astype(np.float32),
            poses_gt=np.stack(poses_gt) if poses_gt else np.zeros((0, 4, 4)),
            n_keyframes=len(self.keyframes), train_iters=self.train_iter,
            losses=self.losses, state=self.state, timed_out=q.timed_out,
            frame_times=frame_times)
