"""The per-frame SLAM programs of the fused front-end (`sags_tpu.slam.fused`
in torch): surfel covariances → GICP align → pose compose → world
registration → map growth → one training step → a metrics row.

There is no `jit`: each "program" is one Python function of device tensors.
Host-read scalars go to a device metrics ring that the pipeline drains every
`metrics_interval` frames. Tracking modes ported: "gicp" (scan-to-scan) and
"none" (odometry poses consumed).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from sags_tpu_torch.core.camera import Camera, focal2fov, make_camera
from sags_tpu_torch.core.config import SLAMConfig
from sags_tpu_torch.core.transforms import LIDAR_TO_CAM
from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.ops import gicp as gicp_ops
from sags_tpu_torch.slam import step as slam_step_mod

# metrics ring-buffer columns
MET_LOSS = 0
MET_N_BINNED = 1
MET_OV_TILE = 2
MET_OV_RECT = 3
MET_OV_WINDOW = 4
MET_OV_BIG = 5
MET_N_TRACKABLE = 6
MET_TRAINED = 7
MET_TILE_PEAK = 8
MET_OV_TILE_LIVE = 9
MET_COLS = 10


class TrackState(NamedTuple):
    T: torch.Tensor  # [4,4] accumulated world-from-sensor pose
    prev_scan: torch.Tensor  # [N,3]
    prev_mask: torch.Tensor  # [N]
    prev_covs: torch.Tensor  # [N,3,3]
    prev_delta: torch.Tensor  # [4,4] last scan-to-scan delta (warm start)
    frame_idx: int  # keyframe_id for map growth
    metrics: torch.Tensor  # [M, MET_COLS]
    mi: int  # monotone metrics write count


def init_track_state(n_scan: int, n_metrics: int, device) -> TrackState:
    eye4 = torch.eye(4, device=device)
    return TrackState(
        T=eye4, prev_scan=torch.zeros((n_scan, 3), device=device),
        prev_mask=torch.zeros(n_scan, dtype=torch.bool, device=device),
        prev_covs=torch.eye(3, device=device).repeat(n_scan, 1, 1),
        prev_delta=eye4.clone(), frame_idx=0,
        metrics=torch.zeros((n_metrics, MET_COLS), device=device), mi=0)


def _estimate_covs(scan, mask, cfg: SLAMConfig):
    g = cfg.gicp
    return gicp_ops.estimate_covariances(scan, mask, g.k_correspondences,
                                         g.knn_max_distance, g.regularization)


def _n_trackable(m: gm.GaussianMap, cfg: SLAMConfig) -> torch.Tensor:
    sel = (gm.get_opacity(m) > cfg.tracking.opacity_threshold) & m.trackable & m.active
    return torch.sum(sel.to(torch.int32))


def _camera_at(T: torch.Tensor, cfg: SLAMConfig, H: int, W: int) -> Camera:
    cam_cfg = cfg.camera
    fovx = focal2fov(cam_cfg.fx * W / cam_cfg.width, W)
    fovy = focal2fov(cam_cfg.fy * H / cam_cfg.height, H)
    R = T[:3, :3]
    if cfg.lidar_axes:
        R = R @ torch.as_tensor(LIDAR_TO_CAM, device=T.device)
    return make_camera(R, T[:3, 3], W, H, fovx, fovy)


def _write_row(track: TrackState, row: torch.Tensor) -> TrackState:
    M = track.metrics.shape[0]
    metrics = track.metrics.clone()
    metrics[track.mi % M] = row
    return track._replace(metrics=metrics, mi=track.mi + 1)


class FusedFrontend:
    """The per-frame programs for one (cfg, H, W, sensor_frame) operating
    point. `lm_log` collects (outer, inner) LM iterations per align."""

    MODES = ("gicp", "none")

    def __init__(self, cfg: SLAMConfig, H: int, W: int, *, sensor_frame: bool):
        if cfg.tracking.backend not in self.MODES:
            raise NotImplementedError(
                f"tracking backend {cfg.tracking.backend!r} is not ported yet "
                f"(ported: {self.MODES})")
        self.cfg = cfg
        self.H, self.W = H, W
        self.sensor_frame = sensor_frame
        self.lm_log: List[tuple] = []

    # -- pieces ------------------------------------------------------------
    def _track(self, track: TrackState, scan, smask, pose_in, *, first: bool):
        cfg = self.cfg
        if cfg.tracking.backend == "none":
            return (pose_in, track.prev_scan, track.prev_mask, track.prev_covs,
                    track.prev_delta)
        covs = _estimate_covs(scan, smask, cfg).covs
        if first:
            return track.T, scan, smask, covs, track.prev_delta
        res = gicp_ops.gicp_align(scan, track.prev_scan, smask, track.prev_mask,
                                  track.prev_delta, cfg.gicp, source_covs=covs,
                                  target_covs=track.prev_covs)
        self.lm_log.append((res.iterations, res.lm_iterations))
        return track.T @ res.T, scan, smask, covs, res.T

    def _add(self, state, T, points, colors, pmask, kf_id: int):
        cfg = self.cfg
        if self.sensor_frame:
            points = points @ T[:3, :3].T + T[:3, 3]
        quats = scales = None
        if cfg.map.surfel_init and cfg.tracking.backend != "none":
            pc = _estimate_covs(points, pmask, cfg)
            quats, scales = pc.quats, pc.scales
        state, _ = slam_step_mod.add_frame_points(
            state, points, colors, pmask, cfg, quats=quats, scales=scales,
            keyframe_id=kf_id)
        return state

    def _track_add(self, state, track, scan, smask, points, colors, pmask,
                   pose_in, first: bool):
        T, pscan, pmsk, pcovs, pdelta = self._track(track, scan, smask, pose_in,
                                                    first=first)
        state = self._add(state, T, points, colors, pmask, track.frame_idx)
        track = track._replace(T=T, prev_scan=pscan, prev_mask=pmsk,
                               prev_covs=pcovs, prev_delta=pdelta,
                               frame_idx=track.frame_idx + 1)
        return state, track, T

    def _train_and_metrics(self, state, track, camera, image, objects):
        cfg = self.cfg
        state, sm = slam_step_mod.slam_step(state, camera, image, objects, cfg)
        f = lambda x: x.to(torch.float32).reshape(())
        row = torch.stack([
            f(sm.loss), f(sm.n_binned), f(sm.overflow_tile), f(sm.overflow_rect),
            f(sm.overflow_window), f(sm.overflow_big),
            f(_n_trackable(state.map, cfg)), torch.ones((), device=sm.loss.device),
            f(sm.tile_peak), f(sm.overflow_tile_live),
        ])
        return state, _write_row(track, row)

    def _idle_metrics(self, state, track):
        row = torch.zeros(MET_COLS, device=track.metrics.device)
        row[MET_N_TRACKABLE] = _n_trackable(state.map, self.cfg).to(torch.float32)
        return _write_row(track, row)

    # -- programs (the JAX FusedFrontend's, less the modes not ported) -----
    def track_add_train_self(self, state, track, scan, smask, points, colors,
                             pmask, pose_in, image, objects, *, first: bool):
        """Keyframe: track → grow → train at the just-estimated pose."""
        state, track, T = self._track_add(state, track, scan, smask, points,
                                          colors, pmask, pose_in, first)
        cam = _camera_at(T, self.cfg, self.H, self.W)
        state, track = self._train_and_metrics(state, track, cam, image, objects)
        return state, track, T, cam

    def track_add_train_stored(self, state, track, scan, smask, points, colors,
                               pmask, pose_in, kf_cam, kf_image, kf_objects):
        """Replay: track → grow → train on a stored keyframe."""
        state, track, T = self._track_add(state, track, scan, smask, points,
                                          colors, pmask, pose_in, False)
        state, track = self._train_and_metrics(state, track, kf_cam, kf_image,
                                               kf_objects)
        return state, track, T

    def track_add(self, state, track, scan, smask, points, colors, pmask,
                  pose_in, *, first: bool):
        """Track → grow without training (no replay keyframe yet), with an
        idle metrics row."""
        state, track, T = self._track_add(state, track, scan, smask, points,
                                          colors, pmask, pose_in, first)
        return state, self._idle_metrics(state, track), T

    def train_only(self, state, track, cam, image, objects):
        """Map optimization with a metrics row (the post-training loop)."""
        return self._train_and_metrics(state, track, cam, image, objects)
