"""The per-frame SLAM programs of the fused front-end (`sags_tpu.slam.fused`
in torch): surfel covariances → GICP align → pose compose → world
registration → map growth → one training step → a metrics row.

There is no `jit`: each "program" is one Python function of device tensors.
Host-read scalars go to a device metrics ring that the pipeline drains every
`metrics_interval` frames. Tracking modes: "gicp" and "vgicp" (scan-to-scan),
"gicp_map" (scan-to-map against the map's trackable Gaussians once the
pipeline finds the map anchored, scan-to-scan before), "none" (odometry
poses consumed). The ESIKF tracker runs on the per-module front-end
(`slam/pipeline.py`), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import torch

from sags_tpu_torch import device_constant
from sags_tpu_torch.core.camera import Camera, focal2fov, make_camera
from sags_tpu_torch.core.config import SLAMConfig
from sags_tpu_torch.core.transforms import (LIDAR_TO_CAM, quat_to_rotmat, rotmat_to_quat,
                                            se3_inverse, se3_matrix)
from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.ops import gicp as gicp_ops
from sags_tpu_torch.slam import step as slam_step_mod
from sags_tpu_torch.utils.profiling import span

# metrics ring columns: the step's host row (`step.HOST_FIELDS`), then the
# frame's trackable count and 1 where the frame trained
MET_N_TRACKABLE = len(slam_step_mod.HOST_FIELDS)
MET_TRAINED = MET_N_TRACKABLE + 1
MET_COLS = MET_TRAINED + 1


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


def lidar_to_cam(device) -> torch.Tensor:
    return device_constant("lidar_to_cam", lambda: LIDAR_TO_CAM, device)


def _camera_at(T: torch.Tensor, cfg: SLAMConfig, H: int, W: int) -> Camera:
    cam_cfg = cfg.camera
    fovx = focal2fov(cam_cfg.fx * W / cam_cfg.width, W)
    fovy = focal2fov(cam_cfg.fy * H / cam_cfg.height, H)
    R = T[:3, :3]
    if cfg.lidar_axes:
        R = R @ lidar_to_cam(T.device)
    return make_camera(R, T[:3, 3], W, H, fovx, fovy)


def _write_row(track: TrackState, row: torch.Tensor) -> TrackState:
    M = track.metrics.shape[0]
    metrics = track.metrics.clone()
    metrics[track.mi % M] = row
    return track._replace(metrics=metrics, mi=track.mi + 1)


class FusedFrontend:
    """The per-frame programs for one (cfg, H, W, sensor_frame, mesh)
    operating point; every training step's compositor is sharded over
    `mesh`. `lm_log` collects (outer, inner) LM iterations per align."""

    MODES = ("gicp", "vgicp", "gicp_map", "none")

    def __init__(self, cfg: SLAMConfig, H: int, W: int, *, sensor_frame: bool,
                 mesh=None):
        if cfg.tracking.backend not in self.MODES:
            raise NotImplementedError(
                f"tracking backend {cfg.tracking.backend!r} has no fused front-end "
                f"(fused: {self.MODES}); SLAMPipeline runs esikf on the per-module one")
        self.cfg = cfg
        self.H, self.W = H, W
        self.sensor_frame = sensor_frame
        self.mesh = mesh
        self.lm_log: List[tuple] = []

    # -- pieces ------------------------------------------------------------
    def _track(self, state, track: TrackState, scan, smask, pose_in, *, anchored: bool,
               first: bool):
        """Pose estimate and the next frame's target (`sags_tpu/slam/fused.py`
        `_track`): scan-to-scan deltas compose into `track.T`; the anchored
        scan-to-map align solves the absolute pose from the constant-velocity
        prediction. Covariances are estimated once per scan and reused as the
        next frame's target."""
        with span("track", device=track.T.device):
            cfg = self.cfg
            mode = cfg.tracking.backend
            if mode == "none":
                return (pose_in, track.prev_scan, track.prev_mask, track.prev_covs,
                        track.prev_delta)
            with span("track.covariances"):
                covs = _estimate_covs(scan, smask, cfg).covs
            if first:
                return track.T, scan, smask, covs, track.prev_delta
            if mode == "gicp_map" and anchored:
                tcfg = cfg.tracking
                tgt, tcov, tmask, _ = gm.trackable_subset(state.map, tcfg.opacity_threshold,
                                                          tcfg.max_points)
                # part of each scan is new geometry with no map counterpart yet:
                # gate the correspondences so it does not drag the solve
                gcfg = dataclasses.replace(cfg.gicp, corr_dist_threshold=tcfg.map_corr_threshold)
                init = track.T @ track.prev_delta  # constant-velocity warm start
                res = gicp_ops.gicp_align(scan, tgt, smask, tmask, init, gcfg, source_covs=covs,
                                          target_covs=tcov)
                self.lm_log.append((res.iterations, res.lm_iterations))
                # a solve that lands far from the prediction failed (thin or
                # ambiguous target): keep the prediction, with no host sync
                jump = torch.linalg.vector_norm(res.T[:3, 3] - init[:3, 3])
                T_new = torch.where(jump <= tcfg.max_jump, res.T, init)
                # Project the rotation back onto SO(3). The next warm start is
                # T·(Tᵀ-inverse(T_prev)·T): without this, float32 rounding of
                # RRᵀ = I grows ~2.4× a frame through that loop (1e-7 → 5e-2 in
                # 16 frames, then the solve fails), as it does in the JAX package
                T_new = se3_matrix(quat_to_rotmat(rotmat_to_quat(T_new[:3, :3])), T_new[:3, 3])
                return T_new, scan, smask, covs, se3_inverse(track.T) @ T_new
            align = gicp_ops.vgicp_align if mode == "vgicp" else gicp_ops.gicp_align
            res = align(scan, track.prev_scan, smask, track.prev_mask, track.prev_delta,
                        cfg.gicp, source_covs=covs, target_covs=track.prev_covs)
            self.lm_log.append((res.iterations, res.lm_iterations))
            return track.T @ res.T, scan, smask, covs, res.T

    def _add(self, state, T, points, colors, pmask, kf_id: int):
        with span("map.add", device=T.device):
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
                   pose_in, anchored: bool, first: bool):
        T, pscan, pmsk, pcovs, pdelta = self._track(state, track, scan, smask, pose_in,
                                                    anchored=anchored, first=first)
        state = self._add(state, T, points, colors, pmask, track.frame_idx)
        track = track._replace(T=T, prev_scan=pscan, prev_mask=pmsk,
                               prev_covs=pcovs, prev_delta=pdelta,
                               frame_idx=track.frame_idx + 1)
        return state, track, T

    def _train_and_metrics(self, state, track, camera, image, objects):
        cfg = self.cfg
        state, sm = slam_step_mod.slam_step(state, camera, image, objects, cfg, self.mesh)
        row = slam_step_mod.host_row(sm, _n_trackable(state.map, cfg),
                                     torch.ones((), device=sm.loss.device))
        return state, _write_row(track, row)

    def _idle_metrics(self, state, track):
        row = torch.zeros(MET_COLS, device=track.metrics.device)
        row[MET_N_TRACKABLE] = _n_trackable(state.map, self.cfg).to(torch.float32)
        return _write_row(track, row)

    # -- programs (the JAX FusedFrontend's) -------------------------------
    def track_add_train_self(self, state, track, scan, smask, points, colors,
                             pmask, pose_in, image, objects, *, first: bool,
                             anchored: bool = False):
        """Keyframe: track → grow → train at the just-estimated pose."""
        state, track, T = self._track_add(state, track, scan, smask, points,
                                          colors, pmask, pose_in, anchored, first)
        cam = _camera_at(T, self.cfg, self.H, self.W)
        state, track = self._train_and_metrics(state, track, cam, image, objects)
        return state, track, T, cam

    def track_add_train_stored(self, state, track, scan, smask, points, colors,
                               pmask, pose_in, kf_cam, kf_image, kf_objects, *,
                               anchored: bool = False):
        """Replay: track → grow → train on a stored keyframe."""
        state, track, T = self._track_add(state, track, scan, smask, points,
                                          colors, pmask, pose_in, anchored, False)
        state, track = self._train_and_metrics(state, track, kf_cam, kf_image,
                                               kf_objects)
        return state, track, T

    def track_add(self, state, track, scan, smask, points, colors, pmask,
                  pose_in, *, first: bool, write_row: bool, anchored: bool = False):
        """Track → grow without training: the first half of the semantics
        split (the host makes the frame's objects at the returned camera,
        then `train_only` finishes the frame) and the frame with no replay
        keyframe yet. `write_row` writes the frame's idle metrics row: True
        when no `train_only` follows, whose row would count the frame twice.
        Returns (state, track, T, cam)."""
        state, track, T = self._track_add(state, track, scan, smask, points,
                                          colors, pmask, pose_in, anchored, first)
        cam = _camera_at(T, self.cfg, self.H, self.W)
        if write_row:
            track = self._idle_metrics(state, track)
        return state, track, T, cam

    def train_only(self, state, track, cam, image, objects):
        """Map optimization with a metrics row (the post-training loop)."""
        return self._train_and_metrics(state, track, cam, image, objects)
