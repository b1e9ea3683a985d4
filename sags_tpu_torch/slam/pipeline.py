"""Online SLAM pipeline (`sags_tpu.slam.pipeline` in torch): frame stream →
track → map growth → keyframing → one training step per frame, the
overflow-adaptive render capacities (with the windowed budget probe), and
`evaluate`, the PSNR / SSIM / LPIPS of the map rendered at given poses.

Two front-ends, as in the JAX package. The fused one (`slam/fused.py`, the
default for "gicp", "vgicp", "gicp_map" and "none") writes each frame's
scalars to a device metrics ring drained every `metrics_interval` frames.
The per-module one (`fused_frontend=False`, and always for "esikf") calls
the tracker, `add_frame_points` and `slam_step` one after the other and
reads each training step's scalars in one packed fetch (`_train_once`). Its
trackers: scan-to-scan "gicp" / "vgicp" from the identity, "gicp_map"
against the map's trackable Gaussians from the last pose once anchored, and
"esikf": IMU propagation (or a constant-position inflation of P), the
iterated point-to-plane update against an incremental surfel map, the
photometric update under `esikf_visual`, then the scan folded into the map
at the estimated pose (`ops/esikf.py`); a scan-to-scan GICP on the first
frame pair seeds pose and velocity (`esikf_bootstrap`). In steady state an
ESIKF frame reads nothing on the host; the surfel count is probed once a
frame until the map is live.

With a mask generator (`semantics.geometric.GeometricMaskGenerator` or
`semantics.masks.MaskGenerator`) a keyframe is split as in
`sags_tpu/slam/pipeline.py:602-611`: `track_add(write_row=False)`, then
`_make_objects` (the generator's label map at the tracked pose, its IDs
associated on the device by `DeviceInstanceAssociator`), then `train_only`
on those objects, which writes the frame's one metrics row.

Tracking "gicp_map" aligns each scan against the map once the map is
anchored: `_map_anchored` flips when a frame's metrics row counts
`anchor_min_points` trackable Gaussians (one scalar fetch a frame until then,
none after; `sags_tpu/slam/pipeline.py:634-642`), and is chosen on the host
before each frame.

`SLAMPipeline(cfg, mesh=parallel.mesh.make_mesh())`, run on every rank of
a `torchrun --nproc-per-node N` launch, shards each training step's
compositor over the ranks' tiles (both front-ends, and across the capacity
and budget rebuilds); everything else runs replicated, so every rank holds
the same state. `evaluate` renders unsharded, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.camera import Camera, focal2fov, make_camera
from sags_tpu_torch.core.config import SLAMConfig
from sags_tpu_torch.core.transforms import LIDAR_TO_CAM, se3_matrix
from sags_tpu_torch.eval import metrics as eval_metrics
from sags_tpu_torch.io.datasets import Frame
from sags_tpu_torch.io.queue import FrameQueue, upload
from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.ops import esikf
from sags_tpu_torch.ops import gicp as gicp_ops
from sags_tpu_torch.ops import rasterize as rz
from sags_tpu_torch.semantics.association import DeviceInstanceAssociator
from sags_tpu_torch.slam import fused as fused_mod
from sags_tpu_torch.slam import step as slam_step_mod
from sags_tpu_torch.utils.profiling import host_read, span


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


def _lattice256(peak) -> int:
    """1.25× headroom over a peak need, rounded up to the 256-lattice."""
    return -(-int(peak * 1.25) // 256) * 256


def camera_for(cfg: SLAMConfig, frame: Frame, pose: np.ndarray, device) -> Camera:
    """The camera of `frame` at `pose` (camera-to-world, 4×4): the preset's
    intrinsics scaled to the frame's image, LiDAR axes turned under
    `cfg.lidar_axes`."""
    H, W = frame.image.shape[1:]
    cam_cfg = cfg.camera
    fovx = focal2fov(cam_cfg.fx * W / cam_cfg.width, W)
    fovy = focal2fov(cam_cfg.fy * H / cam_cfg.height, H)
    R = np.asarray(pose, np.float32)[:3, :3]
    if cfg.lidar_axes:
        R = R @ LIDAR_TO_CAM
    return make_camera(R, np.asarray(pose, np.float32)[:3, 3], W, H, fovx, fovy,
                       device=device)


class SLAMPipeline:
    # frames a metrics snapshot ages before it is read
    _DRAIN_LAG = 2

    def __init__(self, cfg: SLAMConfig, mask_generator=None, mesh=None,
                 point_budget: int = 4096, rng_seed: int = 0, device=None,
                 draws=None):
        self.device = resolve_device(mesh.device if device is None and mesh is not None
                                     else device)
        self.cfg = cfg
        self.mesh = mesh
        self.point_budget = point_budget
        self.mask_generator = mask_generator
        self.state = slam_step_mod.init_state(cfg, rng_seed, device=self.device,
                                              draws=draws)
        self.keyframes: List[Keyframe] = []
        self.associator = DeviceInstanceAssociator(
            cfg.semantics.overlap_threshold, lidar_axes=cfg.lidar_axes,
            num_classes=cfg.semantics.num_classes)
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
        # gicp_map: the map has enough trackable Gaussians to align against.
        # Monotone (the map only grows), so the probe stops once it flips.
        self._map_anchored = False
        self.anchored_at: Optional[int] = None  # first frame tracked scan-to-map
        self._n_frames = 0  # frames tracked over every `run`
        # per-module front-end: (scan, mask, covs) of the last scan, whose
        # covariances serve as the next frame's target; the accumulated pose
        self._prev_scan = None
        self._eye4 = torch.eye(4, device=self.device)
        self._track_T = self._eye4
        self._esikf: Optional[esikf.ESIKFState] = None
        self._track_map: Optional[esikf.SurfelMap] = None  # the filter's surfel map
        self._esikf_boot = None  # (scan, mask, timestamp) of the first frame
        self._surfels_live = False  # the surfel map holds a voxel (monotone)

    # ------------------------------------------------------------------
    def _maybe_grow_map(self, incoming: int) -> None:
        """Grow by doubling before an add could hit capacity; compact first
        when pruned holes free enough room."""
        if self._count_ub is None:
            self._count_ub = host_read(int, self.state.map.count)
        cap = self.state.map.capacity
        if self._count_ub + incoming <= cap:
            self._count_ub += incoming
            return
        self._count_ub = host_read(int, self.state.map.count)
        if self._count_ub + incoming <= cap:
            self._count_ub += incoming
            return
        n_act = host_read(int, gm.n_active(self.state.map))
        if cap - n_act >= max(incoming, cap // 4):
            with span("map.grow"):
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
        with span("map.grow"):
            new_map, new_opt = gm.grow(self.state.map, new_cap, self.state.opt_state)
        self.state = self.state._replace(map=new_map, opt_state=new_opt)

    def _camera_for(self, frame: Frame, pose: np.ndarray) -> Camera:
        return camera_for(self.cfg, frame, pose, self.device)

    def _rederive_windowed(self, r):
        """Size every windowed-path buffer from one occupancy probe of the
        current map at the newest keyframe's viewpoint (`windowed_occupancy`
        → `derive_windowed_budgets`, margin 1.2). Returns the derived knobs,
        or None when there is no keyframe to probe from."""
        if not self.keyframes:
            return None
        m = self.state.map
        with torch.no_grad():
            occ = rz.windowed_occupancy(m.xyz, gm.get_opacity(m), gm.get_scaling(m),
                                        gm.get_rotation(m), self.keyframes[-1].camera,
                                        r, active_mask=m.active)
        occ = {k: host_read(torch.Tensor.cpu, v).numpy() for k, v in occ.items()}
        derived = rz.derive_windowed_budgets(r, occ, m.capacity, margin=1.2)
        out = {
            "windowed_store_fracs": derived.windowed_store_fracs,
            "windowed_mid_frac": derived.windowed_mid_frac,
            "windowed_big_frac": derived.windowed_big_frac,
            "windowed_copy_ring_frac": derived.windowed_copy_ring_frac,
            "windowed_expand_frac": derived.windowed_expand_frac,
            "window_blocks": min(derived.window_blocks, 40),
        }
        # the classic path's R×R window, sized to the widest live splat
        # (capped at 8×8; wider rects stay counted in overflow_rect)
        side = int(occ["max_rect_side"])
        R = int(round(r.max_tiles_per_gaussian ** 0.5))
        if side:
            out["max_tiles_per_gaussian"] = min(max(side, R), 8) ** 2
        return out

    def _rebuild_frontend(self) -> None:
        if self._fused is not None:
            self._fused = fused_mod.FusedFrontend(
                self.cfg, self._fused.H, self._fused.W,
                sensor_frame=self._fused.sensor_frame, mesh=self.mesh)
            self._fused.lm_log = self.lm_log

    def _adapt(self, r, **kw) -> None:
        """Take the raster caps `kw` over `r` and rebuild the front-end at
        them."""
        with span("capacity.adapt"):
            self.cfg = self.cfg.replace(raster=dataclasses.replace(r, **kw))
            self._rebuild_frontend()

    def _maybe_grow_capacity(self, row: np.ndarray) -> None:
        """Overflow-adaptive render capacities, from one step's host row
        (`step.HOST_FIELDS`): three strikes in a row grow tile_capacity (to
        1.25× the peak need), the binning window (rect), and the windowed
        budgets (window, big: one probe; doubling when there is nothing to
        probe or the probe changes nothing)."""
        v = lambda name: int(row[slam_step_mod.HOST_COL[name]])
        thresh = 0.001 * max(v("n_binned"), 1)
        over = {kind: v(name) > thresh for kind, name in (
            ("tile", "overflow_tile_live"), ("rect", "overflow_rect"),
            ("window", "overflow_window"), ("big", "overflow_big"))}
        self._overflow_strikes = self._overflow_strikes + 1 if any(over.values()) else 0
        if self._overflow_strikes < 3:
            return
        r = self.cfg.raster
        kw = {}
        if over["tile"] and r.tile_capacity < r.tile_capacity_max:
            need = _lattice256(v("tile_peak"))
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
            derived = self._rederive_windowed(dataclasses.replace(r, **kw) if kw else r)
            if derived is not None and any(getattr(r, k) != v for k, v in derived.items()):
                kw.update(derived)
            else:
                if over["window"] and r.window_blocks < 40:
                    kw["window_blocks"] = r.window_blocks + 2
                if over["big"]:
                    if r.windowed_mid_frac < 1.0:
                        kw["windowed_mid_frac"] = min(r.windowed_mid_frac * 2, 1.0)
                    if r.windowed_big_frac < 1.0:
                        kw["windowed_big_frac"] = min(r.windowed_big_frac * 2, 1.0)
        self._overflow_strikes = 0
        if kw:
            self._adapt(r, **kw)

    def _maybe_shrink_capacity(self, rows: np.ndarray) -> None:
        """One 256-lattice step down after 4·metrics_interval quiet trained
        frames, never below 1.25× the observed peak. `rows` [n, ≥8]: the
        host rows (`step.HOST_FIELDS`) of the n steps trained since the last
        call."""
        col = slam_step_mod.HOST_COL
        r = self.cfg.raster
        target = max(256, _lattice256(int(rows[:, col["tile_peak"]].max())),
                     r.tile_capacity - 256)
        overflows = [col[f] for f in ("overflow_tile_live", "overflow_rect",
                                      "overflow_window", "overflow_big")]
        overflow_free = not rows[:, overflows].astype(np.int64).any()
        if not (overflow_free and target < r.tile_capacity):
            self._quiet_shrink = 0
            return
        self._quiet_shrink += len(rows)
        if self._quiet_shrink < 4 * max(self.cfg.metrics_interval, 1):
            return
        self._quiet_shrink = 0
        self._adapt(r, tile_capacity=target)

    def _make_objects(self, frame: Frame, pose: torch.Tensor) -> torch.Tensor:
        """The mask generator's label map of the frame, its IDs associated
        on the device with the map's (`sags_tpu/slam/pipeline.py:542-563`):
        one [L, L] vote table crosses to the host. Returns [H,W] int32 on
        the map's device. Span `segment` (device), around the generator's
        spans and `associate`."""
        H, W = frame.image.shape[1:]
        with span("segment", device=self.device):
            labels = self.mask_generator.generate_objects(frame.image)
            mask = host_read(torch.as_tensor, np.asarray(labels).astype(np.int32),
                             device=self.device)
            cam_cfg = self.cfg.camera
            fx = cam_cfg.fx * W / cam_cfg.width
            fy = cam_cfg.fy * H / cam_cfg.height
            cx = cam_cfg.cx * W / cam_cfg.width
            cy = cam_cfg.cy * H / cam_cfg.height
            return self.associator.associate(
                self.state.map.xyz, self.state.map.active, mask, pose, (fx, fy, cx, cy),
                used_labels=getattr(self.mask_generator, "used_labels", None))

    # -- per-module front-end --------------------------------------------
    @property
    def _use_fused(self) -> bool:
        return (self.cfg.fused_frontend
                and self.cfg.tracking.backend in fused_mod.FusedFrontend.MODES)

    def _scan_covs(self, scan, mask) -> torch.Tensor:
        g = self.cfg.gicp
        with span("track.covariances"):
            return gicp_ops.estimate_covariances(scan, mask, g.k_correspondences,
                                                 g.knn_max_distance, g.regularization).covs

    def _align(self, align, *args, **kw):
        res = align(*args, **kw)
        self.lm_log.append((res.iterations, res.lm_iterations))
        return res

    def _track(self, frame: Frame, df) -> torch.Tensor:
        """The frame's pose on the device (`sags_tpu/slam/pipeline.py:143-210`).
        "none" takes the odometry pose; the trackers read `frame.scan`, or,
        without one, the world points brought back through the frame's pose,
        padded to `tracking.max_points`."""
        mode = self.cfg.tracking.backend
        if mode == "none":
            if frame.pose is None:
                raise ValueError("tracking.backend='none' consumes odometry poses, but "
                                 "this frame carries none; use a tracking backend")
            return df.pose
        if frame.scan is not None:
            scan = np.asarray(frame.scan, np.float32)
        else:
            if frame.pose is None:
                raise ValueError("frame has neither scan nor pose")
            Tw = np.asarray(frame.pose, np.float32)
            scan = (frame.points - Tw[:3, 3]) @ Tw[:3, :3]
        budget = self.cfg.tracking.max_points
        n = min(len(scan), budget)
        scan_p = np.zeros((budget, 3), np.float32)
        scan_p[:n] = scan[:n]
        msk = np.arange(budget) < n

        if mode == "esikf":
            # the per-point intensity rides along when the frame's colours
            # are aligned with its scan sample (the synthetic data's are)
            intens = None
            if frame.colors is not None and len(frame.colors) == len(scan):
                iv = np.asarray(frame.colors, np.float32).mean(-1)
                intens = np.zeros(budget, np.float32)
                intens[:n] = iv[:n]
            return self._track_esikf(scan_p, msk, frame.imu, frame.timestamp,
                                     intens=intens, image=df.image)
        scan_d, msk_d = upload(scan_p, self.device), upload(msk, self.device)
        if mode == "gicp_map":
            return self._track_gicp_map(scan_d, msk_d)
        covs_d = self._scan_covs(scan_d, msk_d)
        if self._prev_scan is None:
            self._prev_scan = (scan_d, msk_d, covs_d)
            return self._track_T
        prev_p, prev_m, prev_c = self._prev_scan
        align = gicp_ops.vgicp_align if mode == "vgicp" else gicp_ops.gicp_align
        res = self._align(align, scan_d, prev_p, msk_d, prev_m, self._eye4, self.cfg.gicp,
                          source_covs=covs_d, target_covs=prev_c)
        self._track_T = self._track_T @ res.T
        self._prev_scan = (scan_d, msk_d, covs_d)
        return self._track_T

    def _track_gicp_map(self, scan_d, msk_d) -> torch.Tensor:
        """Scan-to-map GICP against the map's trackable Gaussians from the
        last pose, once the map is anchored (`anchor_min_points`; one scalar
        fetch a frame until then); scan-to-scan before
        (`sags_tpu/slam/pipeline.py:272-305`)."""
        tcfg = self.cfg.tracking
        tgt, tcov, tmask, n_sel = gm.trackable_subset(self.state.map, tcfg.opacity_threshold,
                                                      tcfg.max_points)
        if not self._map_anchored and host_read(int, n_sel) >= tcfg.anchor_min_points:
            self._map_anchored = True
            self.anchored_at = self._n_frames
        covs_d = self._scan_covs(scan_d, msk_d)
        if not self._map_anchored:
            if self._prev_scan is not None:
                prev_p, prev_m, prev_c = self._prev_scan
                res = self._align(gicp_ops.gicp_align, scan_d, prev_p, msk_d, prev_m,
                                  self._eye4, self.cfg.gicp, source_covs=covs_d,
                                  target_covs=prev_c)
                self._track_T = self._track_T @ res.T
            self._prev_scan = (scan_d, msk_d, covs_d)
            return self._track_T
        res = self._align(gicp_ops.gicp_align, scan_d, tgt, msk_d, tmask, self._track_T,
                          self.cfg.gicp, source_covs=covs_d, target_covs=tcov)
        self._track_T = res.T
        self._prev_scan = (scan_d, msk_d, covs_d)
        return self._track_T

    def _track_esikf(self, scan_p: np.ndarray, msk: np.ndarray,
                     imu: Optional[np.ndarray] = None, timestamp: Optional[float] = None,
                     intens: Optional[np.ndarray] = None,
                     image: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One ESIKF frame (`sags_tpu/slam/pipeline.py:307-408`): propagate,
        update against the surfel map (and the image), fold the scan in at
        the estimated pose. `image` is the staged [3,H,W] device image."""
        dev = self.device
        tcfg = self.cfg.tracking
        scan_d, msk_d = upload(scan_p, dev), upload(msk, dev)
        if self._esikf is None:
            self._esikf = esikf.init_state(device=dev)
            self._track_map = esikf.surfel_map_init(
                resolution=tcfg.downsample_resolution * 3, capacity=8192, device=dev)
            if tcfg.esikf_bootstrap:
                self._esikf_boot = (scan_d, msk_d, timestamp)
        elif self._esikf_boot is not None:
            # velocity bootstrap: the filter starts at v = 0, so a platform
            # already moving drifts until the cross-covariance learns v. One
            # scan-to-scan GICP on the first frame pair (no covariances
            # given: estimated) seeds pose and velocity.
            prev_p, prev_m, t0 = self._esikf_boot
            self._esikf_boot = None
            delta = self._align(gicp_ops.gicp_align, scan_d, prev_p, msk_d, prev_m,
                                self._eye4, self.cfg.gicp).T
            st = self._esikf
            dt = (timestamp - t0) if (timestamp is not None and t0 is not None
                                      and timestamp > t0) else None
            v = delta[:3, 3] / dt if dt else st.v
            self._esikf = st._replace(R=delta[:3, :3], p=delta[:3, 3], v=v)
        if imu is not None and len(imu):
            imu_d = upload(np.asarray(imu, np.float32), dev)
            self._esikf = esikf.propagate(self._esikf, imu_d[:, 0:3], imu_d[:, 3:6],
                                          imu_d[:, 6])
        else:
            # constant-position motion model: inflate P each frame
            q = torch.cat([torch.full((3,), 2e-3, device=dev), torch.full((3,), 4e-2, device=dev),
                           torch.full((3,), 1e-4, device=dev), torch.full((9,), 1e-8, device=dev)])
            self._esikf = self._esikf._replace(P=self._esikf.P + torch.diag(q))
        vm = esikf.surfel_map_voxels(self._track_map)
        if not self._surfels_live and host_read(int, vm.n_voxels) > 0:
            self._surfels_live = True  # the voxel count only grows
        if self._surfels_live:
            out = esikf.scan_update(self._esikf, scan_d, msk_d, vm,
                                    num_iters=tcfg.esikf_update_iters,
                                    min_planarity=tcfg.esikf_min_planarity)
            self._esikf = out.state
            if tcfg.esikf_visual and image is not None:
                # the visual leg after the LiDAR one (FAST-LIVO2's order);
                # under lidar_axes the filter tracks the LiDAR body, and the
                # camera-from-body rotation enters the projection as R_ext
                apts, aint, aok = esikf.surfel_map_anchors(self._track_map)
                H, W = image.shape[1:]
                cam_cfg = self.cfg.camera
                self._esikf = esikf.photo_update(
                    self._esikf, apts, aint, aok, image,
                    cam_cfg.fx * W / cam_cfg.width, cam_cfg.fy * H / cam_cfg.height,
                    cam_cfg.cx * W / cam_cfg.width, cam_cfg.cy * H / cam_cfg.height,
                    meas_noise=tcfg.esikf_photo_noise, num_iters=tcfg.esikf_photo_iters,
                    R_ext=fused_mod.lidar_to_cam(dev) if self.cfg.lidar_axes else None).state
        R, p = self._esikf.R, self._esikf.p
        self._track_map = esikf.surfel_map_update(
            self._track_map, scan_d @ R.T + p, msk_d,
            intensity=None if intens is None else upload(intens, dev))
        return se3_matrix(R, p)

    def _train_once(self, kf: Keyframe) -> slam_step_mod.StepMetrics:
        """One training step on keyframe `kf`; its scalars come to the host
        in one packed fetch and drive the capacity adaptation."""
        self.state, metrics = slam_step_mod.slam_step(self.state, kf.camera, kf.image,
                                                      kf.objects, self.cfg, self.mesh)
        row = host_read(torch.Tensor.cpu, slam_step_mod.host_row(metrics)).numpy()
        self.losses.append(float(row[slam_step_mod.HOST_COL["loss"]]))
        self.train_iter += 1
        self._maybe_grow_capacity(row)
        self._maybe_shrink_capacity(row[None])
        return metrics

    def _frame_modules(self, df, frame: Frame, frame_idx: int) -> torch.Tensor:
        """One frame through the per-module front-end
        (`sags_tpu/slam/pipeline.py:797-833`): track, register a sensor-frame
        scan at the estimated pose and grow the map, then train on a new
        keyframe or a stored one. Returns the device pose."""
        cfg = self.cfg
        with span("track", device=self.device):
            pose = self._track(frame, df)
        self._n_frames += 1
        pts = df.points
        if df.sensor_frame:
            pts = pts @ pose[:3, :3].T + pose[:3, 3]
        self._maybe_grow_map(self.point_budget)
        with span("map.add", device=self.device):
            self.state, _ = slam_step_mod.add_frame_points(self.state, pts, df.colors,
                                                           df.mask, cfg, keyframe_id=frame_idx)
        if frame_idx % cfg.keyframes.keyframe_freq == 0:
            H, W = frame.image.shape[1:]
            if self.mask_generator is not None:
                objects = self._make_objects(frame, pose)
            else:
                if self._zeros_objects is None:
                    self._zeros_objects = torch.zeros((H, W), dtype=torch.int32,
                                                      device=self.device)
                objects = self._zeros_objects
            kf = Keyframe(camera=fused_mod._camera_at(pose, cfg, H, W), image=df.image,
                          objects=objects, pose=pose)
            self.keyframes.append(kf)
            if len(self.keyframes) > cfg.keyframes.window:
                self.keyframes.pop(0)
            self._train_once(kf)
        elif cfg.keyframes.replay and self.keyframes:
            self._train_once(self.keyframes[self._kf_rng.integers(len(self.keyframes))])
        return pose

    # -- fused front-end ------------------------------------------------
    def _fused_setup(self, df, frame: Frame) -> None:
        H, W = frame.image.shape[1:]
        self._fused = fused_mod.FusedFrontend(self.cfg, H, W,
                                              sensor_frame=df.sensor_frame, mesh=self.mesh)
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
        anchored = self._map_anchored if mode == "gicp_map" else False
        first = self._fused_first and mode != "none"
        scan, smask = df.scan, df.scan_mask
        if scan is None:
            scan, smask = self.track.prev_scan, self.track.prev_mask
        common = (self.state, self.track, scan, smask, df.points, df.colors,
                  df.mask, df.pose)
        if frame_idx % cfg.keyframes.keyframe_freq == 0:
            if self.mask_generator is not None:
                # the masks and their association need the tracked pose
                # between tracking and training
                self.state, self.track, T, cam = self._fused.track_add(
                    *common, first=first, write_row=False, anchored=anchored)
                objects = self._make_objects(frame, T)
                self.state, self.track = self._fused.train_only(
                    self.state, self.track, cam, df.image, objects)
            else:
                objects = self._zeros_objects
                self.state, self.track, T, cam = self._fused.track_add_train_self(
                    *common, df.image, objects, first=first, anchored=anchored)
            self.keyframes.append(Keyframe(camera=cam, image=df.image,
                                           objects=objects, pose=T))
            if len(self.keyframes) > cfg.keyframes.window:
                self.keyframes.pop(0)
        elif cfg.keyframes.replay and self.keyframes:
            kf = self.keyframes[self._kf_rng.integers(len(self.keyframes))]
            self.state, self.track, T = self._fused.track_add_train_stored(
                *common, kf.camera, kf.image, kf.objects, anchored=anchored)
        else:
            self.state, self.track, T, _ = self._fused.track_add(
                *common, first=first, write_row=True, anchored=anchored)
        self._fused_first = False
        self._host_mi += 1
        self._n_frames += 1
        self._snapshot()
        if mode == "gicp_map" and not self._map_anchored:
            # the anchoring probe: this frame's trackable count, one scalar
            # fetch a frame until the map anchors, then never again
            M = self.track.metrics.shape[0]
            n_sel = host_read(int, self.track.metrics[(self._host_mi - 1) % M,
                                                       fused_mod.MET_N_TRACKABLE])
            if n_sel >= cfg.tracking.anchor_min_points:
                self._map_anchored = True
                self.anchored_at = self._n_frames
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
        with span("metrics.drain"):
            self._drain_rows(k, end_mi, snapshot)

    def _drain_rows(self, k: int, end_mi: int, snapshot) -> None:
        if snapshot is None:
            buf = host_read(torch.Tensor.cpu, self.track.metrics).numpy()
        else:
            host, ev = snapshot
            if ev is not None:
                host_read(ev.synchronize)
            buf = host.numpy()
        M = buf.shape[0]
        if k > M:
            raise RuntimeError(f"metrics drain fell {k} rows behind a ring of {M}")
        rows = buf[(self._drained_mi + np.arange(k)) % M]
        trained = rows[rows[:, fused_mod.MET_TRAINED] > 0.5]
        for r in trained:
            self.losses.append(float(r[slam_step_mod.HOST_COL["loss"]]))
            self.train_iter += 1
            self._maybe_grow_capacity(r)
        if len(trained):
            self._maybe_shrink_capacity(trained)
        self._drained_mi = end_mi

    # ------------------------------------------------------------------
    def run(self, frames: Iterable[Frame], post_train: Optional[int] = None) -> PipelineResult:
        """Consume a frame stream, then post-train on random keyframes.
        `frame_times` are seconds from one frame's completion on the card
        to the next's (CUDA events, the first from the call; read after the
        run's last sync), on the CPU each frame's host seconds."""
        cfg = self.cfg
        use_fused = self._use_fused
        poses_est, poses_gt = [], []
        scan_budget = (cfg.tracking.max_points
                       if use_fused and cfg.tracking.backend != "none" else None)
        q = FrameQueue(frames, self.point_budget, self.device, prefetch=2,
                       timeout_s=cfg.timeout_s, scan_budget=scan_budget)
        frame_fn = self._frame_fused if use_fused else self._frame_modules
        frame_times: List[float] = []
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        done = [torch.cuda.Event(enable_timing=True)] if stream is not None else []
        if done:
            done[0].record(stream)
        try:
            for frame_idx, (df, frame) in enumerate(q):
                t_frame = time.perf_counter()
                with span("frame", device=self.device, unit=self._n_frames):
                    poses_est.append(frame_fn(df, frame, frame_idx))
                poses_gt.append(np.full((4, 4), np.nan, np.float32) if frame.pose is None
                                else np.asarray(frame.pose))
                if stream is None:
                    frame_times.append(time.perf_counter() - t_frame)
                else:
                    done.append(torch.cuda.Event(enable_timing=True))
                    done[-1].record(stream)
        finally:
            q.close()
        n_post = cfg.post_train_iters if post_train is None else post_train
        for _ in range(n_post):
            if not self.keyframes:
                break
            kf = self.keyframes[self._kf_rng.integers(len(self.keyframes))]
            if use_fused and self._fused is not None:
                self._train_once_fused(kf)
            else:
                self._train_once(kf)
        if use_fused:
            self._drain_metrics()
            self._met_snaps.clear()
        poses_np = (host_read(torch.Tensor.cpu, torch.stack(poses_est)).numpy() if poses_est
                    else np.zeros((0, 4, 4)))
        if len(done) > 1:
            host_read(done[-1].synchronize)
            frame_times = [a.elapsed_time(b) * 1e-3 for a, b in zip(done, done[1:])]
        return PipelineResult(
            poses_est=poses_np.astype(np.float32),
            poses_gt=np.stack(poses_gt) if poses_gt else np.zeros((0, 4, 4)),
            n_keyframes=len(self.keyframes), train_iters=self.train_iter,
            losses=self.losses, state=self.state, timed_out=q.timed_out,
            frame_times=frame_times)

    def eval_config(self, derive_budgets: bool = True) -> SLAMConfig:
        """The config `evaluate` renders with: with the windowed render, the
        buffers sized once by the occupancy probe and the tile capacity
        raised to `tile_capacity_max` (coverage over speed)."""
        cfg = self.cfg
        if derive_budgets and cfg.raster.windowed:
            derived = self._rederive_windowed(cfg.raster) or {}
            derived["tile_capacity"] = max(cfg.raster.tile_capacity,
                                           cfg.raster.tile_capacity_max)
            cfg = cfg.replace(raster=dataclasses.replace(cfg.raster, **derived))
        return cfg

    def evaluate(self, frames: Iterable[Frame], every: int = 1, with_lpips: bool = True,
                 poses=None, derive_budgets: bool = True) -> List[dict]:
        """PSNR / SSIM / LPIPS of the map over frames (every `every`-th),
        rendered at `poses[i]` when given (e.g. the run's estimated poses),
        else at each frame's pose, with `eval_config(derive_budgets)`.
        Nothing adapts during the evaluation; each frame reports
        `overflow_pairs` and `n_binned`. Renders under `torch.no_grad()`."""
        cfg = self.eval_config(derive_budgets)
        scores = []
        for i, frame in enumerate(frames):
            if i % every:
                continue
            if poses is not None and i >= len(poses):
                break  # a timed-out run tracked fewer frames than the stream holds
            pose_i = np.asarray(poses[i] if poses is not None else frame.pose)
            cam = self._camera_for(frame, pose_i)
            with torch.no_grad():
                out = slam_step_mod.render_map(self.state.map, cam, cfg)
            pred = out.color
            gt = torch.as_tensor(np.asarray(frame.image), device=pred.device)
            counters = host_read(torch.Tensor.tolist, torch.stack([
                out.overflow_tile, out.overflow_rect, out.overflow_window,
                out.overflow_big, out.n_binned]))
            s = {"psnr": eval_metrics.psnr(pred, gt),
                 "ssim": eval_metrics.ssim(pred, gt),
                 "overflow_pairs": int(sum(counters[:4])), "n_binned": int(counters[4])}
            if with_lpips:
                s["lpips"] = eval_metrics.lpips(pred, gt)
                s["lpips_net"] = eval_metrics.lpips_backend()
            scores.append(s)
        return scores
