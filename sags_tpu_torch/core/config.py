"""One typed configuration tree for the whole framework (PyTorch port: the
same dataclasses as `sags_tpu.core.config`, kept as an own copy).

Replaces the reference's two parallel systems — the reflection-based argparse groups
(`arguments/__init__.py:19-98`) and the hardcoded `SLAMParameters` class
(`arguments/__init__.py:122-164`) plus the per-dataset intrinsics blocks commented
in/out inside the SLAM node (`scripts/gaussian_splatting.py:172-197`).

Defaults mirror `SLAMParameters` and the SLAM node's hardcoded values.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class RasterizeConfig:
    """Tiled rasterizer shape/capacity knobs (plain Python values)."""

    tile: int = 16  # BLOCK_X/BLOCK_Y (`cuda_rasterizer/config.h:17-18`)
    num_objects: int = 16  # NUM_OBJECTS (`config.h:16`)
    # Capacity bounds replacing the reference's dynamic `num_rendered`
    # (`rasterizer_impl.cu:288-294`): max tiles one Gaussian may be binned into
    # (a perfect square — binning enumerates a static R x R offset window)
    # and max Gaussians composited per tile. Overflows are counted and surfaced.
    max_tiles_per_gaussian: int = 36
    tile_capacity: int = 1024
    # overflow-adaptation ceiling for tile_capacity: the fused Pallas
    # backward's scoped-VMEM footprint scales with K — K=2048 exceeds the
    # 16 MB scoped-vmem limit at compile time on v5e (measured: 26.5 MB);
    # 1024 is the proven-on-chip maximum. Past the ceiling, per-tile
    # overflow stays counted (never silent), like the R x R window cap.
    tile_capacity_max: int = 1024
    chunk: int = 64  # Gaussians composited per scan step (matmul K dim)
    bg_depth: float = 15.0  # background depth (`forward.cu:426-427`)
    near: float = 0.2  # frustum cull plane (`auxiliary.h:159`)
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4
    low_pass: float = 0.3  # EWA dilation (`forward.cu:114-115`)
    # Bin each Gaussian into the intersection of the reference's 3σ circle
    # bbox and the exact alpha-cull level-set bbox (w = c·√Σ_axis,
    # c² = 2·ln(opac/α_min)) — image-exact (dropped pairs fail the per-pixel
    # alpha gate everywhere) but far fewer pairs for anisotropic/low-opacity
    # splats. False restores the circle rect (`auxiliary.h:51-61` parity).
    tight_rect: bool = True
    scale_modifier: float = 1.0
    remat: bool = True  # rematerialize compositing chunks in backward
    pallas_backward: bool = True  # fused Pallas compositing backward on TPU
    # Run the SHARDED Pallas compositor in interpreter mode on non-TPU
    # backends — lets the multi-chip kernel path be equivalence-tested on the
    # virtual CPU mesh (tests/conftest.py). No effect on TPU.
    pallas_interpret: bool = False
    # Windowed (gather-free) TPU render path: packed rows are anchor-sorted
    # and the compositor DMAs per-tile candidate spans into a shared VMEM
    # window of `window_blocks` TOTAL 128-row blocks, allocated per span by
    # actual length (see ops/pallas_windowed.py). Overflow is surfaced and
    # pipeline-adapted.
    windowed: bool = True
    # 14 won an interleaved 16/14/12 sweep at the 720p bench point
    # (medians 32.2/31.5/31.2 ms): 12 is fastest but its ~2.5k dropped
    # pairs exceed the 0.1% adaptation threshold (recompile churn), 14's
    # ~180 are well under it. Overflow is counted and pipeline-adapted.
    window_blocks: int = 14
    # Fractions of P reserved for the MID (rect == 3: the 5 extra 3×3-ring
    # offsets) and BIG (rect > 3: all RxR−4 extra offsets) tiers of the
    # windowed pair expansion; everyone gets the 2×2 tier. Saturation of
    # either buffer is surfaced as `overflow_big` and pipeline-adapted
    # (both doubled, capped at 1.0).
    windowed_mid_frac: float = 0.25
    windowed_big_frac: float = 0.125
    # Double-buffered span-DMA prefetch in the windowed forward: tile t+1's
    # candidate window is issued while tile t composites, hiding the copy
    # wait behind compute (2x window VMEM). Bit-exact. Default ON since
    # round 4: −0.7 ms at the 720p exact bench point (3/5 interleaved
    # rounds), neutral at light loads — a scene-independent winner.
    window_prefetch: bool = True
    # Split-precision windowed forward: the 16 obj channels ride the
    # candidate window as bf16 pairs packed in f32 rows (kernel rows 32→24:
    # 25% less DMA + select traffic). Forward-only — backward always takes
    # the exact f32 XLA-recompute path. Obj channels carry bf16 (~1e-3 rel)
    # error; rgb/depth stay exact f32. See docs/PERFORMANCE.md.
    windowed_bf16: bool = False
    # Exclusive-prefix-product formulation in the windowed forward kernel:
    # "roll" = cyclic pltpu.roll + lane-iota mask per Hillis-Steele step;
    # "pad" = static shift-fill-1 concat slices (no masks) + [PIX,1] pixel
    # coords. Numerically identical. Default "pad" since round 4 (−0.6 ms,
    # 4/4 interleaved rounds at the 720p exact bench point).
    scan_impl: str = "pad"
    # Compositing chunk (K lanes per grid step) of the windowed kernels —
    # must be a multiple of 128 dividing tile_capacity (auto-clamped).
    # Larger K = fewer chunk boundaries (scratch RMW, skip tests), smaller
    # K = finer early-exit/count-skip granularity. Default 512 since
    # round 4 (−1.9 ms, 4/4 interleaved rounds at the 720p exact bench
    # point); auto-clamped to tile_capacity when that is smaller.
    windowed_chunk: int = 512
    # EWA alpha evaluation in the windowed forward: "vpu" = longhand
    # [PIX,K] maps (bit-exact vs the XLA path); "quad" = evaluate the
    # quadratic via a [PIX,6]@[6,K] monomial-basis matmul on tile-local
    # coordinates (~1e-3 absolute power tolerance — forward-only perf mode;
    # backward always recomputes longhand).
    ewa_impl: str = "vpu"
    # PERF DIAGNOSIS ONLY — renders garbage when non-empty. Disables one
    # kernel stage to time its cost (tools/ablate_windowed.py):
    # "nosel" single-block select · "noscan" skip exclusive product ·
    # "nomath" skip EWA alpha math · "nomatmul" skip the feature matmul.
    window_ablate: str = ""
    # Slice store — FULL-coverage windowed rendering for big-rect Gaussians.
    # The span window fundamentally caps coverage at the R×R binning window
    # (R = √max_tiles_per_gaussian); Gaussians with a larger screen rect
    # lose their outer (still alpha-live) tiles there. With
    # `windowed_big_capacity` > 0, a rect > R Gaussian is REPLICATED as
    # copy rows anchored every R tiles, each carrying one ≤R×R slice of the
    # parent rect in its packed rect columns — ordinary candidates of the
    # anchor-sorted stream, so the span-DMA kernels (forward AND backward)
    # need no extra machinery and coverage becomes exact for rect ≤
    # `windowed_store_max_rect` (gradients fold back to parents through the
    # copy gather's transpose). Costs extra anchor rows + pair-sort lanes
    # (~30% render time at the 720p bench point); 0 keeps the fast tiered
    # mode (drops counted in overflow_rect/overflow_big, pipeline-adapted
    # to this knob, which acts as the on-switch).
    windowed_big_capacity: int = 0
    windowed_store_max_rect: int = 32
    # Slice sub-tiers: (max_rect_side, fraction of P buffered). A rect>R
    # Gaussian lands in the first sub-tier whose side covers it and gets
    # ceil(side/R)² copy rows; buffer saturation falls back to the classic
    # (windowed, R×R-capped) tiers and is counted in overflow_big. The 32
    # tier is sized for the heavy tail's tail (measured at the 720p bench
    # point: 13 of 262k Gaussians exceed side 16, none exceed 20 — a
    # 128-row buffer zeroes overflow_rect for ~8k extra sort lanes);
    # rect > 32 still truncates to 32 and stays counted.
    windowed_store_fracs: tuple = ((8, 0.08), (16, 0.004), (32, 0.0005))
    # Fraction of the slice-store copy rows buffered for the >2×2-slice
    # ring tier (the R×R−4 extra offsets). 1.0 reproduces the original
    # "never saturates" sizing; smaller fractions shrink the pair sort by
    # 12·(1−frac)·n_copies lanes — saturation is counted in overflow_big
    # and pipeline-adapted like every other tier. Most copies carry thin
    # edge slices (≤2 wide) that the base tier already covers, so ~0.5 is
    # typically lossless at SLAM operating points.
    windowed_copy_ring_frac: float = 1.0
    # Expansion row budget: only the first frac·P_all anchor-sorted rows
    # (live rows sort before culled ones) enter pair expansion and the tier
    # compactions — a static trim of every expansion lane. SLAM scenes cull
    # ~35% of rows, so ~0.75 is typically lossless; live rows beyond the
    # budget are dropped and counted in overflow_big (pipeline-adapted).
    windowed_expand_frac: float = 1.0
    # Pair-sort tie handling: "lex" = (key, gid) two-key sort (reference
    # radix-order parity); "stable" = one-key stable sort, gid as payload
    # (less comparator traffic; same pair SET and per-depth-bucket order,
    # lane-order ties within equal depth buckets).
    windowed_pair_sort: str = "lex"
    # Use the windowed span-DMA kernels for the TRAINING step too (they are
    # differentiable): False pins the classic fused path, which won the
    # round-2 A/B at training density (45.5 vs 42.7 ms/step — the in-VMEM
    # depth-order select cost more than the row gather it replaces at 100+
    # anchors/tile). Knob kept for re-evaluation as the windowed path gets
    # faster.
    train_windowed: bool = False
    # Base-tier split: 0.0 gives EVERY row the 2×2 offset window (4 lanes
    # each). >0 gives every row only its rect-min tile (1 lane) and routes
    # the (1,0),(0,1),(1,1) offsets through a compacted tier of the rows
    # with rect>1, sized frac·P_all — on SLAM scenes most Gaussians bin to
    # 1-2 tiles, so ~0.5 cuts the pair sort by ~2·P lanes. Saturation is
    # counted in overflow_big and pipeline-adapted.
    windowed_base_split_frac: float = 0.0
    # MXU precision of the windowed forward's feature matmul (w @ feats):
    # "highest" = 6-pass fp32 (bit-matches the XLA reference path),
    # "high" = manual bf16x2 split, 3 one-pass dots (~1e-6 rel; Mosaic has
    # no native Precision.HIGH),
    # "default" = 1-pass bf16 (~4e-3 abs — under the 8-bit display quantum;
    # the per-pixel alpha/transmittance math stays full fp32 either way).
    # Forward-only: gradients always recompute at fp32-HIGHEST.
    feature_precision: str = "highest"
    # `RenderOutput.is_used` semantics:
    # "contrib" (default, reference parity `forward.cu:274`) = the Gaussian
    # contributed to ≥1 pixel — passes the alpha gate while the pixel's
    # transmittance is above the early-exit floor; a fully-occluded Gaussian
    # is False. Computed by a feature-free transmittance pass that XLA
    # dead-code-eliminates whenever is_used isn't consumed.
    # "in_frustum" = preprocess validity only (a superset; the pre-round-5
    # behavior, cheaper when is_used IS consumed eagerly).
    is_used_mode: str = "contrib"
    # Where the windowed path's per-tile depth ordering happens:
    # "host" = global pair sort + table build in the XLA program (default;
    # differentiable via the windowed/XLA backwards),
    # "kernel" = the Pallas kernel builds + bitonic-sorts its own candidate
    # keys from the DMA'd window rows (ops/pallas_sort.py) — no host pair
    # sort, no table, no mid/big tier buffers (validity is the exact
    # alpha-gate test). Round-3 A/B at the 720p bench point: the in-VMEM
    # bitonic sort costs MORE than the host sort it deletes (+2.8 ms, 0/5
    # rounds) — stays an option for table-memory-constrained scenes, not a
    # perf win. Render-only: NOT differentiable; requires window_blocks ≤ 16
    # and tile_capacity ≤ 2048.
    windowed_sort: str = "host"


@dataclass(frozen=True)
class OptimizationConfig:
    """Per-group LRs and schedule — `SLAMParameters` (`arguments/__init__.py:140-158`)."""

    iterations: int = 30_000
    position_lr_init: float = 1.6e-6
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 10_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 600
    densify_from_iter: int = 300
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    adam_eps: float = 1e-15  # (`gaussian_model.py:260`)
    adam_b1: float = 0.9
    adam_b2: float = 0.999


@dataclass(frozen=True)
class MapConfig:
    """Gaussian map capacity and growth policy.

    XLA needs static shapes; the map lives in fixed-capacity buffers with an
    active mask (replacing torch optimizer-state surgery,
    `gaussian_model.py:428-534`). Capacity grows by doubling (one recompile per
    doubling).
    """

    initial_capacity: int = 2 ** 17
    max_capacity: int = 2 ** 22
    sh_degree: int = 0  # SLAM uses 0 (`SLAMParameters.sh_degree`)
    num_objects: int = 16
    initial_opacity: float = 0.1  # (`gaussian_model.py:162,203`)
    initial_scale: float = 0.01  # SLAM add path (`scripts/gaussian_splatting.py:684`)
    prune_min_opacity: float = 0.005  # (`scripts/gaussian_splatting.py:830`)
    # Initialize scan splats from the tracker's surfel covariance
    # eigendecomposition (quat + √eigenvalue scales — the reference fork's
    # q/s export, `fast_gicp_impl.hpp:420-434`; the GS-ICP-SLAM design)
    # instead of `initial_scale` isotropic balls. The map then IS the
    # surfel field the scan-to-map tracker aligns against. Applies to the
    # fused front-end's gicp/vgicp/gicp_map modes.
    surfel_init: bool = True
    prune_extent: float = 2.5  # prune_th (`scripts/gaussian_splatting.py:165`)
    prune_interval: int = 200  # (`scripts/gaussian_splatting.py:829-831`)


@dataclass(frozen=True)
class SemanticsConfig:
    num_objects: int = 16
    num_classes: int = 100  # (`scripts/gaussian_splatting.py:210`)
    classifier_lr: float = 5e-4  # (`scripts/gaussian_splatting.py:217`)
    # projection-vote association (`scripts/gaussian_splatting.py:59,738-789`)
    overlap_threshold: float = 0.5
    cls3d_k: int = 5
    cls3d_lambda: float = 2.0
    cls3d_max_points: int = 300_000
    cls3d_sample: int = 1000
    cls3d_interval: int = 5
    loss_rgb_weight: float = 1.0
    loss_obj_weight: float = 1.0
    loss_obj_3d_weight: float = 1.0


@dataclass(frozen=True)
class GICPConfig:
    """fast_gicp defaults (`fast_gicp_impl.hpp:9-33`, `lsq_registration_impl.hpp:9-22`)."""

    k_correspondences: int = 10
    knn_max_distance: float = 0.5  # compared against *squared* NN distance, as in ref
    corr_dist_threshold: float = float("inf")  # ref: numeric_limits<float>::max()
    regularization: str = "normalized_ellipse"  # NONE|PLANE|MIN_EIG|NORMALIZED_MIN_EIG|FROBENIUS|NORMALIZED_ELLIPSE
    max_iterations: int = 64
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    lm_max_iterations: int = 10
    lm_init_lambda_factor: float = 1e-9
    optimizer: str = "lm"  # lm | gn
    # VGICP
    voxel_resolution: float = 1.0
    neighbor_search: str = "direct1"  # direct1 | direct7 | direct27 | direct_radius
    neighbor_radius: float = 1.5  # DIRECT_RADIUS radius in voxel units
    voxel_accumulation: str = "additive"  # additive | additive_weighted | multiplicative
    max_voxels: int = 65536


@dataclass(frozen=True)
class TrackingConfig:
    # gicp | vgicp (scan-to-scan) | gicp_map (scan-to-MAP against the
    # trackable Gaussians, `fast_gicp_impl.hpp:586-720`) | esikf | none
    # (poses given)
    backend: str = "gicp"
    # scan-to-map target gate: trackable splats must retain this much
    # opacity (i.e. not be fading toward the 0.005 prune floor). Scan
    # points enter the map at opacity 0.1 — a high threshold (e.g. the
    # 0.9 of round ≤4) selects NOTHING until long training and silently
    # degrades gicp_map to scan-to-scan.
    opacity_threshold: float = 0.05
    # scan-to-map correspondence gate (meters): scan points whose nearest
    # trackable map point is farther than this are NEW geometry (no map
    # counterpart yet) and must not drag the align. Scan-to-scan keeps the
    # reference's ungated default (both clouds cover the same region).
    map_corr_threshold: float = 1.0
    # scan-to-map engages only once this many trackable splats exist: a
    # one-keyframe-thin map under-constrains the absolute solve (measured:
    # the first anchored frame against a 512-point map jumped 0.88 m; with
    # a mature map the same solve tracks at 1-2 cm). Until then the
    # tracker composes scan-to-scan deltas.
    anchor_min_points: int = 2048
    # reject an anchored solve that jumps farther than this (meters) from
    # the constant-velocity prediction — fall back to the prediction (the
    # role of the reference's "lm not converged" break,
    # `lsq_registration_impl.hpp:68-71`)
    max_jump: float = 0.5
    downsample_resolution: float = 0.1
    max_points: int = 8192  # static-shape cap for the tracker's point budget
    # seed ESIKF pose+velocity from one scan-to-scan GICP on the first frame
    # pair (the filter starts at v=0; a moving platform would otherwise
    # drift until the Kalman cross-covariance learns v)
    esikf_bootstrap: bool = True
    # iterated point-to-plane update count: 10 converges the startup
    # transient ~2.5x tighter than 5 (measured on the moving-start synthetic)
    esikf_update_iters: int = 10
    esikf_min_planarity: float = 0.1  # surfel plane-ness gate
    # LIVO visual leg: after the LiDAR update, run the photometric
    # `esikf.photo_update` against the surfel map's intensity anchors
    # (sequential LiDAR→visual updates, the FAST-LIVO2 order). Under
    # `lidar_axes` the camera-from-body extrinsic (LIDAR_TO_CAM) is threaded
    # into the projection Jacobian automatically.
    esikf_visual: bool = False
    esikf_photo_iters: int = 2
    esikf_photo_noise: float = 0.15


@dataclass(frozen=True)
class KeyframeConfig:
    keyframe_freq: int = 10  # every Nth frame (`scripts/gaussian_splatting.py:280-284`)
    window: int = 64  # keyframe ring-buffer capacity
    replay: bool = True  # random-past-keyframe branch (`:887-935`)


@dataclass(frozen=True)
class CameraPreset:
    """Per-dataset intrinsics (`scripts/gaussian_splatting.py:172-197`)."""

    width: int = 640
    height: int = 512
    fx: float = 431.79553  # FAST-LIVO2 (0.5 x 1280x1024) block in the node
    fy: float = 431.78474
    cx: float = 318.34767
    cy: float = 255.69859


@dataclass(frozen=True)
class SLAMConfig:
    raster: RasterizeConfig = field(default_factory=RasterizeConfig)
    opt: OptimizationConfig = field(default_factory=OptimizationConfig)
    map: MapConfig = field(default_factory=MapConfig)
    semantics: SemanticsConfig = field(default_factory=SemanticsConfig)
    gicp: GICPConfig = field(default_factory=GICPConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    keyframes: KeyframeConfig = field(default_factory=KeyframeConfig)
    camera: CameraPreset = field(default_factory=CameraPreset)
    scene_extent: float = 2.5  # (`scripts/gaussian_splatting.py:164`)
    white_background: bool = False
    timeout_s: float = 10.0  # topic-silence shutdown (`:652-666`)
    lidar_axes: bool = False  # FAST-LIVO2 LiDAR→camera pose fix (`:309-315`)
    post_train_iters: int = 1000  # (`:938-1013`)
    seed: int = 0
    # Fused per-frame front-end (slam/fused.py): tracking + map growth +
    # training in ONE XLA program per frame, host-read scalars in a
    # device-resident ring buffer fetched every `metrics_interval` frames —
    # the per-frame loop then issues one dispatch and no value fetches, so
    # throughput is bounded by device compute, not host↔device RTT.
    # Applies to the gicp/vgicp/gicp_map/none tracking backends; esikf
    # keeps the per-module path.
    fused_frontend: bool = True
    metrics_interval: int = 10

    def replace(self, **kw) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Dataset presets (the intrinsics blocks the reference comments in/out).
# ---------------------------------------------------------------------------

PRESETS = {
    # FAST-LIVO2 sequences at scale=0.5 (the active block in the node)
    "fast_livo2": CameraPreset(640, 512, 431.79553, 431.78474, 318.34767, 255.69859),
    # Replica (python_tester / GS-ICP-SLAM lineage)
    "replica": CameraPreset(1200, 680, 600.0, 600.0, 599.5, 339.5),
    # TUM freiburg3
    "tum": CameraPreset(640, 480, 535.4, 539.2, 320.1, 247.6),
}


def preset(name: str) -> SLAMConfig:
    return SLAMConfig(camera=PRESETS[name])


def expon_lr(
    step: int,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> float:
    """Log-lerp LR schedule with optional delay (`utils/general_utils.py:33-66`).

    `step` is a host integer: the training step counter lives on the host,
    so the schedule costs no device work and no sync.
    """
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
        )
    else:
        delay_rate = 1.0
    return delay_rate * log_lerp
