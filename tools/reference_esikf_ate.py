"""ATE of the JAX package's ESIKF tracker at the SLAM loop cell
(`bench.py:bench_pipeline`'s operating point): the first 24 frames of
`SyntheticDataset(width=640, height=512, n_world=65536, pts_per_frame=4096,
step=0.075, clutter=0.3, imu_substeps=5)` under `TrackingConfig(
backend="esikf", max_points=4096)` at its defaults (IMU propagation, the
velocity bootstrap, 10 update iterations), LiDAR-inertial and, with
`esikf_visual=True`, LiDAR-inertial-visual; and of its per-module "gicp"
tracker (`fused_frontend=False`), which starts each scan-to-scan align from
the identity where the fused front-end starts from the last delta.

The filter reads each frame's scan, IMU samples, timestamp, colours (the
photometric anchors' intensity) and, for the visual leg, its image; the
GICP chain reads the scans; neither reads the Gaussian map. So this runs
`SLAMPipeline._track` alone over the frames, with no training. The results
are the references that `chip_smoke.py`'s esikf phase holds the PyTorch
port's three per-module loops against. Runs on the
CPU in about two minutes (the 24 ground-truth renders take most of it):

    JAX_PLATFORMS=cpu python tools/reference_esikf_ate.py [--frames 24]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from sags_tpu.core.config import SLAMConfig, TrackingConfig
    from sags_tpu.io.datasets import SyntheticDataset
    from sags_tpu.slam.pipeline import SLAMPipeline
    from sags_tpu.utils.traj import ate_rmse

    frames = list(SyntheticDataset(n_frames=args.frames, width=640, height=512,
                                   n_world=65536, pts_per_frame=4096, step=0.075,
                                   clutter=0.3, imu_substeps=5))
    gt = np.stack([f.pose for f in frames])
    out = {"frames": args.frames}
    for name, backend, visual in (("li", "esikf", False), ("liv", "esikf", True),
                                  ("gicp_per_module", "gicp", False)):
        cfg = SLAMConfig(tracking=TrackingConfig(backend=backend, max_points=4096,
                                                 esikf_visual=visual),
                         fused_frontend=False)
        pipe = SLAMPipeline(cfg, point_budget=4096, rng_seed=0)
        poses = np.stack([np.asarray(pipe._track(f)) for f in frames])
        ate, err = ate_rmse(poses, gt, align=False)
        out[name] = {"ate_m": ate, "final_error_m": float(err[-1])}
        if backend == "esikf":
            out[name].update(
                surfel_voxels=int(np.sum(np.asarray(pipe._track_map.keys)
                                         < np.iinfo(np.int32).max)),
                surfel_overflow=int(pipe._track_map.overflow))
    out["path_m"] = float(np.linalg.norm(gt[-1, :3, 3] - gt[0, :3, 3]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
