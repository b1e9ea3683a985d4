"""Scan-to-map ("gicp_map") tracking of the JAX package and of the PyTorch
port over the pipeline bench's trajectory, cut to run on the CPU:
`SyntheticDataset(width=160, height=128, n_world=8192, pts_per_frame=512,
step=0.075, clutter=0.3)`, a 2^14 buffer, the map anchored once it holds 256
trackable Gaussians. For each package it prints the ATE and, per frame, the
translation error and how far the estimated rotation is from orthonormal
(max |RRᵀ − I|).

The JAX package's anchored warm start inverts the previous pose by
transposing its rotation, so that error grows ~2.4× a frame until the
solves fail; the port projects each anchored pose onto SO(3). Takes a few
minutes:

    JAX_PLATFORMS=cpu python tools/gicp_map_drift.py [--frames 24]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _config(mod, points, capacity):
    return mod.SLAMConfig(
        raster=mod.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=512, chunk=64),
        map=mod.MapConfig(initial_capacity=capacity),
        keyframes=mod.KeyframeConfig(keyframe_freq=5, window=16),
        tracking=mod.TrackingConfig(backend="gicp_map", max_points=points,
                                    anchor_min_points=256),
        post_train_iters=0, metrics_interval=5)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from sags_tpu.core import config as jax_config
    from sags_tpu.io.datasets import SyntheticDataset
    from sags_tpu.slam.pipeline import SLAMPipeline as JaxPipeline
    from sags_tpu_torch.core import config as torch_config
    from sags_tpu_torch.io.datasets import Frame
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.traj import ate_rmse

    points, capacity = 512, 2 ** 14
    frames = list(SyntheticDataset(n_frames=args.frames, width=160, height=128, n_world=8192,
                                   pts_per_frame=points, step=0.075, clutter=0.3))
    gt = np.stack([f.pose for f in frames])
    runs = {
        "sags_tpu": lambda: JaxPipeline(_config(jax_config, points, capacity),
                                        point_budget=points, rng_seed=0).run(frames, post_train=0),
        "sags_tpu_torch": lambda: SLAMPipeline(
            _config(torch_config, points, capacity), point_budget=points, rng_seed=0,
            device="cpu").run([Frame(**vars(f)) for f in frames], post_train=0),
    }
    for name, run in runs.items():
        poses = run().poses_est.astype(np.float64)
        ate, err = ate_rmse(poses, gt, align=False)
        ortho = [float(np.abs(p[:3, :3] @ p[:3, :3].T - np.eye(3)).max()) for p in poses]
        print(json.dumps({"package": name, "frames": args.frames, "ate_m": float(ate),
                          "error_m_per_frame": np.asarray(err).tolist(),
                          "max_abs_RRt_minus_I_per_frame": ortho}), flush=True)


if __name__ == "__main__":
    main()
