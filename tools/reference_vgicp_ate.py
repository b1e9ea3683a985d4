"""ATE of the JAX package's scan-to-scan VGICP tracker at the pipeline
bench's operating point (`bench.py:bench_pipeline`): the first 24 frames of
`SyntheticDataset(width=640, height=512, n_world=65536, pts_per_frame=4096,
step=0.075, clutter=0.3)` under the default `GICPConfig` (1 m voxels,
DIRECT1, additive accumulation).

Under tracking backend "vgicp" the pose chain depends on the scans alone, so
the frames are generated without their ground-truth renders (the renders
draw nothing from the dataset's random stream). The result is the reference
that `chip_smoke.py`'s tracking phase holds the PyTorch port's vgicp loop
against. Runs on the CPU in about a minute:

    JAX_PLATFORMS=cpu python tools/reference_vgicp_ate.py [--frames 24]
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
    import jax.numpy as jnp

    from sags_tpu.core.config import SLAMConfig
    from sags_tpu.io.datasets import SyntheticDataset
    from sags_tpu.ops import gicp
    from sags_tpu.utils.traj import ate_rmse

    class ScansOnly(SyntheticDataset):
        def render_gt(self, i):
            return (np.zeros((3, self.height, self.width), np.float32),
                    np.zeros((self.height, self.width), np.float32))

    frames = list(ScansOnly(n_frames=args.frames, width=640, height=512,
                            n_world=65536, pts_per_frame=4096, step=0.075,
                            clutter=0.3))
    cfg = SLAMConfig().gicp
    # the fused front-end's "vgicp" chain (`slam/fused.py:_track`):
    # covariances once per scan, the previous scan's voxel map as the
    # target, the last delta as the next warm start
    T = np.eye(4, dtype=np.float32)
    delta = jnp.eye(4, dtype=jnp.float32)
    prev = None
    poses, iters = [], []
    for f in frames:
        scan = jnp.asarray(f.scan)
        mask = jnp.ones(scan.shape[0], bool)
        covs = gicp.estimate_covariances(scan, mask, cfg.k_correspondences,
                                         cfg.knn_max_distance,
                                         cfg.regularization).covs
        if prev is not None:
            res = gicp.vgicp_align(scan, prev[0], mask, prev[1], delta, cfg,
                                   source_covs=covs, target_covs=prev[2])
            delta = res.T
            T = T @ np.asarray(delta)
            iters.append(int(res.iterations))
        prev = (scan, mask, covs)
        poses.append(T.copy())
    gt = np.stack([f.pose for f in frames])
    ate, err = ate_rmse(np.stack(poses), gt, align=False)
    print(json.dumps({"frames": args.frames, "backend": "vgicp", "ate_m": ate,
                      "final_error_m": float(err[-1]),
                      "path_m": float(np.linalg.norm(gt[-1, :3, 3] - gt[0, :3, 3])),
                      "lm_outer_iterations": iters}))


if __name__ == "__main__":
    main()
