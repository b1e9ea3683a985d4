"""`gicp_align`'s CUDA kernel (`csrc/gicp_align.cu`: the whole LM or
Gauss-Newton align in one cooperative launch) against its plain version,
`lsq_align` over `make_gicp_linearizer` (`gicp.gicp_align_plain`), on the
card: at the stream's shape (4096 x 4096 scans, ungated) and the scan-to-map
shape (4096 x 8192, gate 1.0 m, a third of the targets masked), under both
optimizers; a pair with no correspondence; weights through the
pseudo-inverse; repeatability; no host sync. The card's tests skip without
a CUDA device; the CPU test checks that the CPU path never reaches the
kernel. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gicp_kernel.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from sags_tpu_torch.core.config import GICPConfig
from sags_tpu_torch.ops import gicp

torch.set_num_threads(1)

# the farthest a source point may land apart between the kernel's pose and
# the plain version's, m: a tenth of the stream's `track_gap` limit
POSE_GAP = 2e-4
# H and e are sums over 4096 points: a source point whose two nearest targets
# tie to float32 rounding may take the other in the two versions, which moves
# a sum by about that point's share, 1/4096 of it
SUM_TOL = 1e-3
STREAM_CFG = GICPConfig()  # the stream cells' `gicp` block: fast_gicp's defaults


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def corridor_pair(seed: int, n_src: int = 4096, n_tgt: int = 4096, step: float = 0.075):
    """Two scans of a corridor (walls at x = ±2.5 m, the floor at y = -2 m,
    a wall across it at z = 11 m that fixes the motion along it, 30% of the
    world in 12 blobs), each in its sensor's frame: the source
    `step` metres on and 0.02 rad of yaw from the target's pose, as the
    stream's frames are. Returns (source [n_src,3], target [n_tgt,3])."""
    rng = np.random.default_rng(seed)
    n = 65536
    wall = rng.integers(0, 4, n)
    t = rng.uniform(0, 20, n)
    h = rng.uniform(-2, 2, n)
    u = rng.uniform(-2.5, 2.5, n)
    world = np.stack([np.where(wall == 0, -2.5, np.where(wall == 1, 2.5, np.where(wall == 2, h, u))),
                      np.where(wall == 2, -2.0, h * 0.8), np.where(wall == 3, 11.0, t)], -1)
    world += rng.normal(0, 0.03, world.shape)
    n_cl = int(0.3 * n)
    centers = rng.uniform([-2.0, -1.6, 0.5], [2.0, 1.6, 19.5], (12, 3))
    world[:n_cl] = centers[rng.integers(0, 12, n_cl)] + rng.normal(0, 0.15, (n_cl, 3))

    def scan(z, yaw, k):
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        rel = (world - np.array([0.0, 0.0, z])) @ R
        vis = np.nonzero((rel[:, 2] > 0.5) & (np.linalg.norm(rel, axis=-1) < 8.0))[0]
        return rel[rng.choice(vis, k, replace=False)].astype(np.float32)

    return scan(5.0 + step, 0.02, n_src), scan(5.0, 0.0, n_tgt)


def _data(device, seed, shape, cfg=STREAM_CFG):
    """(GICPData, cfg) on `device`: "scan" the stream's scan-to-scan pair,
    "map" the scan-to-map one (8192 targets, a third masked, gate 1.0 m)."""
    n_tgt = 8192 if shape == "map" else 4096
    src, tgt = (torch.as_tensor(a, device=device) for a in corridor_pair(seed, 4096, n_tgt))
    smask = torch.ones(len(src), dtype=torch.bool, device=device)
    tmask = torch.ones(len(tgt), dtype=torch.bool, device=device)
    if shape == "map":
        keep = np.random.default_rng(seed + 1).uniform(size=n_tgt) >= 1.0 / 3.0
        tmask = torch.as_tensor(keep, device=device)
        cfg = dataclasses.replace(cfg, corr_dist_threshold=1.0)
    cov = lambda p, m: gicp.estimate_covariances(p, m, cfg.k_correspondences,
                                                 cfg.knn_max_distance, cfg.regularization).covs
    return gicp.GICPData(src, smask, cov(src, smask), tgt, tmask, cov(tgt, tmask)), cfg


def pose_gap(Ta, Tb, points) -> float:
    """The farthest `points` land apart under the two poses, m."""
    pa = points @ Ta[:3, :3].T + Ta[:3, 3]
    pb = points @ Tb[:3, :3].T + Tb[:3, 3]
    return float(torch.linalg.vector_norm(pa - pb, dim=-1).max())


def _counts(res):
    return int(res.iterations), int(res.lm_iterations), bool(res.converged)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("optimizer", ["lm", "gn"])
@pytest.mark.parametrize("shape", ["scan", "map"])
def test_align_kernel_matches_plain(device, shape, optimizer, seed):
    """The kernel against `lsq_align` on the card from the identity: the
    same (outer, inner) iterations and convergence, the pose within
    `POSE_GAP`, the last Hessian within 1e-3 of its largest entry and the
    error within 1e-3 relative (`SUM_TOL`)."""
    data, cfg = _data(device, seed, shape, dataclasses.replace(STREAM_CFG, optimizer=optimizer))
    T0 = torch.eye(4, device=device)
    gicp.ALIGN.launches = 0
    got = gicp.gicp_align_kernel(data, T0, cfg)
    want = gicp.gicp_align_plain(data, T0, cfg)
    assert gicp.ALIGN.launches == 1
    assert _counts(got) == _counts(want)
    assert _counts(got)[2], "the pair should converge"
    assert pose_gap(got.T, want.T, data.source) <= POSE_GAP
    scale = float(want.H.abs().max())
    assert float((got.H - want.H).abs().max()) <= SUM_TOL * scale
    assert abs(float(got.error) - float(want.error)) <= SUM_TOL * abs(float(want.error))


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["mask", "gate"])
def test_align_kernel_without_correspondences_keeps_the_initial_guess(device, how):
    """No source point in the mask, or a gate no pair passes: H = 0, every
    trial's step is non-finite and rejected, and the LM align fails with the
    initial guess, bit for bit, after one outer iteration of
    `lm_max_iterations` trials, as the plain version does."""
    data, cfg = _data(device, 3, "scan")
    if how == "mask":
        data = data._replace(source_mask=torch.zeros_like(data.source_mask))
    else:
        cfg = dataclasses.replace(cfg, corr_dist_threshold=1e-6)
    T0 = torch.eye(4, device=device)
    T0[:3, 3] = torch.tensor([0.1, -0.05, 0.2], device=device)
    got = gicp.gicp_align_kernel(data, T0, cfg)
    want = gicp.gicp_align_plain(data, T0, cfg)
    assert _counts(got) == _counts(want) == (1, cfg.lm_max_iterations, False)
    assert float(got.error) == float(want.error) == 0.0
    assert torch.equal(got.H, torch.zeros_like(got.H)) and torch.equal(want.H, got.H)
    assert torch.equal(got.T, T0) and torch.equal(want.T, T0)


@pytest.mark.cuda
def test_align_kernel_weights_through_the_pseudo_inverse(device, monkeypatch):
    """Surfels with an exactly vanishing determinant: each planar target
    covariance (smallest diagonal entry under 5% of the largest) loses the
    row and column of that axis, and every other source covariance is zero,
    so such a pair's C_B + R C_A Rᵀ is C_B exactly and its determinant
    exactly 0: its weight is the pseudo-inverse (the kernel's Jacobi
    eigenpairs). The kernel against the plain version as above, whose `eigh`
    runs in float64 here: in float32 it reads the zero eigenvalue of some of
    these matrices as up to ~1e-7, over the 1e-12 cut, and weighs that axis
    by its inverse (on the CPU, these scans with a 1% cut: 11 of 206
    matrices, a weight of 1.3e10 and a pose 0.36 m off)."""
    data, cfg = _data(device, 4, "scan")
    tcov = data.target_covs.clone()
    diag = torch.diagonal(tcov, dim1=-2, dim2=-1)
    flat = torch.nonzero(diag.min(-1).values < 0.05 * diag.max(-1).values)[:, 0]
    axis = diag.argmin(-1)[flat]
    tcov[flat, axis, :] = 0.0
    tcov[flat, :, axis] = 0.0
    scov = data.source_covs.clone()
    scov[::2] = 0.0
    assert len(flat) >= 400 and bool((torch.linalg.det(tcov[flat].cpu()) == 0).all())
    data = data._replace(source_covs=scov, target_covs=tcov)
    monkeypatch.setattr(gicp, "_eigh_batched",
                        lambda A: tuple(x.float() for x in torch.linalg.eigh(A.double())))
    T0 = torch.eye(4, device=device)
    got = gicp.gicp_align_kernel(data, T0, cfg)
    want = gicp.gicp_align_plain(data, T0, cfg)
    assert _counts(got) == _counts(want)
    assert _counts(got)[2], "the pair should converge"
    assert pose_gap(got.T, want.T, data.source) <= POSE_GAP
    assert abs(float(got.error) - float(want.error)) <= SUM_TOL * abs(float(want.error))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["scan", "map"])
def test_align_kernel_is_bitwise_repeatable(device, shape):
    """Two aligns of the same inputs: T, H, the error and the counts equal
    bit for bit (every sum in a fixed order)."""
    data, cfg = _data(device, 5, shape)
    T0 = torch.eye(4, device=device)
    a, b = (gicp.gicp_align_kernel(data, T0, cfg) for _ in range(2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_align_kernel_makes_no_host_sync(device):
    """`gicp_align` on the card under `torch.cuda.set_sync_debug_mode("error")`:
    no PyTorch op of the wrapper waits for the device, and it launches the
    kernel once; its scalars come back as 0-dim device tensors."""
    data, cfg = _data(device, 6, "scan")
    T0 = torch.eye(4, device=device)
    align = lambda: gicp.gicp_align(data.source, data.target, data.source_mask,
                                    data.target_mask, T0, cfg, source_covs=data.source_covs,
                                    target_covs=data.target_covs)
    align()  # builds the kernel
    torch.cuda.synchronize()
    gicp.ALIGN.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = align()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert gicp.ALIGN.launches == 1
    for x in (res.converged, res.iterations, res.lm_iterations, res.error):
        assert isinstance(x, torch.Tensor) and x.dim() == 0 and x.device.type == "cuda"
    assert bool(res.converged)


def test_gicp_align_on_the_cpu_runs_the_plain_loop():
    """On the CPU `gicp_align` is `gicp_align_plain` (the JAX package's
    parity tests hold that path) and never reaches the kernel."""
    src, tgt = (torch.as_tensor(a) for a in corridor_pair(7, 1024, 1024))
    mask = torch.ones(1024, dtype=torch.bool)
    cfg = dataclasses.replace(STREAM_CFG, knn_max_distance=2.0)
    launches = gicp.ALIGN.launches
    res = gicp.gicp_align(src, tgt, mask, mask, torch.eye(4), cfg)
    data = gicp.GICPData(src, mask, gicp.estimate_covariances(src, mask, 10, 2.0).covs,
                         tgt, mask, gicp.estimate_covariances(tgt, mask, 10, 2.0).covs)
    want = gicp.gicp_align_plain(data, torch.eye(4), cfg)
    assert gicp.ALIGN.launches == launches
    assert isinstance(res.iterations, int) and isinstance(res.converged, bool)
    assert (res.iterations, res.lm_iterations, res.converged) == (
        want.iterations, want.lm_iterations, want.converged)
    assert torch.equal(res.T, want.T) and res.converged
