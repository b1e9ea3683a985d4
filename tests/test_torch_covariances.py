"""`estimate_covariances`' CUDA kernel (`csrc/covariances.cu`: each point's
k nearest points, their gated covariance, its eigendecomposition, the
quaternion and the regularisation in one launch) against its plain version,
`estimate_covariances_plain`. On the CPU: CPU tensors take the plain path
bit for bit and never launch, and the kernel's wrapper refuses what the
kernel does not take. On the card (marker `cuda`, skipped without one): the
kernel against the plain version on a corridor scan at the stream's 4,096
points under every regularisation, with and without `z_values`, a third of
the points masked, and at the edges (duplicates, a plane, a line, the
fallback, few valid points, none, N = 1 and 4,097). This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_covariances.py
"""

import ctypes

import numpy as np
import pytest
import torch

from sags_tpu_torch.core.transforms import quat_scale_to_cov
from sags_tpu_torch.ops import gicp
from sags_tpu_torch.ops.knn import knn

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

# the largest relative Frobenius gap of a row's covariance, and of its
# R S^2 R^T, between the kernel and the plain version on the card
GAP = 1e-5
# a row whose k-th and (k+1)-th plain squared distances lie this close,
# relative, may take another neighbour in the two versions; where two of its
# first k tie, it may sum them in another order (the plain version's top-k
# orders ties as its sort leaves them, the kernel by index), and in a
# degenerate neighbourhood (a line: a middle eigenvalue at 0 or an ulp
# above it) that last bit moves the regularised covariance without bound
TIE = 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def corridor(seed: int, n: int = 4096, masked: float = 1.0 / 3.0):
    """(points [n,3], mask [n]) of the stream's corridor scan (the GICP
    kernel's tests' `corridor_pair`), `masked` of the points masked."""
    from test_torch_gicp_kernel import corridor_pair

    pts = torch.as_tensor(corridor_pair(seed, n, 16)[0])
    keep = np.random.default_rng(seed + 1).uniform(size=n) >= masked
    return pts, torch.as_tensor(keep)


def row_gaps(got, want):
    """Each row's relative Frobenius gap of `covs` and of R S^2 R^T."""
    def rel(a, b):
        a, b = a.double(), b.double()
        return (torch.linalg.matrix_norm(a - b)
                / torch.clamp(torch.linalg.matrix_norm(b), min=1e-30))

    return (rel(got.covs, want.covs),
            rel(quat_scale_to_cov(got.scales, got.quats),
                quat_scale_to_cov(want.scales, want.quats)))


def tie_rows(points, mask, k, within=False):
    """Rows whose plain k-th and (k+1)-th squared distances (`knn` as the
    plain version runs it) lie within `TIE` of each other, relative; with
    `within`, rows where any two neighbouring ones of the first k + 1 do."""
    if points.shape[0] <= k:
        return torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    far = torch.where(mask[:, None], points, torch.full_like(points, 1e10))
    d2, _ = knn(far, far, k=k + 1, chunk=1024)
    a, b = (d2[:, :k], d2[:, 1:]) if within else (d2[:, k - 1:k], d2[:, k:])
    return ((b - a) <= TIE * torch.clamp(torch.abs(a), min=1e-30)).any(-1)


def check_against_plain(points, mask, k=10, gate=0.5, reg="normalized_ellipse", z=None,
                        ties="boundary"):
    """The kernel (one launch) against the plain version on the same
    inputs: masked rows exactly the identity, (0, 0, 0, 1) and 0; the other
    rows within `GAP`, rows at a neighbour tie (`ties`: "boundary", the k-th
    and (k+1)-th; "within", any two of the first k + 1; "none") left out.
    Returns the number of rows left out."""
    before = gicp.COVARIANCES.launches
    got = gicp.estimate_covariances(points, mask, k, gate, reg, z_values=z)
    assert gicp.COVARIANCES.launches == before + 1
    want = gicp.estimate_covariances_plain(points, mask, k, gate, reg, z_values=z)
    off = ~mask
    assert torch.equal(got.covs[off], torch.eye(3, device=points.device).expand(int(off.sum()), 3, 3))
    assert torch.equal(got.quats[off], want.quats[off])
    assert torch.equal(got.scales[off], want.scales[off])
    if ties == "none":
        ties = torch.zeros_like(mask)
    else:
        ties = tie_rows(points, mask, k, within=ties == "within") & mask
    keep = ~ties
    g_cov, g_rss = row_gaps(got, want)
    assert torch.isfinite(got.covs).all() and torch.isfinite(got.quats).all()
    worst = (float(g_cov[keep].max()) if bool(keep.any()) else 0.0,
             float(g_rss[keep].max()) if bool(keep.any()) else 0.0)
    print(f"{reg} z={z is not None}: {int(ties.sum())} tie rows left out; largest gaps "
          f"{worst[0]:.3g} (covs), {worst[1]:.3g} (R S^2 R^T); rows not bit for bit: "
          f"{int((got.covs != want.covs).flatten(1).any(1).sum())} covs, "
          f"{int((got.quats != want.quats).any(1).sum())} quats, "
          f"{int((got.scales != want.scales).any(1).sum())} scales")
    assert worst[0] <= GAP and worst[1] <= GAP, worst
    return int(ties.sum())


@pytest.mark.parametrize("reg", gicp.REGULARIZATIONS)
def test_cpu_tensors_take_the_plain_path_bit_for_bit(reg):
    """On the CPU `estimate_covariances` is `estimate_covariances_plain`, bit
    for bit, and never reaches the kernel (the JAX package's parity tests
    hold that path)."""
    pts, mask = corridor(3, n=256)
    z = torch.as_tensor(np.random.default_rng(4).uniform(0.5, 8, 256).astype(np.float32))
    launches = gicp.COVARIANCES.launches
    got = gicp.estimate_covariances(pts, mask, 10, 2.0, reg, z_values=z)
    want = gicp.estimate_covariances_plain(pts, mask, 10, 2.0, reg, z_values=z)
    assert gicp.COVARIANCES.launches == launches
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _refused(case):
    pts, mask = corridor(5, n=64)
    kw = {}
    if case == "k above the cap":
        kw["k"] = gicp.COVARIANCES_MAX_K + 1
    elif case == "k above N":
        pts, mask = pts[:8], mask[:8]
    elif case == "float64 points":
        pts = pts.double()
    elif case == "float32 mask":
        mask = mask.float()
    elif case == "non-contiguous mask":
        mask = torch.stack([mask, mask], -1)[:, 0]
    elif case == "mismatched-device mask":
        mask = mask.to("meta")
    elif case == "unknown regularization":
        kw["regularization"] = "spherical"
    return pts, mask, kw


@pytest.mark.parametrize("case,error", [
    ("k above the cap", ValueError), ("k above N", ValueError), ("float64 points", TypeError),
    ("float32 mask", TypeError), ("non-contiguous mask", ValueError),
    ("mismatched-device mask", ValueError), ("CPU tensors", ValueError),
    ("unknown regularization", ValueError)])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case, error):
    """`estimate_covariances_kernel` raises before any launch on each input
    the kernel does not take; there is no fallback."""
    pts, mask, kw = _refused(case)
    launches = gicp.COVARIANCES.launches
    with pytest.raises(error):
        gicp.estimate_covariances_kernel(pts, mask, **kw)
    assert gicp.COVARIANCES.launches == launches


def test_no_path_for_another_device():
    pts, mask = (t.to("meta") for t in corridor(6, n=32))
    with pytest.raises(ValueError, match="no path"):
        gicp.estimate_covariances(pts, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize("reg", gicp.REGULARIZATIONS)
def test_kernel_matches_plain_on_the_card(device, reg, with_z):
    """At the stream's shape (4,096 points, k = 10, the stream's gate 0.5)
    with a third of the points masked: `covs` and R S^2 R^T within `GAP` of
    the plain version's on every row but a neighbour tie's (expected: none)."""
    pts, mask = (t.to(device) for t in corridor(0))
    z = None
    if with_z:
        z = torch.as_tensor(np.random.default_rng(1).uniform(0.2, 8.0, 4096).astype(np.float32),
                            device=device)
    check_against_plain(pts, mask, reg=reg, z=z)


@pytest.mark.cuda
def test_kernel_takes_the_largest_k(device):
    """k = 32, the cap (the second of the kernel's two list sizes), and 17."""
    assert gicp.COVARIANCES.function("sags_covariances_max_k", [], ctypes.c_int)() \
        == gicp.COVARIANCES_MAX_K
    pts, mask = (t.to(device) for t in corridor(2, n=2048))
    for k in (17, gicp.COVARIANCES_MAX_K):
        check_against_plain(pts, mask, k=k, gate=2.0)


def _edge(case, device):
    """(points, mask, k, ties) of an edge case (`check_against_plain`)."""
    rng = np.random.default_rng(7)
    k, ties = 10, "within"
    if case == "duplicates":  # 64 places, 16 copies each: zero covariances
        pts = np.repeat(rng.uniform(-4, 4, (64, 3)), 16, axis=0)
        ties = "none"  # every neighbour ties, and every choice is the same place
    elif case == "crowds":  # 80 copies of each place: more ties than the kernel ranks
        pts = np.repeat(rng.uniform(-4, 4, (24, 3)), 80, axis=0)
        ties = "none"
    elif case == "plane":
        xy = rng.uniform(-1, 1, (1024, 2))
        pts = np.concatenate([xy, np.full((1024, 1), 2.0)], -1)
    elif case == "line":
        pts = np.stack([rng.uniform(-3, 3, 512), np.full(512, 0.5), np.full(512, -1.0)], -1)
    elif case == "fallback":  # 3 m apart: no neighbour but itself within the gate
        g = np.arange(8) * 3.0
        pts = np.stack(np.meshgrid(g, g, g[:4], indexing="ij"), -1).reshape(-1, 3)
        pts = pts + rng.normal(0, 0.05, pts.shape)
    elif case == "few valid":
        pts = rng.uniform(-0.3, 0.3, (64, 3))
    elif case == "all masked":
        pts = rng.uniform(-1, 1, (100, 3))
    elif case == "one point":
        pts, k = rng.uniform(-1, 1, (1, 3)), 1
    else:  # "4097": one point past a whole stage of the kernel, and 256 blocks
        pts = corridor(8, n=4097)[0].numpy()
    pts = torch.as_tensor(pts.astype(np.float32), device=device)
    mask = torch.ones(len(pts), dtype=torch.bool, device=device)
    if case == "few valid":
        mask[6:] = False
    elif case == "all masked":
        mask[:] = False
    return pts, mask, k, ties


@pytest.mark.cuda
@pytest.mark.parametrize("reg", ["normalized_ellipse", "plane", "frobenius"])
@pytest.mark.parametrize("case", ["duplicates", "crowds", "plane", "line", "fallback", "few valid",
                                  "all masked", "one point", "4097"])
def test_kernel_at_the_edges(device, case, reg):
    """Zero covariances (the isotropic branch; with 80 copies a place, more
    candidates than the kernel ranks, so its exact fallback), a zero
    smallest eigenvalue, a zero middle one (`normalized_ellipse`'s 1e-9
    branch), fewer than 3 reliable neighbours (every valid neighbour
    counts), fewer valid points than k (the masked ones never count), no
    valid point, one point, and a ragged last stage and block: within `GAP`
    of the plain version, rows with tied neighbours left out (what the plain
    version sums in another order there, such a neighbourhood's eigenvalues
    amplify)."""
    pts, mask, k, ties = _edge(case, device)
    check_against_plain(pts, mask, k=k, reg=reg, ties=ties)
    if case == "all masked":
        got = gicp.estimate_covariances(pts, mask, k)
        assert torch.equal(got.quats, torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device)
                           .expand(len(pts), 4))
        assert torch.equal(got.scales, torch.zeros_like(got.scales))


@pytest.mark.cuda
def test_kernel_makes_no_host_sync(device):
    """The wrapper under `torch.cuda.set_sync_debug_mode("error")`, with the
    `plane` regularisation (whose plain version reads its constants from the
    host): one launch, no sync, no empty input launched."""
    pts, mask = (t.to(device) for t in corridor(9))
    gicp.estimate_covariances(pts, mask, regularization="plane")  # builds the kernel
    torch.cuda.synchronize()
    launches = gicp.COVARIANCES.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gicp.estimate_covariances(pts, mask, regularization="plane")
        empty = gicp.estimate_covariances(pts[:0], mask[:0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert gicp.COVARIANCES.launches == launches + 1
    assert out.covs.shape == (4096, 3, 3) and empty.covs.shape == (0, 3, 3)
