"""GICP / VGICP scan registration in torch (`sags_tpu.ops.gicp`): surfel
covariances (kNN + the closed-form symmetric 3×3 eigendecomposition + the
fork's regularizations), nearest-neighbour correspondences with the
Mahalanobis (C_B + R C_A Rᵀ)⁻¹, the single-thread variant's correspondence
reuse under the triangle bound, the Gaussian voxel map (sorted int32 keys,
`searchsorted` lookups, per-voxel sums of contiguous runs) with the
DIRECT1/7/27/RADIUS neighbour search of VGICP, and the LsqRegistration loop:
Gauss-Newton, or Levenberg-Marquardt with the reference's accept/λ rules
(`lsq_registration_impl.hpp:53-173`).

The JAX `lax.while_loop`s become Python loops: each Gauss-Newton iteration
and each LM trial reads its convergence (and accept) flags on the host (one
sync each), and so does each outer LM iteration's convergence test and each
`robust_inv3` (whether a determinant vanished); the LM loop's two starting
scalars are copied to the device: an LM align of `i` outer iterations and
`n` trials syncs 2·i + n + 2 times (`utils/profiling.host_read` counts them
while tracing is on).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from sags_tpu_torch.core.config import GICPConfig
from sags_tpu_torch.core.transforms import rotmat_to_quat, se3_matrix, skew, so3_exp
from sags_tpu_torch.ops.knn import knn
from sags_tpu_torch.utils.profiling import host_read, span


NEIGHBOR_OFFSETS = {
    "direct1": [(0, 0, 0)],
    "direct7": [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                (0, 0, 1), (0, 0, -1)],
    "direct27": [(i - 1, j - 1, k - 1) for i in range(3) for j in range(3)
                 for k in range(3)],
}


def neighbor_offsets(method: str, radius: float = 1.5):
    """Offset table incl. DIRECT_RADIUS (`gicp_settings.hpp:8`): all integer
    offsets within `radius` voxels."""
    if method != "direct_radius":
        return NEIGHBOR_OFFSETS[method]
    r = int(radius)
    return [(i, j, k) for i in range(-r, r + 1) for j in range(-r, r + 1)
            for k in range(-r, r + 1) if (i * i + j * j + k * k) <= radius * radius]


class PointCovariances(NamedTuple):
    covs: torch.Tensor  # [N,3,3] regularized
    quats: torch.Tensor  # [N,4] xyzw
    scales: torch.Tensor  # [N,3] sqrt eigenvalues, descending


def sym_eig3(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric 3×3 matrices: trigonometric
    eigenvalues, eigenvectors from row cross-products of (A − λI).
    Returns (evals [..,3] descending, evecs [..,3,3] columns, det = +1)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    scale = torch.clamp(torch.abs(q), min=1.0)
    iso = p <= 1e-7 * scale
    ps = torch.where(iso, torch.ones_like(p), p)
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02)) / (ps * ps * ps)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    evals = torch.stack([e1, e2, e3], -1)

    row0 = torch.stack([a00, a01, a02], -1)
    row1 = torch.stack([a01, a11, a12], -1)
    row2 = torch.stack([a02, a12, a22], -1)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    ex, ey, ez = (eye[i].expand_as(row0) for i in range(3))

    def evec(lam, fallback):
        lamx = lam[..., None]
        r0, r1, r2 = row0 - lamx * ex, row1 - lamx * ey, row2 - lamx * ez
        c01 = torch.linalg.cross(r0, r1)
        c02 = torch.linalg.cross(r0, r2)
        c12 = torch.linalg.cross(r1, r2)
        n01 = torch.sum(c01 * c01, -1)
        n02 = torch.sum(c02 * c02, -1)
        n12 = torch.sum(c12 * c12, -1)
        best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                           torch.where((n02 >= n12)[..., None], c02, c12))
        nrm = torch.sqrt(torch.sum(best * best, -1, keepdim=True))
        ok = nrm[..., 0] > 1e-20
        return torch.where(ok[..., None],
                           best / torch.where(ok[..., None], nrm, torch.ones_like(nrm)),
                           fallback)

    v3 = evec(e3, ez)
    v1 = evec(e1, ex)
    v1 = v1 - torch.sum(v1 * v3, -1, keepdim=True) * v3
    n1 = torch.sqrt(torch.sum(v1 * v1, -1, keepdim=True))
    alt = torch.linalg.cross(v3, ex)
    alt_n = torch.sqrt(torch.sum(alt * alt, -1, keepdim=True))
    alt2 = torch.linalg.cross(v3, ey)
    alt2_n = torch.sqrt(torch.sum(alt2 * alt2, -1, keepdim=True))
    alt = torch.where(alt_n > 0.1, alt / torch.clamp(alt_n, min=1e-30),
                      alt2 / torch.clamp(alt2_n, min=1e-30))
    v1 = torch.where(n1 > 1e-10, v1 / torch.clamp(n1, min=1e-30), alt)
    v2 = torch.linalg.cross(v3, v1)
    evecs = torch.stack([v1, v2, v3], -1)
    evecs = torch.where(iso[..., None, None], eye.expand_as(evecs), evecs)
    evals = torch.where(iso[..., None], q[..., None].expand_as(evals), evals)
    return evals, evecs


def estimate_covariances(points: torch.Tensor, mask: torch.Tensor, k: int = 10,
                         knn_max_distance: float = 0.5,
                         regularization: str = "normalized_ellipse",
                         z_values: Optional[torch.Tensor] = None) -> PointCovariances:
    """Per-point surfel covariance + (quat, scale) export
    (`fast_gicp_impl.hpp:380-479`; gates and divisor as in the JAX package).
    `z_values` [N] divides the scales as `calculate_covariances_withz` does
    (`:534-538`)."""
    far = torch.where(mask[:, None], points, torch.full_like(points, 1e10))
    sq_d, idx = knn(far, far, k=k, chunk=1024)
    nbr = points[idx]
    reliable = (sq_d < knn_max_distance) & mask[idx] & mask[:, None]
    enough = torch.sum(reliable, -1) >= 3
    reliable = reliable | (~enough[:, None] & mask[idx] & mask[:, None])
    n_rel = torch.clamp(torch.sum(reliable, -1), min=1)
    zero = torch.zeros((), device=points.device)
    mean = torch.sum(torch.where(reliable[..., None], nbr, zero), 1) / n_rel[:, None]
    d = torch.where(reliable[..., None], nbr - mean[:, None], zero)
    cov = torch.einsum("nki,nkj->nij", d, d) / float(k)

    evals, U = sym_eig3(cov)
    sv = torch.clamp(evals, min=0.0)
    quats = rotmat_to_quat(U)
    scales = torch.sqrt(sv)
    if z_values is not None:
        zc = torch.clamp((z_values ** 1.5) * 2.0, min=1.0)
        scales = scales / zc[:, None]
    if regularization == "none":
        covs = cov
    elif regularization == "frobenius":
        C_inv = torch.linalg.inv(cov + 1e-3 * torch.eye(3, device=points.device))
        norm = torch.linalg.matrix_norm(C_inv, keepdim=True)
        covs = torch.linalg.inv(C_inv / norm)
    else:
        if regularization == "plane":
            vals = host_read(torch.tensor, [1.0, 1.0, 1e-3],
                             device=points.device).expand_as(sv)
        elif regularization == "min_eig":
            vals = torch.clamp(sv, min=1e-3)
        elif regularization == "normalized_min_eig":
            vals = torch.clamp(sv / torch.clamp(sv[:, :1], min=1e-30), min=1e-3)
        elif regularization == "normalized_ellipse":
            mid = sv[:, 1:2]
            vals = torch.where(mid == 0.0, torch.full_like(sv, 1e-9),
                               torch.clamp(sv / torch.where(mid == 0.0, torch.ones_like(mid), mid),
                                           min=1e-3))
        else:
            raise ValueError(f"unknown regularization {regularization!r}")
        covs = torch.einsum("nij,nj,nkj->nik", U, vals, U)
    eye = torch.eye(3, device=points.device).expand_as(covs)
    covs = torch.where(mask[:, None, None], covs, eye)
    return PointCovariances(covs=covs, quats=quats, scales=scales)


def covariances_from_qs(quats: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """pygicp `set_*_covariance_fromqs` (`src/python/main.cpp`): Σ = R S² Rᵀ."""
    from sags_tpu_torch.core.transforms import quat_scale_to_cov

    return quat_scale_to_cov(scales, quats)


# cuSOLVER's batched symmetric eigensolver refuses batches of 3x3 matrices
# from about 2^15 on (CUSOLVER_STATUS_INVALID_VALUE, with torch 2.11 and
# CUDA 12.8 on an H100); each matrix is solved on its own, so chunks give
# the same numbers
_EIGH_CHUNK = 16384


def _eigh_batched(A: torch.Tensor):
    """`torch.linalg.eigh` of [..., 3, 3] in chunks of `_EIGH_CHUNK`."""
    flat = A.reshape(-1, 3, 3)
    parts = [torch.linalg.eigh(c) for c in flat.split(_EIGH_CHUNK)]
    return (torch.cat([p[0] for p in parts]).reshape(A.shape[:-1]),
            torch.cat([p[1] for p in parts]).reshape(A.shape))


def robust_inv3(A: torch.Tensor) -> torch.Tensor:
    """Batched 3×3 adjugate inverse; an eigh pseudo-inverse only where the
    determinant vanishes (checked on the host: one sync)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11, c12, c13 = e * i - f * h, c * h - b * i, b * f - c * e
    c21, c22, c23 = f * g - d * i, a * i - c * g, c * d - a * f
    c31, c32, c33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * c11 + b * c21 + c * c31
    ok = torch.abs(det) > 1e-20
    r = 1.0 / torch.where(ok, det, torch.ones_like(det))
    adj = torch.stack([torch.stack([c11, c12, c13], -1),
                       torch.stack([c21, c22, c23], -1),
                       torch.stack([c31, c32, c33], -1)], -2)
    inv = adj * r[..., None, None]
    if host_read(bool, ok.all()):
        return inv
    evals, evecs = _eigh_batched(A)
    inv_evals = torch.where(torch.abs(evals) > 1e-12, 1.0 / evals, torch.zeros_like(evals))
    pinv = torch.einsum("...ij,...j,...kj->...ik", evecs, inv_evals, evecs)
    return torch.where(ok[..., None, None], inv, pinv)


def _is_converged(delta, rot_eps: float, trans_eps: float) -> torch.Tensor:
    R = delta[:3, :3] - torch.eye(3, device=delta.device)
    r_delta = torch.max(torch.abs(R)) / rot_eps
    t_delta = torch.max(torch.abs(delta[:3, 3])) / trans_eps
    return torch.maximum(r_delta, t_delta) < 1.0


class GICPData(NamedTuple):
    source: torch.Tensor
    source_mask: torch.Tensor
    source_covs: torch.Tensor
    target: torch.Tensor
    target_mask: torch.Tensor
    target_covs: torch.Tensor


def _gicp_correspondences(T, data: GICPData, cfg: GICPConfig):
    R = T[:3, :3]
    src_t = data.source @ R.T + T[:3, 3]
    far_t = torch.where(data.target_mask[:, None], data.target,
                        torch.full_like(data.target, 1e10))
    sq_d, idx = knn(src_t, far_t, k=1, chunk=1024)
    idx = idx[:, 0]
    ok = (data.source_mask & (sq_d[:, 0] < cfg.corr_dist_threshold ** 2)
          & data.target_mask[idx])
    RCR = data.target_covs[idx] + torch.einsum("ij,njk,lk->nil", R, data.source_covs, R)
    return ok, data.target[idx], robust_inv3(RCR)


def _hb_from_pairs(T, mean_A, mean_B, mahal, w):
    src_t = mean_A @ T[:3, :3].T + T[:3, 3]
    err = mean_B - src_t
    e = torch.einsum("ni,nij,nj->", w[:, None] * err, mahal, err)
    S = skew(src_t)
    J = torch.cat([S, -torch.eye(3, device=T.device).expand_as(S)], dim=-1)
    MJ = torch.einsum("nij,njk->nik", mahal, J)
    H = torch.einsum("n,nij,nik->jk", w, J, MJ)
    b = torch.einsum("n,nij,ni->j", w, MJ, err)
    return H, b, e


def make_gicp_linearizer(data: GICPData, cfg: GICPConfig):
    def linearize(T):
        ok, mean_B, mahal = _gicp_correspondences(T, data, cfg)
        H, b, e = _hb_from_pairs(T, data.source, mean_B, mahal, ok.to(torch.float32))
        return H, b, e, (ok, mean_B, mahal)

    def error(T, corr):
        ok, mean_B, mahal = corr
        return _hb_from_pairs(T, data.source, mean_B, mahal, ok.to(torch.float32))[2]

    return linearize, error


def correspondence_dump(T, source, target, source_mask, target_mask,
                        corr_dist_threshold: float = float("inf")):
    """pygicp `get_source_correspondence` (`main.cpp:230-233`): the nearest
    target index (−1 when gated) and squared distance per source point, at
    transformation T."""
    src_t = source @ T[:3, :3].T + T[:3, 3]
    far_t = torch.where(target_mask[:, None], target, torch.full_like(target, 1e10))
    sq_d, idx = knn(src_t, far_t, k=1, chunk=1024)
    idx = idx[:, 0]
    ok = source_mask & (sq_d[:, 0] < corr_dist_threshold ** 2) & target_mask[idx]
    return torch.where(ok, idx, -1), sq_d[:, 0]


def make_gicp_st_linearizer(data: GICPData, cfg: GICPConfig):
    """FastGICPSingleThread semantics (`gicp/impl/fast_gicp_st_impl.hpp`):
    a point's correspondence (and its Mahalanobis weight) is kept across
    linearizations while the triangle bound √d1 + |Δx| < √d2 − |Δx| proves
    its nearest neighbour cannot have changed (d2: the second-nearest at the
    last search, Δx: the point's movement since). The k=2 search runs for
    every point regardless; this is for the variant's results, whose stale
    weights differ from the batched FastGICP's. Returns (linearize(T,
    carry), error, the first carry)."""
    N = data.source.shape[0]
    dev = data.source.device
    far_t = torch.where(data.target_mask[:, None], data.target,
                        torch.full_like(data.target, 1e10))

    def linearize(T, st):
        first, anchors, sqd, sqd2, idx, mahal = st
        R = T[:3, :3]
        src_t = data.source @ R.T + T[:3, 3]
        d_move = torch.linalg.vector_norm(src_t - anchors, dim=-1)
        need = (torch.sqrt(sqd) + d_move >= torch.sqrt(sqd2) - d_move) | first
        sq_k, idx_k = knn(src_t, far_t, k=2, chunk=1024)
        new_idx = torch.where(sq_k[:, 0] < cfg.corr_dist_threshold ** 2, idx_k[:, 0], -1)
        RCR = data.target_covs[idx_k[:, 0]] + torch.einsum(
            "ij,njk,lk->nil", R, data.source_covs, R)
        new_mahal = robust_inv3(RCR)
        idx = torch.where(need, new_idx, idx)
        mahal = torch.where(need[:, None, None], new_mahal, mahal)
        sqd = torch.where(need, sq_k[:, 0], sqd)
        sqd2 = torch.where(need, sq_k[:, 1], sqd2)
        anchors = torch.where(need[:, None], src_t, anchors)
        safe = torch.clamp(idx, min=0)
        ok = data.source_mask & (idx >= 0) & data.target_mask[safe]
        mean_B = data.target[safe]
        H, b, e = _hb_from_pairs(T, data.source, mean_B, mahal, ok.to(torch.float32))
        return H, b, e, (ok, mean_B, mahal), (False, anchors, sqd, sqd2, idx, mahal)

    def error(T, corr):
        ok, mean_B, mahal = corr
        return _hb_from_pairs(T, data.source, mean_B, mahal, ok.to(torch.float32))[2]

    carry0 = (True, torch.zeros((N, 3), device=dev), torch.zeros(N, device=dev),
              torch.full((N,), float("inf"), device=dev),
              torch.full((N,), -1, dtype=torch.int64, device=dev),
              torch.zeros((N, 3, 3), device=dev))
    return linearize, error, carry0


# ---------------------------------------------------------------------------
# Gaussian voxel map + FastVGICP (`fast_vgicp_impl.hpp`, `fast_vgicp_voxel.hpp`)
# ---------------------------------------------------------------------------


class VoxelMap(NamedTuple):
    keys: torch.Tensor  # [V] sorted unique voxel keys (int32, _KEY_MAX pad)
    means: torch.Tensor  # [V,3]
    covs: torch.Tensor  # [V,3,3]
    num_points: torch.Tensor  # [V] float32
    n_voxels: torch.Tensor  # scalar int32
    overflow: torch.Tensor  # voxels dropped by capacity
    mins: torch.Tensor  # [3] int32 coord offset
    dims: torch.Tensor  # [3] int32 grid dims (for key encoding)
    resolution: float


_KEY_MAX = 2 ** 31 - 1


def _voxel_coords(points: torch.Tensor, resolution: float) -> torch.Tensor:
    return torch.floor(points / resolution).to(torch.int32)


def _encode(coords: torch.Tensor, mins: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """int32 voxel key (rel0·dims1 + rel1)·dims2 + rel2 of coords offset by
    `mins` − 1, _KEY_MAX outside the grid. int32 throughout, wrapping as the
    JAX package's does, so keys, their order and the voxel ids agree."""
    rel = coords - mins + 1
    inside = torch.all((rel >= 0) & (rel < dims), dim=-1)
    key = (rel[..., 0] * dims[1] + rel[..., 1]) * dims[2] + rel[..., 2]
    return torch.where(inside, key, _KEY_MAX)


def _matvec3(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [N,3,3] · x [N,3] as a chain of fused multiply-adds,
    fma(a2, x2, fma(a1, x1, a0·x0)), the order XLA's CPU dot takes (each
    step in float64, rounded to float32). The multiplicative voxel map
    multiplies through inverses of covariances with condition numbers in the
    thousands, so a one-ulp difference here is 1e-5 of a voxel mean."""
    A64, x64 = A.double(), x.double()
    acc = (A64[..., 0] * x64[:, None, 0]).float()
    for k in (1, 2):
        acc = (acc.double() + A64[..., k] * x64[:, None, k]).float()
    return acc


def build_voxel_map(points: torch.Tensor, covs: torch.Tensor, mask: torch.Tensor,
                    resolution: float, max_voxels: int, mode: str = "additive") -> VoxelMap:
    """GaussianVoxelMap by sort and segment sums (the reference's hash map,
    `cuda/gaussian_voxelmap.cu`, in the JAX package's form). Accumulation
    modes (`gicp_settings.hpp:10`, `fast_vgicp_voxel.hpp:60-122`):
    additive and additive_weighted (the reference instantiates the same
    voxel for both) average the points and covariances of a voxel;
    multiplicative fuses them as a product of Gaussians, Σ⁻¹ = Σᵢ Σᵢ⁻¹,
    μ = Σ · Σᵢ (Σᵢ⁻¹ μᵢ).

    Points are stably sorted by key, so each voxel's points form one run,
    summed in order by `segment_reduce`: deterministic on every device
    (`index_add_` of floats on CUDA is not)."""
    dev = points.device
    multiplicative = mode == "multiplicative"
    if multiplicative:
        covs = robust_inv3(covs)
        points_acc = _matvec3(covs, points)
    else:
        points_acc = points
    coords = _voxel_coords(points, resolution)
    big = 2 ** 30
    mins = torch.amin(torch.where(mask[:, None], coords, big), dim=0)
    maxs = torch.amax(torch.where(mask[:, None], coords, -big), dim=0)
    dims = maxs - mins + 3  # +2 margin keeps neighbour offsets inside the key space
    keys = torch.where(mask, _encode(coords, mins, dims), _KEY_MAX)
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    valid_pt = ks < _KEY_MAX
    is_new = torch.ones_like(valid_pt)
    is_new[1:] = ks[1:] != ks[:-1]
    is_new &= valid_pt
    vid = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(valid_pt & (vid < max_voxels), vid, max_voxels).long()
    n_new = torch.sum(is_new.to(torch.int32))

    key_buf = torch.full((max_voxels + 1,), _KEY_MAX, dtype=torch.int32, device=dev)
    key_buf.scatter_(0, slot, torch.where(slot < max_voxels, ks, _KEY_MAX))
    # slot is non-decreasing along the sorted points: voxel v's points are
    # the v-th run, and the points past capacity or outside the mask the last
    rows = torch.cat([points_acc[order], covs[order].reshape(-1, 9)], dim=-1)
    lengths = torch.bincount(slot, minlength=max_voxels + 1)
    sums = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)
    sum_p, sum_c = sums[:max_voxels, :3], sums[:max_voxels, 3:].reshape(-1, 3, 3)
    cnt = lengths[:max_voxels].to(torch.float32)
    if multiplicative:
        cov_out = robust_inv3(sum_c)
        mean_out = _matvec3(cov_out, sum_p)
    else:
        cnt_safe = torch.clamp(cnt, min=1.0)
        cov_out = sum_c / cnt_safe[:, None, None]
        mean_out = sum_p / cnt_safe[:, None]
    return VoxelMap(keys=key_buf[:max_voxels], means=mean_out, covs=cov_out,
                    num_points=cnt, n_voxels=torch.clamp(n_new, max=max_voxels),
                    overflow=torch.clamp(n_new - max_voxels, min=0), mins=mins,
                    dims=dims, resolution=resolution)


def lookup_voxels(vm: VoxelMap, coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords [M,3] int32 → (voxel index [M], found [M])."""
    key = _encode(coords, vm.mins, vm.dims)
    idx = torch.searchsorted(vm.keys, key)
    idx_c = torch.clamp(idx, max=vm.keys.shape[0] - 1)
    found = (vm.keys[idx_c] == key) & (key < _KEY_MAX)
    return idx_c, found


class VGICPData(NamedTuple):
    source: torch.Tensor
    source_mask: torch.Tensor
    source_covs: torch.Tensor
    voxel_map: VoxelMap


def make_vgicp_linearizer(data: VGICPData, cfg: GICPConfig):
    """Each source point against the voxels at its own and the neighbour
    offsets' coordinates, weighted by √num_points (`fast_vgicp_impl.hpp`)."""
    vm = data.voxel_map
    offsets = host_read(torch.tensor,
                        neighbor_offsets(cfg.neighbor_search, cfg.neighbor_radius),
                        dtype=torch.int32, device=data.source.device)  # [F,3]
    F, Ns = offsets.shape[0], data.source.shape[0]
    mean_A = data.source[:, None].expand(Ns, F, 3).reshape(-1, 3)

    def flat(T, w, mean_B, mahal):
        return _hb_from_pairs(T, mean_A, mean_B.reshape(-1, 3), mahal.reshape(-1, 3, 3),
                              w.reshape(-1))

    def linearize(T):
        R = T[:3, :3]
        src_t = data.source @ R.T + T[:3, 3]
        c_off = _voxel_coords(src_t, vm.resolution)[:, None, :] + offsets[None]
        vidx, found = lookup_voxels(vm, c_off.reshape(-1, 3))
        vidx = vidx.reshape(Ns, F)
        found = found.reshape(Ns, F) & data.source_mask[:, None]
        RCR = vm.covs[vidx] + torch.einsum("ij,njk,lk->nil", R, data.source_covs, R)[:, None]
        mahal = robust_inv3(RCR.reshape(-1, 3, 3)).reshape(Ns, F, 3, 3)
        w = torch.where(found, torch.sqrt(vm.num_points[vidx]), 0.0)
        mean_B = vm.means[vidx]
        H, b, e = flat(T, w, mean_B, mahal)
        return H, b, e, (w, mean_B, mahal)

    def error(T, corr):
        return flat(T, *corr)[2]

    return linearize, error


class AlignResult(NamedTuple):
    T: torch.Tensor  # [4,4]
    H: torch.Tensor  # [6,6] last Hessian
    converged: bool
    iterations: int  # outer (linearize) iterations
    error: torch.Tensor
    lm_iterations: int  # inner LM trials over all outer iterations


OPTIMIZERS = ("lm", "gn")  # `GICPConfig.optimizer`


def lsq_align(linearize, error_fn, init_T: torch.Tensor, cfg: GICPConfig,
              carry_init=None) -> AlignResult:
    """The LsqRegistration outer loop (`lsq_registration_impl.hpp:53-173`):
    `step_gn` for `optimizer="gn"`, `step_lm` (`:125-173`) for "lm". Each
    Gauss-Newton iteration and each LM trial reads its flags on the host
    (one sync). With `carry_init`, `linearize(T, carry) -> (H, b, e, corr,
    carry)` threads a correspondence state through the outer iterations
    (the single-thread variant's); it is updated at each linearization,
    whether or not that iteration's LM trials accept."""
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r} (one of {OPTIMIZERS})")
    if carry_init is not None:
        carry = carry_init
        stateful_lin = linearize

        def linearize(T):
            nonlocal carry
            H, b, e, corr, carry = stateful_lin(T, carry)
            return H, b, e, corr

    dev = init_T.device
    I6 = torch.eye(6, device=dev)
    conv = lambda d: _is_converged(d, cfg.rotation_epsilon, cfg.transformation_epsilon)

    def delta_of(d):
        return se3_matrix(so3_exp(d[:3]), d[3:])

    def solve(A, rhs):
        # a singular system (no correspondence left: H = 0) gives a
        # non-finite step that no LM trial accepts, as `jnp.linalg.solve`
        # does, instead of raising; and no check syncs the host
        return torch.linalg.solve_ex(A, rhs)[0]

    if cfg.optimizer == "gn":
        T, H, e = init_T, I6, host_read(torch.tensor, float("inf"), device=dev)
        i, converged = 0, False
        while i < cfg.max_iterations and not converged:
            H, b, e, _ = linearize(T)
            delta = delta_of(solve(H, -b))
            T = delta @ T
            converged = host_read(bool, conv(delta))  # one sync
            i += 1
        return AlignResult(T, H, converged, i, e, 0)

    T = init_T
    lam = host_read(torch.tensor, -1.0, device=dev)
    H, e = I6, host_read(torch.tensor, float("inf"), device=dev)
    i, converged, failed, n_lm = 0, False, False, 0
    while i < cfg.max_iterations and not converged and not failed:
        H, b, y0, corr = linearize(T)
        e = y0
        lam = torch.where(lam < 0.0, cfg.lm_init_lambda_factor
                          * torch.max(torch.abs(torch.diagonal(H))), lam)
        nu = 2.0
        delta = torch.eye(4, device=dev)
        success = False
        for _ in range(cfg.lm_max_iterations):
            with span("gicp.lm_trial"):
                d = solve(H + lam * I6, -b)
                dl = delta_of(d)
                xi = dl @ T
                yi = error_fn(xi, corr)
                rho = (y0 - yi) / torch.dot(d, lam * d - b)
                accept_t = rho >= 0.0
                flags = host_read(torch.Tensor.tolist,
                                  torch.stack([accept_t, conv(dl)]))  # one sync
            accept, dl_conv = bool(flags[0]), bool(flags[1])
            n_lm += 1
            delta = dl
            if accept:
                lam = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
                T = xi
                success = True
                break
            lam = nu * lam
            nu = 2.0 * nu
            if dl_conv:  # early: rejected step already below the epsilons
                success = True
                break
        failed = not success
        converged = host_read(bool, conv(delta))
        i += 1
    return AlignResult(T, H, converged, i, e, n_lm)


def gicp_align(source, target, source_mask, target_mask, init_T,
               cfg: GICPConfig = GICPConfig(), source_covs=None,
               target_covs=None) -> AlignResult:
    with span("gicp.align"):
        data = GICPData(
            source, source_mask, _covs_or_estimate(source, source_mask, source_covs, cfg),
            target, target_mask, _covs_or_estimate(target, target_mask, target_covs, cfg))
        lin, err = make_gicp_linearizer(data, cfg)
        return lsq_align(lin, err, init_T, cfg)


def _covs_or_estimate(points, mask, covs, cfg: GICPConfig):
    if covs is not None:
        return covs
    return estimate_covariances(points, mask, cfg.k_correspondences, cfg.knn_max_distance,
                                cfg.regularization).covs


def gicp_align_st(source, target, source_mask, target_mask, init_T,
                  cfg: GICPConfig = GICPConfig(), source_covs=None,
                  target_covs=None) -> AlignResult:
    """FastGICPSingleThread: correspondence reuse under the triangle bound
    (`make_gicp_st_linearizer`)."""
    with span("gicp.align"):
        data = GICPData(
            source, source_mask, _covs_or_estimate(source, source_mask, source_covs, cfg),
            target, target_mask, _covs_or_estimate(target, target_mask, target_covs, cfg))
        lin, err, carry0 = make_gicp_st_linearizer(data, cfg)
        return lsq_align(lin, err, init_T, cfg, carry_init=carry0)


def vgicp_align(source, target, source_mask, target_mask, init_T,
                cfg: GICPConfig = GICPConfig(), source_covs=None,
                target_covs=None) -> AlignResult:
    """FastVGICP: the source against a Gaussian voxel map of the target."""
    with span("gicp.align"):
        source_covs = _covs_or_estimate(source, source_mask, source_covs, cfg)
        target_covs = _covs_or_estimate(target, target_mask, target_covs, cfg)
        vm = build_voxel_map(target, target_covs, target_mask, cfg.voxel_resolution,
                             cfg.max_voxels, mode=cfg.voxel_accumulation)
        lin, err = make_vgicp_linearizer(VGICPData(source, source_mask, source_covs, vm), cfg)
        return lsq_align(lin, err, init_T, cfg)


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, resolution: float,
                     max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """pygicp `downsample` (PCL VoxelGrid): the centroid of each voxel.
    Returns (points [max_out,3], mask [max_out])."""
    covs = torch.zeros((points.shape[0], 3, 3), device=points.device)
    vm = build_voxel_map(points, covs, mask, resolution, max_out)
    valid = torch.arange(max_out, device=points.device) < vm.n_voxels
    return torch.where(valid[:, None], vm.means, 0.0), valid
