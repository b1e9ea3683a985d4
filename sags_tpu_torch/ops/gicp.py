"""GICP scan registration in torch — the `"gicp"` tracker of
`sags_tpu.ops.gicp`: surfel covariances (kNN + the closed-form symmetric
3×3 eigendecomposition + NORMALIZED_ELLIPSE and the other regularizations),
nearest-neighbour correspondences with the Mahalanobis (C_B + R C_A Rᵀ)⁻¹,
and the LsqRegistration loop: Gauss-Newton, or Levenberg-Marquardt with the
reference's accept/λ rules (`lsq_registration_impl.hpp:53-173`).

The JAX `lax.while_loop`s become Python loops: each Gauss-Newton iteration
and each LM trial reads its convergence (and accept) flags on the host (one
sync each).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from sags_tpu_torch.core.config import GICPConfig
from sags_tpu_torch.core.transforms import rotmat_to_quat, se3_matrix, skew, so3_exp
from sags_tpu_torch.ops.knn import knn


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
                         regularization: str = "normalized_ellipse") -> PointCovariances:
    """Per-point surfel covariance + (quat, scale) export
    (`fast_gicp_impl.hpp:380-479`; gates and divisor as in the JAX package)."""
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
    if regularization == "none":
        covs = cov
    else:
        if regularization == "plane":
            vals = torch.tensor([1.0, 1.0, 1e-3], device=points.device).expand_as(sv)
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
    if bool(ok.all()):
        return inv
    evals, evecs = torch.linalg.eigh(A)
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


class AlignResult(NamedTuple):
    T: torch.Tensor  # [4,4]
    H: torch.Tensor  # [6,6] last Hessian
    converged: bool
    iterations: int  # outer (linearize) iterations
    error: torch.Tensor
    lm_iterations: int  # inner LM trials over all outer iterations


OPTIMIZERS = ("lm", "gn")  # `GICPConfig.optimizer`


def lsq_align(linearize, error_fn, init_T: torch.Tensor, cfg: GICPConfig) -> AlignResult:
    """The LsqRegistration outer loop (`lsq_registration_impl.hpp:53-173`):
    `step_gn` for `optimizer="gn"`, `step_lm` (`:125-173`) for "lm". Each
    Gauss-Newton iteration and each LM trial reads its flags on the host
    (one sync)."""
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r} (one of {OPTIMIZERS})")
    dev = init_T.device
    I6 = torch.eye(6, device=dev)
    conv = lambda d: _is_converged(d, cfg.rotation_epsilon, cfg.transformation_epsilon)

    def delta_of(d):
        return se3_matrix(so3_exp(d[:3]), d[3:])

    if cfg.optimizer == "gn":
        T, H, e = init_T, I6, torch.tensor(float("inf"), device=dev)
        i, converged = 0, False
        while i < cfg.max_iterations and not converged:
            H, b, e, _ = linearize(T)
            delta = delta_of(torch.linalg.solve(H, -b))
            T = delta @ T
            converged = bool(conv(delta))  # one sync
            i += 1
        return AlignResult(T, H, converged, i, e, 0)

    T = init_T
    lam = torch.tensor(-1.0, device=dev)
    H, e = I6, torch.tensor(float("inf"), device=dev)
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
            d = torch.linalg.solve(H + lam * I6, -b)
            dl = delta_of(d)
            xi = dl @ T
            yi = error_fn(xi, corr)
            rho = (y0 - yi) / torch.dot(d, lam * d - b)
            accept_t = rho >= 0.0
            flags = torch.stack([accept_t, conv(dl)]).tolist()  # one sync
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
        converged = bool(conv(delta))
        i += 1
    return AlignResult(T, H, converged, i, e, n_lm)


def gicp_align(source, target, source_mask, target_mask, init_T,
               cfg: GICPConfig = GICPConfig(), source_covs=None,
               target_covs=None) -> AlignResult:
    if source_covs is None:
        source_covs = estimate_covariances(source, source_mask, cfg.k_correspondences,
                                           cfg.knn_max_distance, cfg.regularization).covs
    if target_covs is None:
        target_covs = estimate_covariances(target, target_mask, cfg.k_correspondences,
                                           cfg.knn_max_distance, cfg.regularization).covs
    data = GICPData(source, source_mask, source_covs, target, target_mask, target_covs)
    lin, err = make_gicp_linearizer(data, cfg)
    return lsq_align(lin, err, init_T, cfg)
