"""Plain PyTorch scan-to-scan GICP: fast_gicp's per-point covariances with
its `NORMALIZED_ELLIPSE` regularization, nearest-point correspondences
weighted by (C_B + R C_A Rᵀ)⁻¹, and its Levenberg-Marquardt loop
(`lsq_registration_impl.hpp` `step_lm`). The increment is applied as
exp(ω) for the rotation and the translation as it stands, on the left of
the pose, as the configuration's tracker states it. Imports nothing of the
port.
"""

from __future__ import annotations

import torch

from benchmarks.reference import train as rt


def covariances(points, k: int, max_d2: float) -> torch.Tensor:
    """Each point's k-nearest covariance (`train.surfel_cov`), its
    eigenvalues divided by the middle one and floored at 1e-3."""
    cov = rt.surfel_cov(points, k, max_d2)
    ev, U = torch.linalg.eigh(cov)  # ascending: the middle one is [:, 1]
    ev = ev.clamp(min=0.0)
    mid = ev[:, 1:2]
    vals = torch.where(mid == 0.0, torch.full_like(ev, 1e-9),
                       torch.clamp(ev / torch.where(mid == 0.0, torch.ones_like(mid), mid),
                                   min=1e-3))
    return U @ torch.diag_embed(vals) @ U.transpose(1, 2)


def _skew(v):
    z = torch.zeros_like(v[:, 0])
    x, y, w = v.unbind(-1)
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], -1).reshape(-1, 3, 3)


def _so3_exp(w):
    th = torch.linalg.vector_norm(w)
    K = _skew(w[None])[0]
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-10:
        return I + K
    return I + torch.sin(th) / th * K + (1 - torch.cos(th)) / th ** 2 * (K @ K)


def _increment(d):
    T = torch.eye(4, dtype=d.dtype, device=d.device)
    T[:3, :3] = _so3_exp(d[:3])
    T[:3, 3] = d[3:]
    return T


def _converged(delta, rot_eps: float, trans_eps: float) -> bool:
    r = float((delta[:3, :3] - torch.eye(3, device=delta.device)).abs().max()) / rot_eps
    t = float(delta[:3, 3].abs().max()) / trans_eps
    return max(r, t) < 1.0


def align(source, target, init, g: dict) -> torch.Tensor:
    """The pose T (target ← source) that GICP finds from `init`.
    `g`: the configuration's `gicp` block."""
    k, md = g["k_correspondences"], g["knn_max_distance"]
    cs, ct = covariances(source, k, md), covariances(target, k, md)
    gate = float(g["corr_dist_threshold"]) ** 2
    I6 = torch.eye(6, device=source.device)

    def linearize(T):
        R = T[:3, :3]
        st = source @ R.T + T[:3, 3]
        d2, idx = rt.knn_sqdist(st, target, 1)
        w = (d2[:, 0] < gate).to(source.dtype)
        mB = target[idx[:, 0]]
        M = torch.linalg.inv(ct[idx[:, 0]] + R @ cs @ R.T)
        e = mB - st
        J = torch.cat([_skew(st), -torch.eye(3, device=st.device).expand(len(st), 3, 3)], -1)
        MJ = M @ J
        H = torch.einsum("n,nji,njk->ik", w, J, MJ)
        b = torch.einsum("n,nji,nj->i", w, MJ, e)
        return H, b, (w, mB, M)

    def error(T, corr):
        w, mB, M = corr
        e = mB - (source @ T[:3, :3].T + T[:3, 3])
        return torch.einsum("n,ni,nij,nj->", w, e, M, e)

    T = init.clone()
    lam = None
    for _ in range(g["max_iterations"]):
        H, b, corr = linearize(T)
        y0 = error(T, corr)
        if lam is None:
            lam = g["lm_init_lambda_factor"] * float(torch.diagonal(H).abs().max())
        nu, delta, ok = 2.0, torch.eye(4, device=T.device), False
        for _ in range(g["lm_max_iterations"]):
            d = torch.linalg.solve(H + lam * I6, -b)
            delta = _increment(d)
            xi = delta @ T
            rho = float((y0 - error(xi, corr)) / torch.dot(d, lam * d - b))
            if rho >= 0.0:
                lam *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                T, ok = xi, True
                break
            lam, nu = lam * nu, 2.0 * nu
            if _converged(delta, g["rotation_epsilon"], g["transformation_epsilon"]):
                ok = True
                break
        if not ok or _converged(delta, g["rotation_epsilon"], g["transformation_epsilon"]):
            break
    return T


def pose_gap(T_a, T_b, points) -> float:
    """How far apart two poses place the points, at the farthest point:
    max ‖(T_a − T_b)·[x; 1]‖, metres."""
    D = T_a - T_b
    return float(torch.linalg.vector_norm(points @ D[:3, :3].T + D[:3, 3], dim=-1).max())
