"""NDT scan registration, P2D and D2D, in torch (`sags_tpu.ops.ndt`; the
reference's `ndt/ndt_cuda.hpp:21-73`, `cuda/ndt_compute_derivatives.cu`).

P2D cost, the [Biber IROS2003] form with the reference's Cauchy kernel
(`ndt_compute_derivatives.cu:47-95`):

    w = cauchy(resolution, ‖e‖),  e = μ_B − T·p
    E = w · eᵀ Σ_B⁻¹ e,   J = [skew(T·p) | −I]

over voxels that hold more than 6 points. D2D voxelizes the source too and
uses Σ_B + R Σ_A Rᵀ. A voxel's distribution is its points' mean and scatter,
not the GICP surfel covariances. The optimizer is `gicp.lsq_align`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.config import GICPConfig
from sags_tpu_torch.ops.gicp import (NEIGHBOR_OFFSETS, AlignResult, VoxelMap, _hb_from_pairs,
                                     _voxel_coords, build_voxel_map, lookup_voxels, lsq_align,
                                     robust_inv3, sym_eig3)

NDT_MODES = ("p2d", "d2d")


def build_ndt_voxel_map(points: torch.Tensor, mask: torch.Tensor, resolution: float,
                        max_voxels: int) -> VoxelMap:
    """Voxel mean and scatter covariance of the member points, its
    eigenvalues floored at 1e-2 of the largest (and at 1e-9)."""
    outer = torch.einsum("ni,nj->nij", points, points)
    vm = build_voxel_map(points, outer, mask, resolution, max_voxels)
    # the additive map gave mean = E[p], cov = E[ppᵀ]; scatter = E[ppᵀ] − μμᵀ
    cov = vm.covs - torch.einsum("ni,nj->nij", vm.means, vm.means)
    evals, evecs = sym_eig3(cov)
    floor = torch.clamp(evals[..., 0:1] * 1e-2, min=1e-9)
    evals = torch.maximum(evals, floor)
    cov = torch.einsum("nij,nj,nkj->nik", evecs, evals, evecs)
    return vm._replace(covs=cov)


def _cauchy(k: float, x: torch.Tensor) -> torch.Tensor:
    return (k * k) / (k * k + x * x)


def _ndt_pairs(T, src_pts, src_covs, src_w, vm: VoxelMap, offsets, resolution,
               min_voxel_points=6):
    """Weights, voxel means and Mahalanobis matrices of every (point,
    offset) pair: P2D when `src_covs` is None, else D2D."""
    Ns, F = src_pts.shape[0], offsets.shape[0]
    R = T[:3, :3]
    src_t = src_pts @ R.T + T[:3, 3]
    c_off = (_voxel_coords(src_t, resolution)[:, None, :] + offsets[None]).reshape(-1, 3)
    vidx, found = lookup_voxels(vm, c_off)
    vidx = vidx.reshape(Ns, F)
    found = found.reshape(Ns, F) & src_w[:, None] & (vm.num_points[vidx] > min_voxel_points)
    mean_B = vm.means[vidx]
    RCR = vm.covs[vidx]
    if src_covs is not None:
        RCR = RCR + torch.einsum("ij,njk,lk->nil", R, src_covs, R)[:, None]
    mahal = robust_inv3(RCR.reshape(-1, 3, 3)).reshape(Ns, F, 3, 3)
    err = mean_B - src_t[:, None]
    w = torch.where(found, _cauchy(resolution, torch.linalg.vector_norm(err, dim=-1)), 0.0)
    return w, mean_B, mahal


def make_ndt_linearizer(src_pts, src_covs, src_mask, vm: VoxelMap, cfg: GICPConfig):
    offsets = torch.tensor(NEIGHBOR_OFFSETS[cfg.neighbor_search], dtype=torch.int32,
                           device=src_pts.device)
    Ns, F = src_pts.shape[0], offsets.shape[0]
    mean_A = src_pts[:, None].expand(Ns, F, 3).reshape(-1, 3)

    def flat(T, w, mean_B, mahal):
        return _hb_from_pairs(T, mean_A, mean_B.reshape(-1, 3), mahal.reshape(-1, 3, 3),
                              w.reshape(-1))

    def linearize(T):
        corr = _ndt_pairs(T, src_pts, src_covs, src_mask, vm, offsets, cfg.voxel_resolution)
        H, b, e = flat(T, *corr)
        return H, b, e, corr

    def error(T, corr):
        return flat(T, *corr)[2]

    return linearize, error


def ndt_align(source, target, source_mask, target_mask, init_T,
              cfg: GICPConfig = GICPConfig(), mode: str = "p2d") -> AlignResult:
    """NDT registration of `source` onto `target`; `mode` is the reference's
    NDTDistanceMode, "p2d" or "d2d"."""
    if mode not in NDT_MODES:
        raise ValueError(f"unknown NDT mode {mode!r} (one of {NDT_MODES})")
    vm = build_ndt_voxel_map(target, target_mask, cfg.voxel_resolution, cfg.max_voxels)
    if mode == "p2d":
        src_pts, src_covs, src_mask = source, None, source_mask
    else:
        svm = build_ndt_voxel_map(source, source_mask, cfg.voxel_resolution, cfg.max_voxels)
        valid = ((torch.arange(svm.means.shape[0], device=source.device) < svm.n_voxels)
                 & (svm.num_points > 6))
        src_pts, src_covs, src_mask = svm.means, svm.covs, valid
    lin, err = make_ndt_linearizer(src_pts, src_covs, src_mask, vm, cfg)
    return lsq_align(lin, err, init_T, cfg)


class NDT:
    """pygicp `NDTCuda`-shaped wrapper (`src/python/main.cpp`): numpy in,
    numpy out; `device=None` means the card."""

    def __init__(self, cfg: GICPConfig = GICPConfig(), mode: str = "d2d", device=None):
        self.cfg = dataclasses.replace(cfg, neighbor_search="direct7")
        self.mode = mode
        self.device = resolve_device(device)
        self._src = self._tgt = None
        self._result = None

    def set_resolution(self, r: float):
        self.cfg = dataclasses.replace(self.cfg, voxel_resolution=float(r))
        return self

    def set_distance_mode(self, mode: str):
        self.mode = mode.lower()
        return self

    def set_neighbor_search_method(self, m: str, radius: float = -1.0):
        self.cfg = dataclasses.replace(self.cfg, neighbor_search=m.lower())
        return self

    def set_input_source(self, points):
        from sags_tpu_torch.ops.registration import _pad_pow2

        self._src = _pad_pow2(np.asarray(points, np.float32), self.device)
        return self

    def set_input_target(self, points):
        from sags_tpu_torch.ops.registration import _pad_pow2

        self._tgt = _pad_pow2(np.asarray(points, np.float32), self.device)
        return self

    def align(self, initial_guess=None):
        src, smask, _ = self._src
        tgt, tmask, _ = self._tgt
        T0 = torch.as_tensor(np.eye(4, dtype=np.float32) if initial_guess is None
                             else np.asarray(initial_guess, np.float32), device=self.device)
        self._result = ndt_align(src, tgt, smask, tmask, T0, self.cfg, self.mode)
        return self._result.T.cpu().numpy()

    def has_converged(self):
        return bool(self._result.converged)
