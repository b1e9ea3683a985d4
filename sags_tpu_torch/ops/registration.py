"""pygicp-compatible class API over `sags_tpu_torch.ops.gicp`
(`sags_tpu.ops.registration`).

Mirrors the reference's pybind surface (`submodules/fast_gicp/src/python/
main.cpp:149-299`): `FastGICP`, `FastVGICP`, `FastGICPSingleThread`,
`FastVGICPCuda`, `NDTCuda`, `align_points`, `downsample`, with the
GS-ICP-SLAM extensions: covariance ↔ (quaternion, scale) export and import
(`get_*_rotationsq/scales`, `set_*_covariance_fromqs`) and the z-value scale
division (`calculate_*_covariance_withz`).

Numpy goes in and numpy comes out. Each class takes `device=None`, which
means the card; `device="cpu"` runs the same code on the CPU. Inputs are
padded to power-of-two sizes, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.config import GICPConfig
from sags_tpu_torch.ops import gicp as _g


def _pad_pow2(points: np.ndarray, device, minimum: int = 1024):
    """(points [cap,3], mask [cap], n) on `device`, cap a power of two ≥ n."""
    n = len(points)
    cap = max(minimum, 1 << (n - 1).bit_length())
    out = np.zeros((cap, 3), np.float32)
    out[:n] = points
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return torch.as_tensor(out, device=device), torch.as_tensor(mask, device=device), n


class FastGICP:
    """Stateful wrapper with pygicp semantics (covariances cached per cloud)."""

    method = "gicp"

    def __init__(self, cfg: GICPConfig = GICPConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._src = self._tgt = None
        self._src_covs = self._tgt_covs = None
        self._src_qs = self._tgt_qs = None
        self._src_filter = self._tgt_filter = None
        self._result = None

    # --- pygicp API ---
    def set_num_threads(self, n: int):  # kept for API parity
        return self

    def set_correspondence_randomness(self, k: int):
        self.cfg = dataclasses.replace(self.cfg, k_correspondences=int(k))
        return self

    def set_max_knn_distance(self, d: float):
        self.cfg = dataclasses.replace(self.cfg, knn_max_distance=float(d))
        return self

    def set_max_correspondence_distance(self, d: float):
        self.cfg = dataclasses.replace(self.cfg, corr_dist_threshold=float(d))
        return self

    def _set_input(self, which: str, points):
        setattr(self, f"_{which}", _pad_pow2(np.asarray(points, np.float32), self.device))
        setattr(self, f"_{which}_covs", None)
        setattr(self, f"_{which}_qs", None)
        setattr(self, f"_{which}_filter", None)
        return self

    def set_input_source(self, points):
        return self._set_input("src", points)

    def set_input_target(self, points):
        return self._set_input("tgt", points)

    def swap_source_and_target(self):
        self._src, self._tgt = self._tgt, self._src
        self._src_covs, self._tgt_covs = self._tgt_covs, self._src_covs
        self._src_qs, self._tgt_qs = self._tgt_qs, self._src_qs
        self._src_filter, self._tgt_filter = self._tgt_filter, self._src_filter
        return self

    # --- trackable-subset filters (`set_*_filter`, `main.cpp:249-256`;
    # `calculate_*_covariance_with_filter`, `fast_gicp_impl.hpp:586-720`):
    # the filter marks the subset registered against (the mask), while the
    # q/s export still covers every point, as in the JAX package.
    def _set_filter(self, which, num_trackable, filt):
        pts, mask, n = getattr(self, f"_{which}")
        f = np.zeros(len(pts), bool)
        idx = np.asarray(filt, np.int64).reshape(-1)
        f[idx[idx < n]] = True
        setattr(self, f"_{which}_filter",
                (int(num_trackable), torch.as_tensor(f, device=self.device)))
        return self

    def set_source_filter(self, num_trackable, filt):
        return self._set_filter("src", num_trackable, filt)

    def set_target_filter(self, num_trackable, filt):
        return self._set_filter("tgt", num_trackable, filt)

    def calculate_source_covariance_with_filter(self):
        return self._covs("src")

    def calculate_target_covariance_with_filter(self):
        return self._covs("tgt")

    def _covs(self, which: str, z_values=None):
        pts, mask, n = getattr(self, f"_{which}")
        z = None
        if z_values is not None:
            z = torch.as_tensor(np.pad(np.asarray(z_values, np.float32), (0, len(pts) - n)),
                                device=self.device)
        out = _g.estimate_covariances(pts, mask, self.cfg.k_correspondences,
                                      self.cfg.knn_max_distance, self.cfg.regularization,
                                      z_values=z)
        setattr(self, f"_{which}_covs", out.covs)
        setattr(self, f"_{which}_qs", (out.quats, out.scales))
        return out

    def calculate_source_covariance(self):
        return self._covs("src")

    def calculate_target_covariance(self):
        return self._covs("tgt")

    def calculate_source_covariance_withz(self, z_values):
        return self._covs("src", z_values)

    def calculate_target_covariance_withz(self, z_values):
        return self._covs("tgt", z_values)

    def _qs(self, which: str, idx: int):
        if getattr(self, f"_{which}_qs") is None:
            self._covs(which)
        qs = getattr(self, f"_{which}_qs")[idx]
        n = getattr(self, f"_{which}")[2]
        return qs[:n].cpu().numpy().reshape(-1)

    def get_source_rotationsq(self):
        return self._qs("src", 0)

    def get_target_rotationsq(self):
        return self._qs("tgt", 0)

    def get_source_scales(self):
        return self._qs("src", 1)

    def get_target_scales(self):
        return self._qs("tgt", 1)

    def _set_fromqs(self, which: str, quats, scales):
        pts, mask, n = getattr(self, f"_{which}")
        q = torch.as_tensor(np.array(quats, np.float32).reshape(-1, 4), device=self.device)
        s = torch.as_tensor(np.array(scales, np.float32).reshape(-1, 3), device=self.device)
        covs = torch.eye(3, device=self.device).repeat(len(pts), 1, 1)
        covs[:n] = _g.covariances_from_qs(q, s)[:n]
        setattr(self, f"_{which}_covs", covs)
        setattr(self, f"_{which}_qs", (q, s))
        return self

    def set_source_covariance_fromqs(self, quats, scales):
        return self._set_fromqs("src", quats, scales)

    def set_target_covariance_fromqs(self, quats, scales):
        return self._set_fromqs("tgt", quats, scales)

    def _align_fn(self):
        return _g.gicp_align

    def align(self, initial_guess=np.eye(4)):
        src, smask, _ = self._src
        tgt, tmask, _ = self._tgt
        if self._src_filter is not None:
            smask = smask & self._src_filter[1]
        if self._tgt_filter is not None:
            tmask = tmask & self._tgt_filter[1]
        if self._src_covs is None:
            self._covs("src")
        if self._tgt_covs is None:
            self._covs("tgt")
        T0 = torch.as_tensor(np.asarray(initial_guess, np.float32), device=self.device)
        self._result = self._align_fn()(src, tgt, smask, tmask, T0, self.cfg,
                                        source_covs=self._src_covs,
                                        target_covs=self._tgt_covs)
        return self._result.T.cpu().numpy()

    def get_source_correspondence(self):
        """pygicp `get_source_correspondence` (`main.cpp:230-233`): nearest
        target index (−1 when gated) and squared distance per source point
        at the final transformation (identity before align)."""
        src, smask, n = self._src
        tgt, tmask, _ = self._tgt
        T = (self._result.T if self._result is not None
             else torch.eye(4, device=self.device))
        idx, sq = _g.correspondence_dump(T, src, tgt, smask, tmask,
                                         corr_dist_threshold=self.cfg.corr_dist_threshold)
        return idx[:n].cpu().numpy(), sq[:n].cpu().numpy()

    def get_final_transformation(self):
        return self._result.T.cpu().numpy()

    def get_final_hessian(self):
        return self._result.H.cpu().numpy()

    def has_converged(self):
        return bool(self._result.converged)


class FastVGICP(FastGICP):
    method = "vgicp"

    def set_resolution(self, r: float):
        self.cfg = dataclasses.replace(self.cfg, voxel_resolution=float(r))
        return self

    def set_neighbor_search_method(self, m: str, radius: float = 1.5):
        self.cfg = dataclasses.replace(self.cfg, neighbor_search=m.lower(),
                                       neighbor_radius=float(radius))
        return self

    def set_voxel_accumulation_mode(self, m: str):
        self.cfg = dataclasses.replace(self.cfg, voxel_accumulation=m.lower())
        return self

    def get_voxel_mean_cov(self):
        """pygicp `get_voxel_mean_cov` (`main.cpp:268-277`): the target
        Gaussian voxel map's (means, covs) as [V,3] / [V,3,3] arrays."""
        tgt, tmask, _ = self._tgt
        if self._tgt_covs is None:
            self._covs("tgt")
        vm = _g.build_voxel_map(tgt, self._tgt_covs, tmask, self.cfg.voxel_resolution,
                                self.cfg.max_voxels, mode=self.cfg.voxel_accumulation)
        V = int(vm.n_voxels)
        return vm.means[:V].cpu().numpy(), vm.covs[:V].cpu().numpy()

    def _align_fn(self):
        return _g.vgicp_align


class FastGICPSingleThread(FastGICP):
    """FastGICPSingleThread (`gicp/fast_gicp_st.hpp`): correspondence reuse
    across LM iterations under the triangle bound, for the variant's results
    (`gicp.make_gicp_st_linearizer`)."""

    method = "gicp_st"

    def _align_fn(self):
        return _g.gicp_align_st


class FastVGICPCuda(FastVGICP):
    """API alias (`gicp/fast_vgicp_cuda.hpp`): every class here runs on the card."""

    method = "vgicp_cuda"


def NDTCuda(*args, **kw):
    """API alias for the NDT wrapper (`ndt/ndt_cuda.hpp`)."""
    from sags_tpu_torch.ops.ndt import NDT

    return NDT(*args, **kw)


def align_points(target, source, method: str = "GICP", downsample_resolution: float = -1.0,
                 k_correspondences: int = 15,
                 max_correspondence_distance: float = float("inf"),
                 voxel_resolution: float = 1.0, neighbor_search_method: str = "DIRECT1",
                 initial_guess=np.eye(4), device=None) -> np.ndarray:
    """One-shot alignment (pygicp `align_points`, `main.cpp:37-147`)."""
    cfg = GICPConfig(k_correspondences=k_correspondences,
                     corr_dist_threshold=max_correspondence_distance,
                     voxel_resolution=voxel_resolution,
                     neighbor_search=neighbor_search_method.lower())
    name = method.upper()
    if name in ("NDT", "NDT_CUDA"):
        reg = NDTCuda(cfg, device=device)
    else:
        cls = {"GICP": FastGICP, "VGICP": FastVGICP, "VGICP_CUDA": FastVGICP,
               "GICP_ST": FastGICPSingleThread}[name]
        reg = cls(cfg, device=device)
    if downsample_resolution > 0:
        target = downsample(target, downsample_resolution, device=device)
        source = downsample(source, downsample_resolution, device=device)
    reg.set_input_source(source)
    reg.set_input_target(target)
    return reg.align(initial_guess)


def downsample(points, resolution: float, device=None) -> np.ndarray:
    """pygicp `downsample`: voxel-grid centroid filter."""
    pts, mask, n = _pad_pow2(np.asarray(points, np.float32), resolve_device(device))
    out, omask = _g.voxel_downsample(pts, mask, float(resolution), len(pts))
    return out[omask].cpu().numpy()
