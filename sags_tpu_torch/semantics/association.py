"""Cross-frame instance-ID association by projection voting
(`sags_tpu/semantics/association.py` in torch).

Project the Gaussian cloud into the previous and current label masks; for
each previous label, any current label receiving ≥ `threshold` (50%) of its
projected points is remapped to the previous label, keeping instance IDs
temporally consistent.

  * `project_points_pinhole`, `build_label_mapping`, `apply_label_mapping`,
    `InstanceAssociator` and `mapping_from_votes` (`:20-108,163-175`): numpy
    copies, the host path.
  * `_project_vote`, `_apply_lut` and `DeviceInstanceAssociator`
    (`:127-228`): torch on the map's device. The host fetches one [L, L]
    vote table a keyframe, and the label memory lives on the map's slots;
    `associate` is a device span of its name (`utils/profiling.py`).

The device projection is written as elementwise float32 operations in a
fixed order (no matrix product), so the CPU and the card round alike and a
run on one can be held bitwise against the other; the votes are an int32
`index_add_`, exact in any order. Rounding is half-to-even, as in numpy and
JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from sags_tpu_torch.utils.profiling import host_read, span


def project_points_pinhole(
    points: np.ndarray,  # [N,3] world
    pose: np.ndarray,  # [4,4] camera-to-world
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
    lidar_axes: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """World points → integer pixel coords (clipped), like `project_points`.

    `lidar_axes=True` applies the reference's frame change (x fwd, y left,
    z up → camera X=-y, Y=-z, Z=x, `scripts/gaussian_splatting.py:82-85`).
    """
    R = pose[:3, :3]
    t = pose[:3, 3]
    p_cam = (points - t) @ R  # R_cw @ p + t_cw with R_cw = Rᵀ
    if lidar_axes:
        X, Y, Z = -p_cam[:, 1], -p_cam[:, 2], p_cam[:, 0] + 1e-6
    else:
        X, Y, Z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2] + 1e-6
    u = fx * (X / Z) + cx
    v = fy * (Y / Z) + cy
    u_int = np.clip(np.round(u), 0, width - 1).astype(np.int32)
    v_int = np.clip(np.round(v), 0, height - 1).astype(np.int32)
    return u_int, v_int


def build_label_mapping(
    prev_labels: np.ndarray,  # [N] labels sampled at projections in prev frame
    curr_labels: np.ndarray,  # [N] labels sampled at projections in curr frame
    threshold: float = 0.5,
) -> Dict[int, int]:
    """For each prev label, map any curr label covering ≥ threshold of its
    points back to the prev label. Returns {curr → prev}."""
    n = min(len(prev_labels), len(curr_labels))
    prev_c, curr_c = prev_labels[:n], curr_labels[:n]
    mapping: Dict[int, int] = {}
    for prev_val in np.unique(prev_c):
        idx = np.nonzero(prev_c == prev_val)[0]
        if len(idx) == 0:
            continue
        vals, counts = np.unique(curr_c[idx], return_counts=True)
        for v, c in zip(vals, counts):
            if c / len(idx) >= threshold:
                mapping[int(v)] = int(prev_val)
    return mapping


def apply_label_mapping(
    mask: np.ndarray, mapping: Dict[int, int], used_labels: Optional[Set[int]] = None
) -> np.ndarray:
    """Remap curr labels; frees reused labels."""
    out = mask.copy()
    for curr_val, prev_val in mapping.items():
        out[mask == curr_val] = prev_val
        if used_labels is not None:
            used_labels.discard(curr_val)
    return out


class InstanceAssociator:
    """Stateful helper replicating the SLAM node's prev/curr bookkeeping."""

    def __init__(self, threshold: float = 0.5, lidar_axes: bool = False):
        self.threshold = threshold
        self.lidar_axes = lidar_axes
        self._prev_sampled: Optional[np.ndarray] = None

    def associate(
        self,
        points: np.ndarray,  # [N,3] current Gaussian means
        mask: np.ndarray,  # [H,W] current label map
        pose: np.ndarray,  # [4,4] camera-to-world
        intrinsics,  # (fx, fy, cx, cy)
        used_labels: Optional[Set[int]] = None,
    ) -> np.ndarray:
        fx, fy, cx, cy = intrinsics
        H, W = mask.shape
        u, v = project_points_pinhole(points, pose, fx, fy, cx, cy, W, H, self.lidar_axes)
        curr_sampled = mask[v, u]
        if self._prev_sampled is not None:
            mapping = build_label_mapping(self._prev_sampled, curr_sampled, self.threshold)
            mask = apply_label_mapping(mask, mapping, used_labels)
            curr_sampled = mask[v, u]
        self._prev_sampled = curr_sampled.copy()
        return mask


# ---------------------------------------------------------------------------
# Device-resident association: the path the pipeline takes.
# ---------------------------------------------------------------------------


def _project_vote(xyz: torch.Tensor,  # [C,3] map positions (fixed capacity)
                  active: torch.Tensor,  # [C] bool
                  prev_labels: torch.Tensor,  # [C] int32, -1 = never labeled
                  mask: torch.Tensor,  # [H,W] int32 current label map
                  Rcw: torch.Tensor,  # [3,3] camera-to-world rotation
                  tcw: torch.Tensor,  # [3] camera center
                  fx: float, fy: float, cx: float, cy: float,
                  L: int, lidar_axes: bool, width: int, height: int):
    """Project active map slots into the mask; return the [L,L] int32 vote
    table votes[prev, curr] and the per-slot current-mask sample.

    p_cam[:, j] = ((d0·R0j + d1·R1j) + d2·R2j) with d = xyz − tcw, one
    rounded float32 operation at a time; fx·(X/Z) + cx likewise."""
    dev = xyz.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    R = Rcw.to(device=dev, dtype=torch.float32)
    d = xyz - tcw.to(device=dev, dtype=torch.float32)
    p = [(d[:, 0] * R[0, j] + d[:, 1] * R[1, j]) + d[:, 2] * R[2, j] for j in range(3)]
    if lidar_axes:
        X, Y, Z = -p[1], -p[2], p[0] + 1e-6
    else:
        X, Y, Z = p[0], p[1], p[2] + 1e-6
    u = torch.clamp(torch.round(f32(fx) * (X / Z) + f32(cx)), 0, width - 1).to(torch.int32)
    v = torch.clamp(torch.round(f32(fy) * (Y / Z) + f32(cy)), 0, height - 1).to(torch.int32)
    curr = mask[v.long(), u.long()]  # [C]
    voter = active & (prev_labels >= 0)
    idx = torch.clamp(prev_labels, 0, L - 1) * L + torch.clamp(curr, 0, L - 1)
    votes = torch.zeros(L * L, dtype=torch.int32, device=dev)
    votes.index_add_(0, idx.long(), voter.to(torch.int32))
    return votes.reshape(L, L), curr


def _apply_lut(mask: torch.Tensor, curr: torch.Tensor, active: torch.Tensor,
               lut: torch.Tensor):
    """Remap the mask through the label LUT and derive the slots' new label
    memory (the remapped sample; inactive slots stay -1)."""
    n = lut.shape[0]
    mask_new = lut[torch.clamp(mask, 0, n - 1).long()]
    new_prev = torch.where(active, lut[torch.clamp(curr, 0, n - 1).long()],
                           torch.full_like(curr, -1))
    return mask_new, new_prev


def mapping_from_votes(votes: np.ndarray, threshold: float) -> Dict[int, int]:
    """`build_label_mapping` from the aggregated vote table: for each prev
    label, any curr label holding ≥ threshold of its votes remaps to it."""
    totals = votes.sum(axis=1)
    mapping: Dict[int, int] = {}
    for pv in np.nonzero(totals)[0]:
        row = votes[pv]
        for cv in np.nonzero(row)[0]:
            if row[cv] / totals[pv] >= threshold:
                mapping[int(cv)] = int(pv)
    return mapping


class DeviceInstanceAssociator:
    """Projection-vote association with O(L²) host traffic per keyframe.

    Label memory is slot-aligned on the map's fixed-capacity buffers; slots
    added since the last keyframe carry -1 and abstain from voting. On
    capacity growth it is re-padded and keeps the existing labels. A
    compaction of the map moves slots without moving their labels, as in
    the JAX package.
    """

    def __init__(self, threshold: float = 0.5, lidar_axes: bool = False,
                 num_classes: int = 100):
        self.threshold = threshold
        self.lidar_axes = lidar_axes
        self.L = num_classes
        self._prev_labels: Optional[torch.Tensor] = None

    def associate(
        self,
        xyz: torch.Tensor,  # [C,3] map positions (device)
        active: torch.Tensor,  # [C] bool (device)
        mask: torch.Tensor,  # [H,W] int32 (device)
        pose,  # [4,4] camera-to-world (tensor or numpy)
        intrinsics,  # (fx, fy, cx, cy)
        used_labels: Optional[Set[int]] = None,
    ) -> torch.Tensor:
        with span("associate", device=xyz.device):
            return self._associate(xyz, active, mask, pose, intrinsics, used_labels)

    def _associate(self, xyz, active, mask, pose, intrinsics, used_labels):
        fx, fy, cx, cy = intrinsics
        H, W = mask.shape
        C = xyz.shape[0]
        dev = xyz.device
        if self._prev_labels is None or self._prev_labels.shape[0] != C:
            old = self._prev_labels
            self._prev_labels = torch.full((C,), -1, dtype=torch.int32, device=dev)
            if old is not None:  # capacity growth: keep existing labels
                n = min(old.shape[0], C)
                self._prev_labels[:n] = old[:n]
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        votes, curr = _project_vote(
            xyz, active, self._prev_labels, mask, pose[:3, :3], pose[:3, 3],
            float(fx), float(fy), float(cx), float(cy), self.L, self.lidar_axes, W, H)
        votes_h = host_read(torch.Tensor.cpu, votes).numpy()  # the ONE O(L²) fetch
        mapping = mapping_from_votes(votes_h, self.threshold)
        lut = np.arange(self.L, dtype=np.int32)
        for cv, pv in mapping.items():
            lut[cv] = pv
            if used_labels is not None:
                used_labels.discard(cv)
        mask_new, self._prev_labels = _apply_lut(mask, curr, active,
                                                 host_read(torch.as_tensor, lut, device=dev))
        return mask_new
