"""PLY checkpoints with the reference's attribute schema (an own copy of
`sags_tpu.io.ply`).

`save_ply`/`load_ply` write/read the layout of `gaussian_model.py:296-310,
663-681`: x,y,z, nx,ny,nz (zeros), f_dc_*, f_rest_*, opacity, scale_*,
rot_0..3 (xyzw), obj_dc_0..15, as float32 vertex properties, so maps
round-trip with the reference's viewers and tools. The writer emits
binary little-endian; the reader takes binary little-endian or ascii.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.config import MapConfig
from sags_tpu_torch.mapping import gaussian_map as gm


def _attribute_names(n_rest: int, n_obj: int):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    names += [f"obj_dc_{i}" for i in range(n_obj)]
    return names


def save_ply(path: str, xyz: np.ndarray, f_dc: np.ndarray, f_rest: np.ndarray,
             opacity_logit: np.ndarray, log_scales: np.ndarray, quats: np.ndarray,
             obj_dc: np.ndarray) -> None:
    """Write N Gaussians: f_dc [N,3], f_rest [N,R,3] (R may be 0),
    opacity_logit [N], log_scales [N,3], quats [N,4] xyzw, obj_dc [N,O]."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(xyz)
    # channel-major flatten, matching `transpose(1,2).flatten(1)` in the ref
    f_rest_flat = (f_rest.transpose(0, 2, 1).reshape(n, -1) if f_rest.size
                   else np.zeros((n, 0), np.float32))
    attrs = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest_flat,
                            opacity_logit.reshape(n, 1), log_scales, quats, obj_dc],
                           axis=1).astype("<f4")
    names = _attribute_names(f_rest_flat.shape[1], obj_dc.shape[1])
    if attrs.shape[1] != len(names):
        raise ValueError(f"{attrs.shape[1]} columns for {len(names)} PLY properties")
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        f.write(attrs.tobytes())


def _read_ply_raw(path: str):
    """float32 vertex properties of a binary_little_endian or ascii PLY.
    Returns (names, {name: column})."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
        names = [l.split()[2] for l in header if l.startswith("property")]
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(n * len(names) * 4), dtype="<f4")
            data = data.reshape(n, len(names))
        elif fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float32, max_rows=n).reshape(n, len(names))
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return names, {nm: data[:, i] for i, nm in enumerate(names)}


def _numbered(names, prefix: str):
    return sorted((nm for nm in names if nm.startswith(prefix)),
                  key=lambda s: int(s.split("_")[-1]))


def load_ply(path: str) -> dict:
    """xyz, f_dc, f_rest [N,R,3], opacity_logit, log_scales, quats, obj_dc,
    as `load_ply` (`gaussian_model.py:380-426`) reads them."""
    names, v = _read_ply_raw(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    n = len(xyz)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], -1).astype(np.float32)
    rest = _numbered(names, "f_rest_")
    if rest:
        flat = np.stack([v[nm] for nm in rest], -1).astype(np.float32)
        f_rest = flat.reshape(n, 3, len(rest) // 3).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    obj = _numbered(names, "obj_dc_")
    obj_dc = (np.stack([v[nm] for nm in obj], -1).astype(np.float32) if obj
              else np.zeros((n, 0), np.float32))
    return dict(
        xyz=xyz, f_dc=f_dc, f_rest=f_rest,
        opacity_logit=np.asarray(v["opacity"], np.float32),
        log_scales=np.stack([v[f"scale_{i}"] for i in range(3)], -1).astype(np.float32),
        quats=np.stack([v[f"rot_{i}"] for i in range(4)], -1).astype(np.float32),
        obj_dc=obj_dc)


def save_map_ply(path: str, m) -> None:
    """Save the active Gaussians of a `GaussianMap`."""
    act = m.active.cpu().numpy()

    def rows(x):
        return x.detach().cpu().numpy()[act]

    save_ply(path, rows(m.xyz), rows(m.f_dc), rows(m.f_rest), rows(m.opacity_logit),
             rows(m.log_scales), rows(m.quats), rows(m.obj_dc))


def load_map_ply(path: str, capacity: Optional[int] = None, cfg=None, device=None):
    """A fresh `GaussianMap` on `device` (default: the card) holding the
    file's Gaussians in its first slots; capacity defaults to the next power
    of two of their count, `cfg` (a `MapConfig`) to the file's SH degree and
    object channels."""
    device = resolve_device(device)
    d = load_ply(path)
    n = len(d["xyz"])
    cap = capacity or max(1, 1 << (n - 1).bit_length())
    cfg = cfg or MapConfig(sh_degree=int(round((d["f_rest"].shape[1] + 1) ** 0.5)) - 1,
                           num_objects=d["obj_dc"].shape[1] or 16)
    m = gm.init_map(cap, cfg, device)
    O = m.obj_dc.shape[1]
    obj = d["obj_dc"] if d["obj_dc"].shape[1] == O else np.zeros((n, O), np.float32)

    def put(buf, val):
        buf[:n] = torch.as_tensor(np.ascontiguousarray(val), device=device)
        return buf

    return m._replace(
        xyz=put(m.xyz, d["xyz"]), f_dc=put(m.f_dc, d["f_dc"]),
        f_rest=put(m.f_rest, d["f_rest"][:, :m.f_rest.shape[1]]),
        opacity_logit=put(m.opacity_logit, d["opacity_logit"]),
        log_scales=put(m.log_scales, d["log_scales"]), quats=put(m.quats, d["quats"]),
        obj_dc=put(m.obj_dc, obj), active=put(m.active, np.ones(n, bool)),
        count=torch.tensor(n, dtype=torch.int32, device=device))
