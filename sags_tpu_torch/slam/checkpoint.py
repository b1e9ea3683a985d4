"""Checkpoint / resume (`sags_tpu.slam.checkpoint` in torch).

The on-disk layout is the JAX package's, so a directory written by either
package reads in the other:

  * `state.npz` holds the state's leaves as `leaf_<i>`, in the order
    `jax.tree.flatten` gives the JAX package's `SLAMState`:
      0-13   the `GaussianMap` fields, in declaration order;
      14     the map optimizer's Adam count (int32);
      15-21  its first moments, one per `gaussian_map.PARAM_FIELDS` entry;
      22-28  its second moments, in the same order;
      29-30  the classifier's weight and bias;
      31     the classifier optimizer's Adam count (optax's `EmptyState` of
             the learning-rate scale adds no leaf);
      32-33  its first moments (weight, bias); 34-35 its second moments;
      36     `step` (int32);
      37     the random key, a `"prng"` leaf of uint32 key data.
  * `meta.json` lists each leaf's index and kind (`"array"` or `"prng"`).
  * `cfg.json` is the config as nested dicts (`_cfg_to_dict`).

The port's draw hook is a seeded `torch.Generator` (`utils.draws.TorchDraws`),
not a JAX key. Its seed is written as the key leaf (as threefry key data,
[seed >> 32, seed & 0xffffffff], the data of `jax.random.key(seed)`), and
the generator's state as one more `state.npz` entry, `torch_generator`,
that `meta.json`'s leaf list does not name (the JAX loader reads only the
listed leaves); `meta.json`'s `torch_generator` key names the generator's
device type. `load_state` restores the generator state where the device
type matches and otherwise seeds it from the key leaf. A directory written
by the JAX package has no generator entry: its key cannot become torch's
draws, so the hook is seeded from the key data (its 32-bit words, high
first, as one integer).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from sags_tpu_torch import resolve_device
from sags_tpu_torch.core.config import SLAMConfig
from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.models.classifier import ClassifierParams
from sags_tpu_torch.slam.step import SLAMState
from sags_tpu_torch.utils.adam import AdamState
from sags_tpu_torch.utils.draws import TorchDraws

_GEN_ENTRY = "torch_generator"


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _adam_leaves(st: AdamState) -> list:
    return [np.asarray(st.count, np.int32), *st.mu, *st.nu]


def _leaves(state: SLAMState) -> list:
    """Leaves 0-36 of `state` in the order above (tensors, and the host
    counters as int32 arrays); the key leaf is written from the draw hook."""
    return [*state.map, *_adam_leaves(state.opt_state), *state.classifier,
            *_adam_leaves(state.cls_opt_state), np.asarray(state.step, np.int32)]


def save_state(path: str, state: SLAMState, cfg: SLAMConfig) -> None:
    """Write `state` and `cfg` to the directory `path` (created if missing).
    The draw hook must be a `TorchDraws`."""
    if not isinstance(state.rng, TorchDraws):
        raise TypeError(f"save_state needs a TorchDraws hook, not {type(state.rng).__name__}")
    os.makedirs(path, exist_ok=True)
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": _np(x) for i, x in enumerate(leaves)}
    meta = [{"idx": i, "kind": "array"} for i in range(len(leaves))]
    seed = state.rng.seed & 0xFFFFFFFFFFFFFFFF
    arrays[f"leaf_{len(leaves)}"] = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    meta.append({"idx": len(leaves), "kind": "prng"})
    arrays[_GEN_ENTRY] = state.rng.generator.get_state().numpy()
    np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n_leaves": len(meta), "leaves": meta,
                   _GEN_ENTRY: state.rng.device.type}, f)
    with open(os.path.join(path, "cfg.json"), "w") as f:
        json.dump(_cfg_to_dict(cfg), f, indent=2)


def load_state(path: str, device=None) -> Tuple[SLAMState, SLAMConfig]:
    """The state and config that `save_state` (of either package) wrote to
    `path`, on `device` (default: the card), bit for bit."""
    device = resolve_device(device)
    with open(os.path.join(path, "cfg.json")) as f:
        cfg = _cfg_from_dict(json.load(f))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, "state.npz"))
    leaves, key = [], None
    for entry in meta["leaves"]:
        arr = data[f"leaf_{entry['idx']}"]
        if entry["kind"] == "prng":
            key = arr
        else:
            leaves.append(arr)
    it = iter(leaves)

    def take(n):
        return [torch.from_numpy(np.array(next(it))).to(device) for _ in range(n)]

    def adam(n):
        count = int(next(it))
        return AdamState(count, tuple(take(n)), tuple(take(n)))

    P = len(gm.PARAM_FIELDS)
    m = gm.GaussianMap(*take(len(gm.GaussianMap._fields)))
    opt_state = adam(P)
    clf = ClassifierParams(*take(2))
    cls_opt_state = adam(2)
    step = int(next(it))
    seed = 0
    for word in np.asarray(key, np.uint32).reshape(-1):
        seed = ((seed << 32) | int(word)) & 0xFFFFFFFFFFFFFFFF
    draws = TorchDraws(seed, device)
    if _GEN_ENTRY in data.files and meta.get(_GEN_ENTRY) == device.type:
        draws.generator.set_state(torch.from_numpy(np.array(data[_GEN_ENTRY])))
    return SLAMState(map=m, opt_state=opt_state, classifier=clf,
                     cls_opt_state=cls_opt_state, step=step, rng=draws), cfg


def _cfg_to_dict(cfg) -> dict:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _cfg_to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    return cfg


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _cfg_from_dict(d: dict, cls=SLAMConfig):
    """The inverse of `_cfg_to_dict`; JSON's lists become tuples again where
    the field's default is a tuple."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = d.get(f.name, dataclasses.MISSING)
        if v is dataclasses.MISSING:
            continue
        default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if dataclasses.is_dataclass(default):
            kwargs[f.name] = _cfg_from_dict(v, type(default))
        elif isinstance(default, tuple):
            kwargs[f.name] = _tuples(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
