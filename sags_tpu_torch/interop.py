"""Carry SLAM state between the JAX package and this port as numpy arrays.

The tree format (what a caller exports from a JAX `SLAMState`):

    {"map": {field: array for every GaussianMap field},
     "opt": {"count": int, "mu": {param: array}, "nu": {param: array}},
     "classifier": {"weight": array, "bias": array},
     "cls_opt": {"count": int, "mu": {...}, "nu": {...}},
     "step": int}

Param names are `mapping.gaussian_map.PARAM_FIELDS` and ("weight", "bias").
This module imports no JAX: the export from JAX arrays is the caller's.
"""

from __future__ import annotations

import numpy as np
import torch

from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.models.classifier import ClassifierParams
from sags_tpu_torch.slam.step import SLAMState
from sags_tpu_torch.utils.adam import AdamState
from sags_tpu_torch.utils.draws import TorchDraws

_CLS_FIELDS = ("weight", "bias")


def _t(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _adam_from(tree, names, device) -> AdamState:
    return AdamState(int(tree["count"]),
                     tuple(_t(tree["mu"][n], device) for n in names),
                     tuple(_t(tree["nu"][n], device) for n in names))


def _adam_to(state: AdamState, names) -> dict:
    return {"count": int(state.count),
            "mu": {n: x.detach().cpu().numpy() for n, x in zip(names, state.mu)},
            "nu": {n: x.detach().cpu().numpy() for n, x in zip(names, state.nu)}}


def state_from_numpy(tree: dict, device, draws=None, seed: int = 0) -> SLAMState:
    """Build the port's `SLAMState` on `device` from the numpy tree."""
    device = torch.device(device)
    m = gm.GaussianMap(**{f: _t(tree["map"][f], device) for f in gm.GaussianMap._fields})
    return SLAMState(
        map=m,
        opt_state=_adam_from(tree["opt"], gm.PARAM_FIELDS, device),
        classifier=ClassifierParams(*(_t(tree["classifier"][n], device)
                                      for n in _CLS_FIELDS)),
        cls_opt_state=_adam_from(tree["cls_opt"], _CLS_FIELDS, device),
        step=int(tree["step"]),
        rng=TorchDraws(seed, device) if draws is None else draws,
    )


def state_to_numpy(state: SLAMState) -> dict:
    """The inverse of `state_from_numpy` (the draw hook is not exported)."""
    return {
        "map": {f: getattr(state.map, f).detach().cpu().numpy()
                for f in gm.GaussianMap._fields},
        "opt": _adam_to(state.opt_state, gm.PARAM_FIELDS),
        "classifier": {n: x.detach().cpu().numpy()
                       for n, x in zip(_CLS_FIELDS, state.classifier)},
        "cls_opt": _adam_to(state.cls_opt_state, _CLS_FIELDS),
        "step": int(state.step),
    }
