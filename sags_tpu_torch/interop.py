"""Carry SLAM state between the JAX package and this port as numpy arrays.

The tree format (what a caller exports from a JAX `SLAMState`):

    {"map": {field: array for every GaussianMap field},
     "opt": {"count": int, "mu": {param: array}, "nu": {param: array}},
     "classifier": {"weight": array, "bias": array},
     "cls_opt": {"count": int, "mu": {...}, "nu": {...}},
     "step": int}

Param names are `mapping.gaussian_map.PARAM_FIELDS` and ("weight", "bias").

`sam_params_from_numpy` carries a flax SAM parameter tree (the JAX
package's `SAM.params`, or a weight pickle read by `models.sam.read_params`)
into the `state_dict` of the port's `models.sam.SAM`; `sam_params_to_numpy`
is its inverse, the tree that `models.sam_train.save_fp16` pickles.

`esikf_state_from_numpy` and `surfel_map_from_numpy` build the ESIKF
filter state and its surfel map (`ops.esikf`) from `{field: array}`.

`offline_state_from_numpy` / `offline_state_to_numpy` carry the offline
trainer's state (`slam.offline.OfflineState`) as `{"map", "opt", "step"}`,
the first three entries of the SLAM tree.

This module imports no JAX: the export from JAX arrays is the caller's.
"""

from __future__ import annotations

import numpy as np
import torch

from sags_tpu_torch.mapping import gaussian_map as gm
from sags_tpu_torch.models.classifier import ClassifierParams
from sags_tpu_torch.models.sam import SAMParams
from sags_tpu_torch.ops.esikf import ESIKFState, SurfelMap
from sags_tpu_torch.slam.offline import OfflineState
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
    return SLAMState(
        map=_map_from(tree["map"], device),
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
        "map": _map_to(state.map),
        "opt": _adam_to(state.opt_state, gm.PARAM_FIELDS),
        "classifier": {n: x.detach().cpu().numpy()
                       for n, x in zip(_CLS_FIELDS, state.classifier)},
        "cls_opt": _adam_to(state.cls_opt_state, _CLS_FIELDS),
        "step": int(state.step),
    }


def _map_from(tree: dict, device) -> gm.GaussianMap:
    return gm.GaussianMap(**{f: _t(tree[f], device) for f in gm.GaussianMap._fields})


def _map_to(m: gm.GaussianMap) -> dict:
    return {f: getattr(m, f).detach().cpu().numpy() for f in gm.GaussianMap._fields}


def offline_state_from_numpy(tree: dict, device, draws=None,
                             seed: int = 0) -> OfflineState:
    """The offline trainer's state on `device` from `{"map", "opt", "step"}`;
    `draws` defaults to a generator seeded with `seed`."""
    device = torch.device(device)
    return OfflineState(map=_map_from(tree["map"], device),
                        opt_state=_adam_from(tree["opt"], gm.PARAM_FIELDS, device),
                        step=int(tree["step"]),
                        draws=TorchDraws(seed, device) if draws is None else draws)


def offline_state_to_numpy(state: OfflineState) -> dict:
    """The inverse of `offline_state_from_numpy` (the draw hook is not
    exported)."""
    return {"map": _map_to(state.map), "opt": _adam_to(state.opt_state, gm.PARAM_FIELDS),
            "step": int(state.step)}


def esikf_state_from_numpy(tree: dict, device) -> ESIKFState:
    """The filter state on `device` from `{field: array}` (R, p, v, bg, ba,
    g, P)."""
    return ESIKFState(*(_t(tree[f], device) for f in ESIKFState._fields))


def surfel_map_from_numpy(tree: dict, device) -> SurfelMap:
    """The surfel map on `device` from `{field: array}`; `resolution` a
    float."""
    return SurfelMap(**{f: float(tree[f]) if f == "resolution" else _t(tree[f], device)
                        for f in SurfelMap._fields})


def _dense(p: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": np.asarray(p["kernel"]).T, f"{prefix}.bias": np.asarray(p["bias"])}


def _layer_norm(p: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": np.asarray(p["scale"]), f"{prefix}.bias": np.asarray(p["bias"])}


def _attention(p: dict, prefix: str) -> dict:
    """flax `MultiHeadDotProductAttention`: query/key/value kernels
    [C, heads, head_dim] with biases [heads, head_dim], out kernel
    [heads, head_dim, C]; heads major in the port's `Linear` rows."""
    out = {}
    for name in ("query", "key", "value"):
        k = np.asarray(p[name]["kernel"])
        out[f"{prefix}.{name}.weight"] = k.reshape(k.shape[0], -1).T
        out[f"{prefix}.{name}.bias"] = np.asarray(p[name]["bias"]).reshape(-1)
    k = np.asarray(p["out"]["kernel"])
    out[f"{prefix}.out.weight"] = k.reshape(-1, k.shape[-1]).T
    out[f"{prefix}.out.bias"] = np.asarray(p["out"]["bias"])
    return out


def _conv_transpose(p: dict, prefix: str) -> dict:
    """flax `ConvTranspose` (HWIO, no kernel transpose) as
    `nn.ConvTranspose2d`: the spatial axes flipped, then [in, out, kh, kw]."""
    k = np.asarray(p["kernel"])[::-1, ::-1]
    return {f"{prefix}.weight": np.ascontiguousarray(k.transpose(2, 3, 0, 1)),
            f"{prefix}.bias": np.asarray(p["bias"])}


def sam_params_from_numpy(params) -> dict:
    """The port's `SAM.state_dict()` (numpy values) from a flax parameter
    tree `(encoder, prompt, decoder)`, each `{"params": {...}}` as flax
    keeps it (`sags_tpu/models/sam.py:189-214`)."""
    enc, pr, dec = (t["params"] for t in params)
    sd = {"encoder.patch.weight": np.asarray(enc["patch"]["kernel"]).transpose(3, 2, 0, 1),
          "encoder.patch.bias": np.asarray(enc["patch"]["bias"]),
          "encoder.pos_embed": np.asarray(enc["pos_embed"])}
    depth = sum(k.startswith("MultiHeadDotProductAttention_") for k in enc)
    for i in range(depth):
        b = f"encoder.blocks.{i}"
        sd.update(_layer_norm(enc[f"LayerNorm_{2 * i}"], f"{b}.ln1"))
        sd.update(_attention(enc[f"MultiHeadDotProductAttention_{i}"], f"{b}.attn"))
        sd.update(_layer_norm(enc[f"LayerNorm_{2 * i + 1}"], f"{b}.ln2"))
        sd.update(_dense(enc[f"Dense_{2 * i}"], f"{b}.fc1"))
        sd.update(_dense(enc[f"Dense_{2 * i + 1}"], f"{b}.fc2"))
    sd.update(_layer_norm(enc[f"LayerNorm_{2 * depth}"], "encoder.ln_out"))
    sd["prompt_encoder.pe_gaussian"] = np.asarray(pr["pe_gaussian"])
    sd["prompt_encoder.corner_embed"] = np.asarray(pr["corner_embed"])
    sd["mask_decoder.mask_tokens"] = np.asarray(dec["mask_tokens"])
    n_blocks = sum(k.startswith("TwoWayBlock_") for k in dec)
    for j in range(n_blocks):
        p, b = dec[f"TwoWayBlock_{j}"], f"mask_decoder.blocks.{j}"
        for name, flax_name in (("self_attn", 0), ("cross_t2i", 1), ("cross_i2t", 2)):
            sd.update(_attention(p[f"MultiHeadDotProductAttention_{flax_name}"], f"{b}.{name}"))
        for i in range(4):
            sd.update(_layer_norm(p[f"LayerNorm_{i}"], f"{b}.ln{i}"))
        sd.update(_dense(p["Dense_0"], f"{b}.fc1"))
        sd.update(_dense(p["Dense_1"], f"{b}.fc2"))
    sd.update(_conv_transpose(dec["ConvTranspose_0"], "mask_decoder.up1"))
    sd.update(_layer_norm(dec["LayerNorm_0"], "mask_decoder.up_ln"))
    sd.update(_conv_transpose(dec["ConvTranspose_1"], "mask_decoder.up2"))
    # flax names the hypernetwork's outer Dense (C -> C/8) first
    sd.update(_dense(dec["Dense_0"], "mask_decoder.hyper2"))
    sd.update(_dense(dec["Dense_1"], "mask_decoder.hyper1"))
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in sd.items()}


def _sd(sd: dict, key: str) -> np.ndarray:
    v = sd[key]
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _dense_to(sd: dict, prefix: str) -> dict:
    return {"kernel": _sd(sd, f"{prefix}.weight").T, "bias": _sd(sd, f"{prefix}.bias")}


def _layer_norm_to(sd: dict, prefix: str) -> dict:
    return {"scale": _sd(sd, f"{prefix}.weight"), "bias": _sd(sd, f"{prefix}.bias")}


def _attention_to(sd: dict, prefix: str, heads: int) -> dict:
    out = {}
    for name in ("query", "key", "value"):
        w = _sd(sd, f"{prefix}.{name}.weight")  # [heads·hd, C]
        out[name] = {"kernel": w.T.reshape(w.shape[1], heads, -1),
                     "bias": _sd(sd, f"{prefix}.{name}.bias").reshape(heads, -1)}
    w = _sd(sd, f"{prefix}.out.weight")  # [C, heads·hd]
    out["out"] = {"kernel": w.T.reshape(heads, -1, w.shape[0]),
                  "bias": _sd(sd, f"{prefix}.out.bias")}
    return out


def _conv_transpose_to(sd: dict, prefix: str) -> dict:
    w = _sd(sd, f"{prefix}.weight")  # [in, out, kh, kw]
    return {"kernel": w.transpose(2, 3, 0, 1)[::-1, ::-1], "bias": _sd(sd, f"{prefix}.bias")}


def sam_params_to_numpy(sd: dict, num_heads: int = 4) -> SAMParams:
    """The flax parameter tree `SAMParams(encoder, prompt, decoder)`, each
    `{"params": {...}}` of float32 numpy arrays, from the port's
    `SAM.state_dict()`: the inverse of `sam_params_from_numpy`."""
    enc = {"patch": {"kernel": _sd(sd, "encoder.patch.weight").transpose(2, 3, 1, 0),
                     "bias": _sd(sd, "encoder.patch.bias")},
           "pos_embed": _sd(sd, "encoder.pos_embed")}
    depth = len({k.split(".")[2] for k in sd if k.startswith("encoder.blocks.")})
    for i in range(depth):
        b = f"encoder.blocks.{i}"
        enc[f"LayerNorm_{2 * i}"] = _layer_norm_to(sd, f"{b}.ln1")
        enc[f"MultiHeadDotProductAttention_{i}"] = _attention_to(sd, f"{b}.attn", num_heads)
        enc[f"LayerNorm_{2 * i + 1}"] = _layer_norm_to(sd, f"{b}.ln2")
        enc[f"Dense_{2 * i}"] = _dense_to(sd, f"{b}.fc1")
        enc[f"Dense_{2 * i + 1}"] = _dense_to(sd, f"{b}.fc2")
    enc[f"LayerNorm_{2 * depth}"] = _layer_norm_to(sd, "encoder.ln_out")
    pr = {"pe_gaussian": _sd(sd, "prompt_encoder.pe_gaussian"),
          "corner_embed": _sd(sd, "prompt_encoder.corner_embed")}
    dec = {"mask_tokens": _sd(sd, "mask_decoder.mask_tokens")}
    n_blocks = len({k.split(".")[2] for k in sd if k.startswith("mask_decoder.blocks.")})
    for j in range(n_blocks):
        b = f"mask_decoder.blocks.{j}"
        p = {f"MultiHeadDotProductAttention_{i}": _attention_to(sd, f"{b}.{name}", num_heads)
             for i, name in enumerate(("self_attn", "cross_t2i", "cross_i2t"))}
        p.update({f"LayerNorm_{i}": _layer_norm_to(sd, f"{b}.ln{i}") for i in range(4)})
        p["Dense_0"] = _dense_to(sd, f"{b}.fc1")
        p["Dense_1"] = _dense_to(sd, f"{b}.fc2")
        dec[f"TwoWayBlock_{j}"] = p
    dec["ConvTranspose_0"] = _conv_transpose_to(sd, "mask_decoder.up1")
    dec["LayerNorm_0"] = _layer_norm_to(sd, "mask_decoder.up_ln")
    dec["ConvTranspose_1"] = _conv_transpose_to(sd, "mask_decoder.up2")
    dec["Dense_0"] = _dense_to(sd, "mask_decoder.hyper2")
    dec["Dense_1"] = _dense_to(sd, "mask_decoder.hyper1")

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return np.ascontiguousarray(t, dtype=np.float32)

    return SAMParams(*({"params": f32(t)} for t in (enc, pr, dec)))
