"""LPIPS, the perceptual distance of the reference's eval triple
(`scripts/gaussian_splatting.py:405-443`): `sags_tpu.eval.lpips_jax` in
PyTorch (`F.conv2d` and `F.max_pool2d`).

Zhang et al. (CVPR'18): per-layer AlexNet conv features of both images are
unit-normalised over channels, squared-differenced, weighted per channel
(the linear head; uniform when none is shipped), averaged over space and
summed over layers.

Feature weights, in this order:
  1. an `.npz` named by `SAGS_LPIPS_WEIGHTS` (keys `convN_w` [Cout, Cin, kh,
     kw], optional `linN` [C]): a real AlexNet-LPIPS export gives the
     reference metric (`net = "alex"`);
  2. else a FIXED random filter bank (`net = "random_alex"`), drawn by
     `np.random.default_rng(1234)` exactly as the JAX package draws it, so
     both packages hold the same filters. It is a per-run regression metric,
     not comparable to published LPIPS numbers. The backend is reported
     beside every value.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet's conv layers: (out_ch, in_ch, kernel, stride, padding)
_ALEX_LAYERS = (
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
)
# ImageNet normalization the torch implementation applies ([-1,1] inputs)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _weights_file():
    path = os.environ.get("SAGS_LPIPS_WEIGHTS", "")
    return path if path and os.path.exists(path) else None


def _load_weights():
    """Returns (list of [Cout, Cin, kh, kw] filters, list of [C] heads, tag)."""
    path = _weights_file()
    if path:
        z = np.load(path)
        convs, lins = [], []
        for i in range(len(_ALEX_LAYERS)):
            convs.append(np.asarray(z[f"conv{i}_w"], np.float32))
            k = f"lin{i}"
            lins.append(np.asarray(z[k], np.float32) if k in z else
                        np.full(convs[-1].shape[0], 1.0 / convs[-1].shape[0], np.float32))
        return convs, lins, "alex"
    rng = np.random.default_rng(1234)  # fixed: the metric must be stable
    convs, lins = [], []
    for (co, ci, k, _s, _p) in _ALEX_LAYERS:
        std = float(np.sqrt(2.0 / (ci * k * k)))  # He init
        convs.append(rng.normal(0.0, std, (co, ci, k, k)).astype(np.float32))
        lins.append(np.full(co, 1.0 / co, np.float32))
    return convs, lins, "random_alex"


@functools.lru_cache(maxsize=None)
def _bank(device: torch.device):
    convs, lins, tag = _load_weights()
    return ([torch.as_tensor(w, device=device) for w in convs],
            [torch.as_tensor(l, device=device) for l in lins], tag)


def _features(x: torch.Tensor, convs):
    x = x * 2.0 - 1.0  # LPIPS takes [-1, 1]
    shift = torch.as_tensor(_SHIFT, device=x.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[:, None, None]
    x = ((x - shift) / scale)[None]
    out = []
    for w, (_co, _ci, _k, s, p) in zip(convs, _ALEX_LAYERS):
        x = torch.relu(F.conv2d(x, w, stride=s, padding=p))
        out.append(x)
        if len(out) in (1, 2):  # max-pool after conv1 and conv2
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return out


def lpips_backend() -> str:
    """"alex" (a weights file) or "random_alex" (the seeded bank)."""
    return "alex" if _weights_file() else "random_alex"


@torch.no_grad()
def lpips(pred: torch.Tensor, gt: torch.Tensor) -> float:
    """Perceptual distance between [3, H, W] images in [0, 1], computed on
    `pred`'s device."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    gt = torch.as_tensor(gt, dtype=torch.float32, device=pred.device)
    convs, lins, _ = _bank(pred.device)
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for xa, xb, lin in zip(_features(pred, convs), _features(gt, convs), lins):
        na = xa / torch.sqrt(torch.sum(xa * xa, 1, keepdim=True) + 1e-10)
        nb = xb / torch.sqrt(torch.sum(xb * xb, 1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum((na - nb) ** 2 * lin[None, :, None, None], 1))
    return float(total)
