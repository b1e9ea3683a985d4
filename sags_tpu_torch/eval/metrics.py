"""Rendering-quality metrics, the reference's eval triple PSNR / SSIM /
LPIPS (`calc_2d_metric`, `scripts/gaussian_splatting.py:405-443`):
`sags_tpu.eval.metrics` in PyTorch. Images are [3, H, W] tensors (or
arrays) in [0, 1]; each metric runs on the prediction's device."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from sags_tpu_torch.eval.lpips import lpips as _lpips
from sags_tpu_torch.eval.lpips import lpips_backend
from sags_tpu_torch.utils.losses import ssim as _ssim


def _pair(pred, gt, dtype):
    pred = torch.as_tensor(pred)
    return pred.to(dtype), torch.as_tensor(gt).to(device=pred.device, dtype=dtype)


def mse2psnr(mse: float) -> float:
    """-10 log10(mse)."""
    return float(-10.0 * math.log10(max(mse, 1e-12)))


def psnr(pred, gt, mask_zeros: bool = True) -> float:
    """PSNR in float64; the reference masks gt == 0 pixels."""
    pred, gt = _pair(pred, gt, torch.float64)
    if mask_zeros:
        sel = gt != 0
        if not bool(sel.any()):
            return 0.0
        mse = float(torch.mean((pred[sel] - gt[sel]) ** 2))
    else:
        mse = float(torch.mean((pred - gt) ** 2))
    return mse2psnr(mse)


def ssim(pred, gt) -> float:
    pred, gt = _pair(pred, gt, torch.float32)
    return float(_ssim(pred, gt)[1])


def lpips(pred, gt) -> Optional[float]:
    """The perceptual distance of `eval/lpips.py` (its backend:
    `lpips_backend()`)."""
    pred, gt = _pair(pred, gt, torch.float32)
    return _lpips(pred, gt)


def evaluate_pair(pred, gt) -> Dict[str, Optional[float]]:
    """The reference's metric triple, with the LPIPS backend beside it."""
    return {"psnr": psnr(pred, gt), "ssim": ssim(pred, gt), "lpips": lpips(pred, gt),
            "lpips_net": lpips_backend()}
