"""Image losses (`sags_tpu.utils.losses` in torch): masked L1 and L2, SSIM
with the separable banded-matrix Gaussian blur, and the photometric loss
(1−λ)·L1 + λ·(1−SSIM)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from sags_tpu_torch import device_constant


def l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask_zeros: bool = True):
    """Returns (map, mean) like `loss_utils.py:17-20`; `gt == 0` is masked."""
    loss = torch.abs(pred - gt)
    if mask_zeros:
        loss = torch.where(gt != 0, loss, torch.zeros_like(loss))
    return loss, torch.mean(loss)


def l2_loss(pred: torch.Tensor, gt: torch.Tensor, mask_zeros: bool = True) -> torch.Tensor:
    """Mean squared error; `gt == 0` is masked."""
    loss = (pred - gt) ** 2
    if mask_zeros:
        loss = torch.where(gt != 0, loss, torch.zeros_like(loss))
    return torch.mean(loss)


@functools.lru_cache(maxsize=16)
def _band_matrix(size: int, window_size: int, sigma: float) -> np.ndarray:
    """B with (B @ v) == 1-D Gaussian conv of v with zero padding."""
    x = np.arange(window_size)
    g = np.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    B = np.zeros((size, size), np.float32)
    half = window_size // 2
    for i in range(size):
        for j, w in enumerate(g):
            k = i + j - half
            if 0 <= k < size:
                B[i, k] = w
    return B


def _band(size: int, window_size: int, sigma: float, device) -> torch.Tensor:
    return device_constant(("ssim_band", size, window_size, sigma),
                           lambda: _band_matrix(size, window_size, sigma), device)


def _depthwise_conv(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """img [C,H,W] -> separable Gaussian blur via two banded matmuls."""
    _, H, W = img.shape
    Bh = _band(H, window_size, sigma, img.device)
    Bw = _band(W, window_size, sigma, img.device)
    out = torch.einsum("ih,chw->ciw", Bh, img)
    return torch.einsum("jw,chw->chj", Bw, out)


def ssim(img: torch.Tensor, gt: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, mask_zeros: bool = True):
    """SSIM, 11×11 σ=1.5 window (`loss_utils.py:27-69`). [C,H,W] → (map, mean)."""
    if mask_zeros:
        img = torch.where(gt != 0, img, torch.zeros_like(img))

    def conv(x):
        return _depthwise_conv(x, window_size, sigma)

    mu1, mu2 = conv(img), conv(gt)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img * img) - mu1_sq
    sigma2_sq = conv(gt * gt) - mu2_sq
    sigma12 = conv(img * gt) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map, torch.mean(ssim_map)


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1−λ)·L1 + λ·(1−SSIM), the SLAM node's photometric loss
    (`scripts/gaussian_splatting.py:805-810`)."""
    _, l1 = l1_loss(pred, gt)
    _, s = ssim(pred, gt)
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - s)
