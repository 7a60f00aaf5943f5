"""SSIM / MS-SSIM (counterpart of implicit_image_tpu/ops/ssim.py).

  * SSIM (Wang et al. 2004): 11x11 Gaussian window, σ = 1.5, C1 = 0.01²,
    C2 = 0.03² for [0, 1] images, population covariance, per channel then
    averaged;
  * MS-SSIM: up to 5 scales with weights (0.0448, 0.2856, 0.3001, 0.2363,
    0.1333), renormalized over the kept scales, 2x2 average pooling between
    scales; the product of the per-scale contrast-structure means times the
    coarsest scale's full SSIM mean, each raised to its weight.

The metric rests on E[x²] - E[x]², which cancels: JAX runs its blur at
`precision=HIGHEST` because one bf16 pass pushed MS-SSIM above 1. Here the
separable blur is shifted slices multiplied and added in fp32 on whatever
device the images are on, so no TF32 path (cuDNN's convolutions would take
one by default on the card) can enter. The five blurred maps of a scale are
blurred together as one stacked image. Differentiable, for the `ms-ssim`
training loss.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["ssim", "ms_ssim"]

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_C1, _C2 = 0.01**2, 0.03**2


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, kernel: Sequence[float]) -> torch.Tensor:
    """Separable blur of an (H, W, C) image along H then W, VALID padding."""
    k = len(kernel)
    h, w = img.shape[:2]
    x = kernel[0] * img[: h - k + 1]
    for i in range(1, k):
        x = x + kernel[i] * img[i : i + h - k + 1]
    y = kernel[0] * x[:, : w - k + 1]
    for i in range(1, k):
        y = y + kernel[i] * x[:, i : i + w - k + 1]
    return y


def _ssim_terms(x, y, kernel):
    """Per-pixel (luminance·contrast-structure, contrast-structure) maps."""
    stacked = _blur(torch.cat([x, y, x * x, y * y, x * y], dim=-1), kernel)
    mu_x, mu_y, e_xx, e_yy, e_xy = stacked.split(x.shape[-1], dim=-1)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    var_x = e_xx - mu_xx
    var_y = e_yy - mu_yy
    cov = e_xy - mu_xy
    cs = (2.0 * cov + _C2) / (var_x + var_y + _C2)
    lum = (2.0 * mu_xy + _C1) / (mu_xx + mu_yy + _C1)
    return lum * cs, cs


def _kernel(win_size: int, sigma: float):
    return [float(v) for v in _gaussian_kernel(win_size, sigma)]


def ssim(pred: torch.Tensor, target: torch.Tensor, win_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images in [0, 1]."""
    full, _ = _ssim_terms(pred.float(), target.float(), _kernel(win_size, sigma))
    return full.mean()


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pool (an odd trailing row or column is dropped)."""
    h, w, c = img.shape
    h2, w2 = h // 2, w // 2
    return img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, c).mean(dim=(1, 3))


def ms_ssim(pred: torch.Tensor, target: torch.Tensor, levels: int = 5,
            win_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Multi-scale SSIM of two (H, W, C) images in [0, 1]; needs
    min(H, W) >= win_size · 2^(levels-1)."""
    h, w = pred.shape[:2]
    if min(h, w) < win_size * 2 ** (levels - 1):
        raise ValueError(
            f"image {h}x{w} too small for {levels} MS-SSIM levels with "
            f"win_size={win_size}; reduce levels"
        )
    weights = np.asarray(_MS_WEIGHTS[:levels], np.float32)
    if levels < 5:
        weights = weights / weights.sum()
    kernel = _kernel(win_size, sigma)
    x, y = pred.float(), target.float()
    score = torch.ones((), dtype=torch.float32, device=x.device)
    for lvl in range(levels):
        full, cs = _ssim_terms(x, y, kernel)
        term = full if lvl == levels - 1 else cs
        score = score * torch.clamp(term.mean(), min=0.0) ** float(weights[lvl])
        if lvl < levels - 1:
            x, y = _avg_pool2(x), _avg_pool2(y)
    return score
