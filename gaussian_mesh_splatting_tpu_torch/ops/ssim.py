"""Windowed SSIM (port of `gaussian_mesh_splatting_tpu/ops/ssim.py`): 11x11
Gaussian window (sigma = 1.5), zero ('same') padding, per channel,
C1 = 0.01^2, C2 = 0.03^2, over (H, W, C) images in [0, 1].

The separable blur is the JAX package's shifted-add form: 11 shifted
multiply-adds per axis, plain torch elementwise operations in exact float32
and in the JAX order. A `conv2d` would go through cuDNN, which runs float32
convolutions in TF32 by default on the card (`torch.backends.cudnn.allow_tf32`);
this form never reaches cuDNN.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

C1 = 0.01**2
C2 = 0.03**2


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> tuple[float, ...]:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return tuple((g / g.sum()).astype(np.float32).tolist())


def _blur_axis(img: torch.Tensor, w: tuple[float, ...], axis: int) -> torch.Tensor:
    half = len(w) // 2
    n = img.shape[axis]
    pads = [0, 0] * img.ndim  # torch.nn.functional.pad lists the last axis first
    pads[2 * (img.ndim - 1 - axis)] = half
    pads[2 * (img.ndim - 1 - axis) + 1] = half
    xp = torch.nn.functional.pad(img, pads)
    acc = None
    for k, wk in enumerate(w):
        sl = xp.narrow(axis, k, n)
        acc = sl * wk if acc is None else acc + sl * wk
    return acc


def _blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable 'same'-padded Gaussian blur over (H, W, C)."""
    w = _gaussian_window(window_size, sigma)
    return _blur_axis(_blur_axis(img, w, 0), w, 1)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM over (H, W, C) images; returns the scalar mean (size_average) or
    the per-channel mean (C,)."""
    mu1 = _blur(img1, window_size, sigma)
    mu2 = _blur(img2, window_size, sigma)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size, sigma) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(0, 1))
