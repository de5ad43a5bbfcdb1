"""The 3DGS training loss: (1 - l) L1 + l (1 - SSIM), SSIM with an 11x11
Gaussian window of sigma 1.5, zero padding, per channel, C1 = 0.01^2,
C2 = 0.03^2 (Wang et al. 2004, as the 3DGS code computes it)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _window(device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    g = torch.tensor([math.exp(-((i - size // 2) ** 2) / (2 * sigma * sigma)) for i in range(size)],
                     dtype=torch.float64)
    g = (g / g.sum()).float()
    return (g[:, None] @ g[None, :]).expand(3, 1, size, size).contiguous().to(device)


def ssim(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, 3) images."""
    x, y = img.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None]
    w = _window(img.device)

    def blur(z):
        return F.conv2d(z, w, padding=5, groups=3)

    mx, my = blur(x), blur(y)
    sxx, syy, sxy = blur(x * x) - mx * mx, blur(y * y) - my * my, blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mx * my + c1) * (2 * sxy + c2)) / ((mx * mx + my * my + c1) * (sxx + syy + c2))
    return s.mean()


def photometric(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    return (1 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (1 - ssim(img, gt))
