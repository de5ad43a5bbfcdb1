"""Training losses (port of `gaussian_mesh_splatting_tpu/train/loss.py`):
(1 - lambda) * L1 + lambda * (1 - SSIM), the reference objective."""
from __future__ import annotations

import torch

from ..ops.ssim import ssim


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2):
    """Returns (total, l1) over (H, W, 3) images."""
    l1 = l1_loss(pred, gt)
    total = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(pred, gt))
    return total, l1


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR from the MSE over all pixels (the reference's
    utils/image_utils.py)."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))
