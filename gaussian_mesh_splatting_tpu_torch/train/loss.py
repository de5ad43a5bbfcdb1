"""Training losses (port of `gaussian_mesh_splatting_tpu/train/loss.py`):
(1 - lambda) * L1 + lambda * (1 - SSIM), the reference objective."""
from __future__ import annotations

import torch

from ..ops.ssim import photometric_loss_cuda, ssim
from ..utils import profiling


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2):
    """Returns (total, l1) over (H, W, 3) images. CUDA tensors go through the
    loss kernels (`ops.ssim.photometric_loss_cuda`: float32, 3 channels,
    `gt` without grad; anything else raises ValueError there), CPU tensors
    through the chain below; the tracer's counter `loss_kernel` says which
    ran (1 the kernels, 0 the chain)."""
    profiling.count("loss_kernel", int(pred.is_cuda))
    if pred.is_cuda:
        return photometric_loss_cuda(pred, gt, lambda_dssim)
    return photometric_loss_chain(pred, gt, lambda_dssim)


def photometric_loss_chain(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2):
    """(total, l1) as a chain of torch operations on any device: the CPU
    path, and the loss kernels' plain version."""
    l1 = l1_loss(pred, gt)
    total = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(pred, gt))
    return total, l1


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR from the MSE over all pixels (the reference's
    utils/image_utils.py)."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))
