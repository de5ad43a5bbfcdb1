"""Windowed SSIM (port of `gaussian_mesh_splatting_tpu/ops/ssim.py`): 11x11
Gaussian window (sigma = 1.5), zero ('same') padding, per channel,
C1 = 0.01^2, C2 = 0.03^2, over (H, W, C) images in [0, 1].

The separable blur is the JAX package's shifted-add form: 11 shifted
multiply-adds per axis, plain torch elementwise operations in exact float32
and in the JAX order. A `conv2d` would go through cuDNN, which runs float32
convolutions in TF32 by default on the card (`torch.backends.cudnn.allow_tf32`);
this form never reaches cuDNN.

The training loss on the card. `photometric_loss_cuda` computes
(1 - lambda) * L1 + lambda * (1 - SSIM) of an (H, W, 3) float32 CUDA image
pair with two hand-written kernels (csrc/loss.cu) behind one autograd
Function: L1 (the map, bit-equal to `ssim_map`'s, the three partial
derivatives of the map that the VJP needs, the blocks' sums, and a
reduction in a fixed order into `total` and `l1`) and L2 (the VJP). The
chain above stays the plain version and the CPU path; L2's plain version is
`photometric_vjp_plain`, written with the chain's blur.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import cuda_build

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


def _ssim_parts(img1: torch.Tensor, img2: torch.Tensor, window_size: int, sigma: float):
    """(mu1, mu2, the map's numerator factors 2 mu1 mu2 + C1 and
    2 sigma12 + C2, its denominator factors mu1^2 + mu2^2 + C1 and
    sigma1^2 + sigma2^2 + C2)."""
    mu1 = _blur(img1, window_size, sigma)
    mu2 = _blur(img2, window_size, sigma)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size, sigma) - mu1_mu2
    return (mu1, mu2, 2 * mu1_mu2 + C1, 2 * sigma12 + C2, mu1_sq + mu2_sq + C1,
            sigma1_sq + sigma2_sq + C2)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """The SSIM map over (H, W, C) images, per pixel and channel."""
    _, _, a1, a2, b1, b2 = _ssim_parts(img1, img2, window_size, sigma)
    return (a1 * a2) / (b1 * b2)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM over (H, W, C) images; returns the scalar mean (size_average) or
    the per-channel mean (C,)."""
    ssim_map_ = ssim_map(img1, img2, window_size, sigma)
    if size_average:
        return torch.mean(ssim_map_)
    return torch.mean(ssim_map_, dim=(0, 1))


def _loss_coefficients(lambda_dssim: float, n: int) -> tuple[float, float, float]:
    """The VJP's factors of sgn(x - y) under g_total, of the blurred map
    derivatives under g_total, and of sgn(x - y) under g_l1."""
    return (1.0 - lambda_dssim) / n, -lambda_dssim / n, 1.0 / n


def photometric_vjp_plain(
    pred: torch.Tensor,
    gt: torch.Tensor,
    lambda_dssim: float,
    g_total: torch.Tensor | None,
    g_l1: torch.Tensor | None = None,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """The gradient of `pred` under the cotangents `g_total` of
    (1 - lambda) * L1 + lambda * (1 - SSIM) and `g_l1` of L1 (either may be
    None: no gradient), in closed form (the VJP kernel's plain version,
    operation for operation): with m the map and N = pred.numel(),

        g_total ((1 - lambda)/N sgn(x - y) - lambda/N (B'(dm/dmu1)
                 + 2x B'(dm/dE[x^2]) + y B'(dm/dE[xy]))) + g_l1/N sgn(x - y),

    sgn(0) = 0, where B' is the blur's transpose: the same blur (the window
    is symmetric, the padding zero), along W first, then H."""
    w = _gaussian_window(window_size, sigma)
    mu1, mu2, a1, a2, b1, b2 = _ssim_parts(pred, gt, window_size, sigma)
    den = b1 * b2
    m = (a1 * a2) / den
    d_mu = 2 * (mu2 * (a2 - a1) + mu1 * m * (b1 - b2)) / den
    d_xx = -m / b2
    d_xy = 2 * a1 / den

    def blur_t(g):
        return _blur_axis(_blur_axis(g, w, 1), w, 0)

    coef_l1, coef_ssim, coef_g_l1 = _loss_coefficients(lambda_dssim, pred.numel())
    sgn = torch.sign(pred - gt)
    grad = torch.zeros_like(pred)
    if g_total is not None:
        part = blur_t(d_mu) + 2 * pred * blur_t(d_xx) + gt * blur_t(d_xy)
        grad = g_total * (coef_l1 * sgn + coef_ssim * part)
    if g_l1 is not None:
        grad = grad + g_l1 * coef_g_l1 * sgn
    return grad


# ---- the loss kernels (csrc/loss.cu) -------------------------------------

LOSS_WINDOW = (11, 1.5)  # the kernels' window: size, sigma


@functools.cache
def _window_array() -> ctypes.Array:
    return (ctypes.c_float * LOSS_WINDOW[0])(*_gaussian_window(*LOSS_WINDOW))


def _check_loss_inputs(pred: torch.Tensor, gt: torch.Tensor) -> None:
    """An (H, W, 3) float32 image pair on one CUDA device, `gt` not requiring
    grad, within 32-bit indexing; raises ValueError otherwise."""
    if not (pred.is_cuda and gt.device == pred.device):
        raise ValueError(f"the loss kernels take CUDA tensors on one device, got {pred.device} "
                         f"and {gt.device}")
    if pred.dtype != torch.float32 or gt.dtype != torch.float32:
        raise ValueError(f"the loss kernels take float32 images, got {pred.dtype} and {gt.dtype}")
    if pred.dim() != 3 or pred.shape[2] != 3 or gt.shape != pred.shape:
        raise ValueError(f"the loss kernels take two (H, W, 3) images, got {tuple(pred.shape)} "
                         f"and {tuple(gt.shape)}")
    if gt.requires_grad:
        raise ValueError("the loss kernels give `gt` no gradient: it must not require grad")
    if pred.numel() >= 2**31:
        raise ValueError("the loss kernels index with 32-bit integers")


def photometric_fwd_cuda(
    pred: torch.Tensor,
    gt: torch.Tensor,
    lambda_dssim: float,
    *,
    with_map: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Launch L1 and its reduction (csrc/loss.cu `loss_fwd`) on PyTorch's
    current stream over contiguous `pred` and `gt`: (total, l1, the (3, H,
    W, 3) derivative maps dm/dmu1, dm/dE[x^2], dm/dE[xy], the SSIM map if
    `with_map`). Counted in `cuda_build.launches["loss_fwd"]`."""
    _check_loss_inputs(pred, gt)
    if not (pred.is_contiguous() and gt.is_contiguous()):
        raise ValueError("the loss kernels take contiguous images")
    h, w, _ = pred.shape
    dev = pred.device
    maps = torch.empty((3, h, w, 3), dtype=torch.float32, device=dev)
    smap = torch.empty_like(pred) if with_map else None
    blocks = cuda_build.entry("loss_blocks")(h, w)
    partials = torch.empty(2 * blocks, dtype=torch.float64, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    l1 = torch.empty((), dtype=torch.float32, device=dev)
    cuda_build.launch("loss_fwd", dev,
                      pred.data_ptr(), gt.data_ptr(), h, w, _window_array(), C1, C2,
                      1.0 - lambda_dssim, lambda_dssim, None if smap is None else smap.data_ptr(),
                      *(m.data_ptr() for m in maps),
                      partials.data_ptr(), total.data_ptr(), l1.data_ptr())
    return total, l1, maps, smap


def photometric_bwd_cuda(
    pred: torch.Tensor,
    gt: torch.Tensor,
    maps: torch.Tensor,
    lambda_dssim: float,
    g_total: torch.Tensor | None,
    g_l1: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch L2 (csrc/loss.cu `loss_bwd`) on PyTorch's current stream: the
    gradient of `pred` from L1's derivative `maps`, as `photometric_vjp_plain`
    gives it; a cotangent may be None (no gradient). Counted in
    `cuda_build.launches["loss_bwd"]`."""
    _check_loss_inputs(pred, gt)
    h, w, _ = pred.shape
    if not (pred.is_contiguous() and gt.is_contiguous()):
        raise ValueError("the loss kernels take contiguous images")
    cuda_build.check_inputs({"maps": (maps, torch.float32, (3, h, w, 3))}, pred.device)
    cots = []
    for name, g in (("g_total", g_total), ("g_l1", g_l1)):
        if g is not None:
            if g.device != pred.device or g.numel() != 1:
                raise ValueError(f"{name} must be a scalar on {pred.device}")
            g = g.to(torch.float32).contiguous()
        cots.append(g)
    grad = torch.empty_like(pred)
    cuda_build.launch("loss_bwd", pred.device,
                      pred.data_ptr(), gt.data_ptr(), *(m.data_ptr() for m in maps), h, w,
                      _window_array(), *(None if g is None else g.data_ptr() for g in cots),
                      *_loss_coefficients(lambda_dssim, pred.numel()), grad.data_ptr())
    return grad


class _PhotometricLoss(torch.autograd.Function):
    """(total, l1) behind autograd: L1 forward, L2 backward. `gt` gets no
    gradient."""

    @staticmethod
    def forward(ctx, pred, gt, lambda_dssim):
        total, l1, maps, _ = photometric_fwd_cuda(pred, gt, lambda_dssim)
        ctx.save_for_backward(pred, gt, maps)
        ctx.lambda_dssim = lambda_dssim
        ctx.set_materialize_grads(False)  # a missing cotangent is skipped in the kernel
        return total, l1

    @staticmethod
    @once_differentiable
    def backward(ctx, g_total, g_l1):
        if g_total is None and g_l1 is None:
            return None, None, None
        pred, gt, maps = ctx.saved_tensors
        return photometric_bwd_cuda(pred, gt, maps, ctx.lambda_dssim, g_total, g_l1), None, None


def photometric_loss_cuda(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2):
    """(total, l1) of an (H, W, 3) float32 CUDA image pair through the loss
    kernels, differentiable in `pred`: `total` = (1 - lambda) * l1 +
    lambda * (1 - SSIM), each within float32 summation order of the chain's.
    Non-contiguous images are made contiguous; anything else the kernels do
    not take (CPU tensors, another dtype or channel count, a `gt` that
    requires grad) raises ValueError. Its launches are counted in
    `cuda_build.launches` under `loss_fwd` (L1 with its reduction) and
    `loss_bwd` (L2)."""
    return _PhotometricLoss.apply(pred.contiguous(), gt.contiguous(), lambda_dssim)
