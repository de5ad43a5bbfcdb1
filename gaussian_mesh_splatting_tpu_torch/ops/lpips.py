"""LPIPS v0.1 (Learned Perceptual Image Patch Similarity), port of
`gaussian_mesh_splatting_tpu/ops/lpips.py`:

  score(x, y) = sum over target layers L of
                  mean_{h,w}( lin_L( (nx_L - ny_L)^2 ) )

where n*_L are channel-unit-normalized feature maps (f / (||f||_c + 1e-10))
of a VGG16 feature stack applied to the z-scored input ((img - shift) / scale
with the LPIPS v0.1 constants), and lin_L is a learned non-negative 1x1 head
with no bias. Target layers are the ReLU outputs of VGG16 convs #2, #4, #7,
#10, #13.

The stack runs as `torch.nn.functional.conv2d` / `max_pool2d` in NCHW: the
JAX package computes LPIPS with `lax.conv` outside any Pallas kernel, so a
library convolution is its counterpart. cuDNN runs float32 convolutions in
TF32 by default on the card; the scorer turns that off for its own call and
restores it, so the card's score is float32's.

Weights: one `.npz` from `$GMS_LPIPS_WEIGHTS` or
`~/.cache/gms_tpu/lpips_vgg.npz`, the JAX package's file, with arrays

    conv{i}_w  (3, 3, C_in, C_out) float32   i = 0..12  (HWIO)
    conv{i}_b  (C_out,)            float32
    lin{j}_w   (C_j,)              float32   j = 0..4   (1x1 head, no bias)

The HWIO kernels are transposed to torch's OIHW once, at load.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# LPIPS v0.1 input scaling constants, applied to images in the caller's range
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 feature-stack plan: ('C', out_channels) or 'M' (2x2/2 maxpool).
# A trailing '*' on a conv marks a target layer (feature tap after ReLU).
VGG16_PLAN: tuple = (
    ("C", 64), ("C*", 64), "M",
    ("C", 128), ("C*", 128), "M",
    ("C", 256), ("C", 256), ("C*", 256), "M",
    ("C", 512), ("C", 512), ("C*", 512), "M",
    ("C", 512), ("C", 512), ("C*", 512),
)


class LPIPSParams(NamedTuple):
    conv_w: tuple  # OIHW kernels, one per conv in plan order
    conv_b: tuple
    lin_w: tuple  # (C,) per target layer
    plan: tuple = VGG16_PLAN


@contextlib.contextmanager
def _no_tf32():
    """float32 convolutions in float32 on the card, restored afterwards."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _features(x: torch.Tensor, params: LPIPSParams) -> list[torch.Tensor]:
    """Feature taps of the conv stack. x: (N, 3, H, W) z-scored."""
    taps = []
    ci = 0
    for item in params.plan:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        kind, _ = item
        x = torch.relu(F.conv2d(x, params.conv_w[ci], params.conv_b[ci], padding=1))
        ci += 1
        if kind == "C*":
            norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
            taps.append(x / (norm + 1e-10))
    return taps


def lpips(x: torch.Tensor, y: torch.Tensor, params: LPIPSParams) -> torch.Tensor:
    """LPIPS distance. x, y: (H, W, 3) or (N, H, W, 3) images in the range
    the reference feeds ([0, 1]). Returns a 0-d tensor for one image pair,
    else (N,)."""
    if x.ndim == 3:
        x, y = x[None], y[None]
    shift = torch.as_tensor(_SHIFT, device=x.device)
    scale = torch.as_tensor(_SCALE, device=x.device)

    def nchw(img):
        return ((img - shift) / scale).permute(0, 3, 1, 2)

    with _no_tf32():
        fx = _features(nchw(x), params)
        fy = _features(nchw(y), params)
    score = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
    for tx, ty, w in zip(fx, fy, params.lin_w):
        d = (tx - ty) ** 2
        score = score + torch.mean(torch.sum(d * w[None, :, None, None], dim=1), dim=(1, 2))
    return score[0] if score.shape == (1,) else score


def default_weights_path() -> str:
    return os.environ.get(
        "GMS_LPIPS_WEIGHTS",
        os.path.expanduser("~/.cache/gms_tpu/lpips_vgg.npz"),
    )


def params_from_arrays(arrays, plan: tuple = VGG16_PLAN, *, device=None) -> LPIPSParams:
    """LPIPSParams from the documented arrays (a loaded `.npz` or a dict of
    numpy arrays): conv kernels HWIO -> OIHW, all on `device` (CUDA unless
    the caller asks for another)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    n_conv = sum(1 for it in plan if it != "M")
    n_lin = sum(1 for it in plan if it != "M" and it[0] == "C*")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    conv_w = tuple(t(np.transpose(arrays[f"conv{i}_w"], (3, 2, 0, 1))) for i in range(n_conv))
    conv_b = tuple(t(arrays[f"conv{i}_b"]) for i in range(n_conv))
    lin_w = tuple(t(arrays[f"lin{j}_w"]) for j in range(n_lin))
    return LPIPSParams(conv_w, conv_b, lin_w, plan)


def load_params(path: str | None = None, *, device=None) -> LPIPSParams | None:
    """Load LPIPS weights from the documented .npz onto `device`; None when
    the file is absent."""
    path = path or default_weights_path()
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return params_from_arrays(z, device=device)


def synthetic_arrays(rng: np.random.Generator, plan: tuple = VGG16_PLAN) -> dict:
    """Random weights in the documented layout (HWIO kernels), drawn from a
    numpy generator: conv kernels normal / sqrt(9 C_in), biases normal x 0.1,
    heads uniform in [0, 1) (the heads are non-negative). The math does not
    depend on the weights being pretrained."""
    arrays = {}
    c_in, ci, li = 3, 0, 0
    for item in plan:
        if item == "M":
            continue
        kind, c_out = item
        arrays[f"conv{ci}_w"] = (rng.standard_normal((3, 3, c_in, c_out))
                                 / np.sqrt(9 * c_in)).astype(np.float32)
        arrays[f"conv{ci}_b"] = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
        ci += 1
        c_in = c_out
        if kind == "C*":
            arrays[f"lin{li}_w"] = rng.random(c_out).astype(np.float32)
            li += 1
    return arrays


def synthetic_params(generator: torch.Generator, plan: tuple = VGG16_PLAN,
                     *, device=None) -> LPIPSParams:
    """Random-weight params (for tests and calibration), drawn as
    `synthetic_arrays` draws them but from a `torch.Generator` on `device`."""
    from ..device import resolve_device

    dev = resolve_device(device)
    conv_w, conv_b, lin_w = [], [], []
    c_in = 3
    for item in plan:
        if item == "M":
            continue
        kind, c_out = item
        conv_w.append(torch.randn((c_out, c_in, 3, 3), generator=generator, device=dev)
                      / float(np.sqrt(9 * c_in)))
        conv_b.append(torch.randn((c_out,), generator=generator, device=dev) * 0.1)
        c_in = c_out
        if kind == "C*":
            lin_w.append(torch.rand((c_out,), generator=generator, device=dev))
    return LPIPSParams(tuple(conv_w), tuple(conv_b), tuple(lin_w), plan)
