"""Renderer layer: bag + camera -> image (port of
`gaussian_mesh_splatting_tpu/renderer.py`).

Backends:
  * "reference": the sequential torch oracle (ops/rasterize_reference.py);
  * "cuda": preprocess + binning + the CUDA composite kernel
    (ops/rasterize_cuda.py); the bag must be on a CUDA device;
  * "auto": "cuda" for CUDA tensors; for CPU tensors the same pipeline with
    the kernel's plain PyTorch version as the composite.
"""
from __future__ import annotations

from typing import Literal

import torch

from .core.camera import Camera
from .models.gaussian_bag import GaussianBag
from .ops.rasterize_cuda import rasterize_cuda
from .ops.rasterize_reference import RenderOutput, rasterize_reference

Backend = Literal["reference", "cuda", "auto"]


def render(
    bag: GaussianBag,
    cam: Camera,
    bg: torch.Tensor,
    *,
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    backend: Backend = "auto",
    mean2d_offset: torch.Tensor | None = None,
    **backend_kwargs,
) -> RenderOutput:
    """Render a GaussianBag through one camera.

    `mean2d_offset`: optional zeros (N, 2); pass it and differentiate w.r.t.
    it to obtain screen-space positional gradients for densification.
    `backend_kwargs` forward to the selected rasterizer: `radius_mode=`
    for every backend; `pair_capacity=` and `row_band=` for cuda/auto;
    `tile_size=` and `scan_chunk=` for reference."""
    common = dict(
        bg=bg, shs=bag.shs, sh_degree=sh_degree, scale_modifier=scale_modifier,
        antialiasing=antialiasing, mean2d_offset=mean2d_offset, alive=bag.alive,
        **backend_kwargs,
    )
    args = (bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam)
    if backend == "reference":
        return rasterize_reference(*args, **common)
    if backend == "cuda" and not bag.xyz.is_cuda:
        raise ValueError(
            f"backend='cuda' needs CUDA tensors, got {bag.xyz.device}; "
            "use backend='auto' or 'reference' on the CPU"
        )
    if backend not in ("cuda", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    return rasterize_cuda(*args, **common)
