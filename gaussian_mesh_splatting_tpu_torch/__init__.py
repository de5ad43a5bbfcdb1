"""PyTorch/CUDA port of the Gaussian mesh splatting (GaMeS) framework.

Module names and layout mirror the JAX package `gaussian_mesh_splatting_tpu`,
which stays the reference this port is tested against. This package imports
`torch` only. Entry points run on the CUDA device unless the caller passes
`device="cpu"`; the hand-written Hopper kernels live in `csrc/` and are built
with `nvcc` at first use (see `ops/cuda_build.py`).
"""
__version__ = "0.1.0"

from . import core, io, models, ops, parallel, scene, train, utils
from .device import resolve_device
from .renderer import render
