"""The plain reference of the benchmark: GaMeS mesh and FLAME Gaussians,
projection with spherical harmonics, tight tile binning, a chunked
front-to-back composite under autograd, L1 + SSIM and Adam, in plain
PyTorch at float32.

It imports nothing of the program under test (nor JAX): it works out again,
from the inputs that the benchmark makes, everything that the program
derives. `exact_float32()` turns TF32 off for every matrix product and
convolution it runs.
"""
import torch


def exact_float32() -> None:
    """Run float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
