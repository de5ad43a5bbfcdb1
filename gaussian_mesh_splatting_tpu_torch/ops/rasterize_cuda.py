"""Tile rasterizer with a hand-written CUDA composite: the port's fast path
(counterpart of `gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py`).

  preprocess (torch)           project / cull / conic / SH, ops/projection.py
  bin_gaussians (torch)        depth-ordered per-tile pair lists, ops/binning.py
  composite_fwd (CUDA kernel)  per-tile front-to-back composite,
                               csrc/composite_fwd.cu
  background + outputs (torch) image = rgb + T * bg

`composite_fwd` launches the kernel for CUDA tensors and runs the plain
PyTorch version `composite_fwd_plain` for CPU tensors. It never falls back
from one to the other: a CUDA tensor gets the kernel or an exception.
Tiles are 16x16 pixels; in "tight" radius mode the tile size does not change
the image.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.camera import Camera
from . import cuda_build
from .binning import Binning, bin_gaussians
from .projection import preprocess
from .rasterize_reference import ALPHA_MAX, ALPHA_MIN, T_EPS, RenderOutput

TILE = 16  # the kernel's tile edge (one block of TILE*TILE threads per tile)
N_PLANES = 5  # r, g, b, T_final, depth


def _tile_grid(height: int, width: int) -> tuple[int, int]:
    return -(-height // TILE), -(-width // TILE)


def composite_fwd_plain(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    height: int,
    width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the composite kernel, with the same inputs
    and outputs: vectorized over tiles and pixels, a Python loop over the
    k-th pair of every tile. Every product and sum is one torch operation,
    in the kernel's order.

    Returns (planes (5, H, W) float32 = r, g, b, T_final, depth;
    nc (H, W) int32 = 1-based rank of the last included pair in the tile)."""
    dev = mean2d.device
    n_ty, n_tx = _tile_grid(height, width)
    n_tiles = n_ty * n_tx
    lin = torch.arange(TILE * TILE, device=dev)
    tiles = torch.arange(n_tiles, device=dev)
    px = ((tiles % n_tx)[:, None] * TILE + (lin % TILE)[None, :]).to(torch.float32)
    py = ((tiles // n_tx)[:, None] * TILE + (lin // TILE)[None, :]).to(torch.float32)

    T = torch.ones((n_tiles, TILE * TILE), device=dev)
    rgb = torch.zeros((n_tiles, TILE * TILE, 3), device=dev)
    D = torch.zeros((n_tiles, TILE * TILE), device=dev)
    nc = torch.zeros((n_tiles, TILE * TILE), dtype=torch.int32, device=dev)
    done = torch.zeros((n_tiles, TILE * TILE), dtype=torch.bool, device=dev)

    start = tile_start.long()
    count = tile_end.long() - start
    n_pairs = pair_gaussian.shape[0]
    k_max = int(count.max().item()) if n_tiles > 0 and n_pairs > 0 else 0
    for k in range(k_max):
        active = (count > k)[:, None]
        g = pair_gaussian[torch.clamp_max(start + k, n_pairs - 1)].long()
        mx, my = mean2d[g, 0][:, None], mean2d[g, 1][:, None]
        a, b, c = conic[g, 0][:, None], conic[g, 1][:, None], conic[g, 2][:, None]
        dx = mx - px
        dy = my - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(opacity[g][:, None] * torch.exp(power), ALPHA_MAX)
        contributes = active & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_T = T * (1.0 - alpha)
        terminator = contributes & (test_T < T_EPS)
        include = contributes & ~done & ~terminator
        w = torch.where(include, T * alpha, 0.0)
        rgb = rgb + w[..., None] * color[g][:, None, :]
        D = D + w * depth[g][:, None]
        T = torch.where(include, test_T, T)
        nc = torch.where(include, k + 1, nc)
        done = done | terminator

    def to_image(x):  # (..., n_tiles, TILE*TILE) -> (..., H, W)
        lead = x.shape[:-2]
        x = x.reshape(*lead, n_ty, n_tx, TILE, TILE).transpose(-3, -2)
        return x.reshape(*lead, n_ty * TILE, n_tx * TILE)[..., :height, :width]

    planes = torch.cat([rgb.permute(2, 0, 1), T[None], D[None]], dim=0)
    return to_image(planes).contiguous(), to_image(nc).contiguous()


@functools.cache
def _composite_lib() -> ctypes.CDLL:
    lib = cuda_build.load("composite_fwd")
    lib.composite_fwd.restype = ctypes.c_int
    lib.composite_fwd.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    )
    return lib


def composite_fwd_cuda(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    height: int,
    width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the composite kernel (csrc/composite_fwd.cu) on PyTorch's
    current stream. Same contract as `composite_fwd_plain`. Counts its
    launches in `composite_fwd_cuda.launches`."""
    dev = mean2d.device
    n = mean2d.shape[0]
    n_ty, n_tx = _tile_grid(height, width)
    n_tiles = n_ty * n_tx
    expect = {
        "mean2d": (mean2d, torch.float32, (n, 2)),
        "conic": (conic, torch.float32, (n, 3)),
        "opacity": (opacity, torch.float32, (n,)),
        "color": (color, torch.float32, (n, 3)),
        "depth": (depth, torch.float32, (n,)),
        "pair_gaussian": (pair_gaussian, torch.int32, (pair_gaussian.shape[0],)),
        "tile_start": (tile_start, torch.int32, (n_tiles,)),
        "tile_end": (tile_end, torch.int32, (n_tiles,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n >= 2**31 or pair_gaussian.shape[0] >= 2**31:
        raise ValueError("the kernel indexes with 32-bit integers")

    planes = torch.empty((N_PLANES, height, width), dtype=torch.float32, device=dev)
    nc = torch.empty((height, width), dtype=torch.int32, device=dev)
    lib = _composite_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.composite_fwd(
            pair_gaussian.data_ptr(), tile_start.data_ptr(), tile_end.data_ptr(),
            mean2d.data_ptr(), conic.data_ptr(), opacity.data_ptr(),
            color.data_ptr(), depth.data_ptr(),
            height, width, n_tx, n_tiles,
            planes.data_ptr(), nc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error {err}")
    composite_fwd_cuda.launches += 1
    return planes, nc


composite_fwd_cuda.launches = 0


class _CompositeFwd(torch.autograd.Function):
    """The kernel behind autograd. Its backward is the backward composite
    kernel, which is not ported yet: it raises rather than differentiate
    the plain version."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, depth,
                pair_gaussian, tile_start, tile_end, height, width):
        planes, nc = composite_fwd_cuda(
            mean2d, conic, opacity, color, depth,
            pair_gaussian, tile_start, tile_end, height, width,
        )
        ctx.mark_non_differentiable(nc)
        return planes, nc

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the backward composite kernel is not ported yet")


def composite_fwd(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
    binning: Binning,
    height: int,
    width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Returns (planes (5,H,W), nc (H,W))."""
    args = (
        mean2d.contiguous(), conic.contiguous(), opacity.contiguous(), color.contiguous(),
        depth.contiguous(), binning.pair_gaussian, binning.tile_start,
        binning.tile_end, height, width,
    )
    if mean2d.is_cuda:
        return _CompositeFwd.apply(*args)
    if mean2d.device.type != "cpu":
        raise ValueError(f"no composite for device {mean2d.device}")
    return composite_fwd_plain(*args)


def rasterize_cuda(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    *,
    bg: torch.Tensor,
    shs: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    alive: torch.Tensor | None = None,
    pair_capacity: int | None = None,
) -> RenderOutput:
    """Fast equivalent of `rasterize_reference` (same contract) at 16x16
    tiles. `pair_capacity` bounds the pair list; pairs beyond it are
    dropped and counted in `overflow`."""
    proj = preprocess(
        means3d, scales, rotations, opacities, cam,
        shs=shs, colors=colors, sh_degree=sh_degree,
        scale_modifier=scale_modifier, antialiasing=antialiasing,
        alive=alive, radius_mode="tight",
    )
    h, w = cam.height, cam.width
    n_ty, n_tx = _tile_grid(h, w)
    binning = bin_gaussians(
        proj, tile_h=TILE, tile_w=TILE, n_tiles_y=n_ty, n_tiles_x=n_tx,
        pair_capacity=pair_capacity,
    )
    planes, _nc = composite_fwd(
        proj.mean2d, proj.conic, proj.opacity, proj.color, proj.depth,
        binning, h, w,
    )
    t_final = planes[3]
    image = planes[:3].permute(1, 2, 0) + t_final[..., None] * bg
    return RenderOutput(
        image=image,
        radii=proj.radius.to(torch.int32),
        depth=planes[4],
        alpha=1.0 - t_final,
        mean2d=proj.mean2d,
        overflow=binning.overflow,
    )
