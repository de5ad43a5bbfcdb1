"""Oracle rasterizer: a slow, exact, sequential torch Gaussian splatting
renderer (port of `gaussian_mesh_splatting_tpu/ops/rasterize_reference.py`),
differentiable by autograd.

It is the behavioural specification the fast path is held against:
  * Gaussians processed in increasing view depth (stable sort, invalid
    Gaussians keyed +inf);
  * a Gaussian touches a pixel iff the pixel's tile intersects its binning
    rectangle (`binning.tile_rect`, parameterized tile size);
  * alpha = min(0.99, opacity * exp(power)), skipped when power > 0 or
    alpha < 1/255;
  * front-to-back C += T alpha c, T *= (1 - alpha), terminating when T would
    drop below 1e-4 (the triggering Gaussian is NOT composited);
  * image = C + T_final * background; depth = sum_i w_i z_i; alpha = 1 - T.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.camera import Camera
from .binning import tile_rect
from .projection import ProjectedGaussians, preprocess

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class RenderOutput(NamedTuple):
    image: torch.Tensor  # (H, W, 3)
    radii: torch.Tensor  # (N,) int32 conservative pixel radii (0 = invisible)
    depth: torch.Tensor  # (H, W) expected depth
    alpha: torch.Tensor  # (H, W) 1 - final transmittance
    mean2d: torch.Tensor  # (N, 2) projected pixel positions
    overflow: int | None = None  # pairs dropped (fast path only)


def _fold(carry, px, py, tile_x, tile_y, rect, mean2d, conic, opacity, color, depth):
    """Composite one run of depth-ordered Gaussians (row j of each attribute
    and of the integer binning rect) onto the carry (T, C, D, done)."""
    T, C, D, done = carry
    xmin, xmax, ymin, ymax = rect
    for j in range(mean2d.shape[0]):
        in_rect = (
            (tile_x >= xmin[j]) & (tile_x < xmax[j])
            & (tile_y >= ymin[j]) & (tile_y < ymax[j])
        )
        a, b, c = conic[j]
        dx = mean2d[j, 0] - px
        dy = mean2d[j, 1] - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.minimum(opacity[j] * torch.exp(power), power.new_tensor(ALPHA_MAX))
        contributes = in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)
        alpha = torch.where(contributes, alpha, 0.0)
        test_T = T * (1.0 - alpha)
        terminator = contributes & (test_T < T_EPS)
        include = contributes & ~done & ~terminator
        w = torch.where(include, T * alpha, 0.0)
        C = C + w[..., None] * color[j]
        D = D + w * depth[j]
        T = torch.where(include, test_T, T)
        done = done | terminator
    return T, C, D, done


def _composite_sequential(
    proj: ProjectedGaussians,
    order: torch.Tensor,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    bg: torch.Tensor,
    scan_chunk: int | None = None,
):
    """Sequential front-to-back composite over depth-sorted Gaussians.

    With `scan_chunk`, the Gaussians are folded in groups of that many (the
    last may be shorter), each under a non-reentrant checkpoint: autograd
    keeps one (T, C, D, done) carry per group and recomputes the group's
    steps in the backward pass, where the flat fold keeps about ten (H, W)
    tensors for every Gaussian. The arithmetic and its order are the same,
    so the forward is bit-equal to the flat fold."""
    dev = proj.mean2d.device
    px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    py = torch.arange(height, device=dev, dtype=torch.float32)[:, None]
    tile_x = (torch.arange(width, device=dev) // tile_w)[None, :]
    tile_y = (torch.arange(height, device=dev) // tile_h)[:, None]
    n_tiles_x = -(-width // tile_w)
    n_tiles_y = -(-height // tile_h)
    with torch.no_grad():  # integer rects: no gradient flows through them
        rect = tile_rect(
            proj.mean2d, proj.radius_x, tile_h, tile_w, n_tiles_y, n_tiles_x,
            radius_y=proj.radius_y,
        )
    # a Gaussian with an empty rect or culled composites nothing: skip it
    touches = proj.valid & (rect[1] > rect[0]) & (rect[3] > rect[2])
    ids = order[touches[order]]

    carry = (
        torch.ones((height, width), device=dev),
        torch.zeros((height, width, 3), device=dev),
        torch.zeros((height, width), device=dev),
        torch.zeros((height, width), dtype=torch.bool, device=dev),
    )
    attrs = (proj.mean2d, proj.conic, proj.opacity, proj.color, proj.depth)
    step = scan_chunk or max(len(ids), 1)
    for lo in range(0, len(ids), step):
        group = ids[lo:lo + step]
        args = (carry, px, py, tile_x, tile_y, tuple(r[group] for r in rect),
                *(x[group] for x in attrs))
        if scan_chunk is None:
            carry = _fold(*args)
        else:
            carry = checkpoint(_fold, *args, use_reentrant=False)
    T, C, D, _ = carry
    return C + T[..., None] * bg, D, 1.0 - T


def rasterize_reference(
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
    cov3d_precomp: torch.Tensor | None = None,
    antialiasing: bool = False,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    radius_mode: str = "tight",
    tile_size: tuple[int, int] = (16, 16),
    scan_chunk: int | None = None,
) -> RenderOutput:
    """Render one camera view with the oracle (see module docstring).
    Exactly one of `shs` / `colors` is used, as in the JAX package. It is
    differentiable by autograd, which gives the reference gradients;
    `mean2d_offset` (zeros (N, 2)) exposes the screen-space positional
    gradient. `radius_mode` picks the binning rectangle (`preprocess`);
    `scan_chunk` folds the Gaussians in checkpointed groups of that many,
    which bounds autograd's memory at scale and changes no result."""
    proj = preprocess(
        means3d, scales, rotations, opacities, cam,
        shs=shs, colors=colors, sh_degree=sh_degree,
        scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
        antialiasing=antialiasing, mean2d_offset=mean2d_offset, alive=alive,
        radius_mode=radius_mode,
    )
    order = torch.argsort(torch.where(proj.valid, proj.depth, torch.inf), stable=True)
    image, depth, alpha = _composite_sequential(
        proj, order, cam.height, cam.width, tile_size[0], tile_size[1], bg,
        scan_chunk=scan_chunk,
    )
    return RenderOutput(
        image=image,
        radii=proj.radius.to(torch.int32),
        depth=depth,
        alpha=alpha,
        mean2d=proj.mean2d,
    )
