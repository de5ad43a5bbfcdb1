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


def _composite_sequential(
    proj: ProjectedGaussians,
    order: torch.Tensor,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    bg: torch.Tensor,
):
    """Sequential front-to-back composite over depth-sorted Gaussians."""
    dev = proj.mean2d.device
    px = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    py = torch.arange(height, device=dev, dtype=torch.float32)[:, None]
    tile_x = (torch.arange(width, device=dev) // tile_w)[None, :]
    tile_y = (torch.arange(height, device=dev) // tile_h)[:, None]
    n_tiles_x = -(-width // tile_w)
    n_tiles_y = -(-height // tile_h)
    with torch.no_grad():  # integer rects: no gradient flows through them
        xmin, xmax, ymin, ymax = tile_rect(
            proj.mean2d, proj.radius_x, tile_h, tile_w, n_tiles_y, n_tiles_x,
            radius_y=proj.radius_y,
        )
    # a Gaussian with an empty rect or culled composites nothing: skip it
    touches = proj.valid & (xmax > xmin) & (ymax > ymin)

    T = torch.ones((height, width), device=dev)
    C = torch.zeros((height, width, 3), device=dev)
    D = torch.zeros((height, width), device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for i in order[touches[order]].tolist():
        in_rect = (
            (tile_x >= xmin[i]) & (tile_x < xmax[i])
            & (tile_y >= ymin[i]) & (tile_y < ymax[i])
        )
        a, b, c = proj.conic[i]
        dx = proj.mean2d[i, 0] - px
        dy = proj.mean2d[i, 1] - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.minimum(proj.opacity[i] * torch.exp(power), power.new_tensor(ALPHA_MAX))
        contributes = in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)
        alpha = torch.where(contributes, alpha, 0.0)
        test_T = T * (1.0 - alpha)
        terminator = contributes & (test_T < T_EPS)
        include = contributes & ~done & ~terminator
        w = torch.where(include, T * alpha, 0.0)
        C = C + w[..., None] * proj.color[i]
        D = D + w * proj.depth[i]
        T = torch.where(include, test_T, T)
        done = done | terminator
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
    antialiasing: bool = False,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    tile_size: tuple[int, int] = (16, 16),
) -> RenderOutput:
    """Render one camera view with the oracle (see module docstring).
    Exactly one of `shs` / `colors` is used, as in the JAX package. It is
    differentiable by autograd, which gives the reference gradients;
    `mean2d_offset` (zeros (N, 2)) exposes the screen-space positional
    gradient."""
    proj = preprocess(
        means3d, scales, rotations, opacities, cam,
        shs=shs, colors=colors, sh_degree=sh_degree,
        scale_modifier=scale_modifier, antialiasing=antialiasing,
        mean2d_offset=mean2d_offset, alive=alive, radius_mode="tight",
    )
    order = torch.argsort(torch.where(proj.valid, proj.depth, torch.inf), stable=True)
    image, depth, alpha = _composite_sequential(
        proj, order, cam.height, cam.width, tile_size[0], tile_size[1], bg,
    )
    return RenderOutput(
        image=image,
        radii=proj.radius.to(torch.int32),
        depth=depth,
        alpha=alpha,
        mean2d=proj.mean2d,
    )
