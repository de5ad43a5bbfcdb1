"""Gaussian-sharded rendering (port of
`gaussian_mesh_splatting_tpu/parallel/gaussian_sharded.py`): the Gaussians
split over the ranks of a mesh axis in depth slabs, the partial composites
merged in depth order.

  1. Sort the Gaussians by view-space depth once (a stable argsort, dead
     rows keyed +inf, depth computed as the projection computes it) and
     deal contiguous depth ranges to the ranks: rank r takes ranks
     [r * per, (r + 1) * per), per = ceil(N / D), the tail padded with
     repeats of the last index, marked dead. Front-to-back compositing is
     associative over ordered groups: with each slab's pre-background
     colour C_i and transmittance T_i,
         C = sum_i (prod_{j<i} T_j) C_i,   T = prod_i T_i,
     so each rank composites its slab alone (the rasterizer unchanged, with
     bg = 0) and the merge is an exclusive cumprod and a weighted sum after
     one all_gather of (D, H, W, 5) planes.
  2. The per-Gaussian outputs (radii, mean2d) are gathered and put back in
     the Gaussians' own order through the inverse permutation.

Exactness: equal to the unsharded render up to the early-termination
tail. A pixel stops when the NEXT pair would push T below T_EPS = 1e-4,
without compositing it, so the unsharded walk can discard up to
T_EPS / (1 - ALPHA_MAX) = 1e-2 of weight at a pixel whose terminator is
near-opaque; a slab boundary restarts that check, so the sharded render
picks part of the tail back up. Pixels that never saturate match to
reassociation rounding.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..models.gaussian_bag import GaussianBag
from ..ops.rasterize_cuda import rasterize_cuda
from ..ops.rasterize_reference import RenderOutput
from .collectives import all_gather_stacked, gather_portions


@torch.no_grad()
def depth_order(bag: GaussianBag, cam: Camera, n_ranks: int) -> torch.Tensor:
    """(per * n_ranks,) int64: the Gaussians front to back (dead last, ties
    in index order), padded with repeats of the last index."""
    m = cam.world_view[2]
    x, y, z = bag.xyz.unbind(-1)
    depth = m[0] * x + m[1] * y + m[2] * z + m[3]  # as ops/projection computes it
    order = torch.argsort(torch.where(bag.alive, depth, torch.inf), stable=True)
    pad = -(-order.shape[0] // n_ranks) * n_ranks - order.shape[0]
    return torch.cat([order, order[-1:].expand(pad)])


def render_gaussians(
    bag: GaussianBag,
    cam: Camera,
    bg: torch.Tensor,
    group,
    *,
    sh_degree: int = 3,
    mean2d_offset: torch.Tensor | None = None,
    **render_kwargs,
) -> RenderOutput:
    """This rank's depth slab composited, the slabs gathered and merged: the
    whole (H, W) image, depth and alpha on every rank of `group`; `radii`
    and `mean2d` (no gradient) for every Gaussian in its own order;
    `overflow` is this rank's slab's alone. Differentiable: a rank's backward
    gives its slab's share of the gradient, and the SUM over the group is
    the whole gradient (`collectives.all_reduce_flat`)."""
    n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    n = bag.xyz.shape[0]
    order = depth_order(bag, cam, n_ranks)
    per = order.shape[0] // n_ranks
    mine = order[rank * per:(rank + 1) * per]
    alive = bag.alive[order]
    alive[n:] = False  # the padding
    out = rasterize_cuda(
        bag.xyz[mine], bag.scaling[mine], bag.rotation[mine], bag.opacity[mine], cam,
        bg=torch.zeros_like(bg),  # partials are pre-background
        shs=bag.shs[mine], sh_degree=sh_degree, alive=alive[rank * per:(rank + 1) * per],
        mean2d_offset=None if mean2d_offset is None else mean2d_offset[mine],
        **render_kwargs,
    )
    part = torch.cat([out.image, 1.0 - out.alpha[..., None], out.depth[..., None]], dim=-1)
    parts = gather_portions(part, group)  # (D, H, W, 5), slab d nearer than d + 1
    color, t, d = parts[..., :3], parts[..., 3], parts[..., 4]
    t_excl = torch.cat([torch.ones_like(t[:1]), torch.cumprod(t[:-1], dim=0)])
    t_total = t_excl[-1] * t[-1]
    image = (t_excl[..., None] * color).sum(dim=0) + t_total[..., None] * bg

    # per-Gaussian outputs: slabs gathered in depth order, then put back
    with torch.no_grad():
        radii = torch.empty((n,), dtype=out.radii.dtype, device=out.radii.device)
        radii[order[:n]] = all_gather_stacked(out.radii, group).reshape(-1)[:n]
        mean2d = torch.empty((n, 2), dtype=out.mean2d.dtype, device=out.mean2d.device)
        mean2d[order[:n]] = all_gather_stacked(out.mean2d.detach(), group).reshape(-1, 2)[:n]
    return RenderOutput(
        image=image, radii=radii, depth=(t_excl * d).sum(dim=0), alpha=1.0 - t_total,
        mean2d=mean2d, overflow=out.overflow,
    )


def render_gaussian_sharded(
    bag: GaussianBag,
    cam: Camera,
    bg: torch.Tensor,
    mesh,
    *,
    sh_degree: int = 3,
    axis_name: str = "data",
    pair_capacity: int | None = None,
) -> torch.Tensor:
    """Render one camera with the Gaussians sharded over the mesh axis in
    depth slabs. Returns the assembled (H, W, 3) image on every rank of the
    axis (gradients: see `render_gaussians`)."""
    kw = {} if pair_capacity is None else {"pair_capacity": pair_capacity}
    return render_gaussians(bag, cam, bg, mesh.get_group(axis_name), sh_degree=sh_degree,
                            **kw).image
