"""Row-sharded rendering (port of
`gaussian_mesh_splatting_tpu/parallel/row_sharded.py`): one camera's tile
rows split over the ranks of a mesh axis.

Rank r of D renders the tile rows [r * per, (r + 1) * per), per =
ceil(n_tiles_y / D), through `rasterize_cuda(row_band=...)`: the binning
keeps global tile indices and clips each Gaussian's rows to the band, so
the kernels see the whole image's tile grid, walk nothing outside the band,
and every pixel of the band equals the unsharded render's. The bands meet in
one all_gather and the image is cut to H rows: the assembled image is
bit-equal to the unsharded render.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.camera import Camera
from ..models.gaussian_bag import GaussianBag
from ..ops.rasterize_cuda import TILE, rasterize_cuda
from ..ops.rasterize_reference import RenderOutput
from .collectives import gather_portions


def band_tiles(height: int, n_ranks: int) -> int:
    """A band's height in tile rows: ceil(n_tiles_y / n_ranks)."""
    return -(-(-(-height // TILE)) // n_ranks)


def row_band(height: int, rank: int, n_ranks: int) -> tuple[int, int]:
    """Tile rows [lo, hi) of `rank`'s band; the last bands may be short or
    empty."""
    n_ty = -(-height // TILE)
    lo = min(rank * band_tiles(height, n_ranks), n_ty)
    return lo, min(lo + band_tiles(height, n_ranks), n_ty)


def render_rows(
    bag: GaussianBag,
    cam: Camera,
    bg: torch.Tensor,
    group,
    *,
    sh_degree: int = 3,
    mean2d_offset: torch.Tensor | None = None,
    **render_kwargs,
) -> RenderOutput:
    """This rank's band, rendered, then every band gathered: the whole
    (H, W) image, depth and alpha on every rank of `group`. `radii` and
    `mean2d` are the replicated preprocess's, for every Gaussian;
    `overflow` is this rank's band's alone. Differentiable: a rank's
    backward gives its band's share of the gradient, and the SUM over the
    group is the whole gradient (`collectives.all_reduce_flat`)."""
    n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    h, w = cam.height, cam.width
    lo, hi = row_band(h, rank, n_ranks)
    per_rows = band_tiles(h, n_ranks) * TILE
    out = rasterize_cuda(
        bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam,
        bg=bg, shs=bag.shs, sh_degree=sh_degree, alive=bag.alive,
        mean2d_offset=mean2d_offset, row_band=(lo, hi), **render_kwargs,
    )
    part = torch.cat([out.image, out.depth[..., None], out.alpha[..., None]], dim=-1)
    part = F.pad(part, (0, 0, 0, 0, 0, per_rows - part.shape[0]))  # (per_rows, W, 5)
    full = gather_portions(part, group).reshape(-1, w, 5)[:h]
    return RenderOutput(
        image=full[..., :3], radii=out.radii, depth=full[..., 3], alpha=full[..., 4],
        mean2d=out.mean2d, overflow=out.overflow,
    )


def render_row_sharded(
    bag: GaussianBag,
    cam: Camera,
    bg: torch.Tensor,
    mesh,
    *,
    sh_degree: int = 3,
    axis_name: str = "data",
) -> torch.Tensor:
    """Render one camera with its tile rows sharded over the mesh axis.

    Returns the assembled (H, W, 3) image on every rank of the axis
    (gradients: see `render_rows`)."""
    return render_rows(bag, cam, bg, mesh.get_group(axis_name), sh_degree=sh_degree).image
