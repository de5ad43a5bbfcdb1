"""Tile binning: Gaussian -> depth-ordered (tile, Gaussian) pair list.

The GPU-natural form of `gaussian_mesh_splatting_tpu/ops/binning.py`:
  1. per-Gaussian tile rect (`tile_rect`, ported exactly: the oracle and the
     fast path share it) over Gaussians pre-sorted by view depth (stable
     argsort, invalid Gaussians keyed +inf, ties in index order);
  2. span = rect area, exclusive cumsum -> pair offsets;
  3. pair expansion with `repeat_interleave` and an integer tile decode;
  4. ONE sort on the int64 key (tile << 32) | depth_rank, which orders
     pairs by tile and, within a tile, front to back;
  5. per-tile [start, end) ranges by binary search of the sorted tiles;
  6. the order in which the composite kernels take the tiles: by falling
     pair count, so the tiles with the longest walks start first and the
     short ones fill in behind them (`tile_launch_order`).

With `row_band=(lo, hi)` only the tile rows lo <= ty < hi are binned: each
rect's rows are clipped to the band and the tiles keep their global indices,
so every tile of the band gets exactly the pairs, in the order, that it gets
without a band, and every other tile gets none (row-sharded rendering,
`parallel/row_sharded.py`).

Sizing the pair list needs the total pair count on the host: one `.item()`
synchronisation per render. With `pair_capacity` the first pairs in
depth-rank order are kept and the rest reported as `overflow`; without it
the list is sized exactly and `overflow` is 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling
from .projection import ProjectedGaussians


class Binning(NamedTuple):
    pair_gaussian: torch.Tensor  # (P,) int32 ORIGINAL Gaussian ids, sorted by (tile, depth)
    tile_start: torch.Tensor  # (T,) int32 first pair of each tile
    tile_end: torch.Tensor  # (T,) int32 one past the last pair of each tile
    tile_order: torch.Tensor  # (T,) int32 tiles by falling pair count (ties: by tile index)
    gaussian_order: torch.Tensor  # (N,) int64 stable depth argsort
    overflow: int  # pairs dropped for capacity


def tile_rect(
    mean2d: torch.Tensor,
    radius_x: torch.Tensor,
    tile_h: int,
    tile_w: int,
    n_tiles_y: int,
    n_tiles_x: int,
    radius_y: torch.Tensor | None = None,
):
    """Tile rectangle [min, max) each Gaussian touches (CUDA getRect) with
    per-axis half-extents, in float32 with the JAX package's floor/clip
    expressions. Returns (xmin, xmax, ymin, ymax) int32; the rect is empty
    when either radius is 0."""
    if radius_y is None:
        radius_y = radius_x
    mx, my = mean2d[..., 0], mean2d[..., 1]
    empty = (radius_x <= 0) | (radius_y <= 0)
    xmin = torch.clamp(torch.floor((mx - radius_x) / tile_w), 0, n_tiles_x).to(torch.int32)
    xmax = torch.clamp(
        torch.floor((mx + radius_x + tile_w - 1) / tile_w), 0, n_tiles_x
    ).to(torch.int32)
    ymin = torch.clamp(torch.floor((my - radius_y) / tile_h), 0, n_tiles_y).to(torch.int32)
    ymax = torch.clamp(
        torch.floor((my + radius_y + tile_h - 1) / tile_h), 0, n_tiles_y
    ).to(torch.int32)
    xmax = torch.where(empty, xmin, xmax)
    ymax = torch.where(empty, ymin, ymax)
    return xmin, xmax, ymin, ymax


def tile_launch_order(tile_start: torch.Tensor, tile_end: torch.Tensor) -> torch.Tensor:
    """The tiles (T,) int32 by falling pair count, ties in tile order: block i
    of a composite kernel takes tile `order[i]`. A tile's walk is serial and
    cannot be spread over blocks, so the longest tiles start first."""
    return torch.argsort(tile_end - tile_start, descending=True, stable=True).to(torch.int32)


@torch.no_grad()
def bin_gaussians(
    proj: ProjectedGaussians,
    *,
    tile_h: int,
    tile_w: int,
    n_tiles_y: int,
    n_tiles_x: int,
    pair_capacity: int | None = None,
    row_band: tuple[int, int] | None = None,
) -> Binning:
    """Depth-ordered per-tile pair lists (see the module docstring). Integer
    work only: it runs outside autograd, and its outputs carry no gradient.
    `row_band=(lo, hi)` bins only the tile rows [lo, hi)."""
    dev = proj.mean2d.device
    n = proj.mean2d.shape[0]
    n_tiles = n_tiles_y * n_tiles_x
    key = torch.where(proj.valid, proj.depth, torch.inf)
    order = torch.argsort(key, stable=True)

    xmin, xmax, ymin, ymax = tile_rect(
        proj.mean2d[order], proj.radius_x[order], tile_h, tile_w,
        n_tiles_y, n_tiles_x, radius_y=proj.radius_y[order],
    )
    if row_band is not None:
        lo, hi = row_band
        ymin = torch.clamp(ymin, lo, hi)
        ymax = torch.clamp(ymax, lo, hi)
    sx = torch.clamp_min(xmax - xmin, 0).long()
    sy = torch.clamp_min(ymax - ymin, 0).long()
    span = torch.where(proj.valid[order], sx * sy, 0)
    ends = torch.cumsum(span, 0)
    # the one host synchronisation per render: the pair list's length
    total = 0
    if n > 0:
        with profiling.span("bin_sync"):
            total = int(ends[-1].item())
            profiling.count("host_syncs")
    n_pairs = total if pair_capacity is None else min(total, pair_capacity)
    profiling.count("pairs", n_pairs)

    rank = torch.repeat_interleave(
        torch.arange(n, device=dev), span, output_size=total
    )[:n_pairs]
    local = torch.arange(n_pairs, device=dev) - (ends - span)[rank]
    sxr = sx[rank]
    ty = ymin[rank].long() + local // sxr
    tx = xmin[rank].long() + local % sxr
    tile = ty * n_tiles_x + tx
    sorted_key, _ = torch.sort((tile << 32) | rank)
    sorted_tile = sorted_key >> 32
    pair_gaussian = order[sorted_key & 0xFFFFFFFF].to(torch.int32)

    tiles = torch.arange(n_tiles, device=dev)
    tile_start = torch.searchsorted(sorted_tile, tiles, right=False).to(torch.int32)
    tile_end = torch.searchsorted(sorted_tile, tiles, right=True).to(torch.int32)
    return Binning(
        pair_gaussian=pair_gaussian,
        tile_start=tile_start,
        tile_end=tile_end,
        tile_order=tile_launch_order(tile_start, tile_end),
        gaussian_order=order,
        overflow=total - n_pairs,
    )
