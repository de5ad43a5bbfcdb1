"""The port's binning against the JAX package's, on the same projected
Gaussians (numpy seed): `tile_rect` exactly, each tile's front-to-back
Gaussian list exactly (JAX `build_aligned_binning` with its padding removed
and its depth-rank ids mapped through `gaussian_order`), and the overflow
count under a small `pair_capacity`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.ops.binning import build_aligned_binning
from gaussian_mesh_splatting_tpu.ops.binning import tile_rect as j_tile_rect
from gaussian_mesh_splatting_tpu.ops.projection import ProjectedGaussians as JProj
from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
from gaussian_mesh_splatting_tpu_torch.ops.binning import tile_rect as t_tile_rect
from gaussian_mesh_splatting_tpu_torch.ops.projection import ProjectedGaussians as TProj

torch.set_num_threads(2)


def _projected(seed, n, width, height):
    """Random screen-space Gaussians: means partly off screen, some zero
    radii, some invalid, and tied depths."""
    rng = np.random.default_rng(seed)
    mean2d = np.stack([rng.uniform(-20, width + 20, n), rng.uniform(-20, height + 20, n)],
                      axis=1).astype(np.float32)
    rx = np.ceil(rng.exponential(6.0, n)).astype(np.float32)
    ry = np.ceil(rng.exponential(6.0, n)).astype(np.float32)
    rx[::11] = 0.0
    depth = rng.choice(np.linspace(0.5, 5.0, n // 4), n).astype(np.float32)  # ties
    valid = rng.random(n) > 0.1
    rx, ry = np.where(valid, rx, 0.0).astype(np.float32), np.where(valid, ry, 0.0).astype(np.float32)
    radius = np.maximum(rx, ry)
    fields = dict(mean2d=mean2d, depth=depth, conic=np.ones((n, 3), np.float32),
                  opacity=np.ones(n, np.float32), color=np.ones((n, 3), np.float32),
                  radius=radius, valid=valid, radius_x=rx, radius_y=ry)
    jp = JProj(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = TProj(**{k: torch.tensor(v) for k, v in fields.items()})
    return jp, tp


@pytest.mark.parametrize("tile", [(16, 16), (8, 32)])
def test_tile_rect_exact(tile):
    th, tw = tile
    jp, tp = _projected(0, 512, 200, 120)
    nty, ntx = -(-120 // th), -(-200 // tw)
    j = j_tile_rect(jp.mean2d, jp.radius_x, th, tw, nty, ntx, radius_y=jp.radius_y)
    t = t_tile_rect(tp.mean2d, tp.radius_x, th, tw, nty, ntx, radius_y=tp.radius_y)
    for a, b in zip(t, j):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_tile_lists(jp, tile, nty, ntx, n, capacity):
    b = build_aligned_binning(jp, tile_h=tile[0], tile_w=tile[1], n_tiles_y=nty,
                              n_tiles_x=ntx, pair_capacity=capacity, chunk=8,
                              num_gaussians=n)
    order = np.asarray(b.gaussian_order)
    pg, start, count = (np.asarray(x) for x in (b.pair_gaussian, b.tile_start, b.tile_count))
    return [order[pg[s:s + c]].tolist() for s, c in zip(start, count)], int(b.overflow)


def _torch_tile_lists(binning):
    pg = binning.pair_gaussian.numpy()
    return [pg[s:e].tolist() for s, e in zip(binning.tile_start.numpy(), binning.tile_end.numpy())]


@pytest.mark.parametrize("tile,size", [((16, 16), (200, 120)), ((16, 16), (64, 64)),
                                       ((8, 32), (200, 120))])
def test_tile_lists_match_jax(tile, size):
    w, h = size
    n = 400
    jp, tp = _projected(1, n, w, h)
    nty, ntx = -(-h // tile[0]), -(-w // tile[1])
    j_lists, j_over = _jax_tile_lists(jp, tile, nty, ntx, n, capacity=1 << 15)
    tb = bin_gaussians(tp, tile_h=tile[0], tile_w=tile[1], n_tiles_y=nty, n_tiles_x=ntx)
    assert j_over == 0 and tb.overflow == 0
    assert tb.pair_gaussian.dtype == torch.int32
    assert sum(map(len, j_lists)) > n // 2
    assert _torch_tile_lists(tb) == j_lists
    np.testing.assert_array_equal(
        tb.gaussian_order.numpy(),
        np.argsort(np.where(tp.valid.numpy(), tp.depth.numpy(), np.inf), kind="stable"))


@pytest.mark.parametrize("capacity", [1, 200, 500])
def test_overflow_matches_jax(capacity):
    n, w, h = 400, 200, 120
    jp, tp = _projected(2, n, w, h)
    nty, ntx = -(-h // 16), -(-w // 16)
    j_lists, j_over = _jax_tile_lists(jp, (16, 16), nty, ntx, n, capacity)
    tb = bin_gaussians(tp, tile_h=16, tile_w=16, n_tiles_y=nty, n_tiles_x=ntx,
                       pair_capacity=capacity)
    total = bin_gaussians(tp, tile_h=16, tile_w=16, n_tiles_y=nty, n_tiles_x=ntx)
    assert tb.overflow == j_over == total.pair_gaussian.shape[0] - capacity > 0
    assert tb.pair_gaussian.shape[0] == capacity
    assert _torch_tile_lists(tb) == j_lists


def test_empty_binning():
    jp, tp = _projected(3, 16, 64, 64)
    tp = tp._replace(valid=torch.zeros(16, dtype=torch.bool))
    tb = bin_gaussians(tp, tile_h=16, tile_w=16, n_tiles_y=4, n_tiles_x=4)
    assert tb.pair_gaussian.numel() == 0 and tb.overflow == 0
    assert (tb.tile_start == tb.tile_end).all()
