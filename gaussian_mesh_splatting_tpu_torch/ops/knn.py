"""K-nearest-neighbour mean distance (port of
`gaussian_mesh_splatting_tpu/ops/knn.py`), used once at init to set the
Gaussian scales of a point cloud: per point, the mean *squared* distance to
its 3 nearest neighbours, by chunked brute force and `torch.topk`.

The squared distances come from |a|^2 + |b|^2 - 2ab, which cancels badly for
close points, so the product ab is summed coordinate by coordinate with
elementwise float32 operations: no matrix product, hence no TF32 on the card
whatever the process-wide matmul flags say. A (chunk, N) float32 tile at
chunk 4096 and 100,000 points is 1.6 GB.
"""
from __future__ import annotations

import torch


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3, chunk: int = 4096) -> torch.Tensor:
    """Per-point mean squared distance to the k nearest other points.

    Args:
      points: (N, 3) float32, N > k.
      k: neighbour count (3 matches the reference's distCUDA2).
      chunk: query chunk size (the distance tile is (chunk, N)).
    Returns:
      (N,) float32 on the device of `points`.
    """
    n = points.shape[0]
    if n <= k:
        raise ValueError(f"mean_knn_sq_dist needs more than k={k} points, got {n}")
    sq = torch.sum(points * points, dim=-1)  # (N,)
    px, py, pz = points.unbind(-1)
    out = torch.empty((n,), dtype=points.dtype, device=points.device)
    for start in range(0, n, chunk):
        q = points[start:start + chunk]
        rows = torch.arange(q.shape[0], device=points.device)
        dot = q[:, 0:1] * px[None, :] + q[:, 1:2] * py[None, :] + q[:, 2:3] * pz[None, :]
        d2 = sq[start:start + chunk, None] + sq[None, :] - 2.0 * dot  # (chunk, N)
        d2[rows, start + rows] = torch.inf  # a point is not its own neighbour
        nearest = torch.topk(d2, k, dim=-1, largest=False).values
        out[start:start + chunk] = torch.mean(torch.clamp_min(nearest, 0.0), dim=-1)
    return out


def knn_scale_init(points: torch.Tensor, clamp_min: float = 1e-7) -> torch.Tensor:
    """log(sqrt(mean 3-NN squared distance)): the isotropic scale init. (N,)."""
    d2 = torch.clamp_min(mean_knn_sq_dist(points, k=3), clamp_min)
    return torch.log(torch.sqrt(d2))
