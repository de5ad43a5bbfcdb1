"""`gs`: vanilla 3DGS parameterization (port of
`gaussian_mesh_splatting_tpu/models/vanilla.py`).

Raw (trainable) params, named as the optimizer groups:

  xyz (N,3) | f_dc (N,1,3) | f_rest (N,K-1,3) | opacity (N,1) raw logit |
  scaling (N,3) log-scale | rotation (N,4) unnormalized quat

Activations: exp on scaling, sigmoid on opacity, normalize on rotation. Init
from a point cloud: SH DC from RGB, isotropic scale from the 3-NN mean
distance, identity rotations, opacity 0.1.

With `capacity` the params are padded to that many rows under an `alive`
mask: the fixed-size buffer that densification fills (train/densify.py).
"""
from __future__ import annotations

import torch

from ..core.sh import rgb_to_sh
from ..core.transforms import inverse_sigmoid
from ..ops.knn import knn_scale_init
from .gaussian_bag import GaussianBag, features_to_shs


def init_from_points(
    points: torch.Tensor,
    colors: torch.Tensor,
    sh_degree: int = 3,
    capacity: int | None = None,
    scaling_cols: int = 3,
) -> dict:
    """Raw params from (N,3) points + (N,3) RGB colours in [0,1], on the
    device of `points`. `scaling_cols` is 3 for `gs`, 2 for `gs_flat`."""
    n = points.shape[0]
    k = (sh_degree + 1) ** 2
    dev = points.device
    points = points.to(torch.float32)
    rotation = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rotation[:, 0] = 1.0
    params = {
        "xyz": points,
        "f_dc": rgb_to_sh(colors.to(dev, torch.float32))[:, None, :],
        "f_rest": torch.zeros((n, k - 1, 3), dtype=torch.float32, device=dev),
        "opacity": inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32, device=dev)),
        "scaling": knn_scale_init(points)[:, None].repeat(1, scaling_cols),
        "rotation": rotation,
    }
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    if capacity is not None and capacity > n:
        params, alive = pad_rows(params, alive, capacity)
    return {"params": params, "consts": {}, "alive": alive}


def pad_rows(params: dict, alive: torch.Tensor, capacity: int) -> tuple[dict, torch.Tensor]:
    """Pad every param and the alive mask from their n rows to `capacity`
    rows. Padded rows are dead, with zeros except a unit-ish rotation (w = 1:
    no 0/0 in normalize) and a tiny scaling (-10: no huge ghost Gaussians
    should a fault ever revive one)."""
    n = alive.shape[0]
    pad = capacity - n

    def padded(x):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], dim=0)

    params = {key: padded(v) for key, v in params.items()}
    if "rotation" in params:
        params["rotation"][n:, 0] = 1.0
    if "scaling" in params:
        params["scaling"][n:] = -10.0
    return params, padded(alive)


def unit_rotation(raw: torch.Tensor) -> torch.Tensor:
    return raw / (torch.linalg.vector_norm(raw, dim=-1, keepdim=True) + 1e-12)


def to_bag(state: dict) -> GaussianBag:
    p = state["params"]
    return GaussianBag(
        xyz=p["xyz"],
        scaling=torch.exp(p["scaling"]),
        rotation=unit_rotation(p["rotation"]),
        opacity=torch.sigmoid(p["opacity"]),
        shs=features_to_shs(p["f_dc"], p["f_rest"]),
        alive=state["alive"],
    )
