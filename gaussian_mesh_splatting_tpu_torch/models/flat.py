"""`gs_flat`: flat-disk Gaussians (port of
`gaussian_mesh_splatting_tpu/models/flat.py`).

The raw params of `gs`, but `scaling` is (N, 2) log-scale and the activated
scale is [EPS_S0, exp(s1), exp(s2)]: a frozen, vanishing first axis. The
flatness makes each Gaussian a textured surfel, which is what the pseudomesh
(`gs_points`) inverts.
"""
from __future__ import annotations

import torch

from . import vanilla
from .gaussian_bag import GaussianBag, features_to_shs

EPS_S0 = 1e-8


def init_from_points(
    points: torch.Tensor,
    colors: torch.Tensor,
    sh_degree: int = 3,
    capacity: int | None = None,
) -> dict:
    return vanilla.init_from_points(points, colors, sh_degree, capacity, scaling_cols=2)


def flat_scaling(raw_scaling: torch.Tensor) -> torch.Tensor:
    """(N, >= 2) raw log-scale -> (N, 3) activated [EPS_S0, exp(s1), exp(s2)]
    from the last two columns."""
    s0 = torch.full((raw_scaling.shape[0], 1), EPS_S0, dtype=torch.float32,
                    device=raw_scaling.device)
    return torch.cat([s0, torch.exp(raw_scaling[:, -2:])], dim=1)


def to_bag(state: dict) -> GaussianBag:
    p = state["params"]
    return GaussianBag(
        xyz=p["xyz"],
        scaling=flat_scaling(p["scaling"]),
        rotation=vanilla.unit_rotation(p["rotation"]),
        opacity=torch.sigmoid(p["opacity"]),
        shs=features_to_shs(p["f_dc"], p["f_rest"]),
        alive=state["alive"],
    )
