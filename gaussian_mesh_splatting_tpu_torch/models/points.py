"""`gs_points`: the render-only pseudomesh parameterization (port of
`gaussian_mesh_splatting_tpu/models/points.py`).

The inverse of `gs_flat`: trained flat Gaussians become a triangle soup (one
triangle per Gaussian), and scaling and rotation are derived again from the
(possibly edited or animated) triangles. The state is a `gs_flat`-style param
dict, typically loaded from a PLY; the soup carries the geometry from then on.
"""
from __future__ import annotations

import torch

from ..core.face_frames import gaussians_to_pseudomesh, soup_scaling_rotation_quat
from . import vanilla
from .flat import EPS_S0, flat_scaling
from .gaussian_bag import GaussianBag, features_to_shs


def pseudomesh_from_state(state: dict) -> torch.Tensor:
    """Flat-Gaussian params -> (N, 3, 3) triangle soup."""
    p = state["params"]
    return gaussians_to_pseudomesh(
        p["xyz"], flat_scaling(p["scaling"]), vanilla.unit_rotation(p["rotation"]))


def to_bag(state: dict, triangles: torch.Tensor | None = None) -> GaussianBag:
    """Render Gaussians derived from a triangle soup (the state's own
    pseudomesh unless `triangles` is given): xyz = the first soup vertex,
    scaling and rotation from the triangle."""
    p = state["params"]
    if triangles is None:
        triangles = pseudomesh_from_state(state)
    n = triangles.shape[0]
    scales2, quats = soup_scaling_rotation_quat(triangles, eps=1e-8)
    s0 = torch.full((n, 1), EPS_S0, dtype=torch.float32, device=triangles.device)
    return GaussianBag(
        xyz=triangles[:, 0],
        scaling=torch.cat([s0, scales2], dim=1),
        rotation=quats,
        opacity=torch.sigmoid(p["opacity"]),
        shs=features_to_shs(p["f_dc"], p["f_rest"]),
        alive=state["alive"],
    )
