"""`gs_mesh`: GaMeS mesh-face Gaussian parameterization.

Port of `gaussian_mesh_splatting_tpu/models/mesh.py`. Every Gaussian lives on
a mesh face:
  * center = alpha-combination of the face's 3 vertices, with
    alpha = normalize(relu(raw_alpha) + 1e-8) per splat;
  * scale = relu(per-splat scalar * face extents) + eps, the face extents
    being [eps, |centroid->v1|/2, <v2_init, v2>/2];
  * rotation = face frame (normal, v1, v2) as a quaternion.
Passing `triangles=` to `to_bag` deforms the mesh (the animation path).

State: {"params": {vertices (V,3), alpha (F,S,3), scale (N,1), f_dc (N,1,3),
f_rest (N,K-1,3), opacity (N,1)}, "consts": {"faces": (F,3)}, "alive": (N,)}.
"""
from __future__ import annotations

import torch

from ..core.face_frames import face_scaling_rotation_quat
from ..core.sh import rgb_to_sh
from ..core.transforms import inverse_sigmoid
from .gaussian_bag import GaussianBag, features_to_shs

EPS_S0 = 1e-8
ALPHA_EPS = 1e-8


def init_from_mesh(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    alpha: torch.Tensor,
    colors: torch.Tensor,
    sh_degree: int = 3,
) -> dict:
    """Raw params from a mesh + per-splat barycentric seeds, on the device
    of `vertices`.

    Args:
      vertices: (V, 3) float, already in scene axes.
      faces: (F, 3) int vertex indices.
      alpha: (F, S, 3) raw barycentric weights.
      colors: (F*S, 3) RGB in [0,1] for the SH DC init.
    """
    f, s, _ = alpha.shape
    n = f * s
    k = (sh_degree + 1) ** 2
    dev = vertices.device
    params = {
        "vertices": vertices.to(torch.float32),
        "alpha": alpha.to(dev, torch.float32),
        "scale": torch.ones((n, 1), dtype=torch.float32, device=dev),
        "f_dc": rgb_to_sh(colors.to(dev, torch.float32))[:, None, :],
        "f_rest": torch.zeros((n, k - 1, 3), dtype=torch.float32, device=dev),
        "opacity": inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32, device=dev)),
    }
    consts = {"faces": faces.to(dev, torch.int64)}
    return {
        "params": params,
        "consts": consts,
        "alive": torch.ones((n,), dtype=torch.bool, device=dev),
    }


def normalized_alpha(raw_alpha: torch.Tensor) -> torch.Tensor:
    """relu + eps, normalized over the barycentric axis."""
    a = torch.relu(raw_alpha) + ALPHA_EPS
    return a / torch.sum(a, dim=-1, keepdim=True)


def to_bag(state: dict, triangles: torch.Tensor | None = None) -> GaussianBag:
    """Derive render-ready Gaussians.

    Args:
      triangles: optional (F, 3, 3) override of `vertices[faces]` (the
        mesh-animation hook). When given, vertices are ignored.
    """
    p = state["params"]
    if triangles is None:
        triangles = p["vertices"][state["consts"]["faces"].long()]  # (F, 3, 3)
    alpha = normalized_alpha(p["alpha"])  # (F, S, 3)
    f, s, _ = alpha.shape
    n = f * s

    xyz = torch.einsum("fsa,fad->fsd", alpha, triangles).reshape(n, 3)

    face_scales, face_quats = face_scaling_rotation_quat(triangles, EPS_S0)
    scales_b = face_scales[:, None, :].expand(f, s, 3).reshape(n, 3)
    scaling = torch.relu(p["scale"] * scales_b) + EPS_S0
    rotation = face_quats[:, None, :].expand(f, s, 4).reshape(n, 4)

    return GaussianBag(
        xyz=xyz,
        scaling=scaling,
        rotation=rotation,
        opacity=torch.sigmoid(p["opacity"]),
        shs=features_to_shs(p["f_dc"], p["f_rest"]),
        alive=state["alive"],
    )
