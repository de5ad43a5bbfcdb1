"""`gs_multi_mesh`: the gs_mesh parameterization, once per mesh (port of
`gaussian_mesh_splatting_tpu/models/multi_mesh.py`).

The per-mesh trainables are lists of tensors (vertices[i] (V_i,3), alpha[i]
(F_i,S_i,3), scale[i] (N_i,1)), the appearance params single tensors over
the Gaussians of all meshes; each top-level key is one optimizer group.
`to_bag` concatenates the per-mesh derived attributes in mesh order.

State: {"params": {vertices [..], alpha [..], scale [..], f_dc (N,1,3),
f_rest (N,K-1,3), opacity (N,1)}, "consts": {"faces": [(F_i,3) int64]},
"alive": (N,)}.
"""
from __future__ import annotations

import torch

from ..core.face_frames import face_scaling_rotation_quat
from ..core.sh import rgb_to_sh
from ..core.transforms import inverse_sigmoid
from .gaussian_bag import GaussianBag, features_to_shs
from .mesh import EPS_S0, normalized_alpha


def init_from_meshes(
    vertices_list: list[torch.Tensor],
    faces_list: list[torch.Tensor],
    alpha_list: list[torch.Tensor],
    colors: torch.Tensor,
    sh_degree: int = 3,
) -> dict:
    """`mesh.init_from_mesh`, per mesh, on the device of the first mesh's
    vertices; `colors` covers the splats of all meshes in order."""
    counts = [a.shape[0] * a.shape[1] for a in alpha_list]
    n = sum(counts)
    if colors.shape[0] != n:
        raise ValueError(f"{colors.shape[0]} colours for {n} splats")
    k = (sh_degree + 1) ** 2
    dev = vertices_list[0].device
    params = {
        "vertices": [v.to(dev, torch.float32) for v in vertices_list],
        "alpha": [a.to(dev, torch.float32) for a in alpha_list],
        "scale": [torch.ones((c, 1), dtype=torch.float32, device=dev) for c in counts],
        "f_dc": rgb_to_sh(colors.to(dev, torch.float32))[:, None, :],
        "f_rest": torch.zeros((n, k - 1, 3), dtype=torch.float32, device=dev),
        "opacity": inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32, device=dev)),
    }
    consts = {"faces": [f.to(dev, torch.int64) for f in faces_list]}
    return {
        "params": params,
        "consts": consts,
        "alive": torch.ones((n,), dtype=torch.bool, device=dev),
    }


def to_bag(state: dict, triangles_list: list[torch.Tensor] | None = None) -> GaussianBag:
    """Derive render-ready Gaussians; `triangles_list` overrides each mesh's
    `vertices[faces]` (the animation hook)."""
    p = state["params"]
    xyzs, scalings, rotations = [], [], []
    for i, (alpha_raw, faces) in enumerate(zip(p["alpha"], state["consts"]["faces"])):
        if triangles_list is None:
            triangles = p["vertices"][i][faces.long()]
        else:
            triangles = triangles_list[i]
        alpha = normalized_alpha(alpha_raw)
        f, s, _ = alpha.shape
        n_i = f * s
        xyzs.append(torch.einsum("fsa,fad->fsd", alpha, triangles).reshape(n_i, 3))
        face_scales, face_quats = face_scaling_rotation_quat(triangles, EPS_S0)
        scales_b = face_scales[:, None, :].expand(f, s, 3).reshape(n_i, 3)
        scalings.append(torch.relu(p["scale"][i] * scales_b) + EPS_S0)
        rotations.append(face_quats[:, None, :].expand(f, s, 4).reshape(n_i, 4))

    return GaussianBag(
        xyz=torch.cat(xyzs, dim=0),
        scaling=torch.cat(scalings, dim=0),
        rotation=torch.cat(rotations, dim=0),
        opacity=torch.sigmoid(p["opacity"]),
        shs=features_to_shs(p["f_dc"], p["f_rest"]),
        alive=state["alive"],
    )
