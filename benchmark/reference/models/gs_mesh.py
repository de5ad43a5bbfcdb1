"""`gs_mesh`: the mesh's own vertices, the weights relu(alpha) + 1e-8
normalized over the three."""
import torch

from . import EPS, gaussians_on_faces


def bag(p: dict, faces: torch.Tensor, rig=None) -> dict:
    a = torch.relu(p["alpha"]) + EPS
    return gaussians_on_faces(p["vertices"][faces], a / a.sum(-1, keepdim=True), p)
