"""GaMeS Gaussians from raw parameters (arXiv 2402.01459): a Gaussian on a
mesh face is an alpha-combination of the face's vertices, flat along the
face normal, its in-plane extents and orientation taken from the face's
frame. How a kind gets its vertices and weights is in
`reference/models/<kind>.py`.

A bag is a dict: xyz (N, 3), rot (N, 3, 3) with the frame's axes as
columns, scale (N, 3), opacity (N,), sh (N, K, 3), of the live rows alone:
a kind whose rows are a buffer (some dead) gives a row each, and `bag_for`
drops the dead."""
from __future__ import annotations

import importlib

import torch

EPS = 1e-8


def face_frames(tri: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, 3, 3) triangles -> (rotation (F, 3, 3), extents (F, 3)): axes
    normal, centroid -> vertex 1, and the Gram-Schmidt of centroid -> vertex
    2; extents eps, |centroid -> v1| / 2, <centroid -> v2, axis 3> / 2."""
    def unit(v):
        return v / (torch.sqrt((v * v).sum(-1, keepdim=True) + EPS * EPS) + EPS)

    normal = unit(torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    centroid = tri.mean(dim=1)
    e1 = tri[:, 1] - centroid
    len1 = torch.sqrt((e1 * e1).sum(-1, keepdim=True) + EPS * EPS) + EPS
    a1 = e1 / len1
    e2 = tri[:, 2] - centroid
    a2 = unit(e2 - (e2 * normal).sum(-1, keepdim=True) * normal
              - (e2 * a1).sum(-1, keepdim=True) * a1)
    extents = torch.cat([torch.full_like(len1, EPS), len1 / 2, (e2 * a2).sum(-1, keepdim=True) / 2],
                        dim=-1)
    return torch.stack([normal, a1, a2], dim=-1), extents


def gaussians_on_faces(tri: torch.Tensor, weights: torch.Tensor, p: dict) -> dict:
    f, s, _ = weights.shape
    rot, extents = face_frames(tri)
    return {
        "xyz": torch.einsum("fsa,fad->fsd", weights, tri).reshape(f * s, 3),
        "rot": rot[:, None].expand(f, s, 3, 3).reshape(f * s, 3, 3),
        "scale": torch.relu(p["scale"] * extents[:, None].expand(f, s, 3).reshape(f * s, 3)) + EPS,
        "opacity": torch.sigmoid(p["opacity"][:, 0]),
        "sh": torch.cat([p["f_dc"], p["f_rest"]], dim=1),
    }


def bag_for(kind: str, p: dict, faces: torch.Tensor, rig: dict | None,
            alive: torch.Tensor) -> dict:
    """The bag of the model of `kind`, from `reference/models/<kind>.py`: the
    Gaussians of the rows that `alive` marks (every row of a mesh kind)."""
    bag = importlib.import_module(f".{kind}", __name__).bag(p, faces, rig)
    if bool(alive.all()):
        return bag
    return {k: v[alive] for k, v in bag.items()}
