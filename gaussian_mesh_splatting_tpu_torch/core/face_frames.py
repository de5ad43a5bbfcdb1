"""Mesh-face local frames for `gs_mesh` (GaMeS parameterization).

Port of `face_frames` / `face_scaling_rotation_quat` from
`gaussian_mesh_splatting_tpu/core/face_frames.py`: triangles -> per-face
orthonormal frame (normal, centroid->v1, Gram-Schmidt of centroid->v2) and
in-plane extents, from which Gaussian scale and rotation are derived.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .transforms import rotmat_to_quat


class FaceFrame(NamedTuple):
    scales: torch.Tensor  # (F, 3) [eps, s1, s2] in-face extents
    rotation: torch.Tensor  # (F, 3, 3) rotation; columns = frame axes


def _dot(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * u, dim=-1, keepdim=True)


def _safe_norm(v: torch.Tensor, eps: float) -> torch.Tensor:
    """||v|| + eps with a NaN-free gradient at v == 0 (degenerate faces)."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps) + eps


def _normalize(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / _safe_norm(v, eps)


def face_frames(triangles: torch.Tensor, eps: float = 1e-8) -> FaceFrame:
    """Centroid-based face frame.

    Frame axes: v0 = face normal; v1 = direction centroid -> vertex 1;
    v2 = Gram-Schmidt of (centroid -> vertex 2) against {v0, v1}.
    Extents: s0 = eps (flat), s1 = |centroid->v1| / 2, s2 = <v2_init, v2> / 2.

    Args:
      triangles: (F, 3, 3) face vertex positions.
    Returns:
      FaceFrame(scales (F,3), rotation (F,3,3)) with rotation columns
      (v0, v1, v2).
    """
    normals = torch.linalg.cross(
        triangles[:, 1] - triangles[:, 0], triangles[:, 2] - triangles[:, 0]
    )
    v0 = _normalize(normals, eps)
    means = torch.mean(triangles, dim=1)
    v1_raw = triangles[:, 1] - means
    v1_norm = _safe_norm(v1_raw, eps)
    v1 = v1_raw / v1_norm
    v2_init = triangles[:, 2] - means
    v2 = v2_init - _dot(v2_init, v0) * v0 - _dot(v2_init, v1) * v1
    v2 = _normalize(v2, eps)

    s1 = v1_norm / 2.0
    s2 = _dot(v2_init, v2) / 2.0
    s0 = torch.full_like(s1, eps)
    scales = torch.cat([s0, s1, s2], dim=-1)
    rotation = torch.stack([v0, v1, v2], dim=1).transpose(-2, -1)
    return FaceFrame(scales=scales, rotation=rotation)


def face_scaling_rotation_quat(
    triangles: torch.Tensor, eps: float = 1e-8
) -> tuple[torch.Tensor, torch.Tensor]:
    """`face_frames` + quaternion conversion: ((F,3) scales, (F,4) quats)."""
    frame = face_frames(triangles, eps)
    return frame.scales, rotmat_to_quat(frame.rotation)
