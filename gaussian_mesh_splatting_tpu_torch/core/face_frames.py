"""Mesh-face local frames (port of
`gaussian_mesh_splatting_tpu/core/face_frames.py`), in two directions:

  * forward (`face_frames` for `gs_mesh`, centroid-based; `soup_frames` for
    `gs_points` triangle soups, vertex-origin): triangles -> per-face
    orthonormal frame and in-plane extents, from which Gaussian scale and
    rotation are derived;
  * inverse (`gaussians_to_pseudomesh`): flat Gaussians -> a triangle soup
    (one triangle per Gaussian), the render-only `gs_points` parameterization.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .transforms import quat_to_rotmat, rotmat_to_quat


class FaceFrame(NamedTuple):
    scales: torch.Tensor  # (F, 3) [eps, s1, s2] in-face extents; (F, 2) for soups
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


def soup_frames(triangles: torch.Tensor, eps: float = 1e-8) -> FaceFrame:
    """Vertex-origin frame of a `gs_points` triangle soup.

    Edges from vertex 1: e2 = v2 - v1, e3 = v3 - v1. Frame: r1 = normal,
    r2 = e2 direction, r3 = Gram-Schmidt of e3. Extents: s2 = |e2|,
    s3 = <e3, r3> (full lengths, not halves: the inverse map's convention,
    so that a round trip is exact).

    Returns:
      FaceFrame(scales (F, 2) = [s2, s3], rotation (F, 3, 3) with columns
      (r1, r2, r3)); the model layer prepends the flat eps axis.
    """
    v1, v2, v3 = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    e2 = v2 - v1
    e3 = v3 - v1
    r1 = _normalize(torch.linalg.cross(e2, e3), eps)
    s2 = _safe_norm(e2, eps)
    r2 = e2 / s2
    r3 = e3 - _dot(e3, r1) * r1 - _dot(e3, r2) * r2
    r3 = _normalize(r3, eps)
    s3 = _dot(e3, r3)
    scales = torch.cat([s2, s3], dim=-1)
    rotation = torch.stack([r1, r2, r3], dim=1).transpose(-2, -1)
    return FaceFrame(scales=scales, rotation=rotation)


def gaussians_to_pseudomesh(
    xyz: torch.Tensor, scaling: torch.Tensor, rotation_q: torch.Tensor
) -> torch.Tensor:
    """Inverse parameterization: flat Gaussians -> triangle soup.

    v1 = centre; v2 = centre + s_major * axis_major; v3 = centre + s_minor *
    axis_minor, the larger in-plane axis first.

    Args:
      xyz: (N, 3) centres.
      scaling: (N, 3) activated scales; the last two are the in-plane axes.
      rotation_q: (N, 4) quaternions (w, x, y, z).
    Returns:
      (N, 3, 3) triangles.
    """
    axes = quat_to_rotmat(rotation_q).transpose(-2, -1)  # rows = the frame's axes
    s2 = scaling[:, -2:-1]
    s3 = scaling[:, -1:]
    cand2 = xyz + s2 * axes[:, 1]
    cand3 = xyz + s3 * axes[:, 2]
    swap = s2 > s3  # (N, 1)
    v2 = torch.where(swap, cand2, cand3)
    v3 = torch.where(swap, cand3, cand2)
    return torch.stack([xyz, v2, v3], dim=1)


def face_scaling_rotation_quat(
    triangles: torch.Tensor, eps: float = 1e-8
) -> tuple[torch.Tensor, torch.Tensor]:
    """`face_frames` + quaternion conversion: ((F,3) scales, (F,4) quats)."""
    frame = face_frames(triangles, eps)
    return frame.scales, rotmat_to_quat(frame.rotation)


def soup_scaling_rotation_quat(
    triangles: torch.Tensor, eps: float = 1e-8
) -> tuple[torch.Tensor, torch.Tensor]:
    """`soup_frames` + quaternion conversion: ((F,2) |scales|, (F,4) quats)."""
    frame = soup_frames(triangles, eps)
    return torch.abs(frame.scales), rotmat_to_quat(frame.rotation)
