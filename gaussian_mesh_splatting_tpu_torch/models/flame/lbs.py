"""Linear blend skinning in PyTorch (port of
`gaussian_mesh_splatting_tpu/models/flame/lbs.py`, the smplx `lbs`
pipeline that the FLAME decoder runs):

  1. shape/expression blendshapes:  v_shaped = T + shapedirs . betas
  2. joints:                        J = J_regressor @ v_shaped
  3. pose correctives:              v_posed = v_shaped + posedirs . (R - I)
  4. forward kinematics over the joint tree (relative -> global transforms)
  5. skinning:                      v = sum_j w_j A_j v_posed

Batched over the leading dim and differentiable in every input: pixel
gradients reach the shape, expression and pose parameters. The products are
float32 `torch.einsum` / `torch.matmul` (the callers keep TF32 off).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LbsModel(NamedTuple):
    """The rig's static (non-trainable) tensors."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, B) shape+expression basis
    posedirs: torch.Tensor  # (P, V*3) pose-corrective basis (P = 9*(J-1))
    j_regressor: torch.Tensor  # (J, V)
    parents: torch.Tensor  # (J,) int64; parents[0] == -1 (root)
    lbs_weights: torch.Tensor  # (V, J)
    faces: torch.Tensor  # (F, 3) int64


def batch_rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3). The eps sits inside
    the norm, which keeps the zero rotation differentiable."""
    angle = torch.linalg.vector_norm(rot_vecs + eps, dim=-1, keepdim=True)  # (N, 1)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]  # (N, 1, 1)
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(*rot_vecs.shape[:-1], 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1 - cos) * (K @ K)


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor) -> torch.Tensor:
    """(B, num_betas) x (V, 3, num_betas) -> (B, V, 3)."""
    return torch.einsum("bl,mkl->bmk", betas, shape_dirs)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("jv,bvk->bjk", j_regressor, vertices)


def _with_zeros(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3, 1) -> (..., 4, 4) homogeneous."""
    top = torch.cat([R, t], dim=-1)  # (..., 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(*R.shape[:-2], 1, 4)], dim=-2)


def batch_rigid_transform(
    rot_mats: torch.Tensor, joints: torch.Tensor, parents
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics.

    Args:
      rot_mats: (B, J, 3, 3) per-joint relative rotations.
      joints: (B, J, 3) rest-pose joint locations.
      parents: a static sequence of J parent indices, parents[0] == -1: the
        tiny joint tree (J = 5 for FLAME) unrolls into straight-line code.
    Returns:
      (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4)), the transforms
      mapping rest-pose-relative offsets (smplx convention).
    """
    parents = tuple(int(p) for p in parents)
    J = joints.shape[1]
    parent_idx = torch.tensor([max(p, 0) for p in parents], device=joints.device)
    has_parent = torch.tensor([p >= 0 for p in parents], device=joints.device)[None, :, None]
    rel_joints = joints - torch.where(has_parent, joints[:, parent_idx], 0.0)
    local = _with_zeros(rot_mats, rel_joints[..., None])  # (B, J, 4, 4)

    transforms = [local[:, 0]]
    for j in range(1, J):
        transforms.append(transforms[parents[j]] @ local[:, j])
    A = torch.stack(transforms, dim=1)  # (B, J, 4, 4)

    posed_joints = A[..., :3, 3]
    # remove the rest-pose joint's contribution: A_rel = A - [0 | A[:3,:3] @ J]
    correction = (A[..., :3, :3] @ joints[..., None])[..., 0]  # (B, J, 3)
    A_rel = torch.cat([A[..., :3, :3], (A[..., :3, 3] - correction)[..., None]], dim=-1)
    A_rel = torch.cat([A_rel, A[..., 3:, :]], dim=-2)
    return posed_joints, A_rel


def lbs(
    betas: torch.Tensor,
    pose: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    j_regressor: torch.Tensor,
    parents,
    lbs_weights: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """smplx-style LBS.

    Args:
      betas: (B, num_betas); pose: (B, J*3) axis-angle incl. the root.
      v_template: (B, V, 3) or (V, 3).
      parents: the static parents sequence (see `batch_rigid_transform`).
    Returns:
      (vertices (B, V, 3), joints (B, J, 3))
    """
    B = betas.shape[0]
    if v_template.ndim == 2:
        v_template = v_template[None].expand(B, *v_template.shape)

    v_shaped = v_template + blend_shapes(betas, shapedirs)
    J = vertices2joints(j_regressor, v_shaped)

    n_joints = J.shape[1]
    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, n_joints, 3, 3)
    ident = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)  # (B, 9*(J-1))
    pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, A = batch_rigid_transform(rot_mats, J, parents)

    T = torch.einsum("vj,bjmn->bvmn", lbs_weights, A)  # (B, V, 4, 4)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = (T @ v_hom[..., None])[..., :3, 0]
    return verts, posed_joints


def vertices2landmarks(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    lmk_faces_idx: torch.Tensor,
    lmk_bary_coords: torch.Tensor,
) -> torch.Tensor:
    """(B, V, 3), (F, 3), (B, L), (B, L, 3) -> (B, L, 3). Vertex indices are
    taken modulo V, as the JAX package's gather does."""
    lmk_faces = faces[lmk_faces_idx.long()].long() % vertices.shape[1]  # (B, L, 3)
    batch = torch.arange(vertices.shape[0], device=vertices.device)[:, None, None]
    lmk_vertices = vertices[batch, lmk_faces]  # (B, L, 3, 3)
    return torch.einsum("blfi,blf->bli", lmk_vertices, lmk_bary_coords)
