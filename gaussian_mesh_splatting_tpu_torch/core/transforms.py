"""Rotation / covariance primitives on torch tensors.

Port of `gaussian_mesh_splatting_tpu/core/transforms.py`, same conventions:
  - quaternions are real part first (w, x, y, z);
  - matrix -> quaternion builds all four candidates, keeps the one keyed by
    the largest |q| component and standardizes to a non-negative real part;
  - covariance Sigma = R S S^T R^T, compressed to the 6 upper-triangular
    entries (xx, xy, xz, yy, yz, zz).
All functions take leading batch dimensions.
"""
from __future__ import annotations

import torch

from ..utils.profiling import count


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real (first) component is non-negative. (..., 4)."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def quat_normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize quaternions to unit length. (..., 4)."""
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4), normalized here, -> rotation matrices (..., 3, 3)."""
    q = quat_normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(*q.shape[:-1], 3, 3)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x <= 0."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.sqrt(safe), torch.zeros_like(x))


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4), real part first."""
    batch_shape = rot.shape[:-2]
    m = rot.reshape(-1, 9)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)

    q_abs = _sqrt_positive_part(
        torch.stack(
            [
                1.0 + m00 + m11 + m22,
                1.0 + m00 - m11 - m22,
                1.0 - m00 + m11 - m22,
                1.0 - m00 - m11 + m22,
            ],
            dim=-1,
        )
    )
    # candidate quaternions, each scaled by a different q component
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[:, 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[:, 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[:, 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[:, 3] ** 2], dim=-1),
        ],
        dim=-2,
    )  # (B, 4 candidates, 4)
    # a copy from host memory: on a card the host waits for the stream
    floor = q_abs.new_tensor(0.1)
    count("host_syncs")
    quat_candidates = quat_by_rijk / (2.0 * torch.maximum(q_abs[..., None], floor))
    best = torch.argmax(q_abs, dim=-1)
    out = torch.take_along_dim(quat_candidates, best[:, None, None], dim=-2)[:, 0, :]
    return standardize_quaternion(out).reshape(*batch_shape, 4)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): (..., 3) scales + (..., 4) quats -> (..., 3, 3)."""
    return quat_to_rotmat(q) * s[..., None, :]


def strip_symmetric(sym: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) upper triangle (xx,xy,xz,yy,yz,zz)."""
    return torch.stack(
        [
            sym[..., 0, 0], sym[..., 0, 1], sym[..., 0, 2],
            sym[..., 1, 1], sym[..., 1, 2], sym[..., 2, 2],
        ],
        dim=-1,
    )


def unstrip_symmetric(six: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) symmetric. Inverse of strip_symmetric."""
    xx, xy, xz, yy, yz, zz = six.unbind(-1)
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def covariance_from_scaling_rotation(
    scaling: torch.Tensor, scaling_modifier: float, q: torch.Tensor
) -> torch.Tensor:
    """Sigma = (R S)(R S)^T compressed to 6 floats."""
    L = build_scaling_rotation(scaling_modifier * scaling, q)
    return strip_symmetric(L @ L.transpose(-1, -2))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))
