"""Pinhole projective cameras.

Port of `gaussian_mesh_splatting_tpu/core/camera.py`. Matrices are in math
(column-vector) convention, ``p' = M @ p_hom``; ``R`` is the camera-to-world
rotation and ``T`` the world-to-view translation; the projection maps
view-space z into [0, zfar] with z_sign = +1. The host-side matrix builders
run in numpy (float64, stored as float32), exactly as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """4x4 world->view matrix (column-vector convention), optionally
    re-centring and rescaling the camera position in world space."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, z mapped to [0, zfar]."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_half_fovx
    P[1, 1] = 1.0 / tan_half_fovy
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """One pinhole camera. Tensor fields are float32 on one device; the
    scalar fields are 0-d tensors so that arithmetic with them stays in
    float32, as in the JAX package."""

    world_view: torch.Tensor  # (4,4) world -> view
    full_proj: torch.Tensor  # (4,4) = proj @ world_view
    cam_center: torch.Tensor  # (3,) camera position in world space
    tanfovx: torch.Tensor  # 0-d
    tanfovy: torch.Tensor  # 0-d
    znear: torch.Tensor  # 0-d
    zfar: torch.Tensor  # 0-d
    width: int = 0
    height: int = 0

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tanfovy)


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    trans: np.ndarray | None = None,
    scale: float = 1.0,
    *,
    device: str | torch.device | None = None,
) -> Camera:
    """Build a Camera from reference-convention extrinsics (see module doc)."""
    dev = resolve_device(device)
    W = world_to_view(R, T, trans, scale)
    P = projection_matrix(znear, zfar, fovx, fovy)
    full = (P @ W).astype(np.float32)
    center = np.linalg.inv(W.astype(np.float64))[:3, 3].astype(np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return Camera(
        world_view=f32(W),
        full_proj=f32(full),
        cam_center=f32(center),
        tanfovx=f32(math.tan(fovx / 2)),
        tanfovy=f32(math.tan(fovy / 2)),
        znear=f32(znear),
        zfar=f32(zfar),
        width=int(width),
        height=int(height),
    )
