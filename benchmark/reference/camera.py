"""Pinhole camera matrices of the 3DGS convention, from a view's (R, T) and
fields of view: R is the camera-to-world rotation of the COLMAP axes, T the
world-to-view translation, column-vector matrices, and a projection that maps
view z into [0, zfar]."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0


@dataclasses.dataclass(frozen=True)
class View:
    world_view: torch.Tensor  # (4, 4)
    full_proj: torch.Tensor  # (4, 4) projection @ world_view
    center: torch.Tensor  # (3,)
    tan_x: float
    tan_y: float
    width: int
    height: int

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_x)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_y)


def make_view(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float, width: int, height: int,
              device) -> View:
    w2v = np.eye(4)
    w2v[:3, :3] = np.asarray(R, np.float64).T
    w2v[:3, 3] = np.asarray(T, np.float64)
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1], proj[3, 2] = 1.0 / tx, 1.0 / ty, 1.0
    proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
    proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    center = np.linalg.inv(w2v)[:3, 3]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return View(f32(w2v), f32(proj @ w2v), f32(center), tx, ty, int(width), int(height))
