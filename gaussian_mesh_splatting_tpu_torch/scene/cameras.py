"""Camera list construction: resolution policy + GT image preparation
(port of `gaussian_mesh_splatting_tpu/scene/cameras.py`).

Produces (Camera, gt_image) pairs; GT images stay float32 (H, W, 3) numpy
arrays on the host."""
from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera, fov2focal, make_camera, world_to_view
from .dataset_readers import CameraInfo


def resolve_resolution(width: int, height: int, resolution: int) -> tuple[int, int]:
    """-1 = native, auto-downscale beyond 1.6K wide; 1/2/4/8 = divide;
    any other value is the target width."""
    if resolution in (1, 2, 4, 8):
        scale = float(resolution)
    elif resolution == -1:
        scale = width / 1600 if width > 1600 else 1.0
    else:
        scale = width / resolution
    return round(width / scale), round(height / scale)


def _resize(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    w, h = size
    if image.shape[1] == w and image.shape[0] == h:
        return image
    from PIL import Image

    im = Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8))
    return np.asarray(im.resize((w, h)), dtype=np.float32) / 255.0


def load_camera(
    info: CameraInfo,
    resolution: int = -1,
    znear: float = 0.01,
    zfar: float = 100.0,
    *,
    device: str | torch.device | None = None,
) -> tuple[Camera, np.ndarray]:
    orig_h, orig_w = info.image.shape[:2]
    w, h = resolve_resolution(orig_w, orig_h, resolution)
    gt = _resize(info.image, (w, h))
    if info.alpha_mask is not None:
        mask = _resize(np.repeat(info.alpha_mask, 3, axis=2), (w, h))
        gt = gt * mask
    cam = make_camera(
        info.R, info.T, info.fovx, info.fovy, w, h, znear=znear, zfar=zfar,
        device=device,
    )
    return cam, np.clip(gt, 0.0, 1.0)


def camera_list(
    infos: list[CameraInfo], resolution: int = -1, *, device=None
) -> list[tuple[Camera, np.ndarray]]:
    return [load_camera(i, resolution, device=device) for i in infos]


def camera_to_json(uid: int, info: CameraInfo) -> dict:
    """cameras.json entry for viewer interop (reference
    utils/camera_utils.py:62-82)."""
    W2C = world_to_view(info.R, info.T)
    C2W = np.linalg.inv(W2C)
    return {
        "id": uid,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": C2W[:3, 3].tolist(),
        "rotation": [x.tolist() for x in C2W[:3, :3]],
        "fy": fov2focal(info.fovy, info.height),
        "fx": fov2focal(info.fovx, info.width),
    }
