"""Scene orchestrator (port of `gaussian_mesh_splatting_tpu/scene/__init__.py`):
detect the dataset type from the files on disk and the gs_type, run the
matching reader, build the camera lists, and build the initial model state.
Only the Blender and Blender_Mesh formats are ported so far."""
from __future__ import annotations

import os
import random

import torch

from ..device import resolve_device
from .cameras import camera_list
from .dataset_readers import SCENE_LOAD_CALLBACKS, MeshPointCloud, SceneInfo


def detect_scene_type(source_path: str, gs_type: str) -> str:
    if os.path.exists(os.path.join(source_path, "sparse")):
        raise NotImplementedError(f"COLMAP scenes are not ported yet: {source_path}")
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        if gs_type == "gs_mesh":
            return "Blender_Mesh"
        if gs_type == "gs_flame":
            raise NotImplementedError("Blender_FLAME scenes are not ported yet")
        return "Blender"
    raise ValueError(f"could not recognize scene type in {source_path}")


class Scene:
    """Host-side scene: cameras (on `device`) + the initial model state."""

    def __init__(
        self,
        source_path: str,
        gs_type: str = "gs",
        *,
        white_background: bool = False,
        eval: bool = False,
        resolution: int = -1,
        num_splats: int = 2,
        shuffle: bool = True,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.gs_type = gs_type
        self.device = resolve_device(device)
        scene_type = detect_scene_type(source_path, gs_type)
        reader = SCENE_LOAD_CALLBACKS[scene_type]
        if scene_type == "Blender_Mesh":
            info: SceneInfo = reader(source_path, white_background, eval, num_splats)
        else:
            info = reader(source_path, white_background, eval)
        self.scene_info = info
        if shuffle:
            random.Random(seed).shuffle(info.train_cameras)
        self.train_cameras = camera_list(info.train_cameras, resolution, device=self.device)
        self.test_cameras = camera_list(info.test_cameras, resolution, device=self.device)

    def init_model_state(self, model, sh_degree: int = 3) -> dict:
        """The initial param state for this scene's gs_type."""
        pcd = self.scene_info.point_cloud
        if not isinstance(pcd, MeshPointCloud):
            raise NotImplementedError(
                f"initial state for gs_type {self.gs_type!r} is not ported yet"
            )

        def t(x):
            return torch.as_tensor(x, device=self.device)

        return model.init_from_mesh(
            t(pcd.vertices), t(pcd.faces), t(pcd.alpha), t(pcd.colors),
            sh_degree=sh_degree,
        )
