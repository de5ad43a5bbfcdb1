"""Scene orchestrator (port of `gaussian_mesh_splatting_tpu/scene/__init__.py`):
detect the dataset type from the files on disk and the gs_type, run the
matching reader, build the camera lists, and build the initial model state.
With a `model_path` it also writes the model directory's `input.ply` (the
initial point cloud) and `cameras.json`. Scene types: Colmap and Blender (a
plain point cloud, for `gs`, `gs_flat` and `gs_points`), Blender_Mesh
(`gs_mesh`), Colmap_Mesh (`gs_multi_mesh`) and Blender_FLAME (`gs_flame`)."""
from __future__ import annotations

import json
import os
import random
import shutil

import torch

from ..device import resolve_device
from .cameras import camera_list, camera_to_json
from .dataset_readers import (
    SCENE_LOAD_CALLBACKS,
    FlamePointCloud,
    MeshPointCloud,
    MultiMeshPointCloud,
    SceneInfo,
)


def detect_scene_type(source_path: str, gs_type: str) -> str:
    """The scene type from the files in `source_path` and the gs_type."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return "Colmap_Mesh" if gs_type == "gs_multi_mesh" else "Colmap"
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        if gs_type == "gs_mesh":
            return "Blender_Mesh"
        if gs_type == "gs_flame":
            return "Blender_FLAME"
        return "Blender"
    raise ValueError(f"could not recognize scene type in {source_path}")


class Scene:
    """Host-side scene: cameras (on `device`) + the initial model state.

    `images` names the COLMAP image directory (e.g. `images_2` for a set
    downscaled beforehand); `meshes` the Colmap_Mesh meshes; `flame_rig` the
    FLAME rig that a Blender_FLAME scene decodes its head with."""

    def __init__(
        self,
        source_path: str,
        gs_type: str = "gs",
        *,
        model_path: str | None = None,
        white_background: bool = False,
        eval: bool = False,
        resolution: int = -1,
        images: str | None = None,
        num_splats: int = 2,
        meshes: list[str] | None = None,
        flame_rig=None,
        shuffle: bool = True,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.gs_type = gs_type
        self.device = resolve_device(device)
        scene_type = detect_scene_type(source_path, gs_type)
        if gs_type == "gs_multi_mesh" and scene_type != "Colmap_Mesh":
            raise ValueError(f"gs_multi_mesh needs a COLMAP dataset with meshes "
                             f"(sparse/0/*.obj); {source_path} is a {scene_type} dataset")
        reader = SCENE_LOAD_CALLBACKS[scene_type]
        if scene_type == "Blender_Mesh":
            info: SceneInfo = reader(source_path, white_background, eval, num_splats)
        elif scene_type == "Colmap_Mesh":
            info = reader(source_path, images, eval, num_splats, meshes)
        elif scene_type == "Blender_FLAME":
            if flame_rig is None:
                raise ValueError("a Blender_FLAME scene needs a FLAME rig (flame_rig=)")
            info = reader(source_path, white_background, eval, flame_rig)
        elif scene_type == "Colmap":
            info = reader(source_path, images, eval)
        else:
            info = reader(source_path, white_background, eval)
        self.scene_info = info
        self.cameras_extent = float(info.nerf_normalization["radius"])

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            if os.path.exists(info.ply_path):
                shutil.copyfile(info.ply_path, os.path.join(model_path, "input.ply"))
            cams_json = [
                camera_to_json(i, c)
                for i, c in enumerate(info.train_cameras + info.test_cameras)
            ]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cams_json, f)

        if shuffle:
            random.Random(seed).shuffle(info.train_cameras)
        self.train_cameras = camera_list(info.train_cameras, resolution, device=self.device)
        self.test_cameras = camera_list(info.test_cameras, resolution, device=self.device)

    def init_model_state(self, model, sh_degree: int = 3, capacity: int | None = None) -> dict:
        """The initial param state for this scene's gs_type. `capacity` pads
        a point-cloud model's buffers for densification; the mesh models have
        one Gaussian row per splat and ignore it."""
        pcd = self.scene_info.point_cloud

        def t(x):
            return torch.as_tensor(x, device=self.device)

        if isinstance(pcd, MultiMeshPointCloud):
            return model.init_from_meshes(
                [t(v) for v in pcd.vertices], [t(f) for f in pcd.faces],
                [t(a) for a in pcd.alpha], t(pcd.colors), sh_degree=sh_degree,
            )
        if isinstance(pcd, FlamePointCloud):
            return model.init_from_flame(
                t(pcd.alpha), t(pcd.colors), sh_degree=sh_degree,
                vertices_enlargement_init=pcd.vertices_enlargement_init,
            )
        if isinstance(pcd, MeshPointCloud):
            return model.init_from_mesh(
                t(pcd.vertices), t(pcd.faces), t(pcd.alpha), t(pcd.colors),
                sh_degree=sh_degree,
            )
        return model.init_from_points(
            t(pcd.points), t(pcd.colors), sh_degree=sh_degree, capacity=capacity)
