"""Dataset readers for the Blender (NeRF-synthetic) and Blender_Mesh formats,
host-side numpy (port of the matching readers of
`gaussian_mesh_splatting_tpu/scene/dataset_readers.py`; COLMAP and FLAME
readers are not ported yet).

Behavioural contracts kept:
  * Blender transforms are camera-to-world with OpenGL axes, converted by
    negating the Y/Z columns; R is the transposed world-to-view rotation;
  * RGBA images are alpha-composited onto the background colour;
  * scene normalization: camera-centroid radius * 1.1;
  * mesh vertices axis-transformed to [x, z, -y], with per-face random
    barycentric seeds from numpy's generator seeded with 0.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..core.camera import focal2fov, fov2focal, world_to_view
from ..core.sh import sh_to_rgb
from ..io.obj import load_obj
from ..io.ply import fetch_point_cloud, store_point_cloud


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # camera-to-world rotation (reference convention)
    T: np.ndarray  # world-to-view translation
    fovy: float
    fovx: float
    image: np.ndarray  # (H, W, 3) float32 in [0, 1]
    image_path: str
    image_name: str
    width: int
    height: int
    alpha_mask: np.ndarray | None = None


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclasses.dataclass
class MeshPointCloud(PointCloud):
    """gs_mesh payload."""

    alpha: np.ndarray  # (F, S, 3)
    vertices: np.ndarray  # (V, 3)
    faces: np.ndarray  # (F, 3)


@dataclasses.dataclass
class SceneInfo:
    point_cloud: PointCloud
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Camera-centroid radius normalization."""
    centers = []
    for cam in cam_infos:
        C2W = np.linalg.inv(world_to_view(cam.R, cam.T))
        centers.append(C2W[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": diagonal * 1.1}


def _load_image(path: str, white_background: bool) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        rgba = np.asarray(im.convert("RGBA"), dtype=np.float32) / 255.0
    bg = np.ones(3) if white_background else np.zeros(3)
    rgb = rgba[:, :, :3] * rgba[:, :, 3:4] + bg * (1.0 - rgba[:, :, 3:4])
    return rgb.astype(np.float32)


def read_cameras_from_transforms(
    path: str, transformsfile: str, white_background: bool, extension: str = ".png"
) -> list[CameraInfo]:
    """Blender/NeRF-synthetic camera reader."""
    cam_infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if file_path.startswith("./"):
            file_path = file_path[2:]
        cam_name = os.path.join(path, file_path + extension)
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        image = _load_image(cam_name, white_background)
        h, w = image.shape[:2]
        fovy = focal2fov(fov2focal(fovx, w), h)
        cam_infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, fovy=fovy, fovx=fovx, image=image,
                image_path=cam_name,
                image_name=os.path.splitext(os.path.basename(cam_name))[0],
                width=w, height=h,
            )
        )
    return cam_infos


def read_nerf_synthetic_info(
    path: str, white_background: bool, eval: bool, extension: str = ".png",
    num_pts: int = 100_000,
) -> SceneInfo:
    """Blender reader; synthesizes a random point cloud when none exists."""
    train = read_cameras_from_transforms(path, "transforms_train.json", white_background, extension)
    test = read_cameras_from_transforms(path, "transforms_test.json", white_background, extension)
    if not eval:
        train = train + test
        test = []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        store_point_cloud(ply_path, xyz, sh_to_rgb(shs) * 255)
    pts, cols, nrm = fetch_point_cloud(ply_path)
    return SceneInfo(PointCloud(pts, cols, nrm), train, test, norm, ply_path)


def transform_mesh_vertices(vertices: np.ndarray, c: float = 1.0) -> np.ndarray:
    """Blender mesh -> scene axes: [x, z, -y] * c."""
    v = vertices[:, [0, 2, 1]].copy()
    v[:, 1] = -v[:, 1]
    return v * c


def read_nerf_synthetic_mesh_info(
    path: str, white_background: bool, eval: bool, num_splats: int,
    extension: str = ".png", mesh_file: str = "mesh.obj", seed: int = 0,
) -> SceneInfo:
    """Blender_Mesh reader: Blender cameras + `mesh.obj`."""
    train = read_cameras_from_transforms(path, "transforms_train.json", white_background, extension)
    test = read_cameras_from_transforms(path, "transforms_test.json", white_background, extension)
    vertices, faces = load_obj(os.path.join(path, mesh_file))
    vertices = transform_mesh_vertices(vertices)
    triangles = vertices[faces]

    if not eval:
        train = train + test
        test = []
    norm = get_nerfpp_norm(train)

    rng = np.random.default_rng(seed)
    f = triangles.shape[0]
    alpha = rng.random((f, num_splats, 3)).astype(np.float32)
    xyz = np.einsum("fsa,fad->fsd", alpha, triangles).reshape(-1, 3)
    shs = rng.random((xyz.shape[0], 3)) / 255.0
    colors = sh_to_rgb(shs).astype(np.float32)

    ply_path = os.path.join(path, "points3d.ply")
    store_point_cloud(ply_path, xyz, colors * 255)
    pcd = MeshPointCloud(
        points=xyz, colors=colors, normals=np.zeros_like(xyz),
        alpha=alpha, vertices=vertices.astype(np.float32), faces=faces,
    )
    return SceneInfo(pcd, train, test, norm, ply_path)


SCENE_LOAD_CALLBACKS = {
    "Blender": read_nerf_synthetic_info,
    "Blender_Mesh": read_nerf_synthetic_mesh_info,
}
