"""Dataset readers: COLMAP, Blender (NeRF-synthetic), Blender_Mesh,
Colmap_Mesh (several meshes) and Blender_FLAME, host-side numpy (port of
`gaussian_mesh_splatting_tpu/scene/dataset_readers.py`).

Behavioural contracts kept:
  * Blender transforms are camera-to-world with OpenGL axes, converted by
    negating the Y/Z columns; R is the transposed world-to-view rotation;
  * Blender RGBA images are alpha-composited onto the background colour;
    COLMAP images are not: their 4th channel rides along as `alpha_mask`;
  * scene normalization: camera-centroid radius * 1.1;
  * COLMAP eval split: every 8th image (llffhold) of the list sorted by name
    is a test view; only PINHOLE and SIMPLE_PINHOLE cameras are read;
  * Blender meshes are axis-transformed to [x, z, -y] (COLMAP meshes are
    not), with per-face random barycentric seeds and then the colours drawn
    from one numpy generator seeded with `seed`, mesh after mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..core.camera import focal2fov, fov2focal, world_to_view
from ..core.sh import sh_to_rgb
from ..io.obj import load_obj
from ..io.ply import fetch_point_cloud, store_point_cloud
from . import colmap_loader as colmap


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
class MultiMeshPointCloud(PointCloud):
    """gs_multi_mesh payload: one entry per mesh, in mesh order."""

    alpha: list  # [(F_i, S_i, 3)]
    vertices: list  # [(V_i, 3)]
    faces: list  # [(F_i, 3)]


@dataclasses.dataclass
class FlamePointCloud(PointCloud):
    """gs_flame payload."""

    alpha: np.ndarray  # (F, S, 3)
    faces: np.ndarray  # (F, 3)
    vertices_init: np.ndarray  # (V, 3) the decoded template in scene axes
    rig: object  # models.flame.FlameRig
    vertices_enlargement_init: float


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


def read_colmap_cameras(path: str, images_dir: str) -> list[CameraInfo]:
    """COLMAP cameras from `path/sparse/0` (binary, else text), each with the
    image of the same basename under `images_dir`, sorted by image name."""
    from PIL import Image

    sparse = os.path.join(path, "sparse/0")
    try:
        extr = colmap.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_extrinsics_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_intrinsics_text(os.path.join(sparse, "cameras.txt"))

    cam_infos = []
    for im in extr.values():
        cam = intr[im.camera_id]
        R = np.transpose(colmap.qvec2rotmat(im.qvec))
        T = np.array(im.tvec)
        if cam.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(cam.params[0], cam.height)
            fovx = focal2fov(cam.params[0], cam.width)
        elif cam.model == "PINHOLE":
            fovy = focal2fov(cam.params[1], cam.height)
            fovx = focal2fov(cam.params[0], cam.width)
        else:
            raise ValueError(f"unsupported COLMAP camera model {cam.model}: undistort first "
                             "(only PINHOLE and SIMPLE_PINHOLE are read)")
        image_path = os.path.join(images_dir, os.path.basename(im.name))
        with Image.open(image_path) as pil:
            raw = np.asarray(pil, dtype=np.float32) / 255.0
        if raw.ndim == 2:
            raw = np.repeat(raw[:, :, None], 3, axis=2)
        cam_infos.append(
            CameraInfo(
                uid=cam.id, R=R, T=T, fovy=fovy, fovx=fovx, image=raw[:, :, :3],
                image_path=image_path,
                image_name=os.path.splitext(os.path.basename(image_path))[0],
                width=cam.width, height=cam.height,
                alpha_mask=raw[:, :, 3:4].copy() if raw.shape[2] == 4 else None,
            )
        )
    cam_infos.sort(key=lambda c: c.image_name)
    return cam_infos


def read_colmap_scene_info(
    path: str, images: str | None, eval: bool, llffhold: int = 8
) -> SceneInfo:
    """Colmap reader: cameras of `images` (default "images"), the llffhold
    split, and `sparse/0/points3D.ply`, written from `points3D.bin` (else
    `.txt`) when it does not exist."""
    cam_infos = read_colmap_cameras(path, os.path.join(path, images or "images"))
    if eval:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []
    norm = get_nerfpp_norm(train)

    sparse = os.path.join(path, "sparse/0")
    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3D_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3D_text(os.path.join(sparse, "points3D.txt"))
        store_point_cloud(ply_path, xyz, rgb)
    pts, cols, nrm = fetch_point_cloud(ply_path)
    return SceneInfo(PointCloud(pts, cols, nrm), train, test, norm, ply_path)


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


def read_colmap_mesh_scene_info(
    path: str, images: str | None, eval: bool, num_splats: list[int] | int,
    meshes: list[str] | None = None, llffhold: int = 8, seed: int = 0,
) -> SceneInfo:
    """Colmap_Mesh reader: COLMAP cameras + the meshes `sparse/0/<name>.obj`
    (`meshes`, default every `.obj` there, sorted), in scene axes as they
    are; `num_splats` per mesh or one count for all."""
    base = read_colmap_scene_info(path, images, eval, llffhold)
    sparse = os.path.join(path, "sparse/0")
    if meshes is None:
        meshes = sorted(os.path.splitext(f)[0] for f in os.listdir(sparse) if f.endswith(".obj"))
    if not meshes:
        raise ValueError(f"no meshes in {sparse}: gs_multi_mesh needs at least one <name>.obj")
    if isinstance(num_splats, int):
        num_splats = [num_splats] * len(meshes)

    rng = np.random.default_rng(seed)
    alpha_l, verts_l, faces_l, xyz_l = [], [], [], []
    for name, s in zip(meshes, num_splats):
        vertices, faces = load_obj(os.path.join(sparse, name + ".obj"))
        tri = vertices[faces]
        alpha = rng.random((tri.shape[0], s, 3)).astype(np.float32)
        xyz_l.append(np.einsum("fsa,fad->fsd", alpha, tri).reshape(-1, 3))
        alpha_l.append(alpha)
        verts_l.append(vertices.astype(np.float32))
        faces_l.append(faces)
    xyz = np.concatenate(xyz_l, axis=0)
    shs = rng.random((xyz.shape[0], 3)) / 255.0
    colors = sh_to_rgb(shs).astype(np.float32)
    pcd = MultiMeshPointCloud(
        points=xyz, colors=colors, normals=np.zeros_like(xyz),
        alpha=alpha_l, vertices=verts_l, faces=faces_l,
    )
    return SceneInfo(pcd, base.train_cameras, base.test_cameras, base.nerf_normalization,
                     base.ply_path)


def read_nerf_synthetic_flame_info(
    path: str, white_background: bool, eval: bool, rig, extension: str = ".png",
    num_splats_per_face: int = 100, vertices_enlargement: float = 8.35, seed: int = 0,
) -> SceneInfo:
    """Blender_FLAME reader: Blender cameras + the head that the FLAME rig
    `rig` (a models.flame.FlameRig) decodes at zero parameters (shape 100,
    expression 50), in scene axes and enlarged by `vertices_enlargement`."""
    from ..models.flame.decoder import flame_forward

    train = read_cameras_from_transforms(path, "transforms_train.json", white_background, extension)
    test = read_cameras_from_transforms(path, "transforms_test.json", white_background, extension)
    if not eval:
        train = train + test
        test = []
    norm = get_nerfpp_norm(train)

    dev = rig.lbs_model.v_template.device
    with torch.no_grad():
        verts, _ = flame_forward(
            rig, *(torch.zeros((1, n), device=dev) for n in (100, 50, 6, 3)))
    vertices = transform_mesh_vertices(verts[0].cpu().numpy(), c=vertices_enlargement)
    faces = rig.lbs_model.faces.cpu().numpy()
    tri = vertices[faces]

    rng = np.random.default_rng(seed)
    alpha = rng.random((tri.shape[0], num_splats_per_face, 3)).astype(np.float32)
    xyz = np.einsum("fsa,fad->fsd", alpha, tri).reshape(-1, 3)
    shs = rng.random((xyz.shape[0], 3)) / 255.0
    colors = sh_to_rgb(shs).astype(np.float32)
    ply_path = os.path.join(path, "points3d.ply")
    store_point_cloud(ply_path, xyz, colors * 255)
    pcd = FlamePointCloud(
        points=xyz, colors=colors, normals=np.zeros_like(xyz),
        alpha=alpha, faces=faces, vertices_init=vertices, rig=rig,
        vertices_enlargement_init=vertices_enlargement,
    )
    return SceneInfo(pcd, train, test, norm, ply_path)


SCENE_LOAD_CALLBACKS = {
    "Colmap": read_colmap_scene_info,
    "Blender": read_nerf_synthetic_info,
    "Blender_Mesh": read_nerf_synthetic_mesh_info,
    "Colmap_Mesh": read_colmap_mesh_scene_info,
    "Blender_FLAME": read_nerf_synthetic_flame_info,
}
