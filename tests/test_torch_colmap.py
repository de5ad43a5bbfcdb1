"""The port's COLMAP readers against the JAX package's on the CPU: the same
dataset, written with the port's `colmap_loader` writers (and as text
files), read by both packages.

Tolerances and why:
  * cameras (R, T, FoVs), images, alpha masks, uid, order and split: exact
    (the same numpy operations on the same bytes);
  * point clouds and the mesh readers' seeds and colours: exact (the same
    numpy generator draws, in the same order);
  * initial model states: 1e-6 absolute (float32 activations of the same
    values), 1e-3 on the KNN log-scale init (`tests/test_torch_models.py`).
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_mesh_splatting_tpu.models import multi_mesh as j_multi_mesh
from gaussian_mesh_splatting_tpu.models import vanilla as j_vanilla
from gaussian_mesh_splatting_tpu.scene import Scene as JScene
from gaussian_mesh_splatting_tpu.scene import colmap_loader as j_colmap
from gaussian_mesh_splatting_tpu.scene import dataset_readers as j_readers
from gaussian_mesh_splatting_tpu.scene import detect_scene_type as j_detect_scene_type
from gaussian_mesh_splatting_tpu_torch.io.obj import save_obj
from gaussian_mesh_splatting_tpu_torch.models import multi_mesh as t_multi_mesh
from gaussian_mesh_splatting_tpu_torch.models import vanilla as t_vanilla
from gaussian_mesh_splatting_tpu_torch.scene import Scene, detect_scene_type
from gaussian_mesh_splatting_tpu_torch.scene import colmap_loader as colmap
from gaussian_mesh_splatting_tpu_torch.scene import dataset_readers as t_readers

torch.set_num_threads(2)


def _tetrahedron():
    """A tetrahedron turned off the axes (a face in an axis plane would put
    many Gaussians at one depth for a camera on that axis: ties that an ulp
    of either package's projection orders either way)."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64) * 0.5
    a, b = 0.5, 0.3
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    faces = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    return (verts @ (rx @ rz).T).astype(np.float32), faces


def ring_pose(i, n_cams, radius=3.0, height=0.4):
    """World-to-camera rotation and translation of camera `i` of a ring
    looking at the origin, in COLMAP's convention."""
    angle = 2 * np.pi * i / n_cams
    c = np.array([radius * np.sin(angle), height, -radius * np.cos(angle)])
    fwd = -c / np.linalg.norm(c)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    r_w2c = np.stack([right, np.cross(fwd, right), fwd], axis=1).T
    return r_w2c, -r_w2c @ c


def make_colmap_dataset(root, n_cams=3, size=16, with_meshes=False, rgba=(), text=False,
                        simple_pinhole=False, n_points=50, model="PINHOLE"):
    """A COLMAP dataset: a ring of cameras (names in reverse order of their
    ids, so that the readers' sort matters), seeded images (RGBA for the
    indices in `rgba`), a points3D file and, `with_meshes`, two tetrahedra
    in `sparse/0`; binary files, or text files with `text`."""
    sparse = os.path.join(root, "sparse/0")
    images_dir = os.path.join(root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)
    f = 20.0
    distortion = [0.01, 0.0, 0.0, 0.0] if model == "OPENCV" else []
    cams = {1: colmap.ColmapCamera(1, model, size, size,
                                   np.array([f, f * 1.1, size / 2, size / 2, *distortion]))}
    if simple_pinhole:
        cams[2] = colmap.ColmapCamera(2, "SIMPLE_PINHOLE", size, size,
                                      np.array([f * 0.9, size / 2, size / 2]))
    rng = np.random.default_rng(0)
    ims = {}
    for i in range(n_cams):
        r_w2c, t = ring_pose(i, n_cams)
        name = f"img_{n_cams - i:02d}.png"
        ims[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat2qvec(r_w2c), t,
                                        2 if simple_pinhole and i % 2 else 1, name)
        channels = 4 if i in rgba else 3
        img = (rng.random((size, size, channels)) * 255).astype(np.uint8)
        Image.fromarray(img, "RGBA" if channels == 4 else "RGB").save(
            os.path.join(images_dir, name))
    xyz = rng.normal(size=(n_points, 3)) * 0.5
    rgb = rng.integers(0, 255, (n_points, 3)).astype(np.uint8)
    if text:
        with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
            fh.write("# camera list\n")
            for c in cams.values():
                fh.write(f"{c.id} {c.model} {c.width} {c.height} "
                         + " ".join(repr(float(x)) for x in c.params) + "\n")
        with open(os.path.join(sparse, "images.txt"), "w") as fh:
            fh.write("# image list\n")
            for im in ims.values():
                fh.write(" ".join(str(x) for x in (im.id, *map(repr, map(float, im.qvec)),
                                                    *map(repr, map(float, im.tvec)),
                                                    im.camera_id, im.name))
                         # the readers skip blank lines: each image has a point
                         + "\n8.5 3.25 -1\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as fh:
            for i in range(n_points):
                x, y, z = map(float, xyz[i])
                fh.write(f"{i} {x!r} {y!r} {z!r} {rgb[i, 0]} {rgb[i, 1]} {rgb[i, 2]} 0.5\n")
    else:
        colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cams)
        colmap.write_images_binary(os.path.join(sparse, "images.bin"), ims)
        colmap.write_points3D_binary(os.path.join(sparse, "points3D.bin"), xyz, rgb)
    if with_meshes:
        verts, faces = _tetrahedron()
        save_obj(os.path.join(sparse, "obj1.obj"), verts, faces)
        save_obj(os.path.join(sparse, "obj2.obj"), verts - 0.6, faces)
    return root


def _two_copies(tmp_path, **kw):
    """The same dataset twice: each reader writes `points3D.ply` into its own."""
    a = make_colmap_dataset(str(tmp_path / "jax_scene"), **kw)
    b = str(tmp_path / "port_scene")
    shutil.copytree(a, b)
    return a, b


def _assert_same_cameras(got, ref):
    assert [c.image_name for c in got] == [c.image_name for c in ref]
    assert [c.image_name for c in got] == sorted(c.image_name for c in got)
    for g, r in zip(got, ref):
        assert g.uid == r.uid and (g.width, g.height) == (r.width, r.height)
        assert os.path.basename(g.image_path) == os.path.basename(r.image_path)
        np.testing.assert_array_equal(g.R, r.R)
        np.testing.assert_array_equal(g.T, r.T)
        assert g.fovx == r.fovx and g.fovy == r.fovy
        np.testing.assert_array_equal(g.image, r.image)
        assert (g.alpha_mask is None) == (r.alpha_mask is None)
        if r.alpha_mask is not None:
            np.testing.assert_array_equal(g.alpha_mask, r.alpha_mask)


def test_writers_write_the_jax_packages_bytes(tmp_path):
    cams = {3: colmap.ColmapCamera(3, "PINHOLE", 64, 48, np.array([50.0, 51.0, 32.0, 24.0]))}
    r_w2c, t = ring_pose(1, 5)
    ims = {7: colmap.ColmapImage(7, colmap.rotmat2qvec(r_w2c), t, 3, "a.png")}
    xyz = np.random.default_rng(1).normal(size=(6, 3))
    rgb = np.arange(18, dtype=np.uint8).reshape(6, 3)
    for name, t_write, j_write, args in [
            ("cameras.bin", colmap.write_cameras_binary, j_colmap.write_cameras_binary, (cams,)),
            ("images.bin", colmap.write_images_binary, j_colmap.write_images_binary, (ims,)),
            ("points3D.bin", colmap.write_points3D_binary, j_colmap.write_points3D_binary,
             (xyz, rgb))]:
        t_write(str(tmp_path / f"t_{name}"), *args)
        j_write(str(tmp_path / f"j_{name}"), *args)
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
    got = colmap.read_extrinsics_binary(str(tmp_path / "t_images.bin"))[7]
    np.testing.assert_allclose(colmap.qvec2rotmat(got.qvec), r_w2c, atol=1e-12)
    assert colmap.read_intrinsics_binary(str(tmp_path / "t_cameras.bin"))[3].model == "PINHOLE"
    pts, cols, _ = colmap.read_points3D_binary(str(tmp_path / "t_points3D.bin"))
    np.testing.assert_array_equal(pts, xyz)
    np.testing.assert_array_equal(cols, rgb)


@pytest.mark.parametrize("text", [False, True], ids=["binary", "text"])
def test_colmap_reader_matches_jax(text, tmp_path):
    """Nine cameras of two models (PINHOLE, SIMPLE_PINHOLE), two RGBA images:
    cameras, split (llffhold 8 after the sort), normalization and the point
    cloud written to `points3D.ply` from the bin / txt file."""
    a, b = _two_copies(tmp_path, n_cams=9, rgba=(2, 5), text=text, simple_pinhole=True)
    ref = j_readers.read_colmap_scene_info(a, None, True)
    got = t_readers.read_colmap_scene_info(b, None, True)
    assert len(got.train_cameras) == 7 and len(got.test_cameras) == 2
    _assert_same_cameras(got.train_cameras, ref.train_cameras)
    _assert_same_cameras(got.test_cameras, ref.test_cameras)
    assert sum(c.alpha_mask is not None for c in got.train_cameras + got.test_cameras) == 2
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  ref.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == ref.nerf_normalization["radius"]
    with open(ref.ply_path, "rb") as fa, open(got.ply_path, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(got.point_cloud.points, ref.point_cloud.points)
    np.testing.assert_array_equal(got.point_cloud.colors, ref.point_cloud.colors)
    # without --eval every camera trains
    assert len(t_readers.read_colmap_scene_info(b, None, False).train_cameras) == 9


def test_unsupported_camera_model_raises(tmp_path):
    root = make_colmap_dataset(str(tmp_path / "scene"), model="OPENCV")
    with pytest.raises(ValueError, match="OPENCV"):
        t_readers.read_colmap_cameras(root, os.path.join(root, "images"))
    with pytest.raises(ValueError, match="OPENCV"):
        j_readers.read_colmap_cameras(root, os.path.join(root, "images"))


def test_detect_scene_type_matches_jax(tmp_path):
    colmap_root = make_colmap_dataset(str(tmp_path / "colmap"))
    blender_root = str(tmp_path / "blender")
    os.makedirs(blender_root)
    open(os.path.join(blender_root, "transforms_train.json"), "w").close()
    for root in (colmap_root, blender_root):
        for gs_type in ("gs", "gs_flat", "gs_mesh", "gs_multi_mesh", "gs_flame"):
            assert detect_scene_type(root, gs_type) == j_detect_scene_type(root, gs_type)
    assert detect_scene_type(colmap_root, "gs_multi_mesh") == "Colmap_Mesh"
    with pytest.raises(ValueError, match="could not recognize"):
        detect_scene_type(str(tmp_path), "gs")


def test_colmap_scene_initial_state_matches_jax(tmp_path):
    a, b = _two_copies(tmp_path, n_cams=3)
    jscene = JScene(a, "gs", eval=True, shuffle=False)
    scene = Scene(b, "gs", eval=True, shuffle=False, device="cpu")
    assert len(scene.test_cameras) == 1 and len(scene.train_cameras) == 2
    assert scene.cameras_extent == jscene.cameras_extent
    for (cam, gt), (jcam, jgt) in zip(scene.train_cameras, jscene.train_cameras):
        np.testing.assert_array_equal(gt, np.asarray(jgt))
        np.testing.assert_allclose(cam.full_proj.numpy(), np.asarray(jcam.full_proj), atol=1e-6)
    jstate = jscene.init_model_state(j_vanilla, sh_degree=1, capacity=80)
    state = scene.init_model_state(t_vanilla, sh_degree=1, capacity=80)
    assert state["params"]["xyz"].shape == (80, 3) and int(state["alive"].sum()) == 50
    for k, v in jstate["params"].items():
        np.testing.assert_allclose(state["params"][k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-3 if k == "scaling" else 1e-6, err_msg=k)
    assert os.path.exists(os.path.join(b, "sparse/0/points3D.ply"))


def test_colmap_mesh_scene_initial_state_matches_jax(tmp_path):
    """Colmap_Mesh: one seeded generator draws each mesh's alpha in turn and
    then the colours; the multi-mesh state holds lists."""
    a, b = _two_copies(tmp_path, n_cams=3, with_meshes=True)
    ref = j_readers.read_colmap_mesh_scene_info(a, None, False, [2, 3], seed=4)
    got = t_readers.read_colmap_mesh_scene_info(b, None, False, [2, 3], seed=4)
    for k in ("alpha", "vertices", "faces"):
        assert len(getattr(got.point_cloud, k)) == 2
        for g, r in zip(getattr(got.point_cloud, k), getattr(ref.point_cloud, k)):
            np.testing.assert_array_equal(g, r, err_msg=k)
    np.testing.assert_array_equal(got.point_cloud.points, ref.point_cloud.points)
    np.testing.assert_array_equal(got.point_cloud.colors, ref.point_cloud.colors)
    _assert_same_cameras(got.train_cameras, ref.train_cameras)

    jstate = JScene(a, "gs_multi_mesh", num_splats=2, shuffle=False).init_model_state(
        j_multi_mesh, sh_degree=1)
    state = Scene(b, "gs_multi_mesh", num_splats=2, shuffle=False,
                  device="cpu").init_model_state(t_multi_mesh, sh_degree=1)
    for k, v in jstate["params"].items():
        if isinstance(v, list):
            assert isinstance(state["params"][k], list) and len(state["params"][k]) == len(v)
            for g, r in zip(state["params"][k], v):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6,
                                           err_msg=k)
        else:
            np.testing.assert_allclose(state["params"][k].numpy(), np.asarray(v), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert all(f.dtype == torch.int64 for f in state["consts"]["faces"])
    for g, r in zip(state["consts"]["faces"], jstate["consts"]["faces"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # named meshes, in the order given
    one = t_readers.read_colmap_mesh_scene_info(b, None, False, 2, meshes=["obj2"])
    np.testing.assert_array_equal(one.point_cloud.vertices[0], got.point_cloud.vertices[1])


def test_multi_mesh_needs_meshes(tmp_path):
    root = make_colmap_dataset(str(tmp_path / "scene"))
    with pytest.raises(ValueError, match="no meshes"):
        Scene(root, "gs_multi_mesh", device="cpu")


def test_images_dir_plumbing(tmp_path):
    """`images="images_2"` reads the named (downscaled) directory and trains
    at its size; the FoV still comes from the full-size intrinsics."""
    size = 16
    a, b = _two_copies(tmp_path, size=size)
    for root in (a, b):
        im2 = os.path.join(root, "images_2")
        os.makedirs(im2)
        for name in os.listdir(os.path.join(root, "images")):
            arr = np.full((size // 2, size // 2, 3), [255, 0, 0], np.uint8)
            Image.fromarray(arr, "RGB").save(os.path.join(im2, name))
    scene = Scene(b, "gs", eval=False, shuffle=False, images="images_2", device="cpu")
    jscene = JScene(a, "gs", eval=False, shuffle=False, images="images_2")
    cam, gt = scene.train_cameras[0]
    assert gt.shape == (size // 2, size // 2, 3) and (cam.height, cam.width) == (8, 8)
    np.testing.assert_allclose(gt[..., 0], 1.0)
    np.testing.assert_allclose(gt[..., 1:], 0.0)
    jcam, jgt = jscene.train_cameras[0]
    np.testing.assert_array_equal(gt, np.asarray(jgt))
    np.testing.assert_allclose(float(cam.tanfovx), float(jcam.tanfovx), rtol=1e-7)
    default_cam, default_gt = Scene(b, "gs", eval=False, shuffle=False,
                                    device="cpu").train_cameras[0]
    assert float(cam.tanfovx) == float(default_cam.tanfovx)
    assert default_gt.shape == (size, size, 3)


def test_colmap_alpha_mask_multiplied_into_gt(tmp_path):
    size = 16
    a, b = _two_copies(tmp_path, size=size)
    for root in (a, b):
        for name in os.listdir(os.path.join(root, "images")):
            arr = np.full((size, size, 4), 128, np.uint8)
            arr[:, : size // 2, 3] = 0
            arr[:, size // 2:, 3] = 255
            Image.fromarray(arr, "RGBA").save(os.path.join(root, "images", name))
    _, gt = Scene(b, "gs", eval=False, shuffle=False, device="cpu").train_cameras[0]
    _, jgt = JScene(a, "gs", eval=False, shuffle=False).train_cameras[0]
    np.testing.assert_allclose(gt[:, : size // 2], 0.0, atol=1e-6)
    np.testing.assert_allclose(gt[:, size // 2:], 128 / 255, atol=1e-6)
    np.testing.assert_array_equal(gt, np.asarray(jgt))


def test_colmap_scene_writes_the_model_directory(tmp_path):
    root = make_colmap_dataset(str(tmp_path / "scene"), n_cams=3)
    model = str(tmp_path / "model")
    Scene(root, "gs", model_path=model, eval=True, device="cpu")
    assert os.path.exists(os.path.join(model, "input.ply"))
    with open(os.path.join(model, "cameras.json")) as fh:
        cams = json.load(fh)
    assert len(cams) == 3 and {c["img_name"] for c in cams} == {"img_01", "img_02", "img_03"}
