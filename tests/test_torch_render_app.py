"""The port's render app against the JAX package's, end to end on the CPU:
a tiny Blender_Mesh dataset and a `gs_mesh` snapshot written by the JAX
package, rendered by both apps; the PNGs must agree within 1/255. The same
for `gs`, `gs_flat` and `gs_points` on a Blender dataset with a small point
cloud, `gs_multi_mesh` on a COLMAP dataset with two meshes, and `gs_flame`
on a Blender dataset with a FLAME pickle. Also: the CUDA backend refuses CPU tensors, the entry points refuse to run without a
card unless asked for the CPU, and the port imports neither JAX nor the JAX
package."""
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_mesh_splatting_tpu.apps import render as j_render_app
from gaussian_mesh_splatting_tpu.io.checkpoint import snapshot_dir
from gaussian_mesh_splatting_tpu.io.config_io import save_cfg
from gaussian_mesh_splatting_tpu.io.obj import save_obj
from gaussian_mesh_splatting_tpu.io.snapshots import save_snapshot as j_save_snapshot
from gaussian_mesh_splatting_tpu.models import MODEL_REGISTRY as J_MODELS
from gaussian_mesh_splatting_tpu.models import mesh as jmesh
from gaussian_mesh_splatting_tpu.scene import Scene as JScene
from gaussian_mesh_splatting_tpu_torch.apps import render as t_render_app
from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
from gaussian_mesh_splatting_tpu_torch.io.ply import store_point_cloud
from gaussian_mesh_splatting_tpu_torch.io.snapshots import load_snapshot
from gaussian_mesh_splatting_tpu_torch.models import mesh as tmesh
from gaussian_mesh_splatting_tpu_torch.renderer import render

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITER = 7


def _write_dataset(root, n_cams=2, size=40):
    """Blender_Mesh dataset: an octahedron mesh and a ring of cameras."""
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n_cams):
            angle = 2 * np.pi * (i + (0.5 if split == "test" else 0.0)) / n_cams
            c = np.array([3 * np.sin(angle), 0.4, 3 * np.cos(angle)])
            fwd = -c / np.linalg.norm(c)
            right = np.cross([0.0, 1.0, 0.0], fwd)
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, :3] = np.stack([right, np.cross(fwd, right), -fwd], axis=1)
            c2w[:3, 3] = c
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
            img = (rng.random((size, size, 4)) * 255).astype(np.uint8)
            Image.fromarray(img, "RGBA").save(os.path.join(root, split, f"r_{i}.png"))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float32) * 0.8
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    save_obj(os.path.join(root, "mesh.obj"), verts, faces)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """Dataset + a JAX-written gs_mesh model directory (randomized state)."""
    root = str(tmp_path_factory.mktemp("scene"))
    model = str(tmp_path_factory.mktemp("model"))
    _write_dataset(root)
    scene = JScene(root, "gs_mesh", eval=True, num_splats=4, shuffle=False)
    state = scene.init_model_state(jmesh, sh_degree=1)
    rng = np.random.default_rng(1)
    p = dict(state["params"])
    p["f_dc"] = jnp.asarray(rng.random(p["f_dc"].shape, np.float32) * 2 - 0.5)
    p["f_rest"] = jnp.asarray((rng.standard_normal(p["f_rest"].shape) * 0.1).astype(np.float32))
    p["opacity"] = jnp.asarray(rng.standard_normal(p["opacity"].shape).astype(np.float32) + 1.5)
    p["scale"] = jnp.asarray(rng.uniform(0.8, 1.5, p["scale"].shape).astype(np.float32))
    state = {"params": p, "consts": state["consts"], "alive": state["alive"]}
    j_save_snapshot("gs_mesh", jmesh, state, snapshot_dir(model, ITER))
    save_cfg(model, {"source_path": root, "gs_type": "gs_mesh", "sh_degree": 1,
                     "num_splats": 4, "white_background": True, "eval": True})
    return model


def test_render_app_matches_jax(jax_model, tmp_path):
    port_model = str(tmp_path / "port_model")
    shutil.copytree(jax_model, port_model)
    j_render_app.main(["-m", jax_model])
    t_render_app.main(["-m", port_model, "--device", "cpu"])
    n_checked = 0
    for split in ("train", "test"):
        for i in range(2):
            rel = os.path.join(split, f"ours_{ITER}", "renders_gs_mesh", f"{i:05d}.png")
            a = np.asarray(Image.open(os.path.join(jax_model, rel)), np.int32)
            b = np.asarray(Image.open(os.path.join(port_model, rel)), np.int32)
            assert a.shape == b.shape == (40, 40, 3)
            assert np.abs(a - b).max() <= 1, rel
            assert a.std() > 1.0  # the mesh is in view
            n_checked += 1
    assert n_checked == 4


@pytest.mark.parametrize("gs_type", ["gs", "gs_flat", "gs_points"])
def test_render_app_matches_jax_on_point_models(gs_type, tmp_path):
    """A JAX-written `gs` / `gs_flat` model directory on a Blender dataset
    with its own point cloud, rendered by both apps (a `gs_flat` one also as
    `gs_points`): PNGs within 1/255."""
    from test_torch_models import _jax_state, _point_state

    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    _write_dataset(root)
    os.remove(os.path.join(root, "mesh.obj"))
    rng = np.random.default_rng(2)
    store_point_cloud(os.path.join(root, "points3d.ply"), rng.random((50, 3)) - 0.5,
                      rng.random((50, 3)) * 255)
    save_type = "gs_flat" if gs_type == "gs_points" else gs_type
    state = _point_state(save_type, seed=4, n=60, capacity=80)
    state["params"]["scaling"] += 0.8  # large enough to see at 40x40
    j_save_snapshot(save_type, J_MODELS[save_type], _jax_state(state), snapshot_dir(model, ITER))
    save_cfg(model, {"source_path": root, "gs_type": save_type, "sh_degree": 1,
                     "white_background": False, "eval": True})
    port_model = str(tmp_path / "port_model")
    shutil.copytree(model, port_model)
    j_render_app.main(["-m", model, "--gs_type", gs_type])
    t_render_app.main(["-m", port_model, "--gs_type", gs_type, "--device", "cpu"])
    for split in ("train", "test"):
        for i in range(2):
            rel = os.path.join(split, f"ours_{ITER}", f"renders_{gs_type}", f"{i:05d}.png")
            a = np.asarray(Image.open(os.path.join(model, rel)), np.int32)
            b = np.asarray(Image.open(os.path.join(port_model, rel)), np.int32)
            assert a.shape == b.shape == (40, 40, 3)
            assert np.abs(a - b).max() <= 1, rel
            assert a.std() > 1.0  # the Gaussians are in view


def test_blender_reader_makes_the_same_seeded_point_cloud(tmp_path):
    """With no `points3d.ply` both readers make the same seeded points (the
    full 100,000 here cut to 500), write them and read them back alike, and
    the two Scenes build the same padded initial state from them."""
    from gaussian_mesh_splatting_tpu.models import vanilla as jvanilla
    from gaussian_mesh_splatting_tpu.scene.dataset_readers import (
        read_nerf_synthetic_info as j_reader,
    )
    from gaussian_mesh_splatting_tpu_torch.models import vanilla as tvanilla
    from gaussian_mesh_splatting_tpu_torch.scene import Scene
    from gaussian_mesh_splatting_tpu_torch.scene.dataset_readers import read_nerf_synthetic_info

    roots = [str(tmp_path / name) for name in ("jax_scene", "port_scene")]
    for root in roots:
        _write_dataset(root)
        os.remove(os.path.join(root, "mesh.obj"))
    ref = j_reader(roots[0], True, True, num_pts=500)
    got = read_nerf_synthetic_info(roots[1], True, True, num_pts=500)
    with open(ref.ply_path, "rb") as a, open(got.ply_path, "rb") as b:
        assert a.read() == b.read()
    assert got.point_cloud.points.shape == (500, 3)
    np.testing.assert_array_equal(got.point_cloud.points, ref.point_cloud.points)
    np.testing.assert_array_equal(got.point_cloud.colors, ref.point_cloud.colors)
    assert got.nerf_normalization["radius"] == ref.nerf_normalization["radius"]
    # the second read takes the file the first one wrote
    jstate = JScene(roots[0], "gs", eval=True).init_model_state(jvanilla, 1, capacity=1200)
    scene = Scene(roots[1], "gs", eval=True, device="cpu")
    state = scene.init_model_state(tvanilla, 1, capacity=1200)
    assert state["alive"].shape == (1200,) and int(state["alive"].sum()) == 500
    for k, v in jstate["params"].items():
        np.testing.assert_allclose(state["params"][k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-3 if k == "scaling" else 1e-6, err_msg=k)


def test_snapshot_roundtrip_from_jax(jax_model):
    state = load_snapshot("gs_mesh", snapshot_dir(jax_model, ITER), sh_degree=1,
                          consts={"faces": torch.zeros((8, 3), dtype=torch.int64)},
                          device="cpu")
    p = state["params"]
    assert set(p) == {"vertices", "alpha", "scale", "f_dc", "f_rest", "opacity"}
    assert p["alpha"].shape == (8, 4, 3) and p["f_rest"].shape == (32, 3, 3)
    assert state["alive"].shape == (32,)


def test_cuda_backend_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    state = tmesh.init_from_mesh(
        torch.tensor(rng.standard_normal((3, 3)), dtype=torch.float32),
        torch.tensor([[0, 1, 2]]), torch.tensor(rng.random((1, 2, 3))),
        torch.tensor(rng.random((2, 3))), sh_degree=0)
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, 32, 32, device="cpu")
    bag = tmesh.to_bag(state)
    with pytest.raises(ValueError, match="CUDA"):
        render(bag, cam, torch.zeros(3), sh_degree=0, backend="cuda")
    out = render(bag, cam, torch.zeros(3), sh_degree=0, backend="auto")
    assert out.image.shape == (32, 32, 3)


def test_entry_points_need_a_card_unless_asked_for_cpu(jax_model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_render_app.main(["-m", jax_model])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, 8, 8)


def test_unported_gs_type_raises(jax_model, tmp_path):
    """A gs_type that is not in the registry, and a gs_flame model whose
    cfg_args names no FLAME pickle."""
    other = str(tmp_path / "gs_model")
    shutil.copytree(jax_model, other)
    with pytest.raises(KeyError, match="unknown gs_type 'gs_bogus'"):
        t_render_app.main(["-m", other, "--gs_type", "gs_bogus", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs a FLAME model pickle"):
        t_render_app.main(["-m", other, "--gs_type", "gs_flame", "--device", "cpu"])


def _render_both(model, gs_type, views):
    """Render `model` (a JAX-written model directory) with both apps and
    compare the PNGs: within 1/255, and not blank."""
    port_model = model + "_port"
    shutil.copytree(model, port_model)
    j_render_app.main(["-m", model])
    t_render_app.main(["-m", port_model, "--device", "cpu"])
    for split, n in views:
        for i in range(n):
            rel = os.path.join(split, f"ours_{ITER}", f"renders_{gs_type}", f"{i:05d}.png")
            a = np.asarray(Image.open(os.path.join(model, rel)), np.int32)
            b = np.asarray(Image.open(os.path.join(port_model, rel)), np.int32)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1, rel
            assert a.std() > 1.0, rel


def test_render_app_matches_jax_on_multi_mesh(tmp_path):
    from gaussian_mesh_splatting_tpu.models import multi_mesh as jmm
    from test_torch_colmap import make_colmap_dataset

    root = make_colmap_dataset(str(tmp_path / "scene"), n_cams=9, size=24, with_meshes=True)
    model = str(tmp_path / "model")
    state = JScene(root, "gs_multi_mesh", eval=True, num_splats=3,
                   shuffle=False).init_model_state(jmm, sh_degree=1)
    rng = np.random.default_rng(3)
    p = dict(state["params"])
    p["f_dc"] = jnp.asarray(rng.random(p["f_dc"].shape, np.float32) * 2 - 0.5)
    p["opacity"] = jnp.asarray(rng.standard_normal(p["opacity"].shape).astype(np.float32) + 1.5)
    p["scale"] = [jnp.asarray(rng.uniform(0.8, 1.5, s.shape).astype(np.float32))
                  for s in p["scale"]]
    j_save_snapshot("gs_multi_mesh", jmm, {**state, "params": p}, snapshot_dir(model, ITER))
    save_cfg(model, {"source_path": root, "gs_type": "gs_multi_mesh", "sh_degree": 1,
                     "num_splats": 3, "white_background": False, "eval": True,
                     "images": "images", "meshes": None})
    _render_both(model, "gs_multi_mesh", [("train", 7), ("test", 2)])


def test_render_app_matches_jax_on_flame(tmp_path):
    from gaussian_mesh_splatting_tpu.models.flame import load_flame_pickle as j_load_flame
    from gaussian_mesh_splatting_tpu.models.flame_gaussian import FlameGaussianModel
    from test_torch_colmap import _tetrahedron
    from test_torch_flame import head_rigs, write_blender_dataset, write_flame_pickle

    root = write_blender_dataset(str(tmp_path / "scene"), radius=1.6)
    verts, faces = _tetrahedron()
    pkl = write_flame_pickle(str(tmp_path / "flame.pkl"),
                             head_rigs(mesh=(verts * 0.2 - 0.05, faces))[0])
    model = str(tmp_path / "model")
    jmodel = FlameGaussianModel(j_load_flame(pkl))
    state = JScene(root, "gs_flame", eval=True, flame_rig=jmodel.rig,
                   shuffle=False).init_model_state(jmodel, sh_degree=1)
    rng = np.random.default_rng(4)
    p = dict(state["params"])
    p["f_dc"] = jnp.asarray(rng.random(p["f_dc"].shape, np.float32) * 2 - 0.5)
    p["opacity"] = jnp.asarray(rng.standard_normal(p["opacity"].shape).astype(np.float32))
    p["flame_exp"] = jnp.asarray(rng.standard_normal(p["flame_exp"].shape).astype(np.float32))
    p["flame_pose"] = jnp.asarray([[0.0, 0.1, 0.0, 0.2, 0.0, 0.0]], jnp.float32)
    j_save_snapshot("gs_flame", jmodel, {**state, "params": p}, snapshot_dir(model, ITER))
    save_cfg(model, {"source_path": root, "gs_type": "gs_flame", "sh_degree": 1,
                     "white_background": True, "eval": True, "flame_model": pkl})
    _render_both(model, "gs_flame", [("train", 2), ("test", 2)])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gaussian_mesh_splatting_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 60, names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'orbax', 'flax', 'gaussian_mesh_splatting_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
