"""The port's editing apps against the JAX package's, end to end on the CPU:
`render_animated` and `render_mesh_morph` on one port-trained `gs_mesh`
model directory, which the JAX apps read too (frames within 1/255); the
pseudomesh pipeline `save` -> `dummy` -> `retarget` -> `render` -> `animate`
on one port-trained `gs_flat` snapshot (triangles within 1e-6, the same
dummy faces, PNGs within 1/255); `convert` with a stand-in colmap; and the
apps import neither JAX nor the JAX package."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_mesh_splatting_tpu.apps import convert as j_convert
from gaussian_mesh_splatting_tpu.apps import pseudomesh as j_pseudomesh
from gaussian_mesh_splatting_tpu.apps import render_animated as j_render_animated
from gaussian_mesh_splatting_tpu.apps import render_mesh_morph as j_render_mesh_morph
from gaussian_mesh_splatting_tpu_torch.apps import convert as t_convert
from gaussian_mesh_splatting_tpu_torch.apps import pseudomesh as t_pseudomesh
from gaussian_mesh_splatting_tpu_torch.apps import render_animated as t_render_animated
from gaussian_mesh_splatting_tpu_torch.apps import render_mesh_morph as t_render_mesh_morph
from gaussian_mesh_splatting_tpu_torch.apps import train as t_train_app
from gaussian_mesh_splatting_tpu_torch.io.obj import load_obj, save_obj
from gaussian_mesh_splatting_tpu_torch.io.ply import store_point_cloud
from test_torch_train_app import _write_dataset

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 3


def _train(root, model, gs_type, *extra):
    t_train_app.main(["--gs_type", gs_type, "-s", root, "-m", model, "--eval", "--sh_degree", "1",
                      "--white_background", "--iterations", str(ITERS), "--test_iterations",
                      str(ITERS), "--save_iterations", str(ITERS), "--quiet", "--device", "cpu",
                      *extra])
    return model


@pytest.fixture(scope="module")
def mesh_model(tmp_path_factory):
    """A port-trained gs_mesh model directory (an octahedron, 32x32 views)."""
    root = str(tmp_path_factory.mktemp("mesh_scene"))
    _write_dataset(root)
    return _train(root, str(tmp_path_factory.mktemp("mesh_model") / "m"), "gs_mesh",
                  "--num_splats", "3")


@pytest.fixture(scope="module")
def flat_model(tmp_path_factory):
    """A port-trained gs_flat model directory: 40 seeded points, 16x16 views."""
    root = str(tmp_path_factory.mktemp("flat_scene"))
    _write_dataset(root, size=16)
    os.remove(os.path.join(root, "mesh.obj"))
    rng = np.random.default_rng(5)
    store_point_cloud(os.path.join(root, "points3d.ply"), rng.random((40, 3)) * 1.6 - 0.8,
                      rng.random((40, 3)) * 255)
    return _train(root, str(tmp_path_factory.mktemp("flat_model") / "m"), "gs_flat")


def _copies(model, tmp_path):
    """(a copy for the JAX app, a copy for the port's)."""
    out = []
    for name in ("jax", "port"):
        dst = str(tmp_path / name)
        shutil.copytree(model, dst)
        out.append(dst)
    return out


def _same_pngs(a_dir, b_dir, n, tol=1):
    names = sorted(os.listdir(b_dir))
    assert names == sorted(os.listdir(a_dir)) and len(names) == n
    imgs = []
    for name in names:
        a = np.asarray(Image.open(os.path.join(a_dir, name)), np.int32)
        b = np.asarray(Image.open(os.path.join(b_dir, name)), np.int32)
        assert a.shape == b.shape and a.shape[-1] == 3, name
        assert np.abs(a - b).max() <= tol, name
        imgs.append(b)
    return imgs


@pytest.mark.parametrize("deform,frames", [("fly", 3), ("wave", 4)])
def test_render_animated_matches_jax(mesh_model, tmp_path, deform, frames):
    j_model, t_model = _copies(mesh_model, tmp_path)
    argv = ["--frames", str(frames), "--deform", deform]
    j_render_animated.main(["-m", j_model, *argv])
    t_render_animated.main(["-m", t_model, *argv, "--device", "cpu"])
    imgs = _same_pngs(os.path.join(j_model, f"animated_{deform}"),
                      os.path.join(t_model, f"animated_{deform}"), frames)
    assert imgs[0].std() > 1.0
    moved = [np.abs(img - imgs[0]).max() > 0 for img in imgs[1:]]
    # fly over 3 frames samples its sines at 0, pi and 2 pi: no frame moves;
    # wave's phase turns by 4 pi t: t = 1/3 and 2/3 move, t = 1 is t = 0
    assert moved == ([False, False] if deform == "fly" else [True, True, False])


def test_render_mesh_morph_matches_jax(mesh_model, tmp_path):
    from gaussian_mesh_splatting_tpu_torch.io.config_io import load_cfg

    v, f = load_obj(os.path.join(load_cfg(mesh_model)["source_path"], "mesh.obj"))
    target = str(tmp_path / "target.obj")
    save_obj(target, v + np.array([0.2, 0.0, 0.1], np.float32), f)
    j_model, t_model = _copies(mesh_model, tmp_path)
    j_render_mesh_morph.main(["-m", j_model, "--target_mesh", target, "--frames", "2"])
    t_render_mesh_morph.main(["-m", t_model, "--target_mesh", target, "--frames", "2",
                              "--device", "cpu"])
    frames = _same_pngs(os.path.join(j_model, "mesh_morph"), os.path.join(t_model, "mesh_morph"), 2)
    assert np.abs(frames[1] - frames[0]).max() > 0
    bad = str(tmp_path / "bad.obj")
    save_obj(bad, v[:-1], f[:1])
    with pytest.raises(ValueError, match="keep the topology"):
        t_render_mesh_morph.main(["-m", t_model, "--target_mesh", bad, "--device", "cpu"])


def test_pseudomesh_pipeline_matches_jax(flat_model, tmp_path):
    j_model, t_model = _copies(flat_model, tmp_path)
    j_pseudomesh.main(["save", "-m", j_model, "--sh_degree", "1"])
    t_pseudomesh.main(["save", "-m", t_model, "--sh_degree", "1", "--device", "cpu"])
    tris = {}
    for name, model in (("jax", j_model), ("port", t_model)):
        tris[name] = np.load(os.path.join(model, "pseudomesh", "triangles.npz"))["triangles"]
        assert os.path.exists(os.path.join(model, "pseudomesh", "scale_100.0.obj"))
    assert tris["port"].shape == (40, 3, 3)
    np.testing.assert_allclose(tris["port"], tris["jax"], rtol=0, atol=1e-6)

    out = {}
    for name, app, model in (("jax", j_pseudomesh, j_model), ("port", t_pseudomesh, t_model)):
        tri_path = os.path.join(model, "pseudomesh", "triangles.npz")
        dummy, edited = str(tmp_path / f"{name}_dummy.obj"), str(tmp_path / f"{name}_edited.obj")
        app.main(["dummy", "--triangles", tri_path, "--output", dummy, "--alpha", "10.0"])
        v, f = load_obj(dummy)
        # "edit" the dummy mesh: a shift by +1 in x moves the soup with it
        save_obj(edited, v + np.array([1.0, 0.0, 0.0], np.float32), f)
        moved = str(tmp_path / f"{name}_retargeted.npz")
        app.main(["retarget", "--triangles", tri_path, "--estimated_mesh", dummy,
                  "--edited_mesh", edited, "--output", moved])
        out[name] = (v, f, np.load(moved)["triangles"], moved)
    (jv, jf, jt, _), (tv, tf, tt, t_moved) = out["jax"], out["port"]
    assert len(tf) > 0
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt - tris["port"], np.broadcast_to([1.0, 0.0, 0.0], tt.shape),
                               atol=1e-3)

    # both apps render the port's retargeted soup, then animate the model's
    j_pseudomesh.main(["render", "-m", j_model, "--triangles", t_moved])
    t_pseudomesh.main(["render", "-m", t_model, "--triangles", t_moved, "--device", "cpu"])
    _same_pngs(os.path.join(j_model, "renders_soup"), os.path.join(t_model, "renders_soup"), 2)
    j_pseudomesh.main(["animate", "-m", j_model, "--frames", "3"])
    t_pseudomesh.main(["animate", "-m", t_model, "--frames", "3", "--device", "cpu"])
    frames = _same_pngs(os.path.join(j_model, "soup_animated"),
                        os.path.join(t_model, "soup_animated"), 3)
    assert np.abs(frames[1] - frames[0]).max() > 0


def test_convert_matches_jax(tmp_path):
    """--skip_matching with `true` for colmap: the sparse model moves into
    sparse/0 and the image pyramids come out as the JAX app writes them."""
    srcs = []
    for name in ("jax", "port"):
        src = tmp_path / name
        for d in ("input", "images", "sparse"):
            (src / d).mkdir(parents=True)
        (src / "sparse" / "cameras.bin").write_bytes(b"x")
        rng = np.random.default_rng(0)
        for i in range(2):
            Image.fromarray((rng.random((32, 48, 3)) * 255).astype(np.uint8)).save(
                src / "images" / f"r_{i}.png")
        srcs.append(src)
    argv = ["--skip_matching", "--resize", "--colmap_executable", "true"]
    j_convert.main(["-s", str(srcs[0]), *argv])
    t_convert.main(["-s", str(srcs[1]), *argv])
    j_src, t_src = srcs
    assert (t_src / "sparse" / "0" / "cameras.bin").read_bytes() == b"x"
    assert os.listdir(t_src / "sparse") == ["0"]
    for factor in (2, 4, 8):
        names = sorted(os.listdir(t_src / f"images_{factor}"))
        assert names == sorted(os.listdir(j_src / f"images_{factor}")) == ["r_0.png", "r_1.png"]
        for name in names:
            a = np.asarray(Image.open(j_src / f"images_{factor}" / name))
            b = np.asarray(Image.open(t_src / f"images_{factor}" / name))
            assert b.shape == (32 // factor, 48 // factor, 3)
            np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit):  # a failing colmap ends the run with its code
        t_convert.main(["-s", str(t_src), "--skip_matching", "--colmap_executable", "false"])


def test_apps_import_no_jax(mesh_model, flat_model, tmp_path):
    """The apps import their modules inside main: run metrics (after a
    render), render_animated and pseudomesh save in a fresh process and
    check what it imported."""
    mesh, flat = (shutil.copytree(m, str(tmp_path / n)) for m, n in
                  ((mesh_model, "mesh"), (flat_model, "flat")))
    code = (
        "import sys\n"
        "from gaussian_mesh_splatting_tpu_torch.apps import metrics, pseudomesh, render, "
        "render_animated\n"
        f"render.main(['-m', {mesh!r}, '--skip_train', '--device', 'cpu'])\n"
        f"metrics.main(['-m', {mesh!r}, '--device', 'cpu'])\n"
        f"render_animated.main(['-m', {mesh!r}, '--frames', '2', '--device', 'cpu'])\n"
        f"pseudomesh.main(['save', '-m', {flat!r}, '--sh_degree', '1', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'orbax', 'flax', 'gaussian_mesh_splatting_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, GMS_LPIPS_WEIGHTS=str(tmp_path / "absent.npz"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert os.path.exists(os.path.join(mesh, "results_gs_mesh.json"))
    assert len(os.listdir(os.path.join(mesh, "animated_fly"))) == 2
    assert os.path.exists(os.path.join(flat, "pseudomesh", "triangles.npz"))
