"""The port's training app end to end on the CPU: `apps.train.main` on a tiny
seeded Blender_Mesh dataset writes the model directory (cfg_args,
cameras.json, input.ply, metrics, a snapshot) with a finite loss, and the
port's render app reads the snapshot back; on a Blender dataset with a small
point cloud it trains `gs` and `gs_flat` with densify events and an opacity
reset, writes a checkpoint and resumes from it, and the render app renders
the snapshot (a `gs_flat` one also as `gs_points`). On a COLMAP dataset with
two meshes it trains `gs_multi_mesh` (checkpoint, resume, render) and `gs`;
on a Blender dataset with a FLAME pickle it trains `gs_flame`, which the
render app and `apps.render_flame` render. Flags of paths that are not
ported raise NotImplementedError; a gs_type without what it needs raises
ValueError."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_mesh_splatting_tpu_torch import bench
from gaussian_mesh_splatting_tpu_torch.apps import render as t_render_app
from gaussian_mesh_splatting_tpu_torch.apps import render_flame as t_render_flame_app
from gaussian_mesh_splatting_tpu_torch.apps import train as t_train_app
from gaussian_mesh_splatting_tpu_torch.io.obj import save_obj
from gaussian_mesh_splatting_tpu_torch.io.ply import store_point_cloud

torch.set_num_threads(2)
ITERS = 10


def _write_dataset(root, n_cams=2, size=32):
    """Blender_Mesh dataset: an octahedron and a ring of cameras, with
    seeded random images."""
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
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    _write_dataset(root)
    return root


@pytest.fixture(scope="module")
def points_dataset(tmp_path_factory):
    """A Blender dataset with its own `points3d.ply`: 200 seeded points (with
    none the reader would make 100,000)."""
    root = str(tmp_path_factory.mktemp("points_scene"))
    _write_dataset(root)
    os.remove(os.path.join(root, "mesh.obj"))
    rng = np.random.default_rng(1)
    store_point_cloud(os.path.join(root, "points3d.ply"), rng.random((200, 3)) * 1.6 - 0.8,
                      rng.random((200, 3)) * 255)
    return root


def _argv(dataset, model, *extra, device="cpu"):
    return ["--gs_type", "gs_mesh", "-s", dataset, "-m", model, "--eval",
            "--num_splats", "3", "--sh_degree", "1", "--white_background",
            "--iterations", str(ITERS), "--test_iterations", "1", str(ITERS),
            "--save_iterations", str(ITERS), "--quiet", *extra,
            *(["--device", device] if device else [])]


def test_train_app_writes_a_model_the_render_app_reads(dataset, tmp_path):
    model = str(tmp_path / "model")
    res = t_train_app.main(_argv(dataset, model))
    assert len(res.losses) == ITERS and np.isfinite(res.losses).all()
    assert sorted(res.test_psnr) == [1, ITERS]
    assert res.state.step == ITERS
    for name in ("cfg_args", "cameras.json", "input.ply", "metrics.jsonl"):
        assert os.path.exists(os.path.join(model, name)), name
    with open(os.path.join(model, "cameras.json")) as f:
        assert len(json.load(f)) == 4
    snap = os.path.join(model, "point_cloud", f"iteration_{ITERS}")
    assert os.path.exists(os.path.join(snap, "point_cloud.ply"))
    assert os.path.exists(os.path.join(snap, "model_params.npz"))
    t_render_app.main(["-m", model, "--device", "cpu"])
    png = os.path.join(model, "test", f"ours_{ITERS}", "renders_gs_mesh", "00000.png")
    img = np.asarray(Image.open(png))
    assert img.shape == (32, 32, 3) and img.std() > 1.0


def test_train_app_pair_capacity_grows_on_overflow(dataset, tmp_path, capsys):
    res = t_train_app.main(_argv(dataset, str(tmp_path / "m"), "--pair_capacity", "4"))
    assert np.isfinite(res.losses).all()
    assert "growing pair_capacity to 8" in capsys.readouterr().out


def _points_argv(gs_type, dataset, model, iterations, *extra):
    """A run whose schedule is brought forward through the CLI's own flags:
    events at 4, 6, 8, ..., the size threshold on after the reset at 6."""
    return ["--gs_type", gs_type, "-s", dataset, "-m", model, "--eval", "--sh_degree", "1",
            "--white_background", "--iterations", str(iterations),
            "--densify_from_iter", "3", "--densification_interval", "2",
            "--opacity_reset_interval", "6", "--densify_grad_threshold", "1e-7",
            "--capacity_mult", "3", "--test_iterations", "1", str(iterations),
            "--save_iterations", str(iterations), "--quiet", "--device", "cpu", *extra]


@pytest.mark.parametrize("gs_type", ["gs", "gs_flat"])
def test_train_app_densifies_checkpoints_resumes_and_renders(gs_type, points_dataset, tmp_path,
                                                             capsys):
    model = str(tmp_path / "model")
    res = t_train_app.main(_points_argv(gs_type, points_dataset, model, 10,
                                        "--checkpoint_iterations", "7"))
    assert len(res.losses) == 10 and np.isfinite(res.losses).all()
    events = res.densify_events
    assert [e["iteration"] for e in events] == [4, 6, 8, 10]
    assert events[0]["n_clone"] + events[0]["n_split_rows"] > 0
    assert all(e["n_alive"] <= 600 for e in events) and events[-1]["n_alive"] != 200
    assert sum(e["n_pruned"] for e in events) > 0
    # the size threshold is off up to the opacity reset interval, on after it
    assert all(e["n_pruned_screen"] == e["n_pruned_world"] == 0 for e in events[:2])
    state = res.state
    assert state.alive.shape == (600,) and int(state.alive.sum()) == events[-1]["n_alive"]
    assert state.params["scaling"].shape == (600, 3 if gs_type == "gs" else 2)
    assert all(bool(torch.isfinite(p).all()) for p in state.params.values())
    # the opacity reset at iteration 6 (the white-background one at 3 too)
    assert float(torch.sigmoid(state.params["opacity"].detach()[state.alive]).max()) < 0.5
    snap = os.path.join(model, "point_cloud", "iteration_10")
    assert os.listdir(snap) == ["point_cloud.ply"]  # no sidecar
    assert os.path.exists(os.path.join(model, "chkpnt7.pt"))

    # resume: begins at the checkpoint's step, with its rows, whatever
    # --capacity_mult says now
    resumed = t_train_app.main(_points_argv(
        gs_type, points_dataset, str(tmp_path / "resumed"), 10, "--capacity_mult", "2",
        "--start_checkpoint", os.path.join(model, "chkpnt7.pt")))
    assert len(resumed.losses) == 3 and resumed.state.step == 10
    assert [e["iteration"] for e in resumed.densify_events] == [8, 10]
    assert resumed.state.alive.shape == (600,)
    assert (f"at step 7 ({events[1]['n_alive']} alive of 600 rows)"
            in capsys.readouterr().out)  # the alive count the event at 6 left

    t_render_app.main(["-m", model, "--device", "cpu"])
    png = os.path.join(model, "test", "ours_10", f"renders_{gs_type}", "00001.png")
    assert np.asarray(Image.open(png)).shape == (32, 32, 3)
    if gs_type == "gs_flat":
        t_render_app.main(["-m", model, "--gs_type", "gs_points", "--device", "cpu"])
        a = np.asarray(Image.open(png), np.int32)
        b = np.asarray(Image.open(png.replace("renders_gs_flat", "renders_gs_points")), np.int32)
        assert np.abs(a - b).max() <= 2  # the soup round trip, within 2/255


def test_train_app_capacity_mult_sizes_the_buffer(points_dataset, tmp_path):
    res = t_train_app.main(_points_argv("gs", points_dataset, str(tmp_path / "m"), 2,
                                        "--capacity_mult", "1.5"))
    assert res.state.alive.shape == (300,) and int(res.state.alive.sum()) == 200
    assert res.densify_events == []


@pytest.mark.parametrize("extra,match", [
    (["--port", "6009"], "--port"),
    (["--profile_steps", "1:2"], "--profile_steps"),
    # gs_multi_mesh on a Blender dataset: it needs a COLMAP one with meshes
    (["--gs_type", "gs_multi_mesh"], "needs a COLMAP dataset with meshes"),
    (["--gs_type", "gs_flame"], "needs a FLAME model pickle"),
    (["--detect_anomaly"], "--detect_anomaly"),
])
def test_unported_flags_raise(dataset, tmp_path, extra, match):
    # a flag of an unported path raises NotImplementedError; a gs_type
    # without what it needs, ValueError
    error = NotImplementedError if match.startswith("--") else ValueError
    with pytest.raises(error, match=match):
        t_train_app.main(_argv(dataset, str(tmp_path / "m"), *extra))


def test_unported_gs_type_raises(tmp_path):
    """gs_multi_mesh on a COLMAP dataset without meshes."""
    from test_torch_colmap import make_colmap_dataset

    root = make_colmap_dataset(str(tmp_path / "scene"))
    with pytest.raises(ValueError, match="no meshes"):
        t_train_app.main(["--gs_type", "gs_multi_mesh", "-s", root, "-m", str(tmp_path / "m"),
                          "--iterations", "1", "--device", "cpu"])


def test_train_app_needs_a_card_unless_asked_for_cpu(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train_app.main(_argv(dataset, str(tmp_path / "m"), device=None))


def test_bench_runs_on_cpu_and_refuses_zero_gradients(monkeypatch):
    res = bench.run(n=64, size=32, iters=1, device="cpu")
    assert res["value"] > 0 and res["grad_l1"] > 1e-3
    make_params = bench.make_params

    def behind_camera(n, seed, device):
        params = make_params(n, seed, device)
        with torch.no_grad():
            params["xyz"][:, 2] -= 100.0
        return params

    # every Gaussian behind the camera: nothing renders, every gradient is 0
    monkeypatch.setattr(bench, "make_params", behind_camera)
    with pytest.raises(SystemExit, match="BENCH REFUSED"):
        bench.run(n=64, size=32, iters=1, device="cpu")


# ---------------------------------------------------------------- COLMAP, FLAME

@pytest.fixture(scope="module")
def colmap_dataset(tmp_path_factory):
    """A COLMAP dataset of 9 cameras (llffhold: 7 train, 2 test) with two
    meshes in `sparse/0`."""
    from test_torch_colmap import make_colmap_dataset

    return make_colmap_dataset(str(tmp_path_factory.mktemp("colmap")), n_cams=9, size=24,
                               with_meshes=True)


def test_train_app_multi_mesh_checkpoints_resumes_and_renders(colmap_dataset, tmp_path, capsys):
    model = str(tmp_path / "model")
    argv = ["--gs_type", "gs_multi_mesh", "-s", colmap_dataset, "--eval", "--num_splats", "2",
            "--sh_degree", "1", "--test_iterations", "1", "6", "--save_iterations", "6",
            "--quiet", "--device", "cpu"]
    res = t_train_app.main([*argv, "-m", model, "--iterations", "6",
                            "--checkpoint_iterations", "4"])
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert sorted(res.test_psnr) == [1, 6]
    p = res.state.params
    assert [len(p[k]) for k in ("vertices", "alpha", "scale")] == [2, 2, 2]
    assert p["f_dc"].shape == (2 * 4 * 2, 1, 3)
    assert all(float(a.grad.abs().max()) > 0 for a in p["alpha"])
    snap = os.path.join(model, "point_cloud", "iteration_6")
    assert sorted(os.listdir(snap)) == ["model_params.npz", "point_cloud.ply"]
    resumed = t_train_app.main([*argv, "-m", str(tmp_path / "resumed"), "--iterations", "6",
                                "--start_checkpoint", os.path.join(model, "chkpnt4.pt")])
    assert len(resumed.losses) == 2 and resumed.state.step == 6
    assert "at step 4" in capsys.readouterr().out
    t_render_app.main(["-m", model, "--device", "cpu"])
    for split, n in (("train", 7), ("test", 2)):
        pngs = sorted(os.listdir(os.path.join(model, split, "ours_6", "renders_gs_multi_mesh")))
        assert len(pngs) == n
    img = np.asarray(Image.open(os.path.join(model, "test", "ours_6", "renders_gs_multi_mesh",
                                             "00000.png")))
    assert img.shape == (24, 24, 3) and img.std() > 1.0


def test_train_app_gs_on_colmap(colmap_dataset, tmp_path):
    """`gs` from the COLMAP point cloud (50 points), with one densify event."""
    res = t_train_app.main(_points_argv("gs", colmap_dataset, str(tmp_path / "m"), 4))
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()
    assert res.state.alive.shape == (150,) and [e["iteration"] for e in res.densify_events] == [4]
    assert os.path.exists(os.path.join(colmap_dataset, "sparse/0/points3D.ply"))


@pytest.fixture(scope="module")
def flame_setup(tmp_path_factory):
    """A Blender dataset whose cameras look at a FLAME-like head, and the
    head's rig written as a FLAME pickle."""
    from test_torch_colmap import _tetrahedron
    from test_torch_flame import head_rigs, write_blender_dataset, write_flame_pickle

    base = tmp_path_factory.mktemp("flame")
    verts, faces = _tetrahedron()
    # a tetrahedral head, 4 faces: 400 Gaussians at 100 splats per face
    jr, _ = head_rigs(mesh=(verts * 0.2 - 0.05, faces))
    return (write_blender_dataset(str(base / "scene"), radius=1.6),
            write_flame_pickle(str(base / "flame.pkl"), jr))


def test_train_app_gs_flame_and_render_flame(flame_setup, tmp_path):
    dataset, pkl = flame_setup
    model = str(tmp_path / "model")
    res = t_train_app.main(["--gs_type", "gs_flame", "-s", dataset, "-m", model,
                            "--flame_model", pkl, "--eval", "--sh_degree", "1",
                            "--white_background", "--iterations", "3", "--test_iterations", "3",
                            "--save_iterations", "3", "--quiet", "--device", "cpu"])
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    p = res.state.params
    assert p["alpha"].shape == (4, 100, 3)  # 100 splats per face by default
    for k in ("flame_shape", "flame_exp", "flame_pose", "flame_neck_pose", "flame_trans",
              "vertices_enlargement"):
        assert torch.isfinite(p[k].grad).all() and float(p[k].grad.abs().max()) > 0, k
    t_render_app.main(["-m", model, "--device", "cpu"])
    png = os.path.join(model, "test", "ours_3", "renders_gs_flame", "00000.png")
    assert np.asarray(Image.open(png)).std() > 1.0
    t_render_flame_app.main(["-m", model, "--animated", "--frames", "4", "--dump_obj",
                             "--device", "cpu"])
    out = os.path.join(model, "renders_flame_animated")
    names = sorted(os.listdir(out))
    assert names == [f"{i:05d}.png" for i in range(4)] + [f"head_{i:05d}.obj" for i in range(4)]
    frames = [np.asarray(Image.open(os.path.join(out, n)), np.int32) for n in names[:4]]
    assert frames[0].shape == (24, 24, 3)
    assert np.abs(frames[1] - frames[0]).max() > 0  # the jaw and expression moved
    t_render_flame_app.main(["-m", model, "--device", "cpu"])
    assert os.listdir(os.path.join(model, "renders_flame")) == ["00000.png"]
