"""The port's training app end to end on the CPU: `apps.train.main` on a tiny
seeded Blender_Mesh dataset writes the model directory (cfg_args,
cameras.json, input.ply, metrics, a snapshot) with a finite loss, and the
port's render app reads the snapshot back. Flags of paths that are not
ported raise NotImplementedError."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_mesh_splatting_tpu_torch import bench
from gaussian_mesh_splatting_tpu_torch.apps import render as t_render_app
from gaussian_mesh_splatting_tpu_torch.apps import train as t_train_app
from gaussian_mesh_splatting_tpu_torch.io.obj import save_obj

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


@pytest.mark.parametrize("extra,match", [
    (["--port", "6009"], "--port"),
    (["--profile_steps", "1:2"], "--profile_steps"),
    (["--checkpoint_iterations", "5"], "--checkpoint_iterations"),
    (["--start_checkpoint", "chkpnt5"], "--start_checkpoint"),
    (["--detect_anomaly"], "--detect_anomaly"),
])
def test_unported_flags_raise(dataset, tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        t_train_app.main(_argv(dataset, str(tmp_path / "m"), *extra))


def test_unported_gs_type_raises(dataset, tmp_path):
    argv = _argv(dataset, str(tmp_path / "m"))
    argv[1] = "gs"
    with pytest.raises(NotImplementedError, match="'gs' is not ported yet"):
        t_train_app.main(argv)


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
