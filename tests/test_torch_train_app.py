"""The port's training app end to end on the CPU: `apps.train.main` on a tiny
seeded Blender_Mesh dataset writes the model directory (cfg_args,
cameras.json, input.ply, metrics, a snapshot) with a finite loss, and the
port's render app reads the snapshot back; on a Blender dataset with a small
point cloud it trains `gs` and `gs_flat` with densify events and an opacity
reset, writes a checkpoint and resumes from it, and the render app renders
the snapshot (a `gs_flat` one also as `gs_points`). On a COLMAP dataset with
two meshes it trains `gs_multi_mesh` (checkpoint, resume, render) and `gs`;
on a Blender dataset with a FLAME pickle it trains `gs_flame`, which the
render app and `apps.render_flame` render. A non-finite loss dumps the
inputs of its step (with and without `--detect_anomaly`, whose anomaly mode
ends with the run); the GT images go to the device only within a byte
budget; `--profile_steps` writes a `torch.profiler` trace; `--port` serves
the SIBR viewer's protocol (the protocol itself against the JAX package's
`apps/network_gui`). A malformed flag or a gs_type without what it needs
raises ValueError, a GUI address in use OSError."""
import json
import os
import socket
import struct
import threading
import time

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


@pytest.fixture
def busy_port():
    """A port on 127.0.0.1 that a listening socket holds: it cannot be bound."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        yield s.getsockname()[1]


@pytest.mark.parametrize("extra,error,match", [
    # --port on an address that cannot be bound
    (["--ip", "127.0.0.1", "--port", "BUSY"], OSError, "Address already in use"),
    (["--profile_steps", "5"], ValueError, "START:STOP"),
    # gs_multi_mesh on a Blender dataset: it needs a COLMAP one with meshes
    (["--gs_type", "gs_multi_mesh"], ValueError, "needs a COLMAP dataset with meshes"),
    (["--gs_type", "gs_flame"], ValueError, "needs a FLAME model pickle"),
    (["--profile_steps", "3:2"], ValueError, "START <= STOP"),
])
def test_unported_flags_raise(dataset, tmp_path, busy_port, extra, error, match):
    # what a flag refuses: an address in use, a malformed step range; a
    # gs_type without what it needs
    extra = [str(busy_port) if x == "BUSY" else x for x in extra]
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


# ------------------------------------------- the debug dump, anomaly mode, GT

def _poison_from(monkeypatch, poisoned_it, seen):
    """Wrap the train step so that the loss of iteration `poisoned_it` and
    after is NaN; record the state before and after that step in `seen`, and
    whether anomaly mode was on during the steps."""
    import gaussian_mesh_splatting_tpu_torch.train as train_pkg

    real_make = train_pkg.make_train_step

    def params_of(tstate):
        return {k: v.detach().clone() for k, v in tstate.params.items()}

    def poisoned_make(*a, **kw):
        step = real_make(*a, **kw)

        def wrapped(tstate, cam, gt, bg):
            it = tstate.step + 1
            seen.setdefault("anomaly", []).append(torch.is_anomaly_enabled())
            if it == poisoned_it:
                seen["before"] = {"step": tstate.step, "params": params_of(tstate),
                                  "alive": tstate.alive.clone()}
            tstate, metrics = step(tstate, cam, gt, bg)
            if it == poisoned_it:
                seen["after"] = {"step": tstate.step, "params": params_of(tstate)}
            if it >= poisoned_it:
                metrics = dict(metrics, loss=torch.tensor(float("nan")))
            return tstate, metrics

        return wrapped

    monkeypatch.setattr(train_pkg, "make_train_step", poisoned_make)


@pytest.mark.parametrize("anomaly", [False, True], ids=["plain", "detect_anomaly"])
def test_nan_dump_holds_the_step_inputs(dataset, tmp_path, monkeypatch, anomaly):
    """A non-finite loss dumps the inputs of its step: the params and step
    count before the in-place update, exactly. Without --detect_anomaly the
    loss is read at iteration 1 and every 100th; with it, every iteration."""
    poisoned_it = 2 if anomaly else 1
    seen = {}
    _poison_from(monkeypatch, poisoned_it, seen)
    model = str(tmp_path / "m")
    with pytest.raises(RuntimeError, match=f"non-finite loss at iteration {poisoned_it}; "
                                           "step inputs dumped"):
        t_train_app.main(_argv(dataset, model, *(["--detect_anomaly"] if anomaly else [])))
    assert not torch.is_anomaly_enabled()
    assert seen["anomaly"] == [anomaly] * poisoned_it
    before, after = seen["before"], seen["after"]
    with np.load(os.path.join(model, f"debug_dump_{poisoned_it}.npz")) as blob:
        assert int(blob["step"]) == before["step"] == poisoned_it - 1 == after["step"] - 1
        assert sorted(k for k in blob.files if k.startswith("params/")) == \
            sorted(f"params/{k}" for k in before["params"])
        for k, v in before["params"].items():
            np.testing.assert_array_equal(blob[f"params/{k}"], v.numpy(), err_msg=k)
        np.testing.assert_array_equal(blob["alive"], before["alive"].numpy())
        assert "consts/faces" in blob and "camera/world_view" in blob
        # the step moved the params: the dump is not the state after it
        assert any(not np.array_equal(blob[f"params/{k}"], v.numpy())
                   for k, v in after["params"].items())


def test_detect_anomaly_mode_ends_with_the_run(dataset, tmp_path, monkeypatch):
    seen = {}
    _poison_from(monkeypatch, ITERS + 1, seen)  # never poisons
    res = t_train_app.main(_argv(dataset, str(tmp_path / "m"), "--detect_anomaly"))
    assert len(res.losses) == ITERS and np.isfinite(res.losses).all()
    assert seen["anomaly"] == [True] * ITERS
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("fits", [True, False], ids=["on_device", "on_host"])
def test_gt_placement_follows_the_budget(fits):
    """The GT images go to the device when their bytes fit the budget, else
    they stay on the host (the meta device stands in for a card)."""
    images = [np.random.default_rng(i).random((8, 6, 3)).astype(np.float32) for i in range(3)]
    total = sum(g.nbytes for g in images)
    gts, on_device = t_train_app.place_gt(images, torch.device("meta"),
                                          total if fits else total - 1)
    assert on_device is fits
    assert [g.device.type for g in gts] == ["meta" if fits else "cpu"] * 3
    assert all(g.shape == (8, 6, 3) for g in gts)
    if not fits:
        for g, ref in zip(gts, images):
            np.testing.assert_array_equal(g.numpy(), ref)
        assert gts[0].to("meta", non_blocking=True).device.type == "meta"
    assert t_train_app.gt_budget(torch.device("cpu")) == float("inf")


def test_profile_steps_write_a_trace(dataset, tmp_path):
    model = str(tmp_path / "m")
    res = t_train_app.main(_argv(dataset, model, "--profile_steps", "2:3"))
    assert len(res.losses) == ITERS
    with open(os.path.join(model, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    # steps 2 and 3, each one Adam step
    assert sum(e.get("name") == "Optimizer.step#Adam.step" for e in events) == 2
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    # the port's spans of the same steps: six stages each, the step as request
    with open(os.path.join(model, "profile", "spans.json")) as f:
        spans = json.load(f)
    stages = [s for s in spans["spans"] if s["parent"] is None]
    assert [s["name"] for s in stages] == ["to_bag", "render", "loss", "backward", "adam",
                                           "stats"] * 2
    assert sorted({s["request"] for s in spans["spans"]}) == [1, 2]
    assert {s["path"] for s in spans["spans"]} >= {"render/bin/bin_sync",
                                                   "backward/composite_bwd"}
    assert spans["totals"]["host_syncs"] == 6 and spans["totals"]["pairs"] > 0


# ---------------------------------------------------------------- network GUI

def _viewer_message(width=32, height=16, train=True, keep_alive=True, cam=None):
    """A SIBR viewer request; `cam` (a port Camera) sets the view, else the
    JAX test's identity view 4 units out."""
    if cam is None:
        view = np.eye(4)
        view[3, 2] = 4.0  # glm's row-vector convention: the translation in row 3
        proj, fovx, fovy = np.eye(4), 0.8, 0.8
    else:
        view, proj = cam.world_view.numpy().T, cam.full_proj.numpy().T
        fovx, fovy = 2 * np.arctan(float(cam.tanfovx)), 2 * np.arctan(float(cam.tanfovy))
    return {
        "resolution_x": width, "resolution_y": height, "train": train,
        "fov_y": fovy, "fov_x": fovx, "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
        "scaling_modifier": 1.0,
        "view_matrix": np.asarray(view, np.float64).reshape(-1).tolist(),
        "view_projection_matrix": np.asarray(proj, np.float64).reshape(-1).tolist(),
    }


def _send_msg(sock, msg: dict):
    payload = json.dumps(msg).encode("utf-8")
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_exact(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        assert chunk, "server closed early"
        out += chunk
    return out


def _read_reply(sock, n_image_bytes):
    img = _recv_exact(sock, n_image_bytes)
    (slen,) = struct.unpack("<I", _recv_exact(sock, 4))
    return img, _recv_exact(sock, slen).decode()


@pytest.fixture
def gui():
    from gaussian_mesh_splatting_tpu_torch.apps.network_gui import NetworkGUI

    server = NetworkGUI("127.0.0.1", 0)
    yield server
    server.close()


def _viewer_thread(port, script):
    """Run `script(sock)` on a viewer connection in a thread; the socket has
    a 20 s deadline on every operation."""
    def run():
        with socket.create_connection(("127.0.0.1", port), timeout=20) as c:
            script(c)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_gui_request_response_roundtrip(gui):
    from gaussian_mesh_splatting_tpu_torch.apps import network_gui

    width, height = 32, 16
    results = {}

    def script(c):
        _send_msg(c, _viewer_message(width, height, train=False))
        results["img"], results["path"] = _read_reply(c, width * height * 3)

    t = _viewer_thread(gui.listener.getsockname()[1], script)
    assert gui.try_connect(timeout=20)
    cam, do_training, keep_alive, scaling_mod = network_gui.parse_camera(gui.receive(), "cpu")
    assert (do_training, keep_alive, scaling_mod) == (False, True, 1.0)
    assert (cam.width, cam.height) == (width, height)
    # the glm row-vector matrices are transposed back
    np.testing.assert_allclose(cam.world_view.numpy()[2, 3], 4.0)
    img = np.zeros((height, width, 3), np.float32)
    img[..., 0] = 1.0  # a red frame
    gui.send(network_gui.image_to_bytes(img), "/data/scene")
    t.join(timeout=20)
    assert not t.is_alive()
    got = np.frombuffer(results["img"], np.uint8).reshape(height, width, 3)
    assert (got[..., 0] == 255).all() and (got[..., 1:] == 0).all()
    assert results["path"] == "/data/scene"


def test_gui_zero_resolution_parses_to_none(gui):
    """A 0x0 request (the viewer's handshake) builds no camera; the reply is
    the source path alone."""
    from gaussian_mesh_splatting_tpu_torch.apps import network_gui

    results = {}

    def script(c):
        _send_msg(c, _viewer_message(0, 0))
        results["path"] = _read_reply(c, 0)[1]

    t = _viewer_thread(gui.listener.getsockname()[1], script)
    assert gui.try_connect(timeout=20)
    assert network_gui.parse_camera(gui.receive(), "cpu") is None
    gui.send(None, "/data/scene")
    t.join(timeout=20)
    assert not t.is_alive() and results["path"] == "/data/scene"


def test_gui_do_training_false_pauses(gui):
    """With train=False the poll keeps serving frames without returning to
    training; train=True lets it go on: four requests, one poll."""
    from gaussian_mesh_splatting_tpu_torch.apps import network_gui

    size = 8
    served = []

    def script(c):
        for train in (False, False, False, True):
            _send_msg(c, _viewer_message(size, size, train=train))
            _read_reply(c, size * size * 3)

    t = _viewer_thread(gui.listener.getsockname()[1], script)
    assert gui.try_connect(timeout=20)
    while gui.try_connect():  # apps.train's poll, with a grey frame
        parsed = network_gui.parse_camera(gui.receive(), "cpu")
        served.append(parsed[1])
        gui.send(network_gui.image_to_bytes(np.full((size, size, 3), 0.5, np.float32)), "src")
        if parsed[1]:
            break
    t.join(timeout=20)
    assert not t.is_alive() and served == [False, False, False, True]


def test_gui_parse_camera_matches_jax():
    from gaussian_mesh_splatting_tpu.apps import network_gui as j_gui
    from gaussian_mesh_splatting_tpu_torch.apps import network_gui
    from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera

    rng = np.random.default_rng(3)
    rot, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    cam = make_camera(rot, rng.standard_normal(3), 0.7, 0.5, 48, 40, device="cpu")
    msg = json.loads(json.dumps(_viewer_message(48, 40, cam=cam)))
    got, ref = network_gui.parse_camera(msg, "cpu"), j_gui.parse_camera(msg)
    assert got[1:] == ref[1:]
    for attr in ("world_view", "full_proj", "cam_center", "tanfovx", "tanfovy", "znear", "zfar"):
        np.testing.assert_array_equal(getattr(got[0], attr).numpy(),
                                      np.asarray(getattr(ref[0], attr)), err_msg=attr)
    assert (got[0].width, got[0].height) == (ref[0].width, ref[0].height) == (48, 40)
    # the round trip through the viewer's convention gives the camera back
    np.testing.assert_allclose(got[0].world_view.numpy(), cam.world_view.numpy(), atol=1e-6)
    np.testing.assert_allclose(got[0].cam_center.numpy(), cam.cam_center.numpy(), atol=1e-5)


def test_train_app_serves_the_gui(dataset, tmp_path, monkeypatch):
    """apps.train --port: a viewer that asks for one frame with train=True
    gets the render of a test camera and the source path; training goes on.
    The loop's first poll waits for the viewer (up to 30 s), so the frame
    does not depend on when the viewer thread runs."""
    from gaussian_mesh_splatting_tpu_torch.apps.network_gui import NetworkGUI
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    polls = []
    real_try_connect = NetworkGUI.try_connect

    def first_poll_waits(self, timeout=0.0):
        polls.append(timeout)
        return real_try_connect(self, 30.0 if len(polls) == 1 else timeout)

    monkeypatch.setattr(NetworkGUI, "try_connect", first_poll_waits)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cam = Scene(dataset, "gs_mesh", eval=True, shuffle=False, device="cpu").test_cameras[0][0]
    results = {}

    def viewer():
        deadline = time.monotonic() + 60
        while True:  # the trainer binds the port at its start
            try:
                c = socket.create_connection(("127.0.0.1", port), timeout=20)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
        with c:
            _send_msg(c, _viewer_message(32, 32, train=True, cam=cam))
            results["img"], results["path"] = _read_reply(c, 32 * 32 * 3)

    t = threading.Thread(target=viewer, daemon=True)
    t.start()
    res = t_train_app.main(_argv(dataset, str(tmp_path / "m"), "--port", str(port)))
    t.join(timeout=20)
    assert not t.is_alive()
    assert len(res.losses) == ITERS and np.isfinite(res.losses).all()
    assert results["path"] == dataset
    img = np.frombuffer(results["img"], np.uint8).reshape(32, 32, 3)
    assert img.std() > 1.0  # the mesh on white, not a constant frame


# ------------------------------------------------------------------ utilities

def test_safe_state_seeds_and_silences(capsys):
    import random
    import sys

    from gaussian_mesh_splatting_tpu_torch.utils.general import safe_state

    stdout = sys.stdout
    try:
        safe_state(silent=False, seed=3)
        draws = (random.random(), np.random.random(), float(torch.rand(())))
        print("a line")
        safe_state(silent=True, seed=3)
        assert (random.random(), np.random.random(), float(torch.rand(()))) == draws
        print("dropped")
    finally:
        sys.stdout = stdout
    out = capsys.readouterr().out
    assert "a line [" in out and "dropped" not in out
