"""`apps.train` in its parallel modes on the CPU: `--data_parallel`,
`--shard rows` and `--shard gaussians` at world 2 (gloo ranks spawned by
tests/torch_dist_worker.py) train `gs` with densify events on a tiny Blender
dataset with its own point cloud. Only rank 0 writes the model directory or
prints; every rank ends with the same state, bit for bit, after the densify
events; the loss falls. A viewer on rank 0 may pause training for longer
than the process group waits in a collective. A sharding flag with one
process trains as a single device does; with several cards and no process group it is an error that
names torchrun."""
import os

import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu_torch.apps import train as t_train_app
from gaussian_mesh_splatting_tpu_torch.io.ply import store_point_cloud

from test_torch_train_app import _write_dataset
from torch_dist_worker import spawn

ITERS = 12


@pytest.fixture(scope="module")
def points_dataset(tmp_path_factory):
    """A Blender dataset of 2 train views with a 200-point cloud."""
    root = str(tmp_path_factory.mktemp("points_scene"))
    _write_dataset(root)
    os.remove(os.path.join(root, "mesh.obj"))
    rng = np.random.default_rng(1)
    store_point_cloud(os.path.join(root, "points3d.ply"), rng.random((200, 3)) * 1.6 - 0.8,
                      rng.random((200, 3)) * 255)
    return root


def _argv(dataset, model, *extra):
    """gs with densify events at 10 and 12 (no opacity reset in the run)."""
    return ["--gs_type", "gs", "-s", dataset, "-m", model, "--eval", "--sh_degree", "1",
            "--white_background", "--iterations", str(ITERS), "--densify_from_iter", "9",
            "--densification_interval", "2", "--opacity_reset_interval", "1000",
            "--densify_grad_threshold", "1e-7", "--capacity_mult", "3",
            "--test_iterations", str(ITERS), "--save_iterations", str(ITERS),
            "--device", "cpu", *extra]


FLAGS = {"data_parallel": ["--data_parallel"], "rows": ["--shard", "rows"],
         "gaussians": ["--shard", "gaussians"]}


@pytest.fixture(scope="module")
def app_runs(points_dataset, tmp_path_factory):
    """The three modes, one after another on the same 2 ranks (a rank's
    start-up, TensorBoard's import included, is most of a run's time)."""
    root = tmp_path_factory.mktemp("app_runs")
    cases = {mode: ("train_app", dict(argv=_argv(points_dataset, str(root / mode), *flag),
                                      model_path=str(root / mode)))
             for mode, flag in FLAGS.items()}
    return spawn(cases, 2, root / "ranks")


@pytest.mark.parametrize("mode", list(FLAGS))
def test_train_app_parallel_modes_at_world_2(app_runs, mode):
    r0, r1 = (r[mode] for r in app_runs)
    # rank 0 alone writes the model directory and prints
    for name in ("cfg_args", "cameras.json", "input.ply", "metrics.jsonl",
                 os.path.join("point_cloud", f"iteration_{ITERS}", "point_cloud.ply")):
        assert name in r0["writes"], name
    assert r1["writes"] == [] and r1["stdout"] == ""
    assert "parallel over 2 processes" in r0["stdout"]
    assert sorted(r0["test_psnr"]) == [ITERS] and r1["test_psnr"] == {}
    # one replicated state, through the densify events
    assert [e["iteration"] for e in r0["densify_events"]] == [10, 12]
    assert r0["densify_events"] == r1["densify_events"]
    assert any(e["n_clone"] + e["n_split_rows"] > 0 for e in r0["densify_events"])
    assert torch.equal(r0["alive"], r1["alive"]) and r0["step"] == r1["step"] == ITERS
    for k, p in r0["params"].items():
        assert torch.equal(p, r1["params"][k]), k
    assert r0["losses"] == r1["losses"] and np.isfinite(r0["losses"]).all()
    # before the events (each splits most rows: the loss jumps)
    assert np.mean(r0["losses"][6:9]) < np.mean(r0["losses"][:3])


def test_viewer_pause_holds_every_rank(points_dataset, tmp_path):
    """A viewer on rank 0 unchecks "train" for longer than the job's process
    group waits in a collective (4 s here); the other rank waits outside
    that group, and the run ends with one state on both ranks."""
    import datetime
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    model = str(tmp_path / "m")
    case = ("train_app_paused", dict(argv=_argv(points_dataset, model, "--shard", "rows",
                                                "--iterations", "3", "--quiet"),
                                     model_path=model, port=port, pause_s=6.0))
    r0, r1 = (r["run"] for r in spawn({"run": case}, 2, tmp_path / "ranks",
                                      init_kwargs={"timeout": datetime.timedelta(seconds=4)}))
    assert r0["viewer_done"] and r0["viewer"]["pause_s"] >= 6.0
    assert r0["viewer"]["frames"] > 1
    assert r0["step"] == r1["step"] == 3 and r0["losses"] == r1["losses"]
    for k, p in r0["params"].items():
        assert torch.equal(p, r1["params"][k]), k


def test_one_process_trains_as_a_single_device(points_dataset, tmp_path, capsys):
    res = t_train_app.main(_argv(points_dataset, str(tmp_path / "m"), "--shard", "gaussians",
                                 "--iterations", "3", "--quiet"))
    assert res.state.step == 3 and np.isfinite(res.losses).all()
    assert "parallel over" not in capsys.readouterr().out


def test_several_cards_without_a_process_group_raise(points_dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    argv = [a for a in _argv(points_dataset, str(tmp_path / "m"), "--data_parallel")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
        t_train_app.main(argv)
