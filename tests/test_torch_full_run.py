"""`tools_torch_full_run.py --gs_type gs` builds the JAX package's `gs` leg
(`tools_verify_scale.py` `run_training("gs")`, its command captured without
running it): the same apps.train flags (test iterations, SH degree,
background, iteration count, no `--num_splats`) at the full and the
`--quick` schedule, on a dataset with no `points3d.ply`, from which the
Blender reader makes its 100,000 seeded points. No training step runs."""
import os
import sys
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tools_torch_full_run as full_run  # noqa: E402
import tools_verify_scale as jax_leg  # noqa: E402
from gaussian_mesh_splatting_tpu_torch.scene import Scene  # noqa: E402


def flags(argv: list[str]) -> dict:
    """{flag: [values]} of an argument list."""
    out, key = {}, None
    for a in argv:
        if a.startswith("-"):
            key = a
            out[key] = []
        else:
            out[key].append(a)
    return out


def jax_leg_command(monkeypatch, quick: bool) -> list[str]:
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return types.SimpleNamespace(stdout="", stderr="", returncode=0)

    monkeypatch.setattr(jax_leg, "QUICK", quick)
    monkeypatch.setattr(jax_leg.subprocess, "run", fake_run)
    jax_leg.run_training("gs")
    (cmd,) = seen
    return cmd[cmd.index("gaussian_mesh_splatting_tpu.apps.train") + 1:]


@pytest.mark.parametrize("quick", [False, True], ids=["30k", "quick"])
def test_gs_leg_builds_the_jax_legs_run(monkeypatch, quick):
    want = flags(jax_leg_command(monkeypatch, quick))
    iterations = full_run.QUICK_ITERS if quick else 30_000
    tests = full_run.QUICK_TEST_ITERS if quick else full_run.TEST_ITERS
    got = flags(full_run.train_argv("gs", "data", "model", iterations, tests))
    for key in ("--gs_type", "--eval", "--iterations", "--sh_degree", "--white_background",
                "--test_iterations", "--save_iterations"):
        assert got[key] == want[key], key
    assert "--num_splats" not in got and "--num_splats" not in want
    # the port's flags beyond the JAX leg's: the buffer's multiple, at its default
    assert set(got) - set(want) == {"--capacity_mult"} and got["--capacity_mult"] == ["4"]
    assert set(want) - set(got) == {"--backend"}  # the port picks its backend by device


def test_gs_mesh_leg_keeps_its_splats():
    got = flags(full_run.train_argv("gs_mesh", "data", "model", 30_000, full_run.TEST_ITERS))
    assert got["--num_splats"] == ["10"] and got["--gs_type"] == ["gs_mesh"]
    assert "--capacity_mult" not in got


def test_gs_dataset_has_no_point_cloud(monkeypatch, tmp_path):
    monkeypatch.setattr(full_run, "N_TRAIN", 3)
    monkeypatch.setattr(full_run, "N_TEST", 2)
    for gs_type in ("gs_mesh", "gs"):
        root = tmp_path / gs_type
        root.mkdir()
        full_run.prepare_dataset(str(root), gs_type, torch.device("cpu"), render_gt=False)
        assert (root / "points3d.ply").exists() == (gs_type == "gs_mesh")
    scene = Scene(str(tmp_path / "gs"), "gs", white_background=True, eval=True, shuffle=False,
                  device="cpu")
    assert len(scene.scene_info.point_cloud.points) == full_run.GS_POINTS
    assert (len(scene.train_cameras), len(scene.test_cameras)) == (3, 2)


def test_full_run_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert full_run.main(["--gs_type", "gs", "--quick"]) == 2
