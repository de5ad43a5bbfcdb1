"""The port's toy scene (`tools_torch_verify_scene.py`) against the JAX
package's (`tools_verify_scene.py`), and the `--toy_dip` leg of
`tools_torch_full_run.py` against `tools_verify_scale.py`'s
`diagnose_toy_dip`:

- the GT colours the port keeps as a constant are `jax.random`'s draw;
- both tools write the same dataset: the transforms JSON and `mesh.obj`
  byte for byte, the GT PNGs within one 8-bit level at no more than 0.1 %
  of their values (the two renderers' float32 rounding);
- the toy leg runs `diagnose_toy_dip`'s apps.train flags (the command
  captured without running it) but for the backend, the device and the
  evals, which follow the JAX record (`VERIFY_r5.json`: every 500 steps);
- a 3-step run on the CPU, its app log parsed into the train PSNR and the
  evals; the parser reads from the app's log lines what the JAX tool's own
  patterns read."""
import filecmp
import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import tools_torch_full_run as full_run  # noqa: E402
import tools_torch_verify_scene as toy  # noqa: E402
import tools_verify_scale as jax_scale  # noqa: E402

torch.set_num_threads(2)
# the JAX tool's own patterns (tools_verify_scale.py diagnose_toy_dip)
JAX_EVAL = r"\[it (\d+)\] eval: test PSNR ([\d.]+)"
JAX_TRAIN = r"\[it (\d+)/\d+\] loss [\d.]+ psnr ([\d.]+)"


def test_gt_colours_are_the_jax_draw():
    k1, _ = jax.random.split(jax.random.key(42))
    want = np.asarray(jax.random.uniform(k1, (60, 1, 3)) * 2 - 0.5, np.float32)
    np.testing.assert_array_equal(toy.GT_F_DC, want)


def test_the_port_writes_the_jax_tools_dataset(tmp_path):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, os.path.join(ROOT, "tools_verify_scene.py"), str(jax_root)],
                   cwd=ROOT, env=env, check=True, capture_output=True, timeout=600)
    info = toy.build_scene(str(port_root), device="cpu")
    assert info == {"gaussians": 60, "faces": 20, "views": 16, "mean_gt": info["mean_gt"]}
    for name in ("transforms_train.json", "transforms_test.json", "mesh.obj"):
        assert filecmp.cmp(jax_root / name, port_root / name, shallow=False), name
    for split in ("train", "test"):
        for i in range(toy.N_CAMS):
            with Image.open(jax_root / split / f"r_{i}.png") as a, \
                    Image.open(port_root / split / f"r_{i}.png") as b:
                a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
            assert a.shape == b.shape == (toy.SIZE, toy.SIZE, 4)
            diff = np.abs(a - b)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (split, i)
            assert a[..., :3].std() > 1.0  # a real GT, not the placeholder


def test_toy_leg_runs_diagnose_toy_dips_flags(monkeypatch):
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return types.SimpleNamespace(stdout="", stderr="", returncode=0)

    monkeypatch.setattr(jax_scale.subprocess, "run", fake_run)
    jax_scale.diagnose_toy_dip()
    cmd = seen[-1]
    want = cmd[cmd.index("gaussian_mesh_splatting_tpu.apps.train") + 1:]

    def flags(argv):
        out, key = {}, None
        for a in argv:
            if a.startswith("-"):
                key = a
                out[key] = []
            else:
                out[key].append(a)
        return out

    want = flags(want)
    got = flags(full_run.toy_argv(want["-s"][0], want["-m"][0], full_run.TOY_ITERS,
                                  full_run.TOY_TEST_ITERS, "cuda"))
    for key in ("--gs_type", "-s", "-m", "--eval", "--iterations", "--num_splats",
                "--sh_degree", "--white_background", "--save_iterations"):
        assert got[key] == want[key], key
    assert want["--backend"] == ["pallas"] and got["--backend"] == ["cuda"]
    assert got["--device"] == ["cuda"] and set(got) - set(want) == {"--device"}
    # the committed JAX tool evaluates every 1,000 steps; its record, every 500
    record = [[i, v] for i, v in jax_scale_record()["test_psnr"]]
    assert [int(t) for t in got["--test_iterations"]] == [i for i, _ in record]
    assert set(map(int, want["--test_iterations"])) < set(map(int, got["--test_iterations"]))


def jax_scale_record():
    import json

    with open(full_run.JAX_RECORD) as f:
        return json.load(f)["toy_dip_diagnosis"]


def test_three_step_toy_run_on_the_cpu(tmp_path):
    out = full_run.run_toy_dip(str(tmp_path / "toy"), 3, (3,), "cpu")
    assert out["ok"] and out["checks"] == {"evals_finite": True, "launches_as_expected": True}
    assert [i for i, _ in out["test_psnr"]] == [3] and np.isfinite(out["test_psnr"][0][1])
    assert [i for i, _ in out["train_psnr_log"]] == [1] and out["train_psnr_every_500"] == []
    assert out["step_time"]["n"] == 3 and out["launches"]["train"] == [0, 0]
    assert out["jax_record"]["plateau_mean_test_psnr_1500_5000"] == pytest.approx(43.39125)
    assert out[f"plateau_mean_test_psnr_{full_run.TOY_PLATEAU[0]}_{full_run.TOY_PLATEAU[1]}"] \
        is None
    assert np.isfinite(out["final_metrics_cli"]["PSNR"])


def test_log_parsing_reads_what_the_jax_patterns_read():
    text = ("[it 1/5000] loss 0.12345 psnr 18.27 iter 35.1ms (3s)\n"
            "[it 500] eval: test PSNR 32.63\n"
            "[it 500/5000] loss 0.01020 psnr 33.41 iter 31.0ms (20s)\n"
            "[it 500] saved snapshot to x\n"
            "[it 1000/5000] loss 0.00510 psnr 42.56 iter 30.2ms (35s)\n"
            "[it 1000] eval: test PSNR 42.70\n")
    got = full_run.parse_train_log(text)
    assert got["train_psnr"] == [[int(i), float(v)] for i, v in re.findall(JAX_TRAIN, text)]
    assert got["test_psnr"] == [[int(i), float(v)] for i, v in re.findall(JAX_EVAL, text)]
    assert got["loss"] == [[1, 0.12345], [500, 0.0102], [1000, 0.0051]]
