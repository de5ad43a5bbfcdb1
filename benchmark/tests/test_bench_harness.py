"""The harness on the CPU at tiny sizes (`tiny.py`): cells, configurations
and metrics found by name, the result line's layout, `correct` false under
each planted fault and under the precision control, the refusal without a
card, and no JAX anywhere in what the harness loads."""
import ast
import glob
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import faults, harness
from benchmark.control import readings
from benchmark.tests.tiny import BENCH, ROOT, make_copy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("checkout")))


def run(root, cell, trace=False, seconds=0.5, seed=2**31 + 11):
    return harness.run_cell(root, cell, seed, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_result_layout(tiny, trace):
    for cell in ("tiny_mesh.train", "tiny_mesh.render"):
        result, lines = run(tiny, cell, trace, seconds=3.0 if cell.endswith("render") else 0.5)
        keys = list(result)
        assert keys[:5] == KEYS and keys[-1] == "checks"
        assert ("breakdown" in keys) == trace
        assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
        spec = harness.load_cell(tiny, cell)
        want = {m["name"] for m in (spec["per_layer"] if trace else spec["end_to_end"])}
        assert set(result["metrics"]) <= want
        if not trace:
            assert set(result["metrics"]) == want
        assert result["device"]["platform"] == "cpu"
        assert ("busy_s" in result["device"]) == trace
        checks = [line for line in lines if line.startswith("check ")]
        assert lines[-len(checks):] == checks and len(checks) == len(result["checks"])


def test_new_files_are_found_by_name(tiny):
    """A configuration, a cell and a per-layer metric added as files (and
    entries in BENCHMARK.json), with no file of the harness edited."""
    bench = os.path.join(tiny, os.path.basename(BENCH))
    with open(os.path.join(bench, "configs", "tiny_mesh.json")) as f:
        config = json.load(f)
    config["num_splats"] = 3
    with open(os.path.join(bench, "configs", "tiny_mesh3.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "limits", "tiny_mesh3.train.json"), "w") as f:
        json.dump({"loss_gap": 1.0}, f)
    with open(os.path.join(bench, "metrics", "steps_seen.train.py"), "w") as f:
        f.write('LAYER = "step"\nUNIT = "steps"\nMOVES = "train_step_ms"\n\n\n'
                'def read(ctx):\n    return float(ctx["steps"])\n')
    path = os.path.join(tiny, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny_mesh3.train", "config": "tiny_mesh3",
                              "traffic": "train_views", "chips": 1, "why": "a new cell"})
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "step", "moves": "train_step_ms"})
    for m in spec["end_to_end"]:
        if "train_step_ms" == m["name"]:
            m["workloads"].append("tiny_mesh3.train")
    with open(path, "w") as f:
        json.dump(spec, f)
    result, _ = run(tiny, "tiny_mesh3.train", trace=True)
    # the window's steps; a traced run attempts the profiled stretch's too
    assert 0 < result["metrics"]["steps_seen.train"]["value"] < result["attempted"]
    assert list(result["checks"]) == ["loss_gap"]


@pytest.mark.parametrize("cell,fault", [("tiny_mesh.train", "unchanged"),
                                        ("tiny_mesh.train", "half"),
                                        ("tiny_flame.train", "unchanged"),
                                        ("tiny_flame.train", "half"),
                                        ("tiny_mesh.render", "answer")])
def test_a_planted_fault_is_not_correct(tiny, cell, fault):
    with faults.FAULTS[fault]():
        result, _ = run(tiny, cell, seconds=3.0 if cell.endswith("render") else 0.5)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", ["tiny_mesh.train", "tiny_flame.train", "tiny_mesh.render"])
def test_the_precision_control_is_not_correct(tiny, cell):
    seconds = 3.0 if cell.endswith("render") else 0.5
    (_, control, _), = readings(cell, "bf16", [2**31 + 5], seconds, "cpu", tiny)
    (_, exact, _), = readings(cell, "exact", [2**31 + 5], seconds, "cpu", tiny)
    assert exact["correct"] is True and control["correct"] is False


def test_no_card_no_result():
    """With every card hidden, a run exits with another code than 0 and
    prints no result (on a machine with a card as on one without)."""
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                           "gs_mesh.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["gaussian_mesh_splatting_tpu_torch", "gaussian_mesh_splatting_tpu_torch.ops",
             "jaxtyping", "flaxen", "benchmark.harness"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["jax.numpy", "gaussian_mesh_splatting_tpu.ops",
                                              "flax"]) == ["flax", "gaussian_mesh_splatting_tpu.ops",
                                                           "jax.numpy"]


def test_nothing_the_harness_loads_is_jax():
    code = ("import sys, glob, importlib.util; sys.path.insert(0, %r)\n"
            "from benchmark import harness, control, faults\n"
            "for p in glob.glob(%r):\n"
            "    s = importlib.util.spec_from_file_location('m', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(harness.check_modules())\n") % (ROOT, os.path.join(BENCH, "metrics", "*.py"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "**", "*.py"), recursive=True):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                assert not any(a.name.startswith("gaussian_mesh_splatting_tpu") for a in node.names)
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert not (node.module or "").startswith("gaussian_mesh_splatting_tpu"), path


def test_every_entry_has_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for cell in spec["workloads"]:
        c = harness.load_cell(ROOT, cell["name"])
        kind = c["config"]["gs_type"]
        for role in ("scenes", "program", os.path.join("reference", "models"),
                     os.path.join("counts", "models")):
            assert os.path.isfile(os.path.join(BENCH, role, f"{kind}.py")), (role, kind)
        assert callable(harness.load_driver(c["traffic"]["driver"]).run)
    for m in spec["per_layer"]:
        reader = harness.load_reader(ROOT, m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert sorted(json.load(f)["reduced"]) == sorted(c["reduced"])


def test_new_model_kind_and_driver_are_found_by_name(tiny):
    """A model kind (its scene, program, reference and count files) and a
    driver added as files in a copy of the benchmark, run from that copy."""
    bench = os.path.join(tiny, os.path.basename(BENCH))
    for role in ("scenes", "program", "reference/models", "counts/models"):
        module = "benchmark." + role.replace("/", ".") + ".gs_mesh"
        with open(os.path.join(bench, role, "gs_mesh_b.py"), "w") as f:
            f.write(f"from {module} import *  # noqa: F401,F403\n")
    with open(os.path.join(bench, "drivers", "train_b.py"), "w") as f:
        f.write("from benchmark.drivers.train import run  # noqa: F401\n")
    with open(os.path.join(bench, "configs", "tiny_mesh.json")) as f:
        config = dict(json.load(f), gs_type="gs_mesh_b")
    with open(os.path.join(bench, "configs", "tiny_mesh_b.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "train_views.json")) as f:
        traffic = dict(json.load(f), driver="train_b")
    with open(os.path.join(bench, "traffic", "train_views_b.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "limits", "tiny_mesh_b.train.json"), "w") as f:
        json.dump({"loss_gap": 1e-4}, f)
    path = os.path.join(tiny, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny_mesh_b.train", "config": "tiny_mesh_b",
                              "traffic": "train_views_b", "chips": 1, "why": "a new kind"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("tiny_mesh_b.train")
    with open(path, "w") as f:
        json.dump(spec, f)
    code = ("import sys, json, time; sys.path[:0] = [%r, %r]\n"
            "from benchmark import harness\n"
            "assert harness.__file__.startswith(%r), harness.__file__\n"
            "r, _ = harness.run_cell(%r, 'tiny_mesh_b.train', 7, 0.3, False, 'cpu', time.perf_counter())\n"
            "print(json.dumps(r))\n") % (tiny, ROOT, tiny, tiny)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=tiny)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and "train_step_ms" in result["metrics"]
