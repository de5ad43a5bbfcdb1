"""The harness on the CPU at tiny sizes (`tiny.py`): cells, configurations,
metrics, model kinds (on a mesh or not, densifying in the window, its first
density-control event checked and each window event timed) and drivers
found by name, the result line's layout, `correct` false under each planted
fault and under the precision control, the refusal without a card, and no
JAX anywhere in what the harness loads."""
import ast
import glob
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import faults, harness, program, tracing
from benchmark.control import readings
from benchmark.drivers import train as train_driver
from benchmark.tests.tiny import BENCH, DENSITY_LIMITS, ROOT, make_copy

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
                                        ("tiny_mesh.render", "answer"),
                                        ("tiny_padded.train", "densify_skipped"),
                                        ("tiny_padded.train", "split_unsampled")])
def test_a_planted_fault_is_not_correct(tiny, request, cell, fault):
    if cell.startswith("tiny_padded"):
        # the densifying kind's files are in the copy alone: run it from there;
        # its checked density-control event is what fails
        (run_,) = run_copy(request.getfixturevalue("padded")["root"], [(cell, False, 0.5)], fault)
        result = run_["result"]
        failed = {k for k, v in result["checks"].items() if not v["value"] <= v["limit"]}
        assert failed and failed <= set(DENSITY_LIMITS), run_["lines"][-8:]
    else:
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


PADDED_KIND = {
    "scenes": '''"""A kind not on a mesh: vanilla 3DGS from points in a cube, turned at
random, in a buffer of more rows than points (the rest dead, padded as the
port pads them). All but `bright` points start under the pruning opacity,
so that the live rows grow by doubling from `bright` and the buffer fills
only after a few density-control events; half the bright ones are a
quarter of the size of the rest, under the split's limit."""
import math

import torch

from . import expon_lr


def geometry(config, gen, dev):
    return {"params": {}, "faces": torch.zeros((0, 3), dtype=torch.int64, device=dev),
            "rig": None, "n_vertices": 0}


def gaussians(config, traffic, gen, dev):
    n, rows, k = config["points"], config["rows"], (config["sh_degree"] + 1) ** 2
    live = {"xyz": (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) * config["half_width"],
            "f_dc": torch.rand((n, 1, 3), generator=gen, device=dev) * 2 - 0.5,
            "f_rest": torch.zeros((n, k - 1, 3), device=dev),
            "opacity": torch.full((n, 1), math.log(0.001 / 0.999), device=dev),
            "scaling": torch.full((n, 3), math.log(config["scale"]), device=dev),
            "rotation": torch.randn((n, 4), generator=gen, device=dev)}
    live["opacity"][:config["bright"]] = math.log(0.1 / 0.9)
    live["scaling"][:config["bright"] // 2] = math.log(config["scale"] / 4)
    params = {key: torch.cat([v, v.new_zeros((rows - n, *v.shape[1:]))]) for key, v in live.items()}
    params["rotation"][n:, 0] = 1.0
    params["scaling"][n:] = -10.0
    return {"params": params, "alive": torch.arange(rows, device=dev) < n}


def learning_rates(config, extent):
    lr = dict(config["learning_rates"])
    lr["xyz"] = expon_lr(lr.pop("position_lr_init") * extent,
                         lr.pop("position_lr_final") * extent, config["position_lr_max_steps"])
    return lr
''',
    "program": '''"""The port's `gs` model, with no constants."""
from gaussian_mesh_splatting_tpu_torch.models import vanilla

OPTIMIZATION = "gs"


def model(scene):
    return vanilla


def consts(scene):
    return {}
''',
    "reference/models": '''"""Vanilla 3DGS: exp of the log-scales, sigmoid of the opacity, the
normalized quaternion (w, x, y, z) as a rotation."""
import torch


def bag(p, faces=None, rig=None):
    q = p["rotation"] / (torch.linalg.vector_norm(p["rotation"], dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                       2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                       2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                      dim=-1).reshape(-1, 3, 3)
    return {"xyz": p["xyz"], "rot": rot, "scale": torch.exp(p["scaling"]),
            "opacity": torch.sigmoid(p["opacity"][:, 0]),
            "sh": torch.cat([p["f_dc"], p["f_rest"]], dim=1)}
''',
    "counts/models": '''"""Vanilla 3DGS per Gaussian: exp 3, sigmoid 4, the quaternion's norm and
matrix 40."""


def model_flops(n_gaussians, n_faces, n_vertices):
    return 47 * n_gaussians
''',
}


def _files(root: str) -> dict:
    out = {}
    for d, dirs, names in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def padded(tiny):
    """The tiny copy with a kind whose Gaussians are not on a mesh (its own
    parameters in a buffer of 4x the rows, an alive mask, a learning-rate
    schedule on the cameras' extent) and a traffic that densifies inside
    the window, added as new files and entries in BENCHMARK.json only:
    {"root", "before": every file's bytes before, "spec": BENCHMARK.json
    before}."""
    bench = os.path.join(tiny, os.path.basename(BENCH))
    before = _files(tiny)
    for role, source in PADDED_KIND.items():
        with open(os.path.join(bench, role, "gs_padded.py"), "w") as f:
            f.write(source)
    with open(os.path.join(bench, "configs", "tiny_mesh.json")) as f:
        mesh = json.load(f)
    config = {k: mesh[k] for k in ("width", "height", "camera_angle_x", "camera_radius",
                                   "elevation_deg", "sh_degree", "white_background",
                                   "train_views", "test_views", "lambda_dssim",
                                   "attr_precision", "grad_precision")}
    config.update(name="tiny_padded", gs_type="gs_padded", points=150, bright=2, rows=600,
                  half_width=1.0, scale=0.08, start_step=600, position_lr_max_steps=30000,
                  learning_rates={"position_lr_init": 0.00016, "position_lr_final": 0.0000016,
                                  "f_dc": 0.0025, "f_rest": 0.000125, "opacity": 0.05,
                                  "scaling": 0.005, "rotation": 0.001},
                  reduced=[])
    with open(os.path.join(bench, "configs", "tiny_padded.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "train_views.json")) as f:
        # apps/train densifies every 100 steps: too few for a 3 s window on
        # the CPU at these sizes, so the traffic overrides the interval
        traffic = dict(json.load(f), state="initial",
                       density_control={"densification_interval": 4},
                       sample_launches=[0, 3, 6, 9])
    with open(os.path.join(bench, "traffic", "train_views_densify.json"), "w") as f:
        json.dump(traffic, f)
    limits = {"train": dict({"loss_gap": 1e-4, "grad1_elem_median": 1e-3,
                             "grad1_norm_median_gap": 1e-3, "change3_median_gap": 1e-3,
                             "change3_norm_gap": 1e-3}, **DENSITY_LIMITS),
              "render": {"image_mean_gap": 1e-4}}
    for kind, limit in limits.items():
        with open(os.path.join(bench, "limits", f"tiny_padded.{kind}.json"), "w") as f:
            json.dump(limit, f)
    path = os.path.join(tiny, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    old = json.loads(json.dumps(spec))
    spec["configs"].append({"name": "tiny_padded", "source": "https://arxiv.org/abs/2308.04079",
                            "file": "benchmark/configs/tiny_padded.json", "reduced": [],
                            "why": "vanilla 3DGS in a padded buffer"})
    cells = {"tiny_padded.train": "train_views_densify", "tiny_padded.render": "test_views"}
    for name, traffic_name in cells.items():
        spec["workloads"].append({"name": name, "config": "tiny_padded", "traffic": traffic_name,
                                  "chips": 1, "why": "a kind not on a mesh"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        for mesh_cell, cell in (("tiny_mesh.train", "tiny_padded.train"),
                                ("tiny_mesh.render", "tiny_padded.render")):
            if mesh_cell in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(spec, f)
    return {"root": tiny, "before": before, "spec": old}


def run_copy(root: str, runs: list, fault: str | None = None) -> list:
    """Each (cell, trace, seconds) of `runs` from the copy at `root`, in one
    process (under the planted fault `fault`): its result, its lines for
    standard error and, of its driver's ctx, "density_ms",
    "density_events" and the keys of "stage_ms" where present."""
    code = ("import sys, json, time, contextlib; sys.path[:0] = [%r, %r]\n"
            "import torch; torch.set_num_threads(1)\n"
            "from benchmark import faults, harness\n"
            "from benchmark.drivers import train\n"
            "assert harness.__file__.startswith(%r), harness.__file__\n"
            "ctxs, run = [], train.run\n"
            "def kept(*a):\n"
            "    out = run(*a)\n"
            "    ctxs.append(out['ctx'])\n"
            "    return out\n"
            "train.run = kept\n"
            "fault = %r\n"
            "for cell, trace, seconds in %r:\n"
            "    ctxs.clear()\n"
            "    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():\n"
            "        r, lines = harness.run_cell(%r, cell, 2**31 + 23, seconds, trace, 'cpu',\n"
            "                                    time.perf_counter())\n"
            "    ctx = {k: ctxs[0][k] for k in ('density_ms', 'density_events')\n"
            "           if ctxs and k in ctxs[0]}\n"
            "    if ctxs and 'stage_ms' in ctxs[0]:\n"
            "        ctx['stage_keys'] = list(ctxs[0]['stage_ms'])\n"
            "    print(json.dumps({'result': r, 'lines': lines, 'ctx': ctx}))\n"
            ) % (root, ROOT, root, fault, runs, root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900, cwd=root, env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.strip().splitlines()[-len(runs):]]


def _diagnostics(run_: dict) -> dict:
    return json.loads(next(l for l in run_["lines"] if l.startswith("diagnostics "))[12:])


def test_kind_off_mesh_that_densifies_is_added_as_files(padded):
    """The kind off the mesh and its densifying traffic (`padded`), added as
    files only: its train cell (trace off and on) and render cell run
    `correct` from the copy, the first density-control event is checked
    against the plain reference, the window densifies and each window
    event is timed, the traced stretch books the events' idle time as
    "densify", the traced samples count their snapshot's live rows, and
    every file that was there is byte-equal afterwards."""
    tiny = padded["root"]
    runs = run_copy(tiny, [("tiny_padded.train", False, 3.0), ("tiny_padded.train", True, 3.0),
                           ("tiny_padded.render", False, 3.0)])
    for run_ in runs:
        assert run_["result"]["correct"] is True, run_["lines"][-6:]
    assert "train_step_ms" in runs[0]["result"]["metrics"]
    assert "step_mfu.train" in runs[1]["result"]["metrics"]
    assert set(runs[2]["result"]["metrics"]) == {"render_views_per_s", "render_ms_p95", "setup_s"}
    for run_ in runs[:2]:
        checks = run_["result"]["checks"]
        assert {k: checks[k]["limit"] for k in DENSITY_LIMITS} == DENSITY_LIMITS
        checked = _diagnostics(run_)["density_check"]
        assert checked["counts"] == checked["reference_counts"]
        # the checked event clones or splits, and prunes
        assert checked["counts"]["n_clone"] + checked["counts"]["n_split_rows"] > 0
        assert checked["counts"]["n_pruned"] > 0

    diags = [_diagnostics(r) for r in runs[:2]]
    for diag in diags:
        events = diag["density_events"]
        # the checked steps 601-603 pass no event; warm-up step 604 densifies
        assert [e["stretch"] for e in events][:1] == ["warmup"]
        assert sum(e["stretch"] == "window" for e in events) >= 2
        assert diag["alive_at_setup"] == 150
        assert any(e["n_alive"] != 150 for e in events), events
    # each window event of the traced run is timed, in the window's order
    ctx = runs[1]["ctx"]
    window = [e for e in diags[1]["density_events"] if e["stretch"] == "window"]
    assert ctx["density_events"] == window
    assert len(ctx["density_ms"]) == len(window) and all(ms > 0 for ms in ctx["density_ms"])
    assert "densify" in dict(runs[1]["result"]["breakdown"]["idle_gaps"])
    assert "density_ms" not in runs[0]["ctx"]
    # each sampled step of the traced stretch counts the live rows of its own
    # snapshot: those of the last event before it
    diag = diags[1]
    events = diag["density_events"]
    for position, rows, live in diag["sampled_rows"]:
        before_it = [e for e in events
                     if e["stretch"] != "traced" or e["position"] < position]
        assert rows == 600
        assert live == (before_it[-1]["n_alive"] if before_it else 150)
    assert any(live not in (150, 600) for _, _, live in diag["sampled_rows"])

    after = _files(tiny)
    changed = [p for p, data in padded["before"].items()
               if p != "BENCHMARK.json" and after[p] != data]
    assert changed == []
    with open(os.path.join(tiny, "BENCHMARK.json")) as f:
        now = json.load(f)
    old = padded["spec"]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for was, is_ in zip(old[key], now[key]):
            assert {k: v for k, v in is_.items() if k != "workloads"} == \
                {k: v for k, v in was.items() if k != "workloads"}
            assert is_.get("workloads", [])[:len(was.get("workloads", []))] == \
                was.get("workloads", [])


def test_density_control_needs_its_limits(padded):
    """A traffic with density_control whose limits file lacks the checked
    event's numbers is refused at load."""
    bench = os.path.join(padded["root"], os.path.basename(BENCH))
    with open(os.path.join(bench, "limits", "tiny_padded.train.json")) as f:
        limits = {k: v for k, v in json.load(f).items() if k != "density_param_gap"}
    with open(os.path.join(bench, "limits", "tiny_padded_nolimit.train.json"), "w") as f:
        json.dump(limits, f)
    path = os.path.join(padded["root"], "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny_padded_nolimit.train", "config": "tiny_padded",
                              "traffic": "train_views_densify", "chips": 1, "why": "no limit"})
    with open(path, "w") as f:
        json.dump(spec, f)
    with pytest.raises(ValueError, match="density_param_gap"):
        harness.load_cell(padded["root"], "tiny_padded_nolimit.train")
    assert harness.load_cell(padded["root"], "tiny_padded.train")["limits"]["density_param_gap"] \
        == DENSITY_LIMITS["density_param_gap"]


def test_mesh_cells_have_no_density_timing(tiny, monkeypatch):
    """A traced mesh cell, which runs no density control, records no
    density-control event: its ctx has no "density_ms" nor
    "density_events", its stages are `tracing.STAGES`, and no idle gap is
    booked as "densify"."""
    ctxs, driver = [], train_driver.run

    def kept(*a):
        out = driver(*a)
        ctxs.append(out["ctx"])
        return out

    monkeypatch.setattr(train_driver, "run", kept)
    for cell in ("tiny_mesh.train", "tiny_flame.train"):
        ctxs.clear()
        result, _ = run(tiny, cell, trace=True)
        (ctx,) = ctxs
        assert "density_ms" not in ctx and "density_events" not in ctx
        assert tuple(ctx["stage_ms"]) == tracing.STAGES
        assert "densify" not in dict(result["breakdown"]["idle_gaps"])
        assert not set(result["checks"]) & set(DENSITY_LIMITS)


@pytest.mark.parametrize("it, white, want", [
    (499, False, (False, False)), (500, False, (False, False)), (500, True, (False, True)),
    (600, False, (True, False)), (3000, False, (True, True)), (14900, True, (True, False)),
    (15000, False, (False, False))])
def test_density_schedule_is_apps_trains(it, white, want):
    """Density control acts where `apps/train` acts: densify inside
    (densify_from_iter, densify_until_iter) every densification_interval
    steps, reset the opacity every opacity_reset_interval steps and at
    densify_from_iter on a white background; never for a kind that does not
    densify."""
    assert program.density_events(program.optimization_config("gs"), it, white) == want
    assert program.density_events(program.optimization_config("gs_mesh"), it, white) == \
        (False, False)
