"""One run of one cell, found by name: the cell's entry in `BENCHMARK.json`
names a configuration (`configs/<config>.json`, whose `gs_type` names the
model's files `scenes/<gs_type>.py`, `program/<gs_type>.py`,
`reference/models/<gs_type>.py` and `counts/models/<gs_type>.py`) and a
traffic mix (`traffic/<traffic>.json`, whose "driver" names
`drivers/<driver>.py`); `limits/<cell>.json` holds the limit of each number
that decides `correct`; each per-layer metric is read by
`metrics/<metric>.py`. A kind need not sit on a mesh: its scene file may
make its own parameters in a buffer of more rows than are alive, with their
mask, and derive its learning rates (`scenes`); its program file may give
the model state's constants (`program`); and a training traffic may switch
on density control on `apps/train`'s schedule ("density_control",
`drivers/train.py`), whose first event is checked against the plain
reference: its limits file then holds `drivers.train.DENSITY_NUMBERS`.

A run builds its inputs from the seed (`scenes`), and the driver runs the
program (`program`) through set-up, the checked first steps or views and a
measured window, reads the device's peak memory, frees the program and
runs the plain reference (`reference/`) on what the window produced; a
traced run adds the per-layer metrics, from the window's stage events, a
profiled stretch after it and the frozen counts (`counts/`) of a sample of
its launches. The result is one dict in the contract's layout.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

from . import program, scenes
from .drivers import sync
from .drivers.train import DENSITY_NUMBERS

BENCH_DIR = os.path.basename(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_mesh_splatting_tpu")


def forbidden_modules(names) -> list[str]:
    """The module names among `names` whose top-level name (the part before
    the first dot) is, whole, one of FORBIDDEN."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metric entries."""
    spec = _json(root, "BENCHMARK.json")
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[workload]
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    traffic = _json(root, BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    limits = _json(root, BENCH_DIR, "limits", f"{workload}.json")
    missing = [k for k in DENSITY_NUMBERS if k not in limits]
    if traffic.get("density_control") and missing:
        raise ValueError(f"{workload}: a traffic with density_control needs the limits of "
                         f"its checked event; limits/{workload}.json lacks {missing}")
    return {"cell": cell, "root": root, "trace_dir": os.path.join(root, "build", BENCH_DIR),
            "config": _json(root, BENCH_DIR, "configs", f"{cell['config']}.json"),
            "traffic": traffic, "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


def load_driver(name: str):
    """drivers/<name>.py, whose `run(...)` drives one run of the traffic."""
    return importlib.import_module(f".drivers.{name}", __package__)


def load_reader(root: str, metric: str):
    """metrics/<metric>.py as a module (its `read(ctx)` returns the value, or
    None where the run has nothing to read)."""
    path = os.path.join(root, BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_info(dev, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, render_kwargs: dict | None = None) -> tuple[dict, list[str]]:
    """(the result line's object, the lines for standard error) of one run."""
    c = load_cell(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    phases = {"start": t_start, "imported": time.perf_counter()}
    scene = scenes.build(c["config"], c["traffic"], seed, dev)
    if render_kwargs is None:  # the precision the configuration states
        render_kwargs = {k: c["config"][k] for k in ("attr_precision", "grad_precision")}
    sync(dev)
    phases["scene"] = time.perf_counter()
    out = load_driver(c["traffic"]["driver"]).run(c, scene, seed, seconds, trace, dev, phases,
                                                  render_kwargs)
    out["e2e"]["setup_s"] = phases["window"] - t_start
    names = list(phases)
    out["diagnostics"]["setup_phases_s"] = {b: phases[b] - phases[a] for a, b in zip(names, names[1:])}
    device_line = device_info(dev, out["peak"])
    metrics = {}
    if trace:
        ctx = dict(out["ctx"], kernels=program.KERNELS)
        device_line["busy_s"] = ctx["trace"]["busy_s"]
        device_line["window_s"] = ctx["trace"]["window_s"]
        for m in c["per_layer"]:
            value = load_reader(root, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    checks = {k: {"value": out["numbers"][k], "limit": limit}
              for k, limit in c["limits"].items()}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_line}
    if trace:
        result["breakdown"] = out["ctx"]["trace"]["breakdown"]
    result["checks"] = checks
    lines = [f"diagnostics {json.dumps(out['diagnostics'])}",
             f"numbers {json.dumps(out['numbers'])}"]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines


def process_start_seconds() -> float | None:
    """CLOCK_BOOTTIME seconds at which this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def check_modules() -> list[str]:
    return forbidden_modules(list(sys.modules))
