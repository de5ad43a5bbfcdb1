"""A tiny copy of the benchmark for the CPU tests: the real cells' traffic
(the render's checked views drawn among fewer), limits and metric readers,
with configurations cut to a few dozen faces, 48x40 images and a handful of
views, under new names (`tiny_*`), written into a directory beside a copy
of BENCHMARK.json that lists them."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
CELLS = {"gs_mesh.train": "tiny_mesh.train", "gs_flame.train": "tiny_flame.train",
         "gs_mesh.render": "tiny_mesh.render"}
CONFIGS = {"gs_mesh_nerf_synthetic": "tiny_mesh", "gs_flame_head": "tiny_flame"}
# the limits of a checked density-control event in the tiny densifying cell
# (`test_bench_harness.py`), which the reference's own test holds too: rows
# and counts exact; moments are copies and zeros, exact; a split sample's
# centre sums R (eps * s) in another order than the program
DENSITY_LIMITS = {"density_alive_mismatch": 0, "density_count_gap": 0,
                  "density_param_gap": 1e-5, "density_moment_gap": 0}


def tiny_config(config: dict) -> dict:
    c = dict(config, width=48, height=40, num_splats=2, train_views=4, test_views=5)
    if "mesh" in c:
        c["mesh"] = dict(c["mesh"], subdivisions=1, faces=80, vertices=42)
    else:
        c["flame"] = dict(c["flame"], vertices=40, faces=62, eye_faces=2)
    return c


def make_copy(dest: str) -> str:
    """`dest` as the root of a checkout holding the benchmark with the tiny
    cells; returns it."""
    shutil.copytree(BENCH, os.path.join(dest, os.path.basename(BENCH)),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    bench = os.path.join(dest, os.path.basename(BENCH))
    for real, tiny in CONFIGS.items():
        with open(os.path.join(BENCH, "configs", f"{real}.json")) as f:
            config = tiny_config(json.load(f))
        with open(os.path.join(bench, "configs", f"{tiny}.json"), "w") as f:
            json.dump(config, f)
    # a tiny render on the CPU may complete only a few dozen views in a test's
    # window: its checked views are drawn among the first 8
    path = os.path.join(bench, "traffic", "test_views.json")
    with open(path) as f:
        traffic = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(traffic, check_among=8), f)
    for real, tiny in CELLS.items():
        cell = next(c for c in spec["workloads"] if c["name"] == real)
        spec["workloads"].append(dict(cell, name=tiny, config=CONFIGS[cell["config"]]))
        shutil.copyfile(os.path.join(BENCH, "limits", f"{real}.json"),
                        os.path.join(bench, "limits", f"{tiny}.json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [CELLS[w] for w in m["workloads"]]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return dest
