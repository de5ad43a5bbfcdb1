#!/usr/bin/env python3
"""Render time per view and train step time of the PyTorch/CUDA port on the
main-path scene of chip_smoke.py (51,200-Gaussian gs_mesh, 800x800, SH 3):
this checkout against a second checkout of the port, in turns, in one
process on one card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools_torch_step_timing.py --compare build/parent

The second checkout lies under this one's `build/` (which .gitignore lists);
everything the run writes goes there too.

Both stages are bound by the host (many small PyTorch kernels), so their
times move by tens of percent with the host's load from one minute to the
next, and more between processes. Two versions are therefore compared only
in turns (other, this, this, other; `--rounds` times) inside one process:
each checkout's package is imported in its turn under the same name (the
functions made from it keep their own modules), builds its own kernels, and
renders the seed-42 teacher (`rasterize_cuda`, CUDA events, median of
`--reps`) and takes train steps of a fresh student against that render
(`train.make_train_step`, CUDA events that its `mark` hook records at the
stage boundaries, median of `--reps`). This checkout is loaded a second time
and takes its turns as a third side, the control (other, this, control,
control, this, other): what two copies of the same code differ by is what
the comparison cannot resolve. Prints the card's name and power
limit, one JSON line per turn, each side's median and range over its turns,
and last the differences round by round (a side's two turns of a round
averaged, minus the other checkout's): their median, their range and in how
many rounds the side was no slower.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "gaussian_mesh_splatting_tpu_torch"
STAGES = ("to_bag", "render", "loss", "backward", "adam", "stats")


def load_checkout(root: str, label: str):
    """Import chip_smoke and the port from `root`, in place of any copy
    imported before (whose functions keep the modules they were made from).
    Returns the function that takes one turn."""
    import torch

    for name in [n for n in sys.modules if n == "chip_smoke" or n.startswith(PACKAGE)]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        cs = importlib.import_module("chip_smoke")
        rc, mesh_model, scene_mod, train = (importlib.import_module(f"{PACKAGE}.{m}") for m in (
            "ops.rasterize_cuda", "models.mesh", "scene", "train"))
    finally:
        sys.path.remove(root)
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise SystemExit(f"chip_smoke was not imported from {root}")

    dev = torch.device("cuda")
    data_dir = os.path.join(HERE, "build", "step_timing", label)
    os.makedirs(data_dir, exist_ok=True)
    cs.write_dataset(data_dir)
    scene = scene_mod.Scene(data_dir, "gs_mesh", eval=True, num_splats=cs.NUM_SPLATS,
                            shuffle=False, device=dev)
    init_state = scene.init_model_state(mesh_model, cs.SH_DEGREE)
    cam = scene.train_cameras[0][0]
    bg = torch.ones(3, device=dev)
    with torch.no_grad():
        bag = mesh_model.to_bag(cs.randomize_state(init_state, seed=42))

    def render():
        with torch.no_grad():
            return rc.rasterize_cuda(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam, bg=bg,
                                     shs=bag.shs, sh_degree=cs.SH_DEGREE, alive=bag.alive)

    gt = torch.clamp(render().image, 0, 1)
    cfg = train.optimization_config("gs_mesh")
    tstate = train.make_train_state(init_state, cfg, scene.cameras_extent)
    events = {}

    def mark(stage):
        events[stage] = torch.cuda.Event(enable_timing=True)
        events[stage].record()

    step_fn = train.make_train_step(mesh_model, cfg, cs.SH_DEGREE, mark=mark)

    def turn(reps: int) -> dict:
        times: dict = {f"{k}_ms": [] for k in ("step", *STAGES)}
        for _ in range(reps):
            step_fn(tstate, cam, gt, bg)
            events["stats"].synchronize()
            times["step_ms"].append(events["start"].elapsed_time(events["stats"]))
            for prev, k in zip(("start", *STAGES), STAGES):
                times[f"{k}_ms"].append(events[prev].elapsed_time(events[k]))
        row = {k: statistics.median(v) for k, v in times.items()}
        row["render_per_view_ms"] = cs.cuda_ms(render, reps=reps)
        return row

    turn(3)  # builds the kernels, warms the allocator
    return turn


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare", required=True,
                        help="the second checkout's directory, under this checkout's build/")
    parser.add_argument("--reps", type=int, default=12)
    parser.add_argument("--rounds", type=int, default=12)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)

    other = os.path.realpath(opts.compare)
    if os.path.commonpath([other, os.path.join(HERE, "build")]) != os.path.join(HERE, "build"):
        parser.error(f"--compare must lie under {os.path.join(HERE, 'build')}")
    turns = {"other": load_checkout(other, "other"), "this": load_checkout(HERE, "this"),
             "control": load_checkout(HERE, "control")}
    rows: dict = {side: [] for side in turns}
    for _ in range(opts.rounds):
        for side in [*turns, *reversed(turns)]:
            row = turns[side](opts.reps)
            rows[side].append(row)
            print(json.dumps({"side": side, **row}), flush=True)

    def spread(values):
        values = list(values)
        return {"median": statistics.median(values), "min": min(values), "max": max(values)}

    summary = {side: {key: spread(r[key] for r in its_rows) for key in its_rows[0]}
               for side, its_rows in rows.items()}
    print(json.dumps({"turns_each": 2 * opts.rounds, "other": os.path.relpath(other, HERE),
                      "summary": summary}), flush=True)
    # round r holds turns 2r and 2r+1 of every side
    by_round = {side: {key: [(its_rows[2 * r][key] + its_rows[2 * r + 1][key]) / 2
                             for r in range(opts.rounds)] for key in its_rows[0]}
                for side, its_rows in rows.items()}
    minus_other = {}
    for side in [s for s in turns if s != "other"]:
        minus_other[side] = {}
        for key in ("step_ms", "render_ms", "backward_ms", "render_per_view_ms"):
            diffs = [a - b for a, b in zip(by_round[side][key], by_round["other"][key])]
            minus_other[side][key] = {**spread(diffs), "rounds_no_slower": sum(d <= 0 for d in diffs)}
    print(json.dumps({"rounds": opts.rounds, "minus_other_by_round": minus_other}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
