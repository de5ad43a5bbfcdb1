#!/usr/bin/env python3
"""Scaling of the PyTorch/CUDA port's parallel modes over process counts: the
port's counterpart of `tools_measure_scaling.py`, one process per card on
NCCL, at the full width of the `gs_mesh` scene of `tools_verify_scale.py`
(51,200 Gaussians, SH 3, 800x800; `tools_torch_multicard.write_mesh_scene`).

    python3 tools_torch_measure_scaling.py [--widths 1 2 4] [--out build/scaling/torch_scaling.json]
    python3 tools_torch_measure_scaling.py --device cpu --widths 1 2   # gloo CPU ranks, tiny scene

`parallel.multihost.measure_scaling` times the camera-DP step (one camera a
card: rank r renders train view r) at each width: the slowest rank's mean
step (host clock around `--iters` synchronised steps, after one warm-up),
and, as the JAX tool writes them, `step_ms`, `pixels_per_s` (width x H x W
a step) and `efficiency_vs_1` (the narrowest width's step over this one's:
the work per card is constant, so the ideal is 1). The same harness times
the row- and Gaussian-sharded steps of one camera (view 0 on every rank):
`step_ms`, `pixels_per_s` (H x W a step) and `speedup_vs_1`. The DP
efficiency is read against BASELINE.md's target of at least 80 % as a
measurement, not a claim.

On the card it refuses (exit 2) unless `torch.cuda.device_count()` covers
the widest width; no rank falls back to gloo or shares a card. `--device
cpu` runs gloo CPU processes at a tiny scale (for the tests): no time there
is a device figure. Writes the report to --out and prints it as the last
line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import tools_torch_multicard as mc

BASELINE_EFFICIENCY = 0.8  # BASELINE.md: >= 80 % multi-host pixels/s scaling efficiency


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--widths", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--work", default=os.path.join(mc.ROOT, "build", "scaling"))
    p.add_argument("--out", default=None,
                   help="the report's JSON (default: <work>/torch_scaling.json)")
    args = p.parse_args(argv)
    widths = sorted(set(args.widths))
    if args.device == "cuda":
        mc.require_cards(max(widths))
    import torch

    machine = mc.machine_lines(args.device)
    for line in machine:
        mc.log(line)
    t_script = time.perf_counter()
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    scale = mc.CARD if args.device == "cuda" else mc.CPU
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    data_dir, n_gaussians = mc.write_mesh_scene(args.work, scale, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    setup = {"device": args.device, "data_dir": data_dir, "num_splats": scale.num_splats}
    modes = ("data", "rows", "gaussians")
    ranks = mc.spawn({m: ("scaling", {"mode": m, "widths": widths, "iters": args.iters})
                      for m in modes}, max(widths), os.path.join(args.work, "ranks"), setup)
    mc.check_devices("measure_scaling", [r["device"] for r in ranks], args.device)
    pixels = scale.size * scale.size
    dp = ranks[0]["data"]
    report = {
        "workload": {"model": "gs_mesh", "gaussians": n_gaussians,
                     "image": [scale.size, scale.size], "cameras_per_device": 1,
                     "backend": "CUDA kernels, NCCL" if args.device == "cuda"
                     else "plain versions on the CPU, gloo"},
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        "cards": machine,
        "ranks": [r["device"] for r in ranks],
        "physical_cpus": os.cpu_count(),
        "note": ("one process per card; per-step work grows with width (1 camera a card), "
                 "so the ideal is a constant step time. Each process runs its own host-bound "
                 "Python step, so the host's cores are shared by every width's processes."
                 if args.device == "cuda" else
                 "gloo CPU processes sharing this host's cores at a tiny scene: a check of "
                 "the harness, not a device figure."),
        "widths": {str(w): {"step_ms": r["ms"], "pixels_per_s": w * pixels / (r["ms"] / 1e3),
                            "efficiency_vs_1": r["efficiency"]} for w, r in dp.items()},
        "sharded_one_camera": {
            mode: {str(w): {"step_ms": r["ms"], "pixels_per_s": pixels / (r["ms"] / 1e3),
                            "speedup_vs_1": r["efficiency"]} for w, r in ranks[0][mode].items()}
            for mode in ("rows", "gaussians")},
        "baseline_target": {
            "efficiency_vs_1": BASELINE_EFFICIENCY, "source": "BASELINE.md:28",
            "at_or_above": {str(w): r["efficiency"] >= BASELINE_EFFICIENCY
                            for w, r in dp.items() if w > min(widths)}},
        "wall_s": time.perf_counter() - t_script,
    }
    out_path = args.out or os.path.join(args.work, "torch_scaling.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    mc.log(f"wrote {out_path}")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
