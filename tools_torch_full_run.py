#!/usr/bin/env python3
"""The port's run at the real schedule on one CUDA card: train -> render ->
metrics of the at-scale scene, as `gs_mesh` or as `gs` with densification.

    python3 tools_torch_full_run.py [--gs_type gs_mesh|gs] [--iterations 30000]
                                    [--quick] [--out build/full_run/<gs_type>.json]
    python3 tools_torch_full_run.py --toy_dip [--quick] [--iterations 5000]
                                    [--device cuda|cpu] [--out build/full_run/toy_dip.json]

Writes a Blender_Mesh dataset under build/full_run/: the repo's 5120-face
lumpy icosphere (chip_smoke.py's `icosphere_mesh`), 100 train and 20 test
800x800 views on chip_smoke.py's camera ring, GT rendered by the port from
the seed-42 teacher (chip_smoke.py's `randomize_state`: random colours and
view dependence, opacity sigmoid(2.5)) on white. Then, on the card:

- `gs_mesh` (the default): `apps.train --gs_type gs_mesh --num_splats 10
  --sh_degree 3 --white_background` (51,200 Gaussians, constant learning
  rates, no densification: the reference's gs_mesh configuration);
- `gs`: the dataset without `points3d.ply`, so that the Blender reader makes
  its 100,000 seeded points, and `apps.train --gs_type gs --sh_degree 3
  --white_background --capacity_mult 4` (400,000 rows) at the default
  density-control schedule: 144 densify events from step 600 to 14,900,
  opacity resets at 500 (white background) and every 3,000 steps to 12,000,
  the 20-px screen-size prune after step 3,000 (the JAX package's
  `tools_verify_scale.py` `gs` leg);

for `--iterations` steps (`--quick`: 600, evals at 300 and 600) with the
JAX leg's test evals, then `apps.render --skip_train` and `apps.metrics`.
Prints and writes one JSON object: the eval curve, the population every 100
steps (`total_points` in the app's metrics.jsonl) and at every densify
event, the app's step times (`iter_time`, host clock, mean over each
100-step window), the metrics CLI's SSIM / PSNR / LPIPS, the wall times and
the card's name and power limit. The GT comes from the port's own renderer,
so the scores compare with the JAX package's (`VERIFY_r5.json`) only
approximately. Exits 1 if a loss or score is not finite or, for `gs`, if
the population falls below 1,000 after the first event or the last eval's
PSNR is below the one at step 2,000.

`--toy_dip` is the counterpart of `tools_verify_scale.py`'s
`diagnose_toy_dip`: it builds the 128x128 toy scene of
`tools_torch_verify_scene.py` (the JAX tool's dataset, GT and all) and runs
`apps.train --gs_type gs_mesh --eval --iterations 5000 --num_splats 3
--sh_degree 0 --white_background --backend cuda` with test evals every 500
steps, then `apps.render --skip_train` and `apps.metrics`. It writes
build/full_run/toy_dip.json: the test PSNR of every eval, the train PSNR the
app logs every 500 steps, every step's time (host clock between two
synchronizations), the B1/B2 launches against the expected counts, and the
JAX record (`VERIFY_r5.json` `toy_dip_diagnosis`) beside them. It exits 1
if an eval is not finite, the launches are off, or the mean test PSNR over
the evals 1,500-5,000 is more than TOY_PSNR_TOL_DB from the record's;
`--quick` (600 steps, evals at 300 and 600) checks only that the loss falls
and the test PSNR rises. `--device cpu` runs it on the CPU (no launches).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "full_run")
N_TRAIN, N_TEST = 100, 20
TEST_ITERS = (1000, 2000, 3000, 5000, 7000, 10000, 15000, 20000, 25000, 30000)
QUICK_ITERS, QUICK_TEST_ITERS = 600, (300, 600)
GS_POINTS = 100_000  # the Blender reader's seeded cloud without a points3d.ply
MIN_POPULATION = 1_000  # gs: alive Gaussians after the first densify event, at least
# --toy_dip: the JAX record's run (tools_verify_scale.py diagnose_toy_dip)
TOY_ITERS, TOY_TEST_ITERS = 5000, tuple(range(500, 5001, 500))
TOY_PLATEAU = (1500, 5000)  # the evals whose mean test PSNR is held against the record's
TOY_PSNR_TOL_DB = 2.0
TOY_SPLATS, TOY_SH_DEGREE, TOY_VIEWS = 3, 0, 8  # TOY_VIEWS: test views per eval
JAX_RECORD = os.path.join(ROOT, "VERIFY_r5.json")


def write_dataset(root: str) -> None:
    """Blender_Mesh dataset: mesh.obj, placeholder PNGs and the camera ring
    (the same ring as chip_smoke.py, with 100 train and 20 test views)."""
    from PIL import Image

    from gaussian_mesh_splatting_tpu_torch.io.obj import save_obj

    verts, faces = cs.icosphere_mesh()
    save_obj(os.path.join(root, "mesh.obj"), verts, faces)
    for split, n_cams, off in [("train", N_TRAIN, 0.0), ("test", N_TEST, 0.31)]:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n_cams):
            c, rot = cs.ring_camera(i, n_cams, off)
            c2w = np.eye(4)
            c2w[:3, :3] = rot
            c2w[:3, 3] = c
            Image.fromarray(np.zeros((cs.SIZE, cs.SIZE, 4), np.uint8), "RGBA").save(
                os.path.join(root, split, f"r_{i}.png"))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": cs.FOVX, "frames": frames}, f)


def prepare_dataset(data_dir: str, gs_type: str, dev, render_gt: bool = True) -> None:
    """The dataset of `gs_type`'s run: cameras, mesh and the teacher's GT
    (`render_gt=False` leaves the placeholder images). The Blender_Mesh
    reader writes its splat centres as points3d.ply; the `gs` leg removes
    it, so that its Blender reader makes its own GS_POINTS seeded points."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    write_dataset(data_dir)
    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=cs.NUM_SPLATS, shuffle=False,
                  device=dev)
    if render_gt:
        teacher = cs.randomize_state(scene.init_model_state(mesh_model, cs.SH_DEGREE), seed=42)
        with torch.no_grad():
            cs.render_gt_images(scene, mesh_model.to_bag(teacher))
    if gs_type == "gs":
        ply = os.path.join(data_dir, "points3d.ply")
        if os.path.exists(ply):
            os.remove(ply)


def train_argv(gs_type: str, data_dir: str, model_dir: str, iterations: int,
               test_iters: tuple) -> list[str]:
    """apps.train's arguments for the leg (the JAX leg's flags; `gs_mesh`
    adds its splats per face, `gs` names its buffer's multiple)."""
    argv = ["--gs_type", gs_type, "-s", data_dir, "-m", model_dir, "--eval",
            "--sh_degree", str(cs.SH_DEGREE), "--white_background",
            "--iterations", str(iterations),
            "--test_iterations", *map(str, test_iters), "--save_iterations", str(iterations)]
    if gs_type == "gs_mesh":
        argv += ["--num_splats", str(cs.NUM_SPLATS)]
    else:
        argv += ["--capacity_mult", "4"]
    return argv


def read_metrics_jsonl(model_dir: str) -> dict:
    """{tag: [[step, value], ...]} from the app's metrics.jsonl."""
    series: dict = {}
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            step = d.pop("step")
            for k, v in d.items():
                series.setdefault(k, []).append([step, v])
    return series


def step_times(iter_time: list, densify_until: int | None = None) -> dict:
    """Medians of the app's 100-step window means: the whole run and, with
    `densify_until`, either side of the last densify step."""
    def med(rows):
        return statistics.median(v for _, v in rows) if rows else None
    if densify_until is None:
        return {"median_ms": med(iter_time)}
    return {"median_ms": med(iter_time),
            "median_ms_densifying": med([r for r in iter_time if r[0] <= densify_until]),
            "median_ms_after_densification": med([r for r in iter_time if r[0] > densify_until])}


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def toy_argv(data_dir: str, model_dir: str, iterations: int, test_iters, device: str
             ) -> list[str]:
    """apps.train's arguments for the toy leg (`diagnose_toy_dip`'s flags;
    the backend is the CUDA path on the card and its plain twin on the CPU)."""
    return ["--gs_type", "gs_mesh", "-s", data_dir, "-m", model_dir, "--eval",
            "--iterations", str(iterations), "--num_splats", str(TOY_SPLATS),
            "--sh_degree", str(TOY_SH_DEGREE), "--white_background",
            "--backend", "cuda" if device.startswith("cuda") else "auto",
            "--test_iterations", *map(str, test_iters), "--save_iterations", str(iterations),
            "--device", device]


def parse_train_log(text: str) -> dict:
    """apps.train's log lines as [[iteration, value], ...]: the loss (its
    running mean) and train PSNR it logs at step 1 and every 100 steps, and
    the mean test PSNR of every eval."""
    logged = re.findall(r"\[it (\d+)/\d+\] loss ([-\d.naif]+) psnr ([-\d.naif]+)", text)
    evals = re.findall(r"\[it (\d+)\] eval: test PSNR ([-\d.naif]+)", text)
    return {"loss": [[int(i), float(v)] for i, v, _ in logged],
            "train_psnr": [[int(i), float(v)] for i, _, v in logged],
            "test_psnr": [[int(i), float(v)] for i, v in evals]}


def spread(ms: list[float]) -> dict:
    """Median and spread of step times (ms)."""
    q = np.percentile(ms, [10, 50, 90]) if ms else [None] * 3
    return {"n": len(ms), "median_ms": q[1], "p10_ms": q[0], "p90_ms": q[2],
            "min_ms": min(ms, default=None), "max_ms": max(ms, default=None)}


def run_toy_dip(work: str, iterations: int, test_iters, device: str, quick: bool = False
                ) -> dict:
    """The toy leg end to end under `work` (see the module docstring).
    Returns the result object, with "checks" and "ok"."""
    import tools_torch_verify_scene as toy
    from gaussian_mesh_splatting_tpu_torch.apps import metrics as metrics_app
    from gaussian_mesh_splatting_tpu_torch.apps import render as render_app

    shutil.rmtree(work, ignore_errors=True)
    data_dir, model_dir = os.path.join(work, "scene"), os.path.join(work, "model")
    t0 = time.perf_counter()
    scene = toy.build_scene(data_dir, device=device)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, text, step_ms, _, fwd, bwd = cs.timed_train(
        toy_argv(data_dir, model_dir, iterations, test_iters, device), device)
    launches = [fwd, bwd]
    train_s = time.perf_counter() - t0
    render_app.main(["-m", model_dir, "--skip_train", "--device", device])
    metrics_app.main(["-m", model_dir, "--device", device])
    with open(os.path.join(model_dir, "results_gs_mesh.json")) as f:
        final = json.load(f)[f"ours_{iterations}"]["gs_mesh"]
    log = parse_train_log(text)
    test = [[int(k), v] for k, v in sorted(res.test_psnr.items())]
    with open(JAX_RECORD) as f:
        record = json.load(f)["toy_dip_diagnosis"]
    lo, hi = TOY_PLATEAU

    def plateau_mean(curve):
        vals = [v for i, v in curve if lo <= i <= hi]
        return float(np.mean(vals)) if vals else None

    on_card = device.startswith("cuda")
    want = [iterations + TOY_VIEWS * len(test), iterations] if on_card else [0, 0]
    checks = {"evals_finite": bool(test) and all(np.isfinite(v) for _, v in test),
              "launches_as_expected": launches == want}
    ours, theirs = plateau_mean(test), plateau_mean(record["test_psnr"])
    if quick:
        losses = res.losses
        window = max(1, min(100, len(losses) // 4))
        checks["loss_falls"] = float(np.mean(losses[-window:])) < float(np.mean(losses[:window]))
        checks["test_psnr_rises"] = test[-1][1] > test[0][1]
    elif ours is not None and iterations >= hi:
        checks[f"plateau_within_{TOY_PSNR_TOL_DB}_db_of_the_record"] = (
            abs(ours - theirs) <= TOY_PSNR_TOL_DB)
    out = {
        "card": card_line() if on_card else "cpu",
        "scene": {"size": toy.SIZE, "faces": scene["faces"], "gaussians": scene["gaussians"],
                  "train_views": toy.N_CAMS, "test_views": toy.N_CAMS,
                  "sh_degree": TOY_SH_DEGREE, "iterations": iterations},
        "test_psnr": test,
        "train_psnr_every_500": [[i, v] for i, v in log["train_psnr"] if i % 500 == 0],
        "train_psnr_log": log["train_psnr"],
        "loss_log": log["loss"],
        f"plateau_mean_test_psnr_{lo}_{hi}": ours,
        "final_metrics_cli": final,
        "step_time": spread(step_ms),
        "launches": {"train": launches, "expected": want},
        "dataset_s": data_s,
        "train_s": train_s,
        "jax_record": {**record, f"plateau_mean_test_psnr_{lo}_{hi}": theirs,
                       "source": "VERIFY_r5.json toy_dip_diagnosis"},
        "checks": checks,
    }
    out["ok"] = all(checks.values())
    return out


def toy_dip_main(args) -> int:
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("tools_torch_full_run --toy_dip: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 2
    if args.quick:
        iterations, tests = QUICK_ITERS, QUICK_TEST_ITERS
    else:
        iterations = args.iterations if args.iterations is not None else TOY_ITERS
        tests = tuple(t for t in TOY_TEST_ITERS if t < iterations) + (iterations,)
    out = run_toy_dip(os.path.join(WORK, "toy_dip"), iterations, tests, args.device,
                      quick=args.quick)
    out_path = args.out or os.path.join(WORK, "toy_dip.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k not in ("train_psnr_log", "loss_log")}))
    return 0 if out["ok"] else 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("tools_torch_full_run")
    p.add_argument("--gs_type", default="gs_mesh", choices=["gs_mesh", "gs"])
    p.add_argument("--toy_dip", action="store_true",
                   help="the 128x128 toy scene's 5,000-step gs_mesh run (diagnose_toy_dip)")
    p.add_argument("--iterations", type=int, default=None,
                   help=f"default 30000 ({TOY_ITERS} with --toy_dip)")
    p.add_argument("--quick", action="store_true",
                   help=f"{QUICK_ITERS} steps, evals at {QUICK_TEST_ITERS}")
    p.add_argument("--device", default="cuda", help="--toy_dip: cuda (default) or cpu")
    p.add_argument("--out", default=None,
                   help="default build/full_run/<gs_type>.json (toy_dip.json with --toy_dip)")
    args = p.parse_args(argv)
    if args.toy_dip:
        return toy_dip_main(args)
    if args.iterations is None:
        args.iterations = 30_000
    iterations = QUICK_ITERS if args.quick else args.iterations
    tests = QUICK_TEST_ITERS if args.quick else tuple(t for t in TEST_ITERS if t <= iterations)
    out_path = args.out or os.path.join(WORK, f"{args.gs_type}.json")

    import torch

    from gaussian_mesh_splatting_tpu_torch.apps import metrics as metrics_app
    from gaussian_mesh_splatting_tpu_torch.apps import render as render_app
    from gaussian_mesh_splatting_tpu_torch.apps import train as train_app
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.train.config import optimization_config

    if not torch.cuda.is_available():
        print("tools_torch_full_run: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    work = os.path.join(WORK, args.gs_type)
    shutil.rmtree(work, ignore_errors=True)
    data_dir, model_dir = os.path.join(work, "scene"), os.path.join(work, "model")
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    prepare_dataset(data_dir, args.gs_type, dev)
    data_s = time.perf_counter() - t0
    print(f"dataset: {N_TRAIN} + {N_TEST} views, {cs.SIZE}x{cs.SIZE}, in {data_s:.1f} s",
          flush=True)

    # [composite_fwd, composite_bwd] launches: apps.train, then apps.render
    kernel_launches = {}
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    res = train_app.main(train_argv(args.gs_type, data_dir, model_dir, iterations, tests))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    kernel_launches["train"] = [cuda_build.launches[e] for e in cs.COMPOSITES]
    cuda_build.launches.clear()
    render_app.main(["-m", model_dir, "--skip_train"])
    metrics_app.main(["-m", model_dir])
    eval_s = time.perf_counter() - t0 - train_s
    kernel_launches["render"] = [cuda_build.launches[e] for e in cs.COMPOSITES]
    with open(os.path.join(model_dir, f"results_{args.gs_type}.json")) as f:
        final = json.load(f)[f"ours_{iterations}"][args.gs_type]
    series = read_metrics_jsonl(model_dir)
    curve = {str(k): v for k, v in res.test_psnr.items()}
    out = {
        "card": card,
        "gs_type": args.gs_type,
        "scene": {"faces": 5120, "size": cs.SIZE, "sh_degree": cs.SH_DEGREE,
                  "train_views": N_TRAIN, "test_views": N_TEST, "iterations": iterations,
                  **({"gaussians": 51_200} if args.gs_type == "gs_mesh" else
                     {"initial_points": GS_POINTS, "capacity": 4 * GS_POINTS})},
        "test_psnr_curve": curve,
        "loss_last_100_mean": float(np.mean(res.losses[-100:])),
        "final_metrics_cli": final,
        "dataset_s": data_s,
        "train_s": train_s,
        "train_ms_per_step": 1e3 * train_s / iterations,
        "render_and_metrics_s": eval_s,
        "launches": kernel_launches,
    }
    ok = bool(np.isfinite(res.losses).all()
              and all(np.isfinite(v) for v in (final["SSIM"], final["PSNR"])))
    if args.gs_type == "gs":
        cfg = optimization_config("gs")
        events = [{k: int(v) for k, v in e.items()} for e in res.densify_events]
        points = [[s, int(v)] for s, v in series.get("total_points", [])]
        after_first = [n for s, n in points if events and s >= events[0]["iteration"]]
        after_first += [e["n_alive"] for e in events]
        out.update(
            points_trajectory=points,
            densify_events=events,
            min_population_after_first_event=min(after_first) if after_first else None,
            final_points=int(res.state.alive.sum()),
            step_times_app=step_times(series.get("iter_time", []), cfg.densify_until_iter))
        checks = {f"population_at_least_{MIN_POPULATION}":
                  bool(after_first) and min(after_first) >= MIN_POPULATION}
        if "2000" in curve:
            checks["last_psnr_at_least_psnr_at_2000"] = curve[str(tests[-1])] >= curve["2000"]
        out["checks"] = checks
        ok = ok and all(checks.values())
    else:
        out["step_times_app"] = step_times(series.get("iter_time", []))
    out["ok"] = ok
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k not in ("points_trajectory",
                                                                 "densify_events")}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
