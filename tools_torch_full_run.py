#!/usr/bin/env python3
"""The port's run at the real schedule on one CUDA card: train -> render ->
metrics of the at-scale `gs_mesh` scene.

    python3 tools_torch_full_run.py [--iterations 30000] [--out build/full_run/result.json]

Writes a Blender_Mesh dataset under build/full_run/: the repo's 5120-face
lumpy icosphere (chip_smoke.py's `icosphere_mesh`), 100 train and 20 test
800x800 views on chip_smoke.py's camera ring, GT rendered by the port from
the seed-42 teacher (chip_smoke.py's `randomize_state`: random colours and
view dependence, opacity sigmoid(2.5)) on white. Then, on the card:
`apps.train --gs_type gs_mesh --num_splats 10 --sh_degree 3
--white_background` for `--iterations` steps (51,200 Gaussians, constant
learning rates, no densification: the reference's gs_mesh configuration),
with test evals along the way, `apps.render --skip_train` and
`apps.metrics`. Prints and writes one JSON object: the eval curve, the
metrics CLI's SSIM / PSNR / LPIPS, the wall times and the card's name and
power limit. The GT comes from the port's own renderer, so the scores
compare with the JAX package's (`VERIFY_r5.json`) only approximately.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "full_run")
N_TRAIN, N_TEST = 100, 20
TEST_ITERS = (1000, 2000, 3000, 5000, 7000, 10000, 15000, 20000, 25000, 30000)


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


def main() -> int:
    p = argparse.ArgumentParser("tools_torch_full_run")
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--out", default=os.path.join(WORK, "result.json"))
    args = p.parse_args()

    import torch

    from gaussian_mesh_splatting_tpu_torch.apps import metrics as metrics_app
    from gaussian_mesh_splatting_tpu_torch.apps import render as render_app
    from gaussian_mesh_splatting_tpu_torch.apps import train as train_app
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    if not torch.cuda.is_available():
        print("tools_torch_full_run: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    data_dir, model_dir = os.path.join(WORK, "scene"), os.path.join(WORK, "model")
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    write_dataset(data_dir)
    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=cs.NUM_SPLATS, shuffle=False,
                  device=dev)
    teacher = cs.randomize_state(scene.init_model_state(mesh_model, cs.SH_DEGREE), seed=42)
    with torch.no_grad():
        cs.render_gt_images(scene, mesh_model.to_bag(teacher))
    data_s = time.perf_counter() - t0
    print(f"dataset: {N_TRAIN} + {N_TEST} views, {cs.SIZE}x{cs.SIZE}, in {data_s:.1f} s",
          flush=True)

    tests = [t for t in TEST_ITERS if t <= args.iterations]
    t0 = time.perf_counter()
    res = train_app.main([
        "--gs_type", "gs_mesh", "-s", data_dir, "-m", model_dir, "--eval",
        "--num_splats", str(cs.NUM_SPLATS), "--sh_degree", str(cs.SH_DEGREE),
        "--white_background", "--iterations", str(args.iterations),
        "--test_iterations", *map(str, tests), "--save_iterations", str(args.iterations)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    render_app.main(["-m", model_dir, "--skip_train"])
    metrics_app.main(["-m", model_dir])
    eval_s = time.perf_counter() - t0
    with open(os.path.join(model_dir, "results_gs_mesh.json")) as f:
        final = json.load(f)[f"ours_{args.iterations}"]["gs_mesh"]
    out = {
        "card": card,
        "scene": {"faces": 5120, "gaussians": 51_200, "size": cs.SIZE, "sh_degree": cs.SH_DEGREE,
                  "train_views": N_TRAIN, "test_views": N_TEST, "iterations": args.iterations},
        "test_psnr_curve": {str(k): v for k, v in res.test_psnr.items()},
        "loss_last_100_mean": float(np.mean(res.losses[-100:])),
        "final_metrics_cli": final,
        "dataset_s": data_s,
        "train_s": train_s,
        "train_ms_per_step": 1e3 * train_s / args.iterations,
        "render_and_metrics_s": eval_s,
        "finite": bool(np.isfinite(res.losses).all()
                       and all(np.isfinite(v) for v in (final["SSIM"], final["PSNR"]))),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
