"""Batch train/render/metrics harness over scene suites (port of
`gaussian_mesh_splatting_tpu/apps/full_eval.py`): in-process calls to the
port's `train`, `render` and `metrics`, each given `--device`.

    python -m gaussian_mesh_splatting_tpu_torch.apps.full_eval --gs_type gs_mesh \\
        -ns <nerf_synthetic root> -o <output> [--device cpu]
"""
from __future__ import annotations

import argparse
import os

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]
NERF_SYNTHETIC = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]


def main(argv=None):
    p = argparse.ArgumentParser("full_eval")
    p.add_argument("--gs_type", default="gs")
    p.add_argument("--output_path", "-o", default="./eval")
    p.add_argument("--mipnerf360", "-m360", default=None)
    p.add_argument("--tanksandtemples", "-tat", default=None)
    p.add_argument("--deepblending", "-db", default=None)
    p.add_argument("--nerf_synthetic", "-ns", default=None)
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from . import metrics as metrics_app
    from . import render as render_app
    from . import train as train_app

    jobs: list[tuple[str, list[str]]] = []
    if args.mipnerf360:
        for s in MIPNERF360_OUTDOOR:
            jobs.append((os.path.join(args.mipnerf360, s), ["-i", "images_4"]))
        for s in MIPNERF360_INDOOR:
            jobs.append((os.path.join(args.mipnerf360, s), ["-i", "images_2"]))
    if args.tanksandtemples:
        jobs += [(os.path.join(args.tanksandtemples, s), []) for s in TANKS_AND_TEMPLES]
    if args.deepblending:
        jobs += [(os.path.join(args.deepblending, s), []) for s in DEEP_BLENDING]
    if args.nerf_synthetic:
        jobs += [(os.path.join(args.nerf_synthetic, s), ["--white_background"])
                 for s in NERF_SYNTHETIC]

    device = ["--device", args.device]
    model_paths = []
    for source, extra in jobs:
        model_path = os.path.join(args.output_path, os.path.basename(source))
        model_paths.append(model_path)
        if not args.skip_training:
            train_app.main(["--gs_type", args.gs_type, "-s", source, "-m", model_path,
                            "--eval", "--iterations", str(args.iterations), "--quiet",
                            *extra, *device])
        if not args.skip_rendering:
            render_app.main(["-m", model_path, "--skip_train", *device])
    if not args.skip_metrics:
        metrics_app.main(["-m", *model_paths, *device])


if __name__ == "__main__":
    main()
