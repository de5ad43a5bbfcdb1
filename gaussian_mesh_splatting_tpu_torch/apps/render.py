"""Batch rendering CLI (port of `gaussian_mesh_splatting_tpu/apps/render.py`).

Renders the train and test views of a trained model (`gs`, `gs_flat`,
`gs_mesh`, `gs_multi_mesh`, `gs_flame`, or a `gs_flat` model as `--gs_type
gs_points`) to PNG under
{model}/{split}/ours_{iteration}/renders_{gs_type}/ and gt/. Runs on the
CUDA device (preprocess, binning and the CUDA composite kernel) unless
`--device cpu` is given, which takes the kernel's plain PyTorch version.

    python -m gaussian_mesh_splatting_tpu_torch.apps.render -m <model> [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def latest_iteration(model_path: str) -> int:
    root = os.path.join(model_path, "point_cloud")
    return max(int(d.split("_")[1]) for d in os.listdir(root) if d.startswith("iteration_"))


def render_sets(args) -> None:
    from ..device import resolve_device
    from ..io.checkpoint import snapshot_dir
    from ..io.config_io import combined_args
    from ..io.snapshots import load_snapshot
    from ..models import model_for
    from ..renderer import render
    from ..scene import Scene

    device = resolve_device(args.device)
    cfg = combined_args(args.model_path, {
        "source_path": args.source_path, "gs_type": args.gs_type,
    })
    gs_type = cfg.get("gs_type", "gs")
    sh_degree = int(cfg.get("sh_degree", 3))
    model, flame_rig = model_for(gs_type, cfg.get("flame_model"), device)

    scene = Scene(
        cfg["source_path"], gs_type,
        white_background=bool(cfg.get("white_background", False)),
        eval=bool(cfg.get("eval", True)),
        resolution=int(cfg.get("resolution", -1)),
        images=cfg.get("images"),
        num_splats=int(cfg.get("num_splats", 2)),
        meshes=cfg.get("meshes"),
        flame_rig=flame_rig,
        shuffle=False,
        device=device,
    )
    iteration = args.iteration if args.iteration > 0 else latest_iteration(args.model_path)
    # mesh faces do not travel in the snapshot: rebuild them from the scene's
    # meshes, or take the FLAME rig's; a point-cloud state has none
    if gs_type == "gs_flame":
        consts = {"faces": model.faces}
    elif gs_type in ("gs_mesh", "gs_multi_mesh"):
        consts = scene.init_model_state(model, sh_degree)["consts"]
    else:
        consts = {}
    state = load_snapshot(
        gs_type, snapshot_dir(args.model_path, iteration), sh_degree, consts, device=device
    )
    bg = torch.ones(3, device=device) if cfg.get("white_background") else torch.zeros(3, device=device)

    with torch.no_grad():
        # gs_points: the state's own pseudomesh (a triangle soup), and the
        # Gaussians derived back from its triangles
        bag = model.to_bag(state)
        for split, cameras in [("train", scene.train_cameras), ("test", scene.test_cameras)]:
            if (split == "train" and args.skip_train) or (split == "test" and args.skip_test):
                continue
            base = os.path.join(args.model_path, split, f"ours_{iteration}")
            for idx, (cam, gt) in enumerate(cameras):
                out = render(bag, cam, bg, sh_degree=sh_degree, backend="auto")
                img = torch.clamp(out.image, 0.0, 1.0).cpu().numpy()
                save_png(os.path.join(base, f"renders_{gs_type}", f"{idx:05d}.png"), img)
                save_png(os.path.join(base, "gt", f"{idx:05d}.png"), gt)
            print(f"rendered {len(cameras)} {split} views to {base}")


def main(argv=None):
    p = argparse.ArgumentParser("render")
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--source_path", "-s", default=None)
    p.add_argument("--gs_type", default=None)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    render_sets(p.parse_args(argv))


if __name__ == "__main__":
    main()
