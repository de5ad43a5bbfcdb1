"""FLAME avatar rendering (port of `gaussian_mesh_splatting_tpu/apps/render_flame.py`):
decode the head of a trained `gs_flame` model with its trained FLAME params,
or with the jaw and the first expression swept over `--frames` frames
(`--animated`), and render it from one camera of its dataset on a white
background to {model}/renders_flame[_animated]/NNNNN.png; `--dump_obj` also
writes each frame's decoded head as head_NNNNN.obj. Runs on the CUDA device
unless `--device cpu` is given.

    python -m gaussian_mesh_splatting_tpu_torch.apps.render_flame -m <model> \\
        [--animated --frames 30] [--dump_obj] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser("render_flame")
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--animated", action="store_true", help="sweep jaw + expression over frames")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--camera_index", type=int, default=0)
    p.add_argument("--dump_obj", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..io.checkpoint import snapshot_dir
    from ..io.config_io import load_cfg
    from ..io.obj import save_obj
    from ..io.snapshots import load_snapshot
    from ..models import model_for
    from ..renderer import render
    from ..scene import Scene
    from .render import latest_iteration, save_png

    device = resolve_device(args.device)
    cfg = load_cfg(args.model_path)
    sh_degree = int(cfg.get("sh_degree", 3))
    model, rig = model_for("gs_flame", cfg.get("flame_model"), device)
    scene = Scene(
        cfg["source_path"], "gs_flame",
        white_background=bool(cfg.get("white_background", False)),
        eval=True, flame_rig=rig, shuffle=False, device=device,
    )
    iteration = args.iteration if args.iteration > 0 else latest_iteration(args.model_path)
    state = load_snapshot("gs_flame", snapshot_dir(args.model_path, iteration), sh_degree,
                          {"faces": model.faces}, device=device)
    cam, _ = (scene.test_cameras or scene.train_cameras)[args.camera_index]
    bg = torch.ones(3, device=device)  # FLAME renders on white

    out_dir = os.path.join(args.model_path,
                           "renders_flame_animated" if args.animated else "renders_flame")
    n_frames = args.frames if args.animated else 1
    with torch.no_grad():
        for i in range(n_frames):
            params = dict(state["params"])
            if args.animated:
                t = i / max(n_frames - 1, 1)
                # jaw open/close and an expression sweep
                params["flame_pose"] = params["flame_pose"].clone()
                params["flame_pose"][0, 3] = 0.3 * np.sin(2 * np.pi * t)
                params["flame_exp"] = params["flame_exp"].clone()
                params["flame_exp"][0, 0] = 2.0 * np.sin(2 * np.pi * t)
            vertices = model.decode_vertices(params)
            bag = model.to_bag(dict(state, params=params), vertices)
            out = render(bag, cam, bg, sh_degree=sh_degree, backend="auto")
            save_png(os.path.join(out_dir, f"{i:05d}.png"),
                     torch.clamp(out.image, 0.0, 1.0).cpu().numpy())
            if args.dump_obj:
                save_obj(os.path.join(out_dir, f"head_{i:05d}.obj"), vertices.cpu().numpy(),
                         model.faces.cpu().numpy())
    print(f"wrote {n_frames} frames to {out_dir}")


if __name__ == "__main__":
    main()
