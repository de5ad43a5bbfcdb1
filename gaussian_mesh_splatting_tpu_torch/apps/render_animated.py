"""Mesh-animation rendering (port of
`gaussian_mesh_splatting_tpu/apps/render_animated.py`): deform a trained
`gs_mesh` model's vertices over time, derive the Gaussians again from the
deformed faces every frame (`models/mesh.to_bag(state, triangles=)`), and
render the sequence from one camera to {model}/animated_{deform}/NNNNN.png.
Runs on the CUDA device unless `--device cpu` is given.

    python -m gaussian_mesh_splatting_tpu_torch.apps.render_animated -m <model> \\
        [--deform fly|wave|twist] [--frames 60] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


# ------------------------------------------------------------ deform library
# t runs over [0, 1]; at t = 0 every deform is the identity

def transform_fly(vertices: np.ndarray, t: float) -> np.ndarray:
    """A sinusoidal lift and flap."""
    v = vertices.copy()
    v[:, 2] = v[:, 2] + 0.25 * np.sin(2 * np.pi * t)
    v[:, 0] = v[:, 0] * (1.0 + 0.1 * np.sin(4 * np.pi * t))
    return v


def transform_wave(vertices: np.ndarray, t: float) -> np.ndarray:
    v = vertices.copy()
    v[:, 1] = v[:, 1] + 0.1 * np.sin(4 * np.pi * (v[:, 0] + t))
    return v


def transform_twist(vertices: np.ndarray, t: float) -> np.ndarray:
    v = vertices.copy()
    angle = 0.5 * np.sin(2 * np.pi * t) * v[:, 2]
    c, s = np.cos(angle), np.sin(angle)
    x, y = v[:, 0].copy(), v[:, 1].copy()
    v[:, 0] = c * x - s * y
    v[:, 1] = s * x + c * y
    return v


DEFORMS = {"fly": transform_fly, "wave": transform_wave, "twist": transform_twist}


def load_mesh_model(model_path: str, iteration: int, device: torch.device):
    """A trained `gs_mesh` model directory: (its config, its state with the
    faces of its scene's mesh, a camera-ready Scene)."""
    from ..io.checkpoint import snapshot_dir
    from ..io.config_io import load_cfg
    from ..io.snapshots import load_snapshot
    from ..models import mesh as mesh_model
    from ..scene import Scene
    from .render import latest_iteration

    cfg = load_cfg(model_path)
    gs_type = cfg.get("gs_type", "gs_mesh")
    if gs_type != "gs_mesh":
        raise ValueError(f"this app drives gs_mesh models; {model_path} is a {gs_type} model")
    sh_degree = int(cfg.get("sh_degree", 3))
    scene = Scene(
        cfg["source_path"], gs_type,
        white_background=bool(cfg.get("white_background", False)),
        eval=True, num_splats=int(cfg.get("num_splats", 2)), shuffle=False, device=device,
    )
    iteration = iteration if iteration > 0 else latest_iteration(model_path)
    consts = scene.init_model_state(mesh_model, sh_degree)["consts"]
    state = load_snapshot(gs_type, snapshot_dir(model_path, iteration), sh_degree, consts,
                          device=device)
    return cfg, state, scene


def render_frames(out_dir: str, vertex_frames, cfg: dict, state: dict, cam,
                  device: torch.device) -> None:
    """Render `state` with each (V, 3) numpy vertex array of `vertex_frames`
    in place of its vertices, to out_dir/NNNNN.png."""
    from ..models import mesh as mesh_model
    from ..renderer import render
    from .render import save_png

    sh_degree = int(cfg.get("sh_degree", 3))
    bg = torch.full((3,), 1.0 if cfg.get("white_background") else 0.0, device=device)
    faces = state["consts"]["faces"].long()
    with torch.no_grad():
        for i, verts in enumerate(vertex_frames):
            tris = torch.as_tensor(np.asarray(verts, np.float32), device=device)[faces]
            bag = mesh_model.to_bag(state, triangles=tris)
            out = render(bag, cam, bg, sh_degree=sh_degree, backend="auto")
            save_png(os.path.join(out_dir, f"{i:05d}.png"),
                     torch.clamp(out.image, 0.0, 1.0).cpu().numpy())


def main(argv=None):
    p = argparse.ArgumentParser("render_animated")
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--deform", default="fly", choices=sorted(DEFORMS))
    p.add_argument("--camera_index", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    cfg, state, scene = load_mesh_model(args.model_path, args.iteration, device)
    cam, _ = (scene.test_cameras or scene.train_cameras)[args.camera_index]
    deform = DEFORMS[args.deform]
    verts0 = state["params"]["vertices"].detach().cpu().numpy()
    out_dir = os.path.join(args.model_path, f"animated_{args.deform}")
    render_frames(out_dir,
                  (deform(verts0, i / max(args.frames - 1, 1)) for i in range(args.frames)),
                  cfg, state, cam, device)
    print(f"wrote {args.frames} frames to {out_dir}")


if __name__ == "__main__":
    main()
