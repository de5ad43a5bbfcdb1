"""Mesh-to-mesh morph rendering (port of
`gaussian_mesh_splatting_tpu/apps/render_mesh_morph.py`): interpolate a
trained `gs_mesh` model's vertices linearly to an edited `.obj` of the same
topology and render each frame, through `models/mesh.to_bag(state,
triangles=)`, to {model}/mesh_morph/NNNNN.png. Runs on the CUDA device unless
`--device cpu` is given.

    python -m gaussian_mesh_splatting_tpu_torch.apps.render_mesh_morph -m <model> \\
        --target_mesh <edited.obj> [--frames 60] [--transform_target] [--device cpu]
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser("render_mesh_morph")
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--target_mesh", required=True, help="edited .obj, same topology")
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--camera_index", type=int, default=0)
    p.add_argument("--transform_target", action="store_true",
                   help="apply the Blender [x,z,-y] transform to the target")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..io.obj import load_obj
    from ..scene.dataset_readers import transform_mesh_vertices
    from .render_animated import load_mesh_model, render_frames

    device = resolve_device(args.device)
    cfg, state, scene = load_mesh_model(args.model_path, args.iteration, device)
    target_v, _ = load_obj(args.target_mesh)
    if args.transform_target:
        target_v = transform_mesh_vertices(target_v)
    v0 = state["params"]["vertices"].detach().cpu().numpy()
    if target_v.shape != v0.shape:
        raise ValueError(f"the target mesh must keep the topology: {target_v.shape[0]} "
                         f"vertices against the model's {v0.shape[0]}")
    cam, _ = (scene.test_cameras or scene.train_cameras)[args.camera_index]
    out_dir = os.path.join(args.model_path, "mesh_morph")
    frames = ((1 - t) * v0 + t * target_v
              for t in (i / max(args.frames - 1, 1) for i in range(args.frames)))
    render_frames(out_dir, frames, cfg, state, cam, device)
    print(f"wrote {args.frames} morph frames to {out_dir}")


if __name__ == "__main__":
    main()
