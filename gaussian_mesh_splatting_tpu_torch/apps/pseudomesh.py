"""Pseudomesh tooling, the flat-GS editing pipeline (port of
`gaussian_mesh_splatting_tpu/apps/pseudomesh.py`):

  save     : a trained gs_flat model -> its triangle soup
             ({model}/pseudomesh/triangles.npz and a scaled .obj);
  dummy    : an alpha-shape-style surface from the soup's vertices (scipy
             Delaunay tetrahedra kept below a circumradius, their boundary
             faces);
  retarget : express each soup triangle in its nearest dummy-mesh face's
             frame and replay it on an edited copy of that mesh;
  render   : render an (edited) soup through the `gs_points` model, every
             test view, to {model}/renders_soup/;
  animate  : a wave over the soup's vertices, one camera, to
             {model}/soup_animated/.

`dummy` and `retarget` are numpy/scipy on the host; `save`, `render` and
`animate` run on the CUDA device unless `--device cpu` is given.

    python -m gaussian_mesh_splatting_tpu_torch.apps.pseudomesh save -m <model> [--device cpu]
    python -m gaussian_mesh_splatting_tpu_torch.apps.pseudomesh dummy --triangles <npz> --output <obj>
    python -m gaussian_mesh_splatting_tpu_torch.apps.pseudomesh retarget --triangles <npz> \\
        --estimated_mesh <obj> --edited_mesh <obj> --output <npz>
    python -m gaussian_mesh_splatting_tpu_torch.apps.pseudomesh render -m <model> --triangles <npz>
    python -m gaussian_mesh_splatting_tpu_torch.apps.pseudomesh animate -m <model> [--frames 60]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _load_points_model(model_path: str, iteration: int, sh_degree: int, device):
    """The snapshot of a gs_flat model as a `gs_points` state on `device`."""
    from ..io.checkpoint import snapshot_dir
    from ..io.snapshots import load_snapshot
    from .render import latest_iteration

    iteration = iteration if iteration > 0 else latest_iteration(model_path)
    return load_snapshot("gs_points", snapshot_dir(model_path, iteration), sh_degree,
                         device=device)


def _scene_and_bg(model_path: str, device):
    """(cfg, the model's Blender/COLMAP scene without a shuffle, background)."""
    from ..io.config_io import load_cfg
    from ..scene import Scene

    cfg = load_cfg(model_path)
    scene = Scene(cfg["source_path"], "gs_flat",
                  white_background=bool(cfg.get("white_background", False)),
                  eval=True, shuffle=False, device=device)
    bg = torch.full((3,), 1.0 if cfg.get("white_background") else 0.0, device=device)
    return cfg, scene, bg


def _render_soup(state: dict, tris: np.ndarray, cam, bg, sh_degree: int) -> np.ndarray:
    from ..models import points
    from ..renderer import render

    tris = torch.as_tensor(np.asarray(tris, np.float32), device=bg.device)
    with torch.no_grad():
        out = render(points.to_bag(state, tris), cam, bg, sh_degree=sh_degree, backend="auto")
    return torch.clamp(out.image, 0.0, 1.0).cpu().numpy()


def save_pseudomesh(args) -> None:
    from ..device import resolve_device
    from ..io.obj import save_obj
    from ..models import points

    state = _load_points_model(args.model_path, args.iteration, args.sh_degree,
                               resolve_device(args.device))
    with torch.no_grad():
        tris = points.pseudomesh_from_state(state).cpu().numpy()
    out_dir = os.path.join(args.model_path, "pseudomesh")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "triangles.npz"), triangles=tris)
    save_obj(os.path.join(out_dir, f"scale_{args.obj_scale}.obj"), tris * args.obj_scale)
    print(f"saved {tris.shape[0]} soup triangles to {out_dir}")


def create_dummy_mesh(args) -> None:
    """Surface reconstruction: Delaunay tetrahedralization filtered by
    circumradius < alpha, and the faces that only one kept tetrahedron has."""
    from scipy.spatial import Delaunay

    from ..io.obj import save_obj

    tris = np.load(args.triangles)["triangles"]
    pts = tris[:, 0]  # the Gaussians' centres
    if args.max_points and pts.shape[0] > args.max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], args.max_points, replace=False)
        pts = pts[sel]
    simplices = Delaunay(pts).simplices
    a, b, c, d = (pts[simplices[:, i]] for i in range(4))

    def sq(x):
        return np.sum(x * x, axis=1)

    # circumcentres: the solution of 2 (p_i - a) . x = |p_i|^2 - |a|^2
    A = np.stack([b - a, c - a, d - a], axis=1)
    rhs = 0.5 * np.stack([sq(b) - sq(a), sq(c) - sq(a), sq(d) - sq(a)], axis=1)
    ok = np.abs(np.linalg.det(A)) > 1e-12
    centers = np.zeros((simplices.shape[0], 3))
    centers[ok] = np.linalg.solve(A[ok], rhs[ok][..., None])[..., 0]
    radius = np.linalg.norm(centers - a, axis=1)
    keep = ok & (radius < args.alpha)
    faces = {}
    for tet_idx in np.nonzero(keep)[0]:
        s = simplices[tet_idx]
        for f in ([0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]):
            key = tuple(sorted(s[f]))
            faces[key] = faces.get(key, 0) + 1
    boundary = np.array([k for k, v in faces.items() if v == 1], np.int32)
    save_obj(args.output, pts.astype(np.float32), boundary)
    print(f"dummy mesh: {pts.shape[0]} verts, {boundary.shape[0]} boundary faces -> {args.output}")


def retarget(args) -> None:
    """Bind soup triangles to their nearest dummy-mesh faces and replay their
    local-frame coordinates on the edited mesh."""
    from scipy.spatial import cKDTree

    from ..io.obj import load_obj, save_obj

    tris = np.load(args.triangles)["triangles"]  # (N, 3, 3)
    v_src, f_src = load_obj(args.estimated_mesh)
    v_dst, f_dst = load_obj(args.edited_mesh)
    if f_src.shape != f_dst.shape:
        raise ValueError("the edited mesh must keep the estimated mesh's topology")

    def face_frames_np(v, f):
        t = v[f]
        e1 = t[:, 1] - t[:, 0]
        e2 = t[:, 2] - t[:, 0]
        n = np.cross(e1, e2)
        return t[:, 0], np.stack([n, e1, e2], axis=2)  # origin, (F, 3, 3) basis columns

    _, nearest = cKDTree(v_src[f_src].mean(axis=1)).query(tris[:, 0])
    o_src, B_src = face_frames_np(v_src, f_src)
    o_dst, B_dst = face_frames_np(v_dst, f_dst)
    o_s, B_s = o_src[nearest], B_src[nearest]
    o_d, B_d = o_dst[nearest], B_dst[nearest]
    # each soup vertex p: solve B_s c = p - o_s, replay B_d c + o_d
    out = np.empty_like(tris)
    for k in range(3):
        coef = np.linalg.solve(B_s, (tris[:, k] - o_s)[..., None])
        out[:, k] = (B_d @ coef)[..., 0] + o_d
    np.savez(args.output, triangles=out.astype(np.float32))
    save_obj(args.output.replace(".npz", ".obj"), out.astype(np.float32))
    print(f"retargeted {tris.shape[0]} triangles -> {args.output}")


def animate_soup(args) -> None:
    """A wave over every soup vertex per frame, scaling and rotation derived
    again from the moved triangles, from one camera."""
    from ..device import resolve_device
    from ..models import points
    from .render import save_png

    device = resolve_device(args.device)
    cfg, scene, bg = _scene_and_bg(args.model_path, device)
    sh_degree = int(cfg.get("sh_degree", 3))
    state = _load_points_model(args.model_path, args.iteration, sh_degree, device)
    with torch.no_grad():
        tris0 = points.pseudomesh_from_state(state).cpu().numpy()
    cam, _ = (scene.test_cameras or scene.train_cameras)[args.camera_index]
    out_dir = os.path.join(args.model_path, "soup_animated")
    for i in range(args.frames):
        t = i / max(args.frames - 1, 1)
        tris = tris0.copy()
        tris[..., 1] += args.amplitude * np.sin(2 * np.pi * (tris[..., 0] + t))
        save_png(os.path.join(out_dir, f"{i:05d}.png"),
                 _render_soup(state, tris, cam, bg, sh_degree))
    print(f"wrote {args.frames} frames to {out_dir}")


def render_soup(args) -> None:
    from ..device import resolve_device
    from ..io.obj import load_obj
    from .render import save_png

    device = resolve_device(args.device)
    cfg, scene, bg = _scene_and_bg(args.model_path, device)
    sh_degree = int(cfg.get("sh_degree", 3))
    state = _load_points_model(args.model_path, args.iteration, sh_degree, device)
    if args.triangles.endswith(".npz"):
        tris = np.load(args.triangles)["triangles"]
    else:
        v, _ = load_obj(args.triangles)
        tris = v.reshape(-1, 3, 3) * args.obj_scale
    out_dir = os.path.join(args.model_path, "renders_soup")
    cams = scene.test_cameras or scene.train_cameras
    for idx, (cam, _) in enumerate(cams):
        save_png(os.path.join(out_dir, f"{idx:05d}.png"),
                 _render_soup(state, tris, cam, bg, sh_degree))
    print(f"rendered soup to {out_dir}")


def main(argv=None):
    p = argparse.ArgumentParser("pseudomesh")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(parser):
        parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    s = sub.add_parser("save")
    s.add_argument("--model_path", "-m", required=True)
    s.add_argument("--iteration", type=int, default=-1)
    s.add_argument("--sh_degree", type=int, default=3)
    s.add_argument("--obj_scale", type=float, default=100.0)
    device_flag(s)
    s.set_defaults(fn=save_pseudomesh)

    d = sub.add_parser("dummy")
    d.add_argument("--triangles", required=True)
    d.add_argument("--output", required=True)
    d.add_argument("--alpha", type=float, default=0.1)
    d.add_argument("--max_points", type=int, default=20000)
    d.set_defaults(fn=create_dummy_mesh)

    r = sub.add_parser("retarget")
    r.add_argument("--triangles", required=True)
    r.add_argument("--estimated_mesh", required=True)
    r.add_argument("--edited_mesh", required=True)
    r.add_argument("--output", required=True)
    r.set_defaults(fn=retarget)

    rr = sub.add_parser("render")
    rr.add_argument("--model_path", "-m", required=True)
    rr.add_argument("--triangles", required=True)
    rr.add_argument("--iteration", type=int, default=-1)
    rr.add_argument("--obj_scale", type=float, default=0.01)
    device_flag(rr)
    rr.set_defaults(fn=render_soup)

    an = sub.add_parser("animate")
    an.add_argument("--model_path", "-m", required=True)
    an.add_argument("--iteration", type=int, default=-1)
    an.add_argument("--frames", type=int, default=60)
    an.add_argument("--amplitude", type=float, default=0.1)
    an.add_argument("--camera_index", type=int, default=0)
    device_flag(an)
    an.set_defaults(fn=animate_soup)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
