#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gaussian_mesh_splatting_tpu_torch`)
on one CUDA card: the quickest proof that the port builds, is right and
starts on the GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. build every kernel of the render path from `csrc/` with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes (the 5120-face, 51,200-Gaussian `gs_mesh` scene at
     800x800, SH degree 3), on a non-aligned 803x611 view, on a dense scene
     that drives pixels to termination and on an empty (all culled) one;
     and the CUDA render against the sequential torch oracle on a small
     scene;
  3. drive the main path through the user's entry point: write a seeded
     Blender_Mesh dataset and a `gs_mesh` model directory, run
     `apps.render.main(["-m", ...])` on the card, check the PNGs and that
     the kernel launched once per view; time preprocess, binning and
     composite per view;
  4. print the kernels line, the card's name and power limit, and last the
     device line.
Data is generated from fixed seeds under build/chip_smoke/ (git-ignored).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SIZE = 800  # main-path image edge
N_TRAIN, N_TEST = 3, 2
NUM_SPLATS = 10
SH_DEGREE = 3
FOVX = 0.8
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
# float operations of one (pixel, pair) evaluation of the composite:
# dx, dy (2), power (9), exp (1), op*G (1), min (1), 1-alpha and T*() (2),
# w = T*alpha (1), four accumulations (8)
FLOPS_PER_EVAL = 25


def log(msg: str) -> None:
    print(msg, flush=True)


def icosphere_mesh() -> tuple[np.ndarray, np.ndarray]:
    """The repo's at-scale test mesh: a 4-times subdivided icosphere (2562
    vertices, 5120 faces) with a lumpy radius."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array(
        [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
         [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
         [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(4):
        vlist = [tuple(v) for v in verts]
        cache: dict = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                cache[key] = len(vlist)
                vlist.append(tuple(m / np.linalg.norm(m)))
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts, faces = np.array(vlist), np.array(new_faces)
    bump = 1.0 + 0.25 * np.sin(4 * verts[:, 0]) * np.cos(3 * verts[:, 1]) \
        + 0.15 * np.sin(5 * verts[:, 2])
    return (verts * bump[:, None]).astype(np.float32), faces


def write_dataset(root: str) -> None:
    """Blender_Mesh dataset: mesh.obj + placeholder PNGs + a ring of cameras."""
    from PIL import Image

    from gaussian_mesh_splatting_tpu_torch.io.obj import save_obj

    verts, faces = icosphere_mesh()
    save_obj(os.path.join(root, "mesh.obj"), verts, faces)
    for split, n_cams, off in [("train", N_TRAIN, 0.0), ("test", N_TEST, 0.31)]:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n_cams):
            angle = 2 * np.pi * (i + off) / n_cams
            elev = 0.9 * np.sin(2.1 * i + off)
            c = np.array([3.2 * np.sin(angle) * np.cos(elev), 3.2 * np.sin(elev) + 0.2,
                          3.2 * np.cos(angle) * np.cos(elev)])
            fwd = -c / np.linalg.norm(c)
            right = np.cross([0.0, 1.0, 0.0], fwd)
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, :3] = np.stack([right, np.cross(fwd, right), -fwd], axis=1)
            c2w[:3, 3] = c
            Image.fromarray(np.zeros((SIZE, SIZE, 4), np.uint8), "RGBA").save(
                os.path.join(root, split, f"r_{i}.png"))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": FOVX, "frames": frames}, f)


def randomize_state(state: dict, seed: int) -> dict:
    """Trained-looking mesh Gaussians: random colours and view dependence,
    opacity sigmoid(2.5)."""
    import torch

    rng = np.random.default_rng(seed)
    p = dict(state["params"])
    dev = p["f_dc"].device
    p["f_dc"] = torch.as_tensor(rng.random(p["f_dc"].shape, np.float32) * 2 - 0.5, device=dev)
    p["f_rest"] = torch.as_tensor(
        (rng.standard_normal(p["f_rest"].shape) * 0.08).astype(np.float32), device=dev)
    p["opacity"] = torch.full_like(p["opacity"], 2.5)
    return {"params": p, "consts": state["consts"], "alive": state["alive"]}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of `reps` single-call times with CUDA events (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def composite_inputs(bag, cam, sh_degree):
    from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
    from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE

    proj = preprocess(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam,
                      shs=bag.shs, sh_degree=sh_degree, alive=bag.alive, radius_mode="tight")
    n_ty, n_tx = -(-cam.height // TILE), -(-cam.width // TILE)
    binning = bin_gaussians(proj, tile_h=TILE, tile_w=TILE, n_tiles_y=n_ty, n_tiles_x=n_tx)
    args = (proj.mean2d.contiguous(), proj.conic.contiguous(), proj.opacity.contiguous(),
            proj.color.contiguous(), proj.depth.contiguous(), binning.pair_gaussian,
            binning.tile_start, binning.tile_end, cam.height, cam.width)
    return proj, binning, args


def compare_composite(label: str, args, time_it: bool) -> dict:
    """Kernel vs plain version on the same inputs, on the card."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        TILE, composite_fwd_cuda, composite_fwd_plain)

    planes_k, nc_k = composite_fwd_cuda(*args)
    planes_p, nc_p = composite_fwd_plain(*args)
    torch.cuda.synchronize()
    err_img = (planes_k[:4] - planes_p[:4]).abs().max().item()  # r, g, b, T (= 1 - alpha)
    d_scale = max(planes_p[4].abs().max().item(), 1e-6)
    err_depth = (planes_k[4] - planes_p[4]).abs().max().item()
    nc_mismatch = int((nc_k != nc_p).sum().item())
    ok = err_img <= 2e-5 and err_depth <= 2e-4 * d_scale and nc_mismatch == 0
    mean2d, tile_start, tile_end, h, w = args[0], args[6], args[7], args[8], args[9]
    n_pairs = int(args[5].shape[0])
    res = {"case": label, "height": h, "width": w, "gaussians": int(mean2d.shape[0]),
           "pairs": n_pairs, "max_abs_err_rgbT": err_img, "max_abs_err_depth": err_depth,
           "depth_tol": 2e-4 * d_scale, "nc_mismatches": nc_mismatch,
           "frac_T_below_1e-3": (planes_p[3] < 1e-3).float().mean().item(), "ok": ok}
    if time_it:
        # least time: bytes each input read once + outputs written once,
        # and the (pixel, pair) evaluations this data needs: every pair of
        # the pixel's tile, or up to the last included pair (nc) where the
        # pixel may have stopped early (T_final < 0.01)
        n_tx = -(-w // TILE)
        count = (tile_end - tile_start).long()
        ys = torch.arange(h, device=mean2d.device) // TILE
        xs = torch.arange(w, device=mean2d.device) // TILE
        tile_count = count[ys[:, None] * n_tx + xs[None, :]]
        evals = torch.where(planes_p[3] < 0.01, nc_p.long(), tile_count).sum().item()
        bytes_moved = 4 * n_pairs + 8 * count.numel() + 40 * mean2d.shape[0] + 24 * h * w
        t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
        t_ops = evals * FLOPS_PER_EVAL / H100_F32_FLOPS * 1e3
        res.update(
            ms=cuda_ms(lambda: composite_fwd_cuda(*args), reps=20),
            plain_ms=cuda_ms(lambda: composite_fwd_plain(*args), reps=10, warmup=1),
            evaluations=evals, bytes=bytes_moved,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
    log(f"  B1 {label}: {json.dumps(res)}")
    if not ok:
        raise SystemExit(f"B1 disagrees with its plain version on {label}")
    return res


def dense_scene(n: int, seed: int, device):
    """Many large, nearly opaque Gaussians around the origin."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models.gaussian_bag import GaussianBag

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return GaussianBag(
        xyz=t(rng.standard_normal((n, 3)) * 0.15),
        scaling=t(np.exp(rng.standard_normal((n, 3)) * 0.3 - 1.5)),
        rotation=t(rng.standard_normal((n, 4))),
        opacity=t(np.clip(rng.random((n, 1)) * 3.0, 0.05, 0.999)),
        shs=t(rng.standard_normal((n, 3, 16)) * 0.3),
        alive=torch.ones(n, dtype=torch.bool, device=device),
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 2
    from gaussian_mesh_splatting_tpu_torch.apps import render as render_app
    from gaussian_mesh_splatting_tpu_torch.core.camera import focal2fov, fov2focal, make_camera
    from gaussian_mesh_splatting_tpu_torch.io.checkpoint import snapshot_dir
    from gaussian_mesh_splatting_tpu_torch.io.config_io import save_cfg
    from gaussian_mesh_splatting_tpu_torch.io.snapshots import save_snapshot
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build, rasterize_cuda as rc
    from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
    from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    path, build_s, build_log = cuda_build.build("composite_fwd")
    log(f"[1] built {os.path.relpath(path, ROOT)} in {build_s:.2f} s "
        f"(phase {time.perf_counter() - t0:.2f} s)")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"    ptxas: {line.strip()}")

    # ---- scene + model directory (seeded) ----------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    data_dir, model_dir = os.path.join(WORK, "scene"), os.path.join(WORK, "model")
    os.makedirs(data_dir)
    write_dataset(data_dir)
    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=NUM_SPLATS, shuffle=False, device=dev)
    state = randomize_state(scene.init_model_state(mesh_model, SH_DEGREE), seed=42)
    iteration = 30000
    save_snapshot("gs_mesh", mesh_model, state, snapshot_dir(model_dir, iteration))
    save_cfg(model_dir, {"source_path": data_dir, "gs_type": "gs_mesh", "sh_degree": SH_DEGREE,
                         "num_splats": NUM_SPLATS, "white_background": True, "eval": True})
    with torch.no_grad():
        bag = mesh_model.to_bag(state)
    log(f"    gs_mesh scene: {bag.num_gaussians} Gaussians, "
        f"{state['consts']['faces'].shape[0]} faces, {SIZE}x{SIZE}, SH {SH_DEGREE}")

    # ---- 2. kernels against their plain versions on the card ---------------
    log("[2] B1 composite_fwd vs its plain version (tolerance 2e-5 rgb/T, "
        "2e-4*max|depth| depth, 0 nc mismatches)")
    t0 = time.perf_counter()
    with torch.no_grad():
        cam0 = scene.train_cameras[0][0]
        _, _, args_full = composite_inputs(bag, cam0, SH_DEGREE)
        full = compare_composite("gs_mesh 800x800", args_full, time_it=True)
        R = np.asarray(scene.scene_info.train_cameras[0].R)
        T = np.asarray(scene.scene_info.train_cameras[0].T)
        cam_na = make_camera(R, T, FOVX, focal2fov(fov2focal(FOVX, 803), 611), 803, 611,
                             device=dev)
        compare_composite("gs_mesh 803x611", composite_inputs(bag, cam_na, SH_DEGREE)[2], False)
        cam_dense = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 0.8, 0.8, 512, 512,
                                device=dev)
        dense = compare_composite(
            "dense overlap 512x512", composite_inputs(dense_scene(4000, 2, dev), cam_dense, 3)[2],
            False)
        if dense["frac_T_below_1e-3"] < 0.1:
            raise SystemExit("the dense case does not drive pixels to termination")
        cam_small = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, 200, 50,
                                device=dev)
        culled = dense_scene(64, 3, dev)
        culled = dataclasses.replace(culled, xyz=culled.xyz - torch.tensor([0.0, 0.0, 100.0],
                                                                           device=dev))
        empty = compare_composite("empty (all culled) 200x50",
                                  composite_inputs(culled, cam_small, 3)[2], False)
        if empty["pairs"] != 0:
            raise SystemExit("the culled scene still binned pairs")
        # the whole CUDA render against the sequential torch oracle
        small = dense_scene(96, 5, dev)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
        kw = dict(bg=bg, shs=small.shs, sh_degree=2, alive=small.alive)
        fast = rc.rasterize_cuda(small.xyz, small.scaling, small.rotation, small.opacity,
                                 cam_small, **kw)
        ref = rasterize_reference(small.xyz, small.scaling, small.rotation, small.opacity,
                                  cam_small, **kw)
        oracle_err = max((fast.image - ref.image).abs().max().item(),
                         (fast.alpha - ref.alpha).abs().max().item())
        log(f"  CUDA render vs torch oracle (96 Gaussians, 200x50): max abs err {oracle_err:.3g}")
        if not oracle_err <= 2e-5:
            raise SystemExit("the CUDA render disagrees with the oracle")
    log(f"    phase 2: {time.perf_counter() - t0:.1f} s")

    # ---- 3. the main path through the user's entry point -------------------
    log("[3] apps.render.main on the card")
    rc.composite_fwd_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_app.main(["-m", model_dir])
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    launches = rc.composite_fwd_cuda.launches
    n_views = N_TRAIN + N_TEST
    log(f"    {n_views} views in {app_s:.2f} s ({1e3 * app_s / n_views:.1f} ms per view, "
        f"scene load and PNG writes included); composite_fwd launches: {launches}")
    if launches != n_views:
        raise SystemExit(f"expected {n_views} composite launches, counted {launches}")
    from PIL import Image

    for split, n_cams in [("train", N_TRAIN), ("test", N_TEST)]:
        for i in range(n_cams):
            png = os.path.join(model_dir, split, f"ours_{iteration}", "renders_gs_mesh",
                               f"{i:05d}.png")
            gt_png = os.path.join(model_dir, split, f"ours_{iteration}", "gt", f"{i:05d}.png")
            if not os.path.exists(gt_png):
                raise SystemExit(f"missing {gt_png}")
            with Image.open(png) as im:
                img = np.asarray(im, dtype=np.float32)
            if img.shape != (SIZE, SIZE, 3) or not np.isfinite(img).all() or img.std() < 1.0:
                raise SystemExit(f"bad render {png}: shape {img.shape}, std {img.std():.3f}")
            if (split, i) == ("train", 0):
                planes = rc.composite_fwd_cuda(*args_full)[0]
                expect = planes[:3].permute(1, 2, 0) + planes[3][..., None]  # white bg
                expect = (torch.clamp(expect, 0, 1) * 255).to(torch.uint8).cpu().numpy()
                diff = np.abs(expect.astype(np.int32) - img.astype(np.int32)).max()
                if diff > 1:
                    raise SystemExit(f"app render differs from the kernel's by {diff}/255")
    log("    PNGs: all written, finite, not blank; train view 0 matches the kernel output")

    # per-view split of the render path (CUDA events, median of 10)
    with torch.no_grad():
        n_ty, n_tx = -(-cam0.height // rc.TILE), -(-cam0.width // rc.TILE)

        def do_pre():
            return preprocess(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam0,
                              shs=bag.shs, sh_degree=SH_DEGREE, alive=bag.alive,
                              radius_mode="tight")

        proj = do_pre()

        def do_bin():
            return bin_gaussians(proj, tile_h=rc.TILE, tile_w=rc.TILE, n_tiles_y=n_ty,
                                 n_tiles_x=n_tx)

        split = {
            "to_bag_ms": cuda_ms(lambda: mesh_model.to_bag(state), reps=10),
            "preprocess_ms": cuda_ms(do_pre, reps=10),
            "binning_ms": cuda_ms(do_bin, reps=10),
            "composite_ms": cuda_ms(lambda: rc.composite_fwd_cuda(*args_full), reps=10),
            "render_ms": cuda_ms(lambda: rc.rasterize_cuda(
                bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam0,
                bg=torch.ones(3, device=dev), shs=bag.shs, sh_degree=SH_DEGREE,
                alive=bag.alive), reps=10),
        }
    log(f"    per view, 800x800: {json.dumps(split)}")

    # ---- 4. output lines ----------------------------------------------------
    kernels = {"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "gaussian_mesh_splatting_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py:238",
        "launches": launches,
        "max_abs_err": full["max_abs_err_rgbT"],
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
