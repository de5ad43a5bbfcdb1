#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gaussian_mesh_splatting_tpu_torch`)
on one CUDA card: the quickest proof that the port builds, is right and
starts on the GPU, for rendering and for training.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. build every kernel of the render and training paths from `csrc/` with
     nvcc (sm_90a), one nvcc per source, all started together;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (the 5120-face, 51,200-Gaussian `gs_mesh` scene at
     800x800, SH degree 3), on a non-aligned 803x611 view, on a dense scene
     that drives pixels to termination and on an empty (all culled) one:
     the forward composite (B1) on its outputs, the backward composite (B2)
     on seeded cotangents and on the photometric loss's cotangent; each
     case prints how many of its tiles walk a ragged list of over two
     batches and how many have a warp that includes nothing beside one that
     does (the kernels' special paths; one case at least must have each);
     then the CUDA render and its gradients against the sequential torch
     oracle and its autograd on a small scene;
  3. drive the render path through the user's entry point: a seeded
     Blender_Mesh dataset whose images the port renders from a seeded
     teacher, a `gs_mesh` model directory of the teacher, and
     `apps.render.main(["-m", ...])` on the card; check the PNGs and that B1
     launched once per view;
  4. drive the training path through the user's entry point:
     `apps.train.main([...])` trains a fresh `gs_mesh` model on that dataset
     for TRAIN_ITERS steps; the loss must fall, the test PSNR rise, B2
     launch once per step and B1 once per step and eval view; the snapshot
     renders through `apps.render`;
  5. time the render path per view, the training path's own step per stage
     (CUDA events at the stage boundaries it marks), and the package's
     fwd+bwd bench (which refuses zero gradients); print how the pairs and
     the walked steps spread over the tiles, and each kernel's time on its
     longest tile alone (the critical path: a tile's walk is serial), launch
     by launch and with the launches queued back to back (`cuda_ms_queued`:
     the device time without the host's share of a single launch);
  6. print the kernels line (with each kernel's launches on the render and
     on the training path, and its bound from the operations that this
     run's data needs), the card's name and power limit, and last the
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
# float operations of one (pixel, pair) evaluation, counted from the kernels'
# bodies by how far the evaluation gets (a sum over the tile counts one add
# per pixel):
# B1 (csrc/composite_fwd.cu), every pair a pixel walks before it is done:
# dx, dy, power (11); where power <= 0: exp, op*G, min (3); where also
# alpha >= 1/255: 1-alpha, T*() (2); where the pair is composited: w = T*alpha
# and four accumulations (9). A composited pair costs 25.
FWD_FLOPS = (11, 3, 2, 9)
# B2 (csrc/composite_bwd.cu), every pair of rank below the pixel's nc: dx, dy,
# power (11); where power <= 0: exp, op*G, min (3); where the pair was
# composited: 1-alpha, T/(1-alpha), w (3), u (7), dalpha (3), S += w u (2), the
# colour and depth terms (4), the ten terms' sum over the tile (10), 29 in all;
# where also alpha_raw < 0.99: dpower (1), the six geometry terms
# (4 + 4 + 3 + 2 + 3 + 1). A composited, unclamped pair costs 61.
BWD_FLOPS = (11, 3, 29, 18)
GRAD_TOL = 5e-4  # B2 vs its plain version and the oracle, x max|g| per column
TRAIN_ITERS = 300
TEST_ITERS = (1, 100, 200, 300)


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


def cuda_ms_queued(fn, reps: int, warmup: int = 2) -> float:
    """Time per call (ms) of `reps` calls queued back to back between one pair
    of CUDA events: where the device work of a call outlasts the host's work
    to launch it, the host's share hides behind the device's and this is the
    device time alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def composite_inputs(bag, cam, sh_degree):
    """(projection, binning, the composite's arguments as the plain versions
    take them, the kernels' own layout inputs as the render path makes them)."""
    from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
    from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE, pack_attributes

    proj = preprocess(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam,
                      shs=bag.shs, sh_degree=sh_degree, alive=bag.alive, radius_mode="tight")
    n_ty, n_tx = -(-cam.height // TILE), -(-cam.width // TILE)
    binning = bin_gaussians(proj, tile_h=TILE, tile_w=TILE, n_tiles_y=n_ty, n_tiles_x=n_tx)
    args = (proj.mean2d.contiguous(), proj.conic.contiguous(), proj.opacity.contiguous(),
            proj.color.contiguous(), proj.depth.contiguous(), binning.pair_gaussian,
            binning.tile_start, binning.tile_end, cam.height, cam.width)
    layout = {"tile_order": binning.tile_order, "attrs": pack_attributes(*args[:5])}
    return proj, binning, args, layout


def tile_pixels(h: int, w: int, n_tiles: int, dev):
    """Pixel coordinates (n_tiles, 256) of each 16x16 tile in the kernels'
    thread order (a warp is an 8x4 patch), and which lie inside the image."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE

    n_tx = -(-w // TILE)
    tile = torch.arange(n_tiles, device=dev)[:, None]
    tid = torch.arange(TILE * TILE, device=dev)[None, :]
    warp, lane = tid // 32, tid % 32
    px = (tile % n_tx) * TILE + (warp % 2) * 8 + lane % 8
    py = (tile // n_tx) * TILE + (warp // 2) * 4 + lane // 8
    return px, py, (px < w) & (py < h)


def walk_shape(args, nc, fwd_steps=None) -> dict:
    """How the walks of these inputs spread over the tiles: pairs per tile,
    the steps B2 walks (min(pairs, largest nc of the tile)) and, where the
    replay counted them, the steps B1 walks (ranks at which some pixel of the
    tile was not yet done). Also how many tiles take the kernels' special
    paths: a ragged pair list over two batches of 256, and a warp whose
    pixels include nothing (nc = 0) beside a warp that includes something."""
    import torch

    tile_start, tile_end, h, w = args[6:10]
    n_tiles = int(tile_start.shape[0])
    px, py, inside = tile_pixels(h, w, n_tiles, nc.device)
    tile_nc = torch.where(inside, nc.long()[py.clamp_max(h - 1), px.clamp_max(w - 1)], 0)
    warp_nc = tile_nc.reshape(n_tiles, 8, 32).amax(dim=2)
    count = (tile_end - tile_start).long()
    bwd_steps = torch.minimum(count, warp_nc.amax(dim=1))

    def spread(x):
        x = x.float()
        q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99], device=x.device)).tolist()
        return {"sum": int(x.sum()), "max": int(x.max()), "argmax": int(x.argmax()),
                "p50": q[0], "p90": q[1], "p99": q[2], "nonzero": int((x > 0).sum())}

    res = {"tiles": n_tiles, "pairs_per_tile": spread(count), "bwd_steps": spread(bwd_steps),
           "tiles_ragged_over_two_batches": int(((count > 512) & (count % 256 != 0)).sum()),
           "tiles_with_idle_and_busy_warps": int(
               ((warp_nc.amin(dim=1) == 0) & (warp_nc.amax(dim=1) > 0)).sum())}
    if fwd_steps is not None:
        res["fwd_steps"] = spread(fwd_steps)
    return res


def one_tile(args, tile: int):
    """The same inputs with every tile's pair range emptied but `tile`'s, and
    the tile order that goes with them: a launch on them times that tile's
    walk alone."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.binning import tile_launch_order

    tile_start, tile_end = torch.zeros_like(args[6]), torch.zeros_like(args[7])
    tile_start[tile], tile_end[tile] = args[6][tile], args[7][tile]
    return (*args[:6], tile_start, tile_end, *args[8:]), tile_launch_order(tile_start, tile_end)


def composite_op_counts(args, nc) -> tuple[dict, "torch.Tensor"]:
    """The (pixel, pair) evaluations that B1 and B2 make on these inputs,
    split by how far each gets (FWD_FLOPS, BWD_FLOPS): a replay of the
    forward walk over every tile and pixel. Checks that B2's rule (rank
    below nc, power <= 0, alpha >= 1/255) picks exactly the pairs that the
    forward composited. Also returns, per tile, the steps of B1's walk: the
    ranks at which some pixel of the tile was not yet done."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        ALPHA_MAX, ALPHA_MIN, T_EPS, TILE)

    mean2d, conic, opacity = args[0], args[1], args[2]
    pair_gaussian, tile_start, tile_end, h, w = args[5:10]
    dev = mean2d.device
    n_tx = -(-w // TILE)
    n_tiles = int(tile_start.shape[0])
    tile = torch.arange(n_tiles, device=dev)[:, None]
    pix = torch.arange(TILE * TILE, device=dev)[None, :]
    px, py = (tile % n_tx) * TILE + pix % TILE, (tile // n_tx) * TILE + pix // TILE
    inside = (px < w) & (py < h)
    rank_stop = torch.where(inside, nc.long()[py.clamp_max(h - 1), px.clamp_max(w - 1)], 0)
    fx, fy = px.float(), py.float()
    start = tile_start.long()
    count = tile_end.long() - start
    n_pairs = int(pair_gaussian.shape[0])
    T = torch.ones((n_tiles, TILE * TILE), device=dev)
    done = ~inside
    totals = torch.zeros(8, dtype=torch.long, device=dev)
    fwd_steps = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    for k in range(int(count.max().item()) if n_pairs else 0):
        active = (count > k)[:, None]
        g = pair_gaussian[torch.clamp_max(start + k, n_pairs - 1)].long()
        dx = mean2d[g, 0][:, None] - fx
        dy = mean2d[g, 1][:, None] - fy
        a, b, c = conic[g, 0][:, None], conic[g, 1][:, None], conic[g, 2][:, None]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha_raw = opacity[g][:, None] * torch.exp(power)
        alpha = torch.clamp_max(alpha_raw, ALPHA_MAX)
        near = power <= 0.0
        hit = near & (alpha >= ALPHA_MIN)
        walked = active & ~done
        fwd_steps += walked.any(dim=1)
        test_T = T * (1.0 - alpha)
        stop = walked & hit & (test_T < T_EPS)
        composited = walked & hit & ~stop
        T = torch.where(composited, test_T, T)
        done = done | stop
        below_nc = active & (k < rank_stop)
        totals += torch.stack([walked.sum(), (walked & near).sum(), (walked & hit).sum(),
                               composited.sum(), below_nc.sum(), (below_nc & near).sum(),
                               (below_nc & hit).sum(),
                               (below_nc & hit & (alpha_raw < ALPHA_MAX)).sum()])
    t = totals.tolist()
    counts = {"fwd_evaluations": t[0], "fwd_power_le_0": t[1], "fwd_alpha_ge_min": t[2],
              "fwd_composited": t[3], "bwd_evaluations": t[4], "bwd_power_le_0": t[5],
              "bwd_composited": t[6], "bwd_unclamped": t[7]}
    if counts["bwd_composited"] != counts["fwd_composited"]:
        raise SystemExit(f"B2's inclusion rule disagrees with the forward walk: {counts}")
    counts["fwd_flops"] = sum(f * n for f, n in zip(FWD_FLOPS, t[0:4]))
    counts["bwd_flops"] = sum(f * n for f, n in zip(BWD_FLOPS, t[4:8]))
    return counts, fwd_steps


def compare_composite(label: str, args, layout, time_it: bool) -> dict:
    """Kernel vs plain version on the same inputs, on the card."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_fwd_cuda, composite_fwd_plain)

    planes_k, nc_k = composite_fwd_cuda(*args, **layout)
    planes_p, nc_p = composite_fwd_plain(*args)
    torch.cuda.synchronize()
    err_img = (planes_k[:4] - planes_p[:4]).abs().max().item()  # r, g, b, T (= 1 - alpha)
    d_scale = max(planes_p[4].abs().max().item(), 1e-6)
    err_depth = (planes_k[4] - planes_p[4]).abs().max().item()
    nc_mismatch = int((nc_k != nc_p).sum().item())
    ok = err_img <= 2e-5 and err_depth <= 2e-4 * d_scale and nc_mismatch == 0
    mean2d, tile_start, h, w = args[0], args[6], args[8], args[9]
    n_pairs = int(args[5].shape[0])
    res = {"case": label, "height": h, "width": w, "gaussians": int(mean2d.shape[0]),
           "pairs": n_pairs, "max_abs_err_rgbT": err_img, "max_abs_err_depth": err_depth,
           "depth_tol": 2e-4 * d_scale, "nc_mismatches": nc_mismatch,
           "frac_T_below_1e-3": (planes_p[3] < 1e-3).float().mean().item(), "ok": ok}
    if time_it:
        # least time: bytes each input read once + outputs written once, and
        # the operations of the (pixel, pair) evaluations this data needs
        n_tiles = int(tile_start.shape[0])
        ops, fwd_steps = composite_op_counts(args, nc_p)
        res["walk"] = walk_shape(args, nc_p, fwd_steps)
        bytes_moved = 4 * n_pairs + 8 * n_tiles + 40 * mean2d.shape[0] + 24 * h * w
        t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
        t_ops = ops["fwd_flops"] / H100_F32_FLOPS * 1e3
        res.update(
            ms=cuda_ms(lambda: composite_fwd_cuda(*args, **layout), reps=20),
            queued_ms=cuda_ms_queued(lambda: composite_fwd_cuda(*args, **layout), reps=20),
            plain_ms=cuda_ms(lambda: composite_fwd_plain(*args), reps=10, warmup=1),
            **{k: v for k, v in ops.items() if k.startswith("fwd_")}, bytes=bytes_moved,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
    else:
        res["walk"] = walk_shape(args, nc_p)
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


def render_gt_images(scene, bag, data_dir: str) -> None:
    """Overwrite the dataset's placeholder PNGs with the port's renders of
    the teacher `bag` (white background), as tools_verify_scale.py does."""
    import torch
    from PIL import Image

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda

    with torch.no_grad():
        for split, cams in [("train", scene.train_cameras), ("test", scene.test_cameras)]:
            for i, (cam, _) in enumerate(cams):
                out = rasterize_cuda(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam,
                                     bg=torch.ones(3, device=bag.xyz.device), shs=bag.shs,
                                     sh_degree=SH_DEGREE, alive=bag.alive)
                img = torch.clamp(out.image, 0, 1).cpu().numpy()
                rgba = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
                Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
                    os.path.join(data_dir, split, f"r_{i}.png"))


def photometric_cotangent(planes, teacher, bg):
    """The cotangent of the five composite planes under the training loss
    0.8 L1 + 0.2 (1 - SSIM) of image = rgb + T bg against `teacher`."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.train.loss import photometric_loss

    with torch.enable_grad():
        p = planes.detach().clone().requires_grad_(True)
        image = p[:3].permute(1, 2, 0) + p[3][..., None] * bg
        loss, _ = photometric_loss(image, teacher, 0.2)
        (g,) = torch.autograd.grad(loss, p)
    return g


def compare_composite_bwd(label: str, args, layout, teacher, time_it: bool) -> dict:
    """B2 vs its plain version on the same inputs and cotangents, on the
    card: a seeded normal cotangent of all five planes, and the photometric
    loss's cotangent against `teacher` (white background)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_bwd_cuda, composite_bwd_plain, composite_fwd_cuda)

    dev = args[0].device
    h, w = args[8], args[9]
    planes, nc = composite_fwd_cuda(*args, **layout)
    rng = np.random.default_rng(11)
    cots = {
        "seeded": torch.as_tensor(rng.standard_normal((5, h, w)).astype(np.float32), device=dev),
        "photometric": photometric_cotangent(planes, teacher, torch.ones(3, device=dev)),
    }
    empty = args[5].shape[0] == 0
    res = {"case": label, "pairs": int(args[5].shape[0]), "ok": True}
    for name, cot in cots.items():
        g_k = composite_bwd_cuda(*args, planes[3], nc, cot, **layout)
        g_p = composite_bwd_plain(*args, planes[3], nc, cot)
        torch.cuda.synchronize()
        scale = g_p.abs().amax(dim=0)
        err = (g_k - g_p).abs().amax(dim=0)
        finite = bool(torch.isfinite(g_k).all()) and bool(torch.isfinite(g_p).all())
        nonzero = empty or (bool((g_k.abs().amax(dim=0) > 0).all()) if name == "seeded"
                            else float(g_k.abs().sum()) > 0)
        ok = finite and nonzero and bool((err <= GRAD_TOL * scale).all())
        res[name] = {"max_abs_err": float(err.max()), "max_rel_err_per_col": float(
            (err / torch.clamp_min(scale, 1e-30)).max()), "finite": finite,
            "nonzero": nonzero, "ok": ok}
        res["ok"] = res["ok"] and ok
    if time_it:
        cot = cots["photometric"]
        # least time: each input read once (pair list, tile ranges, the
        # Gaussians' 10 attributes, T_final, nc, five cotangent planes) and
        # the (N, 10) gradients written once; operations: the (pixel, pair)
        # evaluations up to each pixel's nc, by how far each gets
        n_pairs, n_tiles, n = int(args[5].shape[0]), int(args[6].shape[0]), int(args[0].shape[0])
        ops, _ = composite_op_counts(args, nc)
        res["walk"] = walk_shape(args, nc)
        bytes_moved = 4 * n_pairs + 8 * n_tiles + 40 * n + 28 * h * w + 40 * n
        t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
        t_ops = ops["bwd_flops"] / H100_F32_FLOPS * 1e3
        res.update(
            ms=cuda_ms(lambda: composite_bwd_cuda(*args, planes[3], nc, cot, **layout), reps=20),
            queued_ms=cuda_ms_queued(
                lambda: composite_bwd_cuda(*args, planes[3], nc, cot, **layout), reps=20),
            plain_ms=cuda_ms(lambda: composite_bwd_plain(*args, planes[3], nc, cot),
                             reps=3, warmup=1),
            **{k: v for k, v in ops.items() if k.startswith("bwd_")}, bytes=bytes_moved,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
    log(f"  B2 {label}: {json.dumps(res)}")
    if not res["ok"]:
        raise SystemExit(f"B2 disagrees with its plain version on {label}")
    res.update(planes=planes, nc=nc, cot=cots["photometric"])
    return res


def oracle_gradients(cam) -> float:
    """Gradients of the whole CUDA rasterizer w.r.t. means3d, scales,
    rotations, opacities, shs and mean2d_offset against the torch oracle's
    autograd, on 96 Gaussians at 200x50, with a loss that touches image,
    depth and alpha. Returns the largest error relative to each gradient's
    max |g|."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference

    small = dense_scene(96, 5, cam.world_view.device)
    target = torch.as_tensor(np.random.default_rng(6).random((cam.height, cam.width, 3)),
                             dtype=torch.float32, device=cam.world_view.device)

    def grads(raster):
        p = {k: getattr(small, k).detach().clone().requires_grad_(True)
             for k in ("xyz", "scaling", "rotation", "opacity", "shs")}
        offset = torch.zeros((96, 2), device=p["xyz"].device, requires_grad=True)
        out = raster(p["xyz"], p["scaling"], p["rotation"], p["opacity"], cam,
                     bg=torch.tensor([0.1, 0.2, 0.3], device=p["xyz"].device), shs=p["shs"],
                     sh_degree=2, alive=small.alive, mean2d_offset=offset)
        loss = (torch.mean(torch.abs(out.image - target)) + 0.1 * torch.mean(out.depth)
                + 0.05 * torch.mean(out.alpha))
        loss.backward()
        return {**{k: v.grad for k, v in p.items()}, "mean2d_offset": offset.grad}

    g_fast, g_ref = grads(rasterize_cuda), grads(rasterize_reference)
    worst = 0.0
    for k, ref in g_ref.items():
        scale = float(ref.abs().max())
        err = float((g_fast[k] - ref).abs().max())
        if not (torch.isfinite(g_fast[k]).all() and scale > 0 and err <= GRAD_TOL * scale):
            raise SystemExit(f"CUDA rasterizer gradient of {k} disagrees with the oracle: "
                             f"err {err}, max|g| {scale}")
        worst = max(worst, err / scale)
    return worst


def train_step_split(state, cam, gt, bg, reps: int = 12) -> dict:
    """Device times (ms, median of `reps`) of the training path's own step
    (`train.loop.make_train_step`, as `apps.train` builds it) at `state`:
    the whole step and each stage, from CUDA events that the step's `mark`
    hook records at its stage boundaries. Also, at the same state, B2 alone
    and the loss's forward + backward alone. The steps it takes keep
    training the state."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.ops import rasterize_cuda as rc
    from gaussian_mesh_splatting_tpu_torch.train import make_train_step, optimization_config
    from gaussian_mesh_splatting_tpu_torch.train.loss import photometric_loss

    stages = ("to_bag", "render", "loss", "backward", "adam", "stats")
    events = {}

    def mark(stage):
        events[stage] = torch.cuda.Event(enable_timing=True)
        events[stage].record()

    step_fn = make_train_step(mesh_model, optimization_config("gs_mesh"), SH_DEGREE, mark=mark)
    times = {f"{k}_ms": [] for k in ("step", *stages)}
    for _ in range(reps + 2):
        step_fn(state, cam, gt, bg)
        events["stats"].synchronize()
        times["step_ms"].append(events["start"].elapsed_time(events["stats"]))
        for prev, k in zip(("start", *stages), stages):
            times[f"{k}_ms"].append(events[prev].elapsed_time(events[k]))
    split = {k: statistics.median(v[2:]) for k, v in times.items()}

    with torch.no_grad():
        bag = mesh_model.to_bag(state.model_state())
        _, _, args, layout = composite_inputs(bag, cam, SH_DEGREE)
        planes, nc = rc.composite_fwd_cuda(*args, **layout)
    cot = photometric_cotangent(planes, gt, bg)
    split["b2_ms"] = cuda_ms(
        lambda: rc.composite_bwd_cuda(*args, planes[3], nc, cot, **layout), reps=reps)
    image = (planes[:3].permute(1, 2, 0) + planes[3][..., None] * bg).requires_grad_(True)
    split["loss_fwd_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(photometric_loss(image, gt, 0.2)[0], image), reps=reps)
    split["backward_rest_ms"] = split["backward_ms"] - split["b2_ms"]
    return split


def build_scene(dev):
    """The main paths' seeded data under WORK: the Blender_Mesh dataset, the
    seed-42 teacher state with its model directory, the GT images rendered
    from it, and the fresh student's Gaussians."""
    import types

    import torch

    from gaussian_mesh_splatting_tpu_torch.io.checkpoint import snapshot_dir
    from gaussian_mesh_splatting_tpu_torch.io.config_io import save_cfg
    from gaussian_mesh_splatting_tpu_torch.io.snapshots import save_snapshot
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    shutil.rmtree(WORK, ignore_errors=True)
    data_dir, model_dir = os.path.join(WORK, "scene"), os.path.join(WORK, "model")
    train_dir = os.path.join(WORK, "train_model")
    os.makedirs(data_dir)
    write_dataset(data_dir)
    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=NUM_SPLATS, shuffle=False, device=dev)
    init_state = scene.init_model_state(mesh_model, SH_DEGREE)
    state = randomize_state(init_state, seed=42)
    iteration = 30000
    save_snapshot("gs_mesh", mesh_model, state, snapshot_dir(model_dir, iteration))
    save_cfg(model_dir, {"source_path": data_dir, "gs_type": "gs_mesh", "sh_degree": SH_DEGREE,
                         "num_splats": NUM_SPLATS, "white_background": True, "eval": True})
    with torch.no_grad():
        bag = mesh_model.to_bag(state)
        student_bag = mesh_model.to_bag(init_state)
    render_gt_images(scene, bag, data_dir)
    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=NUM_SPLATS, shuffle=False, device=dev)
    log(f"    gs_mesh scene: {bag.num_gaussians} Gaussians, "
        f"{state['consts']['faces'].shape[0]} faces, {SIZE}x{SIZE}, SH {SH_DEGREE}; "
        f"GT images rendered from the seed-42 teacher")
    return types.SimpleNamespace(
        scene=scene, state=state, bag=bag, student_bag=student_bag, data_dir=data_dir,
        model_dir=model_dir, train_dir=train_dir, iteration=iteration)


def kernel_cases(ns, dev) -> dict:
    """The inputs the kernels are held against their plain versions on, as
    (args, layout) of `composite_inputs`: the render path's (teacher, train
    view 0), the training path's first step (fresh student, same view), a
    non-aligned 803x611 view, a dense scene that drives pixels to
    termination, and an empty (all culled) one."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.core.camera import focal2fov, fov2focal, make_camera

    with torch.no_grad():
        cam0 = ns.scene.train_cameras[0][0]
        info = ns.scene.scene_info.train_cameras[0]
        cam_na = make_camera(np.asarray(info.R), np.asarray(info.T), FOVX,
                             focal2fov(fov2focal(FOVX, 803), 611), 803, 611, device=dev)
        cam_dense = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 0.8, 0.8, 512, 512,
                                device=dev)
        cam_small = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, 200, 50,
                                device=dev)
        culled = dense_scene(64, 3, dev)
        culled = dataclasses.replace(culled, xyz=culled.xyz - torch.tensor([0.0, 0.0, 100.0],
                                                                           device=dev))
        return {
            "full": composite_inputs(ns.bag, cam0, SH_DEGREE)[2:],
            "train": composite_inputs(ns.student_bag, cam0, SH_DEGREE)[2:],
            "nonaligned": composite_inputs(ns.bag, cam_na, SH_DEGREE)[2:],
            "dense": composite_inputs(dense_scene(4000, 2, dev), cam_dense, 3)[2:],
            "empty": composite_inputs(culled, cam_small, 3)[2:],
        }


def main() -> int:
    import concurrent.futures

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 2
    from gaussian_mesh_splatting_tpu_torch import bench
    from gaussian_mesh_splatting_tpu_torch.apps import render as render_app
    from gaussian_mesh_splatting_tpu_torch.apps import train as train_app
    from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build, rasterize_cuda as rc
    from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians, tile_launch_order
    from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_script = time.perf_counter()

    # ---- 1. build (one nvcc per source, started together) --------------------
    t0 = time.perf_counter()
    kernel_names = ("composite_fwd", "composite_bwd")
    with concurrent.futures.ThreadPoolExecutor(len(kernel_names)) as pool:
        builds = dict(zip(kernel_names, pool.map(cuda_build.build, kernel_names)))
    for name, (path, build_s, build_log) in builds.items():
        log(f"[1] built {os.path.relpath(path, ROOT)} in {build_s:.2f} s")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    ptxas: {line.strip()}")
    log(f"    phase 1: {time.perf_counter() - t0:.2f} s")

    ns = build_scene(dev)
    scene, state, bag, student_bag = ns.scene, ns.state, ns.bag, ns.student_bag
    data_dir, model_dir, train_dir, iteration = ns.data_dir, ns.model_dir, ns.train_dir, ns.iteration

    # ---- 2. kernels against their plain versions on the card ---------------
    log("[2] B1 composite_fwd vs its plain version (tolerance 2e-5 rgb/T, "
        "2e-4*max|depth| depth, 0 nc mismatches)")
    t0 = time.perf_counter()
    cases = kernel_cases(ns, dev)
    args_full, layout_full = cases["full"]
    args_train, layout_train = cases["train"]
    cam0, gt0 = scene.train_cameras[0]
    gt0 = torch.as_tensor(gt0, device=dev)
    with torch.no_grad():
        full = compare_composite("gs_mesh 800x800", *cases["full"], time_it=True)
        fwd_walks = [full["walk"],
                     compare_composite("gs_mesh 803x611", *cases["nonaligned"], False)["walk"]]
        dense = compare_composite("dense overlap 512x512", *cases["dense"], False)
        fwd_walks.append(dense["walk"])
        if dense["frac_T_below_1e-3"] < 0.1:
            raise SystemExit("the dense case does not drive pixels to termination")
        empty = compare_composite("empty (all culled) 200x50", *cases["empty"], False)
        if empty["pairs"] != 0:
            raise SystemExit("the culled scene still binned pairs")
        cam_small = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, 200, 50,
                                device=dev)
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

    log(f"[2] B2 composite_bwd vs its plain version (tolerance {GRAD_TOL}*max|g| per column; "
        "all finite; nonzero where pairs exist)")
    rng = np.random.default_rng(12)

    def random_teacher(h, w):
        return torch.as_tensor(rng.random((h, w, 3)).astype(np.float32), device=dev)

    # the training path's first step: the fresh student against the GT
    full_bwd = compare_composite_bwd("gs_mesh 800x800 (student vs GT)", *cases["train"], gt0,
                                     time_it=True)
    compare_composite_bwd("gs_mesh 803x611", *cases["nonaligned"], random_teacher(611, 803), False)
    compare_composite_bwd("dense overlap 512x512", *cases["dense"], random_teacher(512, 512),
                          False)
    compare_composite_bwd("empty (all culled) 200x50", *cases["empty"], random_teacher(50, 200),
                          False)
    for key in ("tiles_ragged_over_two_batches", "tiles_with_idle_and_busy_warps"):
        if not any(walk[key] for walk in fwd_walks + [full_bwd["walk"]]):
            raise SystemExit(f"no case has {key}: a path of the kernels went unchecked")
    grad_err = oracle_gradients(cam_small)
    log(f"  CUDA rasterizer gradients vs torch oracle autograd (96 Gaussians, 200x50): "
        f"max err / max|g| {grad_err:.3g}")
    log(f"    phase 2: {time.perf_counter() - t0:.1f} s")

    # ---- 3. the render path through the user's entry point -----------------
    log("[3] apps.render.main on the card")
    rc.composite_fwd_cuda.launches = 0
    rc.composite_bwd_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_app.main(["-m", model_dir])
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    render_launches = rc.composite_fwd_cuda.launches
    render_bwd_launches = rc.composite_bwd_cuda.launches
    n_views = N_TRAIN + N_TEST
    log(f"    {n_views} views in {app_s:.2f} s ({1e3 * app_s / n_views:.1f} ms per view, "
        f"scene load and PNG writes included); composite_fwd launches: {render_launches}, "
        f"composite_bwd launches: {render_bwd_launches}")
    if render_launches != n_views or render_bwd_launches != 0:
        raise SystemExit(f"expected {n_views} forward and 0 backward launches")
    from PIL import Image

    def check_pngs(model: str, it: int) -> None:
        for split, n_cams in [("train", N_TRAIN), ("test", N_TEST)]:
            for i in range(n_cams):
                png = os.path.join(model, split, f"ours_{it}", "renders_gs_mesh", f"{i:05d}.png")
                if not os.path.exists(os.path.join(model, split, f"ours_{it}", "gt",
                                                   f"{i:05d}.png")):
                    raise SystemExit(f"missing the GT PNG of {png}")
                with Image.open(png) as im:
                    img = np.asarray(im, dtype=np.float32)
                if img.shape != (SIZE, SIZE, 3) or not np.isfinite(img).all() or img.std() < 1.0:
                    raise SystemExit(f"bad render {png}: shape {img.shape}, std {img.std():.3f}")

    check_pngs(model_dir, iteration)
    with Image.open(os.path.join(model_dir, "train", f"ours_{iteration}", "renders_gs_mesh",
                                 "00000.png")) as im:
        img = np.asarray(im, dtype=np.int32)
    planes = rc.composite_fwd_cuda(*args_full, **layout_full)[0]
    expect = planes[:3].permute(1, 2, 0) + planes[3][..., None]  # white bg
    expect = (torch.clamp(expect, 0, 1) * 255).to(torch.uint8).cpu().numpy()
    diff = np.abs(expect.astype(np.int32) - img).max()
    if diff > 1:
        raise SystemExit(f"app render differs from the kernel's by {diff}/255")
    log("    PNGs: all written, finite, not blank; train view 0 matches the kernel output")

    # ---- 4. the training path through the user's entry point ---------------
    log(f"[4] apps.train.main on the card: {TRAIN_ITERS} steps, evals at {list(TEST_ITERS)}")
    rc.composite_fwd_cuda.launches = 0
    rc.composite_bwd_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train_app.main([
        "--gs_type", "gs_mesh", "-s", data_dir, "-m", train_dir, "--eval",
        "--num_splats", str(NUM_SPLATS), "--sh_degree", str(SH_DEGREE), "--white_background",
        "--iterations", str(TRAIN_ITERS), "--test_iterations", *map(str, TEST_ITERS),
        "--save_iterations", str(TRAIN_ITERS),
    ])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd_launches = rc.composite_fwd_cuda.launches
    bwd_launches = rc.composite_bwd_cuda.launches
    losses = result.losses
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    psnrs = [result.test_psnr[i] for i in TEST_ITERS]
    n_eval_renders = len(TEST_ITERS) * N_TEST
    log(f"    {TRAIN_ITERS} steps in {train_s:.2f} s ({1e3 * train_s / TRAIN_ITERS:.1f} ms per "
        f"step, scene load, evals and snapshot included); mean loss first 20 {first:.5f}, "
        f"last 20 {last:.5f}; test PSNR {json.dumps(dict(zip(TEST_ITERS, psnrs)))}; "
        f"composite_fwd launches {fwd_launches}, composite_bwd launches {bwd_launches}")
    if not np.isfinite(losses).all() or not last < 0.8 * first:
        raise SystemExit("the training loss did not fall by 20 %")
    if not psnrs[-1] > psnrs[0]:
        raise SystemExit("the test PSNR did not rise")
    if bwd_launches != TRAIN_ITERS or fwd_launches != TRAIN_ITERS + n_eval_renders:
        raise SystemExit(f"expected {TRAIN_ITERS} backward and {TRAIN_ITERS + n_eval_renders} "
                         "forward launches")
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in result.state.params.values())
    if not grads_finite:
        raise SystemExit("a gradient of the last train step is not finite")
    rc.composite_fwd_cuda.launches = 0
    render_app.main(["-m", train_dir])
    if rc.composite_fwd_cuda.launches != n_views:
        raise SystemExit("the trained snapshot did not render through the kernel")
    check_pngs(train_dir, TRAIN_ITERS)
    log("    the trained snapshot renders through apps.render; all gradients finite")

    # ---- 5. timings ---------------------------------------------------------
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
            "tile_order_ms": cuda_ms(lambda: tile_launch_order(args_full[6], args_full[7]),
                                     reps=10),
            "pack_attributes_ms": cuda_ms(lambda: rc.pack_attributes(*args_full[:5]), reps=10),
            "composite_ms": cuda_ms(lambda: rc.composite_fwd_cuda(*args_full, **layout_full),
                                    reps=10),
            "render_ms": cuda_ms(lambda: rc.rasterize_cuda(
                bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam0,
                bg=torch.ones(3, device=dev), shs=bag.shs, sh_degree=SH_DEGREE,
                alive=bag.alive), reps=10),
        }
    log(f"[5] render per view, 800x800: {json.dumps(split)}")
    # the critical path: each kernel on its longest tile alone, beside the
    # whole launch and a launch in which every tile is empty
    no_tile = torch.zeros_like(args_full[6])
    critical = {}
    for name, args, layout, steps, launch in (
            ("composite_fwd", args_full, layout_full, full["walk"]["fwd_steps"],
             lambda a, lay: rc.composite_fwd_cuda(*a, **lay)),
            ("composite_bwd", args_train, layout_train, full_bwd["walk"]["bwd_steps"],
             lambda a, lay: rc.composite_bwd_cuda(*a, full_bwd["planes"][3], full_bwd["nc"],
                                                  full_bwd["cot"], **lay))):
        alone, order = one_tile(args, steps["argmax"])
        empty_args = (*args[:6], no_tile, no_tile, *args[8:])
        critical[name] = {
            "walk_steps": {k: steps[k] for k in ("sum", "max", "p50", "p90", "p99", "nonzero")},
            "longest_tile": steps["argmax"],
            "longest_tile_alone_ms": cuda_ms(
                lambda: launch(alone, {**layout, "tile_order": order}), reps=20),
            "all_tiles_empty_ms": cuda_ms(lambda: launch(empty_args, layout), reps=20),
            "full_ms": cuda_ms(lambda: launch(args, layout), reps=20),
            "queued_longest_tile_alone_ms": cuda_ms_queued(
                lambda: launch(alone, {**layout, "tile_order": order}), reps=20),
            "queued_all_tiles_empty_ms": cuda_ms_queued(
                lambda: launch(empty_args, layout), reps=20),
            "queued_full_ms": cuda_ms_queued(lambda: launch(args, layout), reps=20),
        }
    log(f"    critical path, 800x800 (steps per tile; ms): {json.dumps(critical)}")
    step_split = train_step_split(result.state, cam0, gt0, torch.ones(3, device=dev))
    log(f"    train step at step {TRAIN_ITERS}, 800x800: {json.dumps(step_split)}")
    bench_res = bench.run(n=100_000, size=SIZE, iters=10, device=dev)
    log(f"    bench (100k Gaussians, 800x800, SH 3, fwd+bwd+update): {json.dumps(bench_res)}")
    log(f"    script so far: {time.perf_counter() - t_script:.1f} s")

    # ---- 6. output lines ----------------------------------------------------
    kernels = {"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "gaussian_mesh_splatting_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py:238",
        "launches": fwd_launches,
        "launches_render": render_launches,
        "launches_train": fwd_launches,
        "max_abs_err": full["max_abs_err_rgbT"],
        "ms": full["ms"],
        "queued_ms": full["queued_ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "gaussian_mesh_splatting_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py:405",
        "launches": bwd_launches,
        "launches_render": render_bwd_launches,
        "launches_train": bwd_launches,
        "max_abs_err": full_bwd["photometric"]["max_abs_err"],
        "ms": full_bwd["ms"],
        "queued_ms": full_bwd["queued_ms"],
        "plain_ms": full_bwd["plain_ms"],
        "bound_ms": full_bwd["bound_ms"],
        "bound_by": full_bwd["bound_by"],
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
