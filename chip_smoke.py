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
     800x800, SH degree 3; the first step of the `gs` path: 100,000 isotropic
     Gaussians of opacity 0.1 alive in a 400,000-row buffer; the first step
     of the `gs_flame` path: 980,000 Gaussians on a 9,800-face head, B1
     bit-equal there too), on a
     non-aligned 803x611 view, on a dense scene that drives pixels to
     termination and on an empty (all culled) one:
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
  4. drive the training paths through the user's entry point:
     `apps.train.main([...])` trains a fresh `gs_mesh` model on that dataset
     for TRAIN_ITERS steps; the loss must fall, the test PSNR rise, B2
     launch once per step and B1 once per step and eval view; the snapshot
     renders through `apps.render`. Then `gs_multi_mesh` on a COLMAP dataset
     written with the port's `colmap_loader` writers (9 PINHOLE 800x800 views
     on the same ring, llffhold giving 7 train and 2 test views; two copies of
     the mesh, scaled and moved apart, in `sparse/0`, both in every view,
     102,400 Gaussians; a points3D.bin; RGB GT from a seeded gs_multi_mesh
     teacher on black) for MM_ITERS steps with a checkpoint, checked as above
     and for every mesh's alpha moving, a short resume from the checkpoint
     and `apps.render` of the snapshot; then `gs_flame` from a FLAME-format
     pickle (FLAME's joints, parents and bases on a closed, head-sized UV
     sphere of 9,800 faces) on a Blender dataset of the scene's cameras
     with GT from a seeded teacher with an expression and the jaw open, at
     the reader's 100 splats per face (980,000 Gaussians), FLAME_ITERS steps,
     checked as above and for a finite, nonzero gradient of every FLAME
     param at the last step; and `apps.render_flame --animated --dump_obj`
     (FLAME_FRAMES PNGs and OBJs, one B1 launch a frame);
  5. drive the `gs` training path (vanilla 3DGS from a point cloud, with
     density control) through the user's entry points: the same cameras and
     GT images in a dataset of its own with no `points3d.ply`, so that the
     Blender reader makes its 100,000 seeded points; `apps.train.main([...
     "--gs_type", "gs", ...])` at the default `--capacity_mult 4` (400,000
     rows), the schedule brought forward through the CLI's own flags so that
     GS_ITERS steps hold several densify events (some with the size threshold
     on) and opacity resets; clones, split rows and prunes must all occur, the
     alive count change and stay within the capacity, every param stay
     finite, the loss fall, the test PSNR rise, B2 launch once per step and B1
     once per step and eval view; a checkpoint is written on the way, a
     second short run resumes from it at that step with the same alive count,
     and `apps.render` renders the `gs` snapshot; then a short `gs_flat`
     run on the same dataset (FLAT_ITERS steps, one opacity reset, one
     event), whose snapshot `apps.render` renders as `gs_flat` and, through
     its triangle soup, as `gs_points`: the two must agree; and a short `gs`
     run from the COLMAP dataset's points (the plain Colmap reader);
  6. time the render path per view, the training paths' own step per stage
     (CUDA events at the stage boundaries it marks; the `gs` path's at its
     last state and at a fresh first state, 100,000 alive; the
     `gs_multi_mesh` and `gs_flame` paths' at their last states), one densify
     event, the KNN scale init at 100,000 points, and the package's
     fwd+bwd bench (which refuses zero gradients); print how the pairs and
     the walked steps spread over the tiles, and each kernel's time on its
     longest tile alone (the critical path: a tile's walk is serial), launch
     by launch and with the launches queued back to back (`cuda_ms_queued`:
     the device time without the host's share of a single launch);
  7. drive evaluation and editing through the user's entry points: LPIPS
     (VGG16 weights drawn from a seed, written as the documented .npz and
     named by $GMS_LPIPS_WEIGHTS) on two 800x800 GT views on the card
     against the CPU (1e-4 relative; identical images score 0);
     `apps.render --skip_train` and `apps.metrics` of the trained `gs_mesh`
     model (finite SSIM, PSNR, LPIPS; PSNR within 0.5 dB of the train app's
     last test PSNR); `apps.full_eval --gs_type gs_mesh` over eight symlinks
     to the dataset; `apps.train --detect_anomaly` beside a plain run of the
     same steps (step times); `apps.train --profile_steps` (the trace names
     both kernels once a traced step; the device's busy share of the
     window); `apps.train --port` with a viewer thread that asks for one
     800x800 frame; `apps.render_animated` and `apps.render_mesh_morph`
     (frame 0 equals apps.render's view within 1/255); the pseudomesh
     pipeline save -> dummy -> retarget -> render, and animate, on the
     `gs_flat` snapshot; every path's launches counted from 0 and checked;
  8. drive the parallel modes (`parallel/`), their ranks spawned as processes
     that share the one card over gloo (NCCL refuses two ranks on one GPU),
     on the gs_mesh scene at full width: (a) the teacher's view rendered
     row-sharded at world 2, bit-equal to the unsharded render; (b) the same
     Gaussian-sharded, within PAR_SATURATION_TOL (the saturated pixels
     counted); (c)-(e) the first step of the rows, gaussians, camera-DP
     (world 2) and composed 2x2 (world 4) steps against the unsharded step
     (`make_train_step`) on the card: gradients within PAR_GRAD_TOL * max|g|
     per key (DP and composed: the mean of two cameras' steps), statistics
     within PAR_STATS_TOL, loss 1e-4 relative; (f) PAR_STEPS steps of each
     (the 1-D modes through `apps.train --data_parallel / --shard rows /
     --shard gaussians` at world 2): the loss falls, the params are
     bit-identical on every rank, B1 and B2 launch once a step a rank; (g)
     step times (CUDA events, per rank), the gathers' and the gradient
     all-reduce's times, `measure_scaling` at widths 1 and 2; B1 alone on
     each row band beside the whole image; (h) one rank on NCCL: (a), (b)
     and 20 steps of rows, gaussians and DP, their collectives on NCCL in a
     group of one, held against the unsharded render and step per param key
     (each mode's key with the largest first-step error logged); then a
     world-1 `torchrun` launch of `apps.train --shard gaussians` (a group of
     one trains as one device); (i) the `fastio` extension's
     points3D.bin and PLY reads equal the numpy readers' byte for byte, and
     their times;
  9. hold the gradient at scale (`tools_torch_verify_grads.py`): (a) the
     oracle folded in checkpointed groups (`scan_chunk`) against its flat
     fold on the card, 96 Gaussians at 200x50: forward bit-equal, gradients
     within CHUNK_TOL * max|g|; (b) the CUDA path's loss and gradients
     against the chunked oracle's at ORACLE_CASE (every key within
     GRAD_TOL * max|g|, the losses within 1e-6 relative); (c) two-sided
     finite differences of the loss along gradient-aligned directions at
     100,000 Gaussians, 800x800, eps 2e-3 (each within 0.1 relative); B1
     and B2 launches counted from 0 over (b) and (c);
 10. `radius_mode="cuda"` on the CUDA path (`radius_mode_cuda`): (a) B1 and
     B2 on the "cuda" pair sets of the gs_mesh teacher's view and the
     gs_flame first step against their plain versions (phase 2's bounds)
     and against "tight" mode: the pairs only "cuda" mode bins composite
     nothing, the image, T and depth agree within MODE_TOL but at the pixels
     that only "tight" mode's pairs reach (`reached_pixels`), B2 on the
     loss's cotangent zeroed there within GRAD_TOL * max|g|, the radii are
     equal; each mode's pairs and kernel times; (b) a band of tile rows
     bit-equal to the same rows of the whole "cuda"-mode render, and the
     overflow count under `pair_capacity`; (c) the 128x128 toy scene
     (`tools_torch_verify_scene.py`) built on the card and TOY_SMOKE_ITERS
     steps of `tools_torch_full_run.py --toy_dip`'s leg through apps.train:
     the loss falls, the test PSNR rises from step 1; launches of (b) and (c)
     counted from 0 and checked;
 11. the JAX rasterizer's bf16 pair-table modes (`attr_precision`,
     `grad_precision`; `bf16_modes`): (a) at the gs_mesh teacher's view (B2:
     the student's first step there) and the gs first step, B1 on the bf16
     table bit-equal to its plain version on the rounded attributes and to
     B1 on their float32 table, B2 in each mode pair within BF16_KERNEL_TOL *
     max|g| per column of its plain version and BF16_MODE_TOL of the exact
     B2, the per-Gaussian totals through the autograd Function bf16 values
     under attr "bf16", a band of tile rows bit-equal to the whole bf16
     render's rows; (b) the gs_flame first step, kernels only (B1 bit-equal
     to B1 on the rounded float32 table, B2 on the bf16 table within
     BF16_KERNEL_TOL of B2 on it, (f32, bf16) within BF16_MODE_TOL of the
     exact B2; the attr "bf16" modes' distance from it measured, with its
     sources, not bounded: the mode's rounding moves it past the bound
     there); (c) both kernels' times on both tables in turns at the three
     inputs, each bf16 bound from its walk's operations and 32-byte rows;
     (d) `render(..., attr_precision="bf16")` of the teacher, and
     BF16_ITERS gs_mesh steps through `make_train_step(render_kwargs=...)`
     in the full-bf16 and the exact mode from one state (the losses fall,
     the final test PSNRs within BF16_PSNR_GAP dB) and BF16_GRAD_ITERS in
     (f32, bf16), every entry point's launches counted from 0 and checked;
 12. the projection kernels (`projection_kernels`, csrc/preprocess.cu) on
     phase 2's gs_mesh, gs and gs_flame inputs and the gs_mesh input at SH
     degrees 0, 1, 2 and 4, in both radius modes with antialiasing off and
     on: the forward bit-equal to `preprocess` in all nine outputs; the VJP
     kernel per leaf, on the training loss's cotangents and on seeded ones,
     within PROJECT_PLAIN_TOL x max|g| of its plain version
     `preprocess_bwd_plain` on every row, its distances from autograd of
     `preprocess` in float32 and float64 reported; each kernel's time alone
     (median of 10, and queued) beside its bound from the bytes and the
     chain's time;
     their launches on apps.render and on PROJECT_STEPS steps of each
     training path, with the tracer's `project_kernel` count a step;
 13. the loss kernels (`loss_kernels`, csrc/loss.cu) at 800x800 on a
     seeded image pair, the same with white rows and tied entries, and the
     gs_mesh student's first render against its GT, and at the ragged sizes
     LOSS_RAGGED: L1's SSIM map bit-equal to `ssim_map`'s, `total` and `l1`
     within LOSS_REL_TOL of the chain's; L2 on three sets of cotangents
     within LOSS_PLAIN_TOL x max|g| of `photometric_vjp_plain`, its distances
     from autograd of the chain in float32 and float64 reported; both
     kernels repeat their bits; at 800x800 each kernel's time alone (median
     of 20, and queued) beside its bound from the bytes and the chain's
     times; their launches on LOSS_STEPS steps of the gs_mesh and gs_flame
     training paths, with the tracer's `loss_kernel` count a step;
 14. print the kernels line (with each kernel's launches on the render path,
     on each training path, `apps.render_flame`, each path of phase 7 (per
     rank: phase 8) and phases 9 to 11; the projection kernels' from phase 12
     and the loss kernels' from phase 13, their times and bounds; B1's and
     B2's times and bounds at the `gs_mesh`, the `gs` and the `gs_flame`
     inputs, each bound from the operations that this run's data needs,
     each radius mode's pairs and times, and the bf16 table's times, bounds
     and errors), the card's name and power limit, and last the device
     line.
Data is generated from fixed seeds under build/chip_smoke/ (git-ignored).
"""
from __future__ import annotations

import dataclasses
import functools
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
# B1 and B2 on the float32 table: the kernel entries (ops/cuda_build.ENTRIES)
# whose launches (`cuda_build.launches`) each path's checks count
COMPOSITES = ("composite_fwd", "composite_bwd")
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
TRAIN_ITERS = 100  # the gs_mesh path (an earlier slice's: cut from 300)
TEST_ITERS = (1, 100)
# the gs path: 100,000 points (the Blender reader's), capacity 4x; events at
# 200, 300, ..., 600 (the size threshold on after 350), opacity resets at 100
# (white background) and 350, a checkpoint at 400
GS_POINTS = 100_000
GS_CAPACITY = 4 * GS_POINTS
GS_ITERS = 600
GS_TEST_ITERS = (1, 300, 600)
GS_SCHEDULE = {"--densify_from_iter": 100, "--densification_interval": 100,
               "--opacity_reset_interval": 350}
GS_CHECKPOINT, GS_RESUME_ITERS = 400, 420
# gs_flat on the same dataset and schedule, cut to one reset and one event
FLAT_ITERS = 220
FLAT_TEST_ITERS = (1, 220)
SOUP_TOL = 2  # gs_points against gs_flat PNGs, in 1/255 (the round trip is float32)
# the COLMAP dataset: 9 cameras on the Blender scene's ring (llffhold 8: 7 train
# and 2 test views), two meshes of 5120 faces in sparse/0 (2 x 51,200
# Gaussians for gs_multi_mesh), a points3D.bin of COLMAP_POINTS points
N_COLMAP = 9
N_COLMAP_TEST = 2
COLMAP_POINTS = 20_000
MM_ITERS = 100
MM_TEST_ITERS = (1, 100)
MM_CHECKPOINT, MM_RESUME_ITERS = 60, 70
COLMAP_GS_ITERS = 50
COLMAP_GS_TEST_ITERS = (1, 50)
# gs_flame: a FLAME-format pickle of a head-sized closed mesh (a UV sphere of
# 49 rings of 100 vertices and two poles: 4,902 vertices, 9,800 faces, about
# FLAME's 5,023 and 9,976), trained at the reader's 100 splats per face
FLAME_RINGS, FLAME_SEGMENTS, FLAME_RADIUS = 49, 100, 0.08
FLAME_SPLATS = 100
FLAME_ITERS = 100
FLAME_TEST_ITERS = (1, 100)
FLAME_FRAMES = 3
FLAME_PARAMS = ("flame_shape", "flame_exp", "flame_pose", "flame_neck_pose", "flame_trans",
                "vertices_enlargement")
# phase 7: evaluation and editing on the gs_mesh and gs_flat models
LPIPS_SEED = 45
FULL_EVAL_ITERS = 30  # per scene of the eight-scene suite
ANOMALY_ITERS = 20
PROFILE_STEPS = (10, 15)
GUI_ITERS = 10
ANIMATED_FRAMES, MORPH_FRAMES, SOUP_FRAMES = 10, 5, 5
DUMMY_ALPHA = 0.25  # the pseudomesh dummy's circumradius bound, scene units
# phase 8: the parallel modes, their ranks spawned as processes that share
# the one card (cuda:0) over gloo (NCCL refuses two ranks on one GPU)
PAR_WORLD = 2
PAR_STEPS = 20  # steps of each mode: apps.train at world 2, the composed step at world 4
PAR_TIMED = 10  # steps of each mode timed with CUDA events after the compared first step
PAR_GRAD_TOL = 5e-4  # x max|g| per param key, against the unsharded step's
PAR_STATS_TOL = 1e-5  # grad_accum, absolute; denom and max_radii exact
PAR_SATURATION_TOL = 2e-3  # Gaussian-sharded render vs unsharded, per pixel
SATURATED_T = 1.5e-4  # a pixel whose final T is at most this has saturated
TORCHRUN_ITERS = 5
# phase 9: gradient conformance at scale (tools_torch_verify_grads.py)
CHUNK = 17  # the chunked oracle's group on the card, against its flat fold
CHUNK_TOL = 1e-6  # its gradients against the flat fold's, x max|g| per key
ORACLE_CASE = (4_000, 256, 256)  # Gaussians, width, height: CUDA path vs the chunked oracle
# phase 10: radius_mode="cuda" on the CUDA path, and the toy scene's run
MODE_TOL = (1e-6, 1e-5)  # "cuda" against "tight" mode: r, g, b, T; depth (absolute)
REACH_CHUNK = 1 << 16  # pairs a pass of `reached_pixels`
BAND = (20, 30)  # the tile rows of the "cuda"-mode band, of 50
TOY_SMOKE_ITERS = 500
TOY_SMOKE_TEST_ITERS = (1, 500)
# phase 11: the JAX rasterizer's bf16 pair-table modes, (attr_precision,
# grad_precision); the two with attr "bf16" are one computation (a bf16
# table's pairs are rounded whatever grad_precision says)
BF16_MODES = (("bf16", "bf16"), ("f32", "bf16"), ("bf16", "f32"))
BF16_KERNEL_TOL = 8e-3  # B2 on the bf16 table vs its plain version, x max|g| a column
# B2 on the float32 table, pairs rounded, vs its plain version, x max|g| a
# column: below what the pairs' rounding itself moves (2.5e-3 to 3.0e-3 of
# the exact B2 on the H100; the kernel measured 1.5e-4 to 3.3e-4 off)
BF16_PAIR_KERNEL_TOL = 1e-3
# Gaussians that a rounded mode's B2 puts more than GRAD_TOL x max|g| off its
# plain version, at most: the atomics' order moves a few (0-2 on the H100);
# a flush that skips the rounding moves thousands (2,269-9,677)
BF16_KERNEL_OVER = 100
BF16_MODE_TOL = 8e-2  # a bf16 mode's B2 against the exact B2, x max|g| (the JAX bound)
# gs_flame's first step, the attr "bf16" modes' distance from the exact B2
# (x max|g|) and its Gaussians past BF16_MODE_TOL, of 980,000: read 0.523 and
# 1,066 on the H100 (PERF.md, the bf16 modes), held with margin
FLAME_BF16_GAP = 0.8
FLAME_BF16_OVER = 1600
BF16_RENDER_PSNR = 40.0  # dB: the bf16 render of the teacher against the exact one, at least
BF16_PSNR_GAP = 0.2  # dB: the bf16 A/B's final test PSNR against the exact run's
BF16_ITERS = 100  # gs_mesh steps of each A/B run
BF16_GRAD_ITERS = 30  # gs_mesh steps in the (f32, bf16) mode


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
            c, rot = ring_camera(i, n_cams, off)
            c2w = np.eye(4)
            c2w[:3, :3] = rot
            c2w[:3, 3] = c
            Image.fromarray(np.zeros((SIZE, SIZE, 4), np.uint8), "RGBA").save(
                os.path.join(root, split, f"r_{i}.png"))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": FOVX, "frames": frames}, f)


def ring_camera(i: int, n_cams: int, off: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Camera `i` of the scene's ring: its centre and its camera-to-world
    rotation in Blender's axes (x right, y up, z backward)."""
    angle = 2 * np.pi * (i + off) / n_cams
    elev = 0.9 * np.sin(2.1 * i + off)
    c = np.array([3.2 * np.sin(angle) * np.cos(elev), 3.2 * np.sin(elev) + 0.2,
                  3.2 * np.cos(angle) * np.cos(elev)])
    fwd = -c / np.linalg.norm(c)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    return c, np.stack([right, np.cross(fwd, right), -fwd], axis=1)


def colmap_meshes() -> list[tuple[np.ndarray, np.ndarray]]:
    """The COLMAP scene's two meshes: the lumpy icosphere, scaled and moved
    to either side of the origin."""
    verts, faces = icosphere_mesh()
    return [(verts * 0.55 + np.array([-0.45, -0.15, 0.0], np.float32), faces),
            (verts * 0.4 + np.array([0.55, 0.35, 0.1], np.float32), faces)]


def write_colmap_dataset(root: str, size: int = SIZE) -> None:
    """COLMAP dataset with the port's own writers: one PINHOLE camera model,
    N_COLMAP images on the scene's ring (black placeholder RGB PNGs), the two
    meshes in sparse/0 and a points3D.bin of COLMAP_POINTS points drawn on
    their faces. Fails unless every mesh is in every view."""
    from PIL import Image

    from gaussian_mesh_splatting_tpu_torch.core.camera import fov2focal
    from gaussian_mesh_splatting_tpu_torch.io.obj import save_obj
    from gaussian_mesh_splatting_tpu_torch.scene import colmap_loader as colmap

    sparse, images = os.path.join(root, "sparse", "0"), os.path.join(root, "images")
    os.makedirs(sparse)
    os.makedirs(images)
    f = fov2focal(FOVX, size)
    colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), {
        1: colmap.ColmapCamera(1, "PINHOLE", size, size, np.array([f, f, size / 2, size / 2]))})
    meshes = colmap_meshes()
    ims = {}
    for i in range(N_COLMAP):
        c, c2w = ring_camera(i, N_COLMAP)
        r_w2c = (c2w * np.array([1.0, -1.0, -1.0])).T  # Blender -> COLMAP axes
        t = -r_w2c @ c
        for k, (verts, _) in enumerate(meshes):
            cam = verts @ r_w2c.T + t
            uv = f * cam[:, :2] / cam[:, 2:] + size / 2
            inside = (cam[:, 2] > 0) & (uv >= 0).all(1) & (uv < size).all(1)
            if inside.mean() < 0.99:
                raise SystemExit(f"mesh {k} is not in COLMAP view {i}")
        ims[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat2qvec(r_w2c), t, 1, f"c_{i:02d}.png")
        Image.fromarray(np.zeros((size, size, 3), np.uint8), "RGB").save(
            os.path.join(images, f"c_{i:02d}.png"))
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), ims)
    rng = np.random.default_rng(7)
    xyz = []
    for name, (verts, faces) in zip(("mesh_a", "mesh_b"), meshes):
        save_obj(os.path.join(sparse, f"{name}.obj"), verts, faces)
        w = rng.dirichlet(np.ones(3), COLMAP_POINTS // 2)
        tri = verts[faces[rng.integers(0, len(faces), COLMAP_POINTS // 2)]]
        xyz.append(np.einsum("na,nad->nd", w, tri))
    colmap.write_points3D_binary(os.path.join(sparse, "points3D.bin"), np.concatenate(xyz),
                                 rng.integers(0, 256, (COLMAP_POINTS, 3)).astype(np.uint8))


def smooth_fields(rng, verts: np.ndarray, n: int, amp: float) -> np.ndarray:
    """n smooth displacement fields over the vertices, (V, 3, n): each a
    sine of the position along a random direction, along another."""
    scale = np.abs(verts).max()
    freq = rng.normal(0.0, 2.0, (n, 3)) / scale
    phase = rng.uniform(0, 2 * np.pi, n)
    along = rng.normal(size=(n, 3))
    along /= np.linalg.norm(along, axis=1, keepdims=True)
    return amp * np.sin(verts @ freq.T + phase)[:, None, :] * along.T[None]


def write_flame_pickle(path: str, seed: int = 0) -> None:
    """A FLAME model pickle in the real file's format (the keys and layout
    that `load_flame_pickle` reads, float64 arrays, faces as uint32, the
    root's parent as 2**32 - 1) with FLAME's structure: 5 joints (global,
    neck, jaw, eyes) with parents (-1, 0, 1, 1, 1), 300 shape and 100
    expression directions, 36 pose-corrective directions. The template is a
    closed, head-sized ellipsoidal UV sphere (FLAME_RINGS x FLAME_SEGMENTS
    + 2 vertices) in FLAME's axes (y up, z forward); the bases are smooth
    fields; the joints and skinning weights follow the head's regions."""
    import pickle

    rng = np.random.default_rng(seed)
    theta = np.pi * np.arange(1, FLAME_RINGS + 1) / (FLAME_RINGS + 1)
    phi = 2 * np.pi * np.arange(FLAME_SEGMENTS) / FLAME_SEGMENTS
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi), np.cos(theta)[:, None]
                     * np.ones_like(phi), np.sin(theta)[:, None] * np.sin(phi)], axis=-1)
    unit = np.concatenate([[[0.0, 1.0, 0.0]], ring.reshape(-1, 3), [[0.0, -1.0, 0.0]]])
    verts = unit * FLAME_RADIUS * np.array([0.85, 1.1, 0.95])
    n, last = FLAME_SEGMENTS, len(verts) - 1
    j = np.arange(n)
    faces = [np.stack([np.zeros(n, int), 1 + (j + 1) % n, 1 + j], 1)]
    for i in range(FLAME_RINGS - 1):
        a, b = 1 + i * n + j, 1 + i * n + (j + 1) % n
        faces += [np.stack([a, b, a + n], 1), np.stack([b, b + n, a + n], 1)]
    base = 1 + (FLAME_RINGS - 1) * n
    faces.append(np.stack([np.full(n, last), base + j, base + (j + 1) % n], 1))
    faces = np.concatenate(faces)
    r = FLAME_RADIUS
    centres = np.array([[0, 0, 0], [0, -0.8 * r, -0.1 * r], [0, -0.45 * r, 0.55 * r],
                        [-0.35 * r, 0.25 * r, 0.85 * r], [0.35 * r, 0.25 * r, 0.85 * r]])
    near = np.exp(-((verts[:, None] - centres[None]) ** 2).sum(-1)
                  / (2 * (np.array([10.0, 0.4, 0.35, 0.15, 0.15]) * r) ** 2))
    j_regressor = near / near.sum(0)  # each joint: a weighted mean of its region
    weights = near * np.array([1.0, 0.5, 2.0, 1.5, 1.5])
    weights /= weights.sum(1, keepdims=True)
    data = {
        "kintree_table": np.array([[2**32 - 1, 0, 1, 1, 1], [0, 1, 2, 3, 4]], np.uint32),
        "v_template": verts,
        "shapedirs": np.concatenate([smooth_fields(rng, verts, 300, 2e-3),
                                     smooth_fields(rng, verts, 100, 3e-3)], axis=2),
        "posedirs": smooth_fields(rng, verts, 36, 1e-3),  # the file's (V, 3, P)
        "J_regressor": j_regressor.T,
        "weights": weights,
        "f": faces.astype(np.uint32),
    }
    with open(path, "wb") as fh:
        pickle.dump(data, fh)


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


def bytes_and_bound(n_flops: float, n_bytes: int) -> dict:
    """The least time the card could take (ms): the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOPS * 1e3
    return {"bytes": n_bytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timed_once(fn):
    """(fn(), its time in ms between two CUDA events): one call, no warm-up."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def composite_inputs(bag, cam, sh_degree, row_band=None, radius_mode="tight"):
    """(projection, binning, the composite's arguments as the plain versions
    take them, the kernels' own layout inputs as the render path makes them);
    `row_band` bins only those tile rows, as a row-sharded rank does;
    `radius_mode` picks the binning rectangles, as `rasterize_cuda`'s does."""
    from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
    from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE, pack_attributes

    proj = preprocess(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam,
                      shs=bag.shs, sh_degree=sh_degree, alive=bag.alive, radius_mode=radius_mode)
    n_ty, n_tx = -(-cam.height // TILE), -(-cam.width // TILE)
    binning = bin_gaussians(proj, tile_h=TILE, tile_w=TILE, n_tiles_y=n_ty, n_tiles_x=n_tx,
                            row_band=row_band)
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


def compare_composite(label: str, args, layout, time_it: bool, plain_reps=(10, 1)) -> dict:
    """Kernel vs plain version on the same inputs, on the card. `plain_reps`:
    the (reps, warm-up calls) of the plain version's timing; with (1, 0) the
    plain call of the comparison is the one timed."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_fwd_cuda, composite_fwd_plain)

    planes_k, nc_k = composite_fwd_cuda(*args, **layout)
    (planes_p, nc_p), plain_once_ms = timed_once(lambda: composite_fwd_plain(*args))
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
        res.update(
            ms=cuda_ms(lambda: composite_fwd_cuda(*args, **layout), reps=20),
            queued_ms=cuda_ms_queued(lambda: composite_fwd_cuda(*args, **layout), reps=20),
            plain_ms=plain_once_ms if plain_reps == (1, 0) else cuda_ms(
                lambda: composite_fwd_plain(*args), reps=plain_reps[0], warmup=plain_reps[1]),
            **{k: v for k, v in ops.items() if k.startswith("fwd_")},
            **bytes_and_bound(ops["fwd_flops"], 4 * n_pairs + 8 * n_tiles
                              + 40 * int(mean2d.shape[0]) + 24 * h * w),
        )
    else:
        res["walk"] = walk_shape(args, nc_p)
    log(f"  B1 {label}: {json.dumps(res)}")
    if not ok:
        raise SystemExit(f"B1 disagrees with its plain version on {label}")
    if time_it:
        res["op_counts"] = ops
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


def render_gt_images(scene, bag, white: bool = True) -> None:
    """Overwrite the dataset's placeholder PNGs with the port's renders of
    the teacher `bag`, as tools_verify_scale.py does: opaque RGBA on white
    for a Blender dataset, RGB (a COLMAP GT is not composited) on black."""
    import torch
    from PIL import Image

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda

    info = scene.scene_info
    with torch.no_grad():
        for ci, (cam, _) in zip(info.train_cameras + info.test_cameras,
                                scene.train_cameras + scene.test_cameras):
            out = rasterize_cuda(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam,
                                 bg=torch.full((3,), float(white), device=bag.xyz.device),
                                 shs=bag.shs, sh_degree=SH_DEGREE, alive=bag.alive)
            img = torch.clamp(out.image, 0, 1).cpu().numpy()
            if white:
                img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
            Image.fromarray((img * 255).astype(np.uint8), "RGBA" if white else "RGB").save(
                ci.image_path)


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


def compare_composite_bwd(label: str, args, layout, teacher, time_it: bool,
                          plain_reps=(3, 1), ops: dict | None = None,
                          cotangents=("seeded", "photometric")) -> dict:
    """B2 vs its plain version on the same inputs and cotangents, on the
    card: a seeded normal cotangent of all five planes, and the photometric
    loss's cotangent against `teacher` (white background). `plain_reps`: the
    (reps, warm-up calls) of the plain version's timing (with (1, 0) the
    photometric comparison's plain call is the one timed); `ops`: the
    operation counts of `compare_composite` on the same inputs, where it has
    made them (the replay is long on a large case); `cotangents`: which of
    the two to compare (each costs a plain call)."""
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
    cots = {k: v for k, v in cots.items() if k in cotangents}
    empty = args[5].shape[0] == 0
    res = {"case": label, "pairs": int(args[5].shape[0]), "ok": True}
    for name, cot in cots.items():
        g_k = composite_bwd_cuda(*args, planes[3], nc, cot, **layout)
        g_p, plain_once_ms = timed_once(lambda: composite_bwd_plain(*args, planes[3], nc, cot))
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
        if ops is None:
            ops, _ = composite_op_counts(args, nc)
        res["walk"] = walk_shape(args, nc)
        res.update(
            ms=cuda_ms(lambda: composite_bwd_cuda(*args, planes[3], nc, cot, **layout), reps=20),
            queued_ms=cuda_ms_queued(
                lambda: composite_bwd_cuda(*args, planes[3], nc, cot, **layout), reps=20),
            plain_ms=plain_once_ms if plain_reps == (1, 0) else cuda_ms(
                lambda: composite_bwd_plain(*args, planes[3], nc, cot),
                reps=plain_reps[0], warmup=plain_reps[1]),
            **{k: v for k, v in ops.items() if k.startswith("bwd_")},
            **bytes_and_bound(ops["bwd_flops"], 4 * n_pairs + 8 * n_tiles + 40 * n
                              + 28 * h * w + 40 * n),
        )
    log(f"  B2 {label}: {json.dumps(res)}")
    if not res["ok"]:
        raise SystemExit(f"B2 disagrees with its plain version on {label}")
    res.update(planes=planes, nc=nc, cot=cots["photometric"])
    if time_it:
        res["op_counts"] = ops
    return res


def small_scene_grads(raster, cam, **kw):
    """(output, gradients w.r.t. means3d, scales, rotations, opacities, shs
    and mean2d_offset) of `raster` on 96 dense Gaussians (seed 5), with a
    loss that touches image, depth and alpha."""
    import torch

    dev = cam.world_view.device
    small = dense_scene(96, 5, dev)
    target = torch.as_tensor(np.random.default_rng(6).random((cam.height, cam.width, 3)),
                             dtype=torch.float32, device=dev)
    p = {k: getattr(small, k).detach().clone().requires_grad_(True)
         for k in ("xyz", "scaling", "rotation", "opacity", "shs")}
    offset = torch.zeros((96, 2), device=dev, requires_grad=True)
    out = raster(p["xyz"], p["scaling"], p["rotation"], p["opacity"], cam,
                 bg=torch.tensor([0.1, 0.2, 0.3], device=dev), shs=p["shs"],
                 sh_degree=2, alive=small.alive, mean2d_offset=offset, **kw)
    loss = (torch.mean(torch.abs(out.image - target)) + 0.1 * torch.mean(out.depth)
            + 0.05 * torch.mean(out.alpha))
    loss.backward()
    return out, {**{k: v.grad for k, v in p.items()}, "mean2d_offset": offset.grad}


def worst_grad_err(label: str, got: dict, want: dict, tol: float) -> float:
    """Largest max err / max|g| over the keys; exits if a key is not finite,
    has no gradient, or is off by more than `tol` x max|g|."""
    import torch

    worst = 0.0
    for k, ref in want.items():
        scale = float(ref.abs().max())
        err = float((got[k] - ref).abs().max())
        if not (torch.isfinite(got[k]).all() and scale > 0 and err <= tol * scale):
            raise SystemExit(f"{label}: the gradient of {k} is off: err {err}, max|g| {scale}")
        worst = max(worst, err / scale)
    return worst


def oracle_gradients(cam) -> float:
    """Gradients of the whole CUDA rasterizer against the torch oracle's
    autograd on `small_scene_grads`' scene at 200x50. Returns the largest
    error relative to each gradient's max |g|."""
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference

    return worst_grad_err("CUDA rasterizer vs the oracle",
                          small_scene_grads(rasterize_cuda, cam)[1],
                          small_scene_grads(rasterize_reference, cam)[1], GRAD_TOL)


def chunked_oracle_check(cam) -> float:
    """The oracle folded in checkpointed groups of CHUNK against its flat
    fold on the card, on `small_scene_grads`' scene: image, depth and alpha
    bit-equal, every gradient within CHUNK_TOL * max|g|. Returns the largest
    gradient error relative to max|g|."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference

    flat, g_flat = small_scene_grads(rasterize_reference, cam)
    chunked, g_chunked = small_scene_grads(rasterize_reference, cam, scan_chunk=CHUNK)
    for k in ("image", "depth", "alpha"):
        if not torch.equal(getattr(flat, k), getattr(chunked, k)):
            raise SystemExit(f"the chunked oracle's {k} is not bit-equal to the flat fold's")
    return worst_grad_err("chunked oracle vs its flat fold", g_chunked, g_flat, CHUNK_TOL)


def gradient_conformance(dev) -> dict:
    """Phase 9: (a) `chunked_oracle_check` on 96 Gaussians at 200x50; (b)
    the CUDA path's loss and gradients against the chunked oracle's
    (`tools_torch_verify_grads.oracle_grad_check`) at ORACLE_CASE; (c) its
    finite differences (`fd_checks`) at the full 100,000 Gaussians, 800x800,
    eps 2e-3. The launches of (b) and (c) are counted from 0 and checked:
    B1 once a loss, B2 once a gradient. Returns {"fwd", "bwd"} and the
    reports."""
    from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

    import tools_torch_verify_grads as vg

    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, 200, 50, device=dev)
    chunk_err = chunked_oracle_check(cam)
    log(f"[9a] chunked oracle (scan_chunk {CHUNK}) vs its flat fold on the card (96 Gaussians, "
        f"200x50): forward bit-equal, gradients max err / max|g| {chunk_err:.3g} "
        f"(bound {CHUNK_TOL})")
    cuda_build.launches.clear()
    oracle = vg.oracle_grad_check(*ORACLE_CASE, device=dev)
    fd = vg.fd_checks(eps=vg.FD_EPS[:1], device=dev)
    fwd, bwd = (cuda_build.launches[e] for e in COMPOSITES)
    log(f"[9b] CUDA path vs the chunked oracle ({ORACLE_CASE[0]} Gaussians, "
        f"{ORACLE_CASE[1]}x{ORACLE_CASE[2]}, tolerance {GRAD_TOL}*max|g| per key): "
        f"{json.dumps(oracle)}")
    log(f"[9c] finite differences (100,000 Gaussians, 800x800, eps {vg.FD_EPS[0]}, bound "
        f"{vg.FD_TOL}): {json.dumps(fd)}")
    if not oracle["ok"]:
        raise SystemExit("the CUDA path's gradients disagree with the chunked oracle's")
    if not fd["ok"]:
        raise SystemExit("a finite difference disagrees with the CUDA path's gradient")
    want_fwd = 1 + 1 + 2 * len(fd["directions"])  # (b)'s loss, (c)'s gradient, each +-eps
    expect_launches("phase 9 (b, c)", fwd, bwd, want_fwd, 2)
    return {"fwd": fwd, "bwd": bwd, "chunk_err": chunk_err, "oracle": oracle, "fd": fd}


def pair_tiles(binning):
    """The tile of every pair of a binning (its pair ranges are in tile
    order)."""
    import torch

    n_pairs = binning.pair_gaussian.shape[0]
    idx = torch.arange(n_pairs, device=binning.tile_end.device)
    return torch.searchsorted(binning.tile_end.long(), idx, right=True)


def reached_pixels(args, tiles, gaussians):
    """Where the (tile, Gaussian) pairs can composite: an (H, W) bool mask of
    the pixels at which some pair has power <= 0 and alpha >= 1/255 (the
    kernels' expressions), and the number of such (pixel, pair)s. In passes
    of REACH_CHUNK pairs."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import ALPHA_MAX, ALPHA_MIN

    mean2d, conic, opacity = args[0], args[1], args[2]
    h, w, n_tiles = args[8], args[9], int(args[6].shape[0])
    dev = mean2d.device
    px, py, inside = tile_pixels(h, w, n_tiles, dev)
    mask = torch.zeros(h * w, dtype=torch.bool, device=dev)
    count = 0
    for lo in range(0, int(tiles.shape[0]), REACH_CHUNK):
        t, g = tiles[lo:lo + REACH_CHUNK], gaussians[lo:lo + REACH_CHUNK].long()
        dx = mean2d[g, 0:1] - px[t].to(torch.float32)
        dy = mean2d[g, 1:2] - py[t].to(torch.float32)
        a, b, c = conic[g, 0:1], conic[g, 1:2], conic[g, 2:3]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(opacity[g][:, None] * torch.exp(power), ALPHA_MAX)
        reach = inside[t] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        count += int(reach.sum())
        mask[(py[t] * w + px[t])[reach]] = True
    return mask.reshape(h, w), count


def radius_modes_agree(label: str, bag, cam, teacher) -> dict:
    """B1 and B2 in "cuda" mode against "tight" mode on one view, on the
    card. The modes bin different pair sets: the ones only "cuda" mode bins
    must composite nothing; the ones only "tight" mode bins may, at the
    pixels an exact extent reaches past the 3-sigma square's tile rect
    (`reached_pixels`: with opacity above ~0.35 a Gaussian still has alpha
    >= 1/255 there). Elsewhere the image, T and depth agree within MODE_TOL,
    and B2 on the training loss's cotangent zeroed at those pixels within
    GRAD_TOL * max|g| per column (B1's `nc` indexes different lists). The
    reported radii are equal. Also each kernel's time in both modes."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_bwd_cuda, composite_fwd_cuda)

    proj_t, bin_t, args_t, lay_t = composite_inputs(bag, cam, SH_DEGREE, radius_mode="tight")
    proj_c, bin_c, args_c, lay_c = composite_inputs(bag, cam, SH_DEGREE, radius_mode="cuda")
    if not torch.equal(proj_t.radius, proj_c.radius):
        raise SystemExit(f"{label}: the reported radii differ between the radius modes")
    n = bag.num_gaussians
    tiles_t, tiles_c = pair_tiles(bin_t), pair_tiles(bin_c)
    key_t = tiles_t * n + bin_t.pair_gaussian.long()
    key_c = tiles_c * n + bin_c.pair_gaussian.long()
    only_t, only_c = ~torch.isin(key_t, key_c), ~torch.isin(key_c, key_t)
    boundary, reach_t = reached_pixels(args_t, tiles_t[only_t], bin_t.pair_gaussian[only_t])
    _, reach_c = reached_pixels(args_c, tiles_c[only_c], bin_c.pair_gaussian[only_c])
    planes_t, nc_t = composite_fwd_cuda(*args_t, **lay_t)
    planes_c, nc_c = composite_fwd_cuda(*args_c, **lay_c)
    diff = (planes_c - planes_t).abs()
    outside = ~boundary
    err_rgbT = float(diff[:4][:, outside].max()) if outside.any() else 0.0
    err_depth = float(diff[4][outside].max()) if outside.any() else 0.0
    cot = photometric_cotangent(planes_t, teacher, torch.ones(3, device=teacher.device))
    cot = cot * outside
    g_t = composite_bwd_cuda(*args_t, planes_t[3], nc_t, cot, **lay_t)
    g_c = composite_bwd_cuda(*args_c, planes_c[3], nc_c, cot, **lay_c)
    scale = g_t.abs().amax(dim=0)
    grad_rel = float(((g_c - g_t).abs().amax(dim=0) / torch.clamp_min(scale, 1e-30)).max())
    res = {
        "case": label, "pairs_tight": int(key_t.shape[0]), "pairs_cuda": int(key_c.shape[0]),
        "pairs_only_tight": int(only_t.sum()), "pairs_only_cuda": int(only_c.sum()),
        "longest_tile_tight": int((bin_t.tile_end - bin_t.tile_start).max()),
        "longest_tile_cuda": int((bin_c.tile_end - bin_c.tile_start).max()),
        "composites_only_cuda": reach_c, "composites_only_tight": reach_t,
        "boundary_pixels": int(boundary.sum()),
        "boundary_pixels_differing": int(((diff[:4].amax(dim=0) > MODE_TOL[0]) & boundary).sum()),
        "max_abs_err_rgbT_elsewhere": err_rgbT, "max_abs_err_depth_elsewhere": err_depth,
        "bwd_rel_err_per_col": grad_rel,
        "fwd_ms_tight": cuda_ms(lambda: composite_fwd_cuda(*args_t, **lay_t), reps=20),
        "fwd_ms_cuda": cuda_ms(lambda: composite_fwd_cuda(*args_c, **lay_c), reps=20),
        "bwd_ms_tight": cuda_ms(
            lambda: composite_bwd_cuda(*args_t, planes_t[3], nc_t, cot, **lay_t), reps=20),
        "bwd_ms_cuda": cuda_ms(
            lambda: composite_bwd_cuda(*args_c, planes_c[3], nc_c, cot, **lay_c), reps=20),
    }
    res["pair_ratio"] = res["pairs_cuda"] / max(res["pairs_tight"], 1)
    log(f"  radius modes, {label}: {json.dumps(res)}")
    if reach_c:
        raise SystemExit(f"{label}: pairs that only radius_mode='cuda' bins composite")
    if not (err_rgbT <= MODE_TOL[0] and err_depth <= MODE_TOL[1]):
        raise SystemExit(f"{label}: radius_mode='cuda' renders another image than 'tight'")
    if not grad_rel <= GRAD_TOL:
        raise SystemExit(f"{label}: B2 differs between the radius modes")
    return {**res, "args": args_c, "layout": lay_c}


def radius_mode_cuda(ns, dev) -> dict:
    """Phase 10: (a) B1 and B2 on the "cuda" pair sets of the gs_mesh
    teacher's view 0 and the gs_flame first step against their plain
    versions (the phase-2 bounds; gs_flame's B2 on the training loss's
    cotangent alone: each plain call walks its longest tile) and against
    "tight" mode (`radius_modes_agree`); (b) `rasterize_cuda(radius_mode=
    "cuda")` on the tile rows BAND equal to the same rows of the whole
    render, and with `pair_capacity` half the pairs the overflow the other
    half; (c) the toy scene built on the card and TOY_SMOKE_ITERS steps of
    the `--toy_dip` leg through apps.train (tools_torch_full_run.py): the
    loss falls, the test PSNR rises from step 1, the launches as expected.
    Returns the launches of (b) and (c) and the phase's numbers."""
    import torch

    import tools_torch_full_run as full_run
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda

    cam0, gt0 = ns.scene.train_cameras[0]
    gt0 = torch.as_tensor(gt0, device=dev)
    fcam, fgt = ns.flame_scene.train_cameras[0]
    fgt = torch.as_tensor(fgt, device=dev)
    out = {}
    for key, label, bag, cam, gt, cots in (
            ("gs_mesh", "gs_mesh teacher 800x800", ns.bag, cam0, gt0,
             ("seeded", "photometric")),
            ("flame", f"gs_flame first step 800x800 ({ns.flame_bag.num_gaussians} Gaussians)",
             ns.flame_bag, fcam, fgt, ("photometric",))):
        with torch.no_grad():
            modes = radius_modes_agree(label, bag, cam, gt)
            fwd = compare_composite(f"{label}, radius_mode cuda", modes["args"],
                                    modes["layout"], time_it=False)
        bwd = compare_composite_bwd(f"{label}, radius_mode cuda", modes["args"],
                                    modes["layout"], gt, time_it=False, cotangents=cots)
        out[key] = {k: v for k, v in modes.items() if k not in ("args", "layout")}
        out[key].update(fwd_max_abs_err=fwd["max_abs_err_rgbT"],
                        bwd_max_abs_err=bwd["photometric"]["max_abs_err"])

    bag = ns.bag
    kw = dict(bg=torch.ones(3, device=dev), shs=bag.shs, sh_degree=SH_DEGREE, alive=bag.alive,
              radius_mode="cuda")
    args = (bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam0)

    def band_and_capacity():
        whole = rasterize_cuda(*args, **kw)
        band = rasterize_cuda(*args, row_band=BAND, **kw)
        capped = rasterize_cuda(*args, pair_capacity=out["gs_mesh"]["pairs_cuda"] // 2, **kw)
        return whole, band, capped

    with torch.no_grad():
        (whole, band, capped), _, fwd_b, bwd_b = counted(band_and_capacity)
    rows = slice(BAND[0] * 16, min(BAND[1] * 16, cam0.height))
    for k in ("image", "depth", "alpha"):
        if not torch.equal(getattr(band, k), getattr(whole, k)[rows]):
            raise SystemExit(f"radius_mode='cuda' with row_band={BAND}: {k} differs from the "
                             "same rows of the whole render")
    want_overflow = out["gs_mesh"]["pairs_cuda"] - out["gs_mesh"]["pairs_cuda"] // 2
    log(f"[10b] radius_mode cuda: tile rows {BAND} bit-equal to the whole render's rows; "
        f"pair_capacity {out['gs_mesh']['pairs_cuda'] // 2}: overflow {capped.overflow} "
        f"(expected {want_overflow})")
    if capped.overflow != want_overflow:
        raise SystemExit("radius_mode='cuda' with pair_capacity: the overflow count is off")
    expect_launches("phase 10 (b)", fwd_b, bwd_b, 3, 0)

    toy, toy_s, fwd_t, bwd_t = counted(lambda: full_run.run_toy_dip(
        os.path.join(WORK, "toy_dip"), TOY_SMOKE_ITERS, TOY_SMOKE_TEST_ITERS, "cuda",
        quick=True))
    log(f"[10c] toy scene (tools_torch_verify_scene.py) + {TOY_SMOKE_ITERS} steps of the "
        f"--toy_dip leg in {toy_s:.1f} s: test PSNR {toy['test_psnr']}, step "
        f"{toy['step_time']['median_ms']:.2f} ms (median), checks {toy['checks']}")
    if not toy["ok"]:
        raise SystemExit(f"the toy leg failed its checks: {toy['checks']}")
    n_views = len(toy["test_psnr"]) * full_run.TOY_VIEWS + full_run.TOY_VIEWS  # evals + render
    expect_launches("phase 10 (c)", fwd_t, bwd_t, TOY_SMOKE_ITERS + n_views, TOY_SMOKE_ITERS)
    out.update(fwd={"radius_mode_cuda_render": fwd_b, "toy_dip": fwd_t},
               bwd={"radius_mode_cuda_render": bwd_b, "toy_dip": bwd_t},
               toy={k: toy[k] for k in ("test_psnr", "step_time", "final_metrics_cli")})
    return out


def bf16_inputs(args, layout) -> dict:
    """The composite's inputs in the bf16 table mode: the bf16 table's layout,
    the attributes the kernels read from it (`round_attributes`) as plain-
    version arguments, and those attributes' float32 layout."""
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        pack_attributes, pack_attributes_bf16, round_attributes)

    rounded = (*round_attributes(*args[:5]), *args[5:])
    return {"layout": {"tile_order": layout["tile_order"],
                       "attrs": pack_attributes_bf16(*args[:5])},
            "rounded": rounded,
            "rounded_layout": {"tile_order": layout["tile_order"],
                               "attrs": pack_attributes(*rounded[:5])}}


def inclusion_flips(args, rounded, nc_exact, nc_rounded) -> dict:
    """Per Gaussian, counts of the (pixel, pair)s whose part in B2 differs
    between the exact attributes (`args`, with the exact forward's nc) and
    the rounded ones (`rounded`, with their own forward's nc): included by
    one and not the other (B2's rule: rank below nc, power <= 0, alpha >=
    1/255), and included by both but clamped at ALPHA_MAX by one only (a
    clamped alpha passes no gradient to the power or the opacity); also each
    side's included (pixel, pair)s. In passes of REACH_CHUNK pairs."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import ALPHA_MAX, ALPHA_MIN

    pair_gaussian, tile_start, tile_end, h, w = args[5:10]
    dev, n = args[0].device, int(args[0].shape[0])
    n_pairs, n_tiles = int(pair_gaussian.shape[0]), int(tile_start.shape[0])
    px, py, inside = tile_pixels(h, w, n_tiles, dev)
    pix = py.clamp_max(h - 1) * w + px.clamp_max(w - 1)
    idx = torch.arange(n_pairs, device=dev)
    tiles = torch.searchsorted(tile_end.long(), idx, right=True)
    rank = idx - tile_start.long()[tiles.clamp_max(n_tiles - 1)]

    def part(attrs, nc, t, g, k):
        mean2d, conic, opacity = attrs[0], attrs[1], attrs[2]
        dx = mean2d[g, 0:1] - px[t].to(torch.float32)
        dy = mean2d[g, 1:2] - py[t].to(torch.float32)
        a, b, c = conic[g, 0:1], conic[g, 1:2], conic[g, 2:3]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha_raw = opacity[g][:, None] * torch.exp(power)
        inc = (inside[t] & (k[:, None] < nc.reshape(-1)[pix[t]].long()) & (power <= 0.0)
               & (torch.clamp_max(alpha_raw, ALPHA_MAX) >= ALPHA_MIN))
        return inc, inc & (alpha_raw < ALPHA_MAX)

    out = {key: torch.zeros(n, dtype=torch.long, device=dev) for key in
           ("included_exact", "included_rounded", "inclusion_flips", "clamp_flips")}
    for lo in range(0, n_pairs, REACH_CHUNK):
        t, g = tiles[lo:lo + REACH_CHUNK], pair_gaussian[lo:lo + REACH_CHUNK].long()
        k = rank[lo:lo + REACH_CHUNK]
        inc_x, free_x = part(args, nc_exact, t, g, k)
        inc_r, free_r = part(rounded, nc_rounded, t, g, k)
        for key, v in (("included_exact", inc_x), ("included_rounded", inc_r),
                       ("inclusion_flips", inc_x != inc_r),
                       ("clamp_flips", inc_x & inc_r & (free_x != free_r))):
            out[key].index_add_(0, g, v.sum(dim=1))
    return out


def check_b1_bf16(label: str, args, layout, plain: bool) -> dict:
    """B1 on the bf16 table: bit-equal (planes and nc) to B1 on the float32
    table of the rounded attributes and, with `plain`, to the plain version
    on them (that call timed once). Also its largest difference from the
    exact mode (r, g, b, T)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_fwd_cuda, composite_fwd_plain)

    b = bf16_inputs(args, layout)
    planes, nc = composite_fwd_cuda(*args, **b["layout"])
    planes_r, nc_r = composite_fwd_cuda(*b["rounded"], **b["rounded_layout"])
    planes_x, _ = composite_fwd_cuda(*args, **layout)
    res = {"case": label, "pairs": int(args[5].shape[0]),
           "bit_equal_f32_on_rounded": torch.equal(planes, planes_r) and torch.equal(nc, nc_r),
           "max_abs_diff_exact_rgbT": float((planes[:4] - planes_x[:4]).abs().max())}
    if plain:
        (planes_p, nc_p), plain_ms = timed_once(lambda: composite_fwd_plain(*b["rounded"]))
        res.update(plain_ms=plain_ms,
                   bit_equal_plain=torch.equal(planes, planes_p) and torch.equal(nc, nc_p),
                   max_abs_err=float((planes - planes_p).abs().max()),
                   nc_mismatches=int((nc != nc_p).sum()))
    else:
        res["max_abs_err"] = float((planes - planes_r).abs().max())
    log(f"  B1 bf16 {label}: {json.dumps(res)}")
    if not (res["bit_equal_f32_on_rounded"] and res.get("bit_equal_plain", True)):
        raise SystemExit(f"B1 on the bf16 table is not bit-equal on {label}")
    return res


GRAD_COL_NAMES = ("mx", "my", "a", "b", "c", "op", "r", "g", "b_color", "z")


def rounded_b2(attrs, rest, tile_order, cot):
    """B1 then B2 on the float32 table of `attrs`, pairs rounded, the totals
    rounded: the attr "bf16" mode's arithmetic on chosen attributes."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_bwd_cuda, composite_fwd_cuda, pack_attributes)

    lay = {"tile_order": tile_order, "attrs": pack_attributes(*attrs)}
    planes, nc = composite_fwd_cuda(*attrs, *rest, **lay)
    g = composite_bwd_cuda(*attrs, *rest, planes[3], nc, cot, **lay, round_pairs=True)
    return g.to(torch.bfloat16).float()


def rel_per_gaussian(g, g_exact):
    """Each Gaussian's largest |g - g_exact| over the columns, as a share of
    the column's max|g_exact| (the measure of BF16_MODE_TOL)."""
    import torch

    return ((g - g_exact).abs() / torch.clamp_min(g_exact.abs().amax(dim=0), 1e-30)).amax(dim=1)


def flame_gap(args, layout, b, nc_exact, nc_rounded, cot, g_exact, g) -> dict:
    """The attr "bf16" mode's distance from the exact B2 on gs_flame, where
    it passes BF16_MODE_TOL, split by what carries it (tools_torch_bf16_gap.py
    breaks it down further): the Gaussians with (pixel, pair)s of their own
    whose part in B2 flips between the exact and the rounded attributes
    (`inclusion_flips`; a few-pixel Gaussian whose edge pixel flips moves by
    a large share of max|g|), and the rest, which the colour's rounding moves
    (B2 on the float32 table with the colour alone rounded, pairs and totals
    rounded). Held: the largest distance is on a Gaussian with a flip of its
    own; the rest are within the colour rounding's distance + BF16_MODE_TOL;
    the distance and the Gaussians past BF16_MODE_TOL within FLAME_BF16_GAP
    and FLAME_BF16_OVER."""
    rel = rel_per_gaussian(g, g_exact)
    flips = inclusion_flips(args, b["rounded"], nc_exact, nc_rounded)
    own = (flips["inclusion_flips"] > 0) | (flips["clamp_flips"] > 0)
    over = rel > BF16_MODE_TOL
    colour = (*args[:3], b["rounded"][3], args[4])
    colour_gap = float(rel_per_gaussian(rounded_b2(colour, args[5:], layout["tile_order"], cot),
                                        g_exact).max())
    r = {"gaussians_over_mode_tol": int(over.sum()),
         "over_with_own_flip": int((over & own).sum()),
         "worst_column": GRAD_COL_NAMES[int(((g - g_exact).abs().amax(dim=0) / g_exact.abs()
                                             .amax(dim=0).clamp_min(1e-30)).argmax())],
         "rel_err_with_own_flip": float(rel[own].max()) if bool(own.any()) else 0.0,
         "rel_err_without_own_flip": float(rel[~own].max()) if bool((~own).any()) else 0.0,
         "colour_rounded_alone": colour_gap,
         "gaussians_with_own_flip": int(own.sum()),
         **{k: int(v.sum()) for k, v in flips.items()}}
    r["held"] = (r["rel_err_with_own_flip"] >= r["rel_err_without_own_flip"]
                 and r["rel_err_without_own_flip"] <= colour_gap + BF16_MODE_TOL
                 and float(rel.max()) <= FLAME_BF16_GAP
                 and r["gaussians_over_mode_tol"] <= FLAME_BF16_OVER)
    return r


def check_b2_bf16(label: str, args, layout, teacher, plain: bool, flame: bool = False) -> dict:
    """B2 in each of BF16_MODES on the photometric cotangent of the exact
    forward against `teacher`, T and nc of the forward on that mode's
    table: finite and not equal to the exact B2. In the rounded modes the
    kernel's own output (before the totals' rounding) of every Gaussian with
    exactly one pair is a bf16 value (the flush rounded that pair's sums);
    the exact B2's, counted, is not for some (`bf16_modes` checks that an
    input has such Gaussians). With `plain`, held against its plain
    version, that call timed once, per column: on the bf16 table within
    BF16_KERNEL_TOL x max|g|; on the float32 table with pairs rounded within
    BF16_PAIR_KERNEL_TOL, below that rounding's own effect; in both at most
    BF16_KERNEL_OVER Gaussians off it by more than GRAD_TOL x max|g|.
    Without, the bf16 table against B2 on the float32 table of the rounded
    attributes, pairs rounded, held so. Each mode within BF16_MODE_TOL of the
    exact B2, but the attr "bf16" modes on gs_flame (`flame`), which
    `flame_gap` holds. The per-Gaussian totals of an attr "bf16" mode
    are rounded to bf16 here as `_Composite.backward` rounds them
    (`function_totals` checks that path)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_bwd_cuda, composite_bwd_plain, composite_fwd_cuda)

    def is_bf16(x):
        return x == x.to(torch.bfloat16).float()

    b = bf16_inputs(args, layout)
    exact_fwd = composite_fwd_cuda(*args, **layout)
    bf16_fwd = composite_fwd_cuda(*args, **b["layout"])
    # one cotangent for every mode (the exact forward's), so that the modes
    # differ by their tables and roundings alone
    cot = photometric_cotangent(exact_fwd[0], teacher, torch.ones(3, device=args[0].device))
    g_exact = composite_bwd_cuda(*args, exact_fwd[0][3], exact_fwd[1], cot, **layout)
    one_pair = torch.bincount(args[5].long(), minlength=args[0].shape[0]) == 1
    res = {"case": label, "pairs": int(args[5].shape[0]),
           "one_pair_gaussians": int(one_pair.sum()),
           "one_pair_not_bf16_exact_mode": int((~is_bf16(g_exact[one_pair])).any(dim=1).sum())}
    by_flags = {}
    for attr, grad in BF16_MODES:
        bf16 = attr == "bf16"
        flags = (bf16, bf16 or grad == "bf16")
        if flags not in by_flags:
            planes, nc = bf16_fwd if bf16 else exact_fwd
            g = composite_bwd_cuda(*args, planes[3], nc, cot, **(b["layout"] if bf16 else layout),
                                   round_pairs=flags[1])
            r = {"one_pair_bf16": bool(is_bf16(g[one_pair]).all())}
            if bf16:
                g = g.to(torch.bfloat16).float()
            rel = rel_per_gaussian(g, g_exact)
            r.update(finite=bool(torch.isfinite(g).all()), rel_err_vs_exact=float(rel.max()),
                     equal_to_exact=torch.equal(g, g_exact))
            if plain or bf16:
                if plain:
                    p, r["plain_ms"] = timed_once(lambda: composite_bwd_plain(
                        *(b["rounded"] if bf16 else args), planes[3], nc, cot,
                        round_pairs=flags[1]))
                else:  # the float32 table of the rounded attributes, pairs rounded
                    p = composite_bwd_cuda(*b["rounded"], planes[3], nc, cot,
                                           **b["rounded_layout"], round_pairs=True)
                if bf16:
                    p = p.to(torch.bfloat16).float()
                torch.cuda.synchronize()
                scale = p.abs().amax(dim=0)
                err = (g - p).abs()
                r["tol"] = BF16_KERNEL_TOL if bf16 else BF16_PAIR_KERNEL_TOL
                r.update(max_abs_err=float(err.max()),
                         max_rel_err_per_col=float((err.amax(dim=0)
                                                    / torch.clamp_min(scale, 1e-30)).max()),
                         gaussians_over_grad_tol=int((err > GRAD_TOL * scale).any(dim=1).sum()),
                         within_tol=bool((err.amax(dim=0) <= r["tol"] * scale).all()))
                r["within_tol"] &= r["gaussians_over_grad_tol"] <= BF16_KERNEL_OVER
            if flame and bf16:
                r["gap"] = flame_gap(args, layout, b, exact_fwd[1], bf16_fwd[1], cot, g_exact, g)
            held = r["gap"]["held"] if "gap" in r else r["rel_err_vs_exact"] <= BF16_MODE_TOL
            r["ok"] = (held and r["finite"] and not r["equal_to_exact"]
                       and r.get("within_tol", True) and r["one_pair_bf16"])
            by_flags[flags] = r
        res[f"{attr}_{grad}"] = by_flags[flags]
    log(f"  B2 bf16 modes {label}: {json.dumps(res)}")
    if not all(r["ok"] for r in by_flags.values()):
        raise SystemExit(f"B2 in a bf16 mode failed its checks on {label}")
    return res


def function_totals(args, layout, teacher) -> dict:
    """Through the autograd Function (`rasterize_cuda.composite`) on the card:
    under attr_precision "bf16" every per-Gaussian gradient is a bf16 value;
    under (f32, bf16) they are float32 sums and not all are."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.binning import Binning
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import composite

    binning = Binning(*args[5:8], layout["tile_order"], None, 0)
    res = {}
    for attr, grad in BF16_MODES:
        leaves = [a.detach().clone().requires_grad_(True) for a in args[:5]]
        planes, _ = composite(*leaves, binning, *args[8:10], attr_precision=attr,
                              grad_precision=grad)
        planes.backward(photometric_cotangent(planes.detach(), teacher,
                                              torch.ones(3, device=args[0].device)))
        g = torch.cat([x.grad.reshape(x.shape[0], -1) for x in leaves], dim=1)
        res[f"{attr}_{grad}"] = torch.equal(g, g.to(torch.bfloat16).float())
    log(f"  per-Gaussian totals through the autograd Function, bf16-representable: "
        f"{json.dumps(res)}")
    if res != {"bf16_bf16": True, "f32_bf16": False, "bf16_f32": True}:
        raise SystemExit("the bf16 modes' per-Gaussian totals are not rounded as they should be")
    return res


def bf16_times(args, layout, teacher, ops: dict) -> dict:
    """The kernels' times on the float32 and the bf16 table in turns (f32,
    bf16, bf16, f32; CUDA events: `ms`, median of 10 single launches, and
    `queued_ms`, 10 queued), each mode's mean of its two turns, and each bf16
    kernel's bound with its bytes (32-byte rows). `ops` holds phase 2's
    operation counts of the same inputs ("fwd", "bwd", or both; a kernel is
    timed where its counts are given): those of the exact attributes' walk.
    The rounded attributes' walk differs from it only by the (pixel, pair)s
    whose inclusion flips, a few per million of those included
    (`inclusion_flips`, counted on gs_flame in (b)), so the bound is the
    same to that share, and no replay of the walk is made for it."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_bwd_cuda, composite_fwd_cuda)

    b = bf16_inputs(args, layout)
    runs = {}
    if "fwd" in ops:
        runs["fwd"] = {"f32": lambda: composite_fwd_cuda(*args, **layout),
                       "bf16": lambda: composite_fwd_cuda(*args, **b["layout"])}
    if "bwd" in ops:
        planes_b, nc_b = composite_fwd_cuda(*args, **b["layout"])
        planes_f, nc_f = composite_fwd_cuda(*args, **layout)
        cot = photometric_cotangent(planes_f, teacher, torch.ones(3, device=args[0].device))
        runs["bwd"] = {
            "f32": lambda: composite_bwd_cuda(*args, planes_f[3], nc_f, cot, **layout),
            "bf16": lambda: composite_bwd_cuda(*args, planes_b[3], nc_b, cot, **b["layout"],
                                               round_pairs=True)}
    out = {}
    for kernel, fns in runs.items():
        t = {m: {"ms": [], "queued_ms": []} for m in fns}
        for mode in ("f32", "bf16", "bf16", "f32"):
            t[mode]["ms"].append(cuda_ms(fns[mode], reps=10))
            t[mode]["queued_ms"].append(cuda_ms_queued(fns[mode], reps=10))
        out[kernel] = {f"{m}_{k}": statistics.mean(v) for m, d in t.items() for k, v in d.items()}
    n_pairs, n_tiles, n = int(args[5].shape[0]), int(args[6].shape[0]), int(args[0].shape[0])
    h, w = args[8], args[9]
    if "fwd" in ops:
        out["fwd"].update(bytes_and_bound(ops["fwd"]["fwd_flops"],
                                          4 * n_pairs + 8 * n_tiles + 32 * n + 24 * h * w))
    if "bwd" in ops:
        out["bwd"].update(bytes_and_bound(ops["bwd"]["bwd_flops"], 4 * n_pairs + 8 * n_tiles
                                          + 32 * n + 28 * h * w + 40 * n))
    return out


def bf16_training(ns, dev) -> dict:
    """`render(..., attr_precision="bf16")` of the gs_mesh teacher beside the
    exact render; then BF16_ITERS steps of a fresh student through
    `make_train_step(render_kwargs=...)` in the full-bf16 mode beside as many
    in the exact mode, from the same state and camera order (view i % 3):
    both losses fall (the mean of the last steps below the first's, 20 or a
    third of the run at each end), and the bf16 run's final test PSNR (the
    app's eval render, `make_eval_render`) is within BF16_PSNR_GAP dB of the
    exact run's; BF16_GRAD_ITERS steps in the (f32, bf16) mode, whose loss
    falls too. Each run's launches of every entry point are counted from 0
    and checked."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import BWD_ENTRIES, FWD_ENTRIES
    from gaussian_mesh_splatting_tpu_torch.renderer import render
    from gaussian_mesh_splatting_tpu_torch.train import (
        make_train_state, make_train_step, optimization_config)
    from gaussian_mesh_splatting_tpu_torch.train.loop import make_eval_render
    from gaussian_mesh_splatting_tpu_torch.train.loss import psnr

    white = torch.ones(3, device=dev)
    cam0 = ns.scene.train_cameras[0][0]

    def entry_launches() -> dict:  # the composites' five entries
        return {e: cuda_build.launches[e] for e in (*FWD_ENTRIES.values(), *BWD_ENTRIES.values())}

    cuda_build.launches.clear()
    with torch.no_grad():
        r_b = render(ns.bag, cam0, white, sh_degree=SH_DEGREE, attr_precision="bf16")
        r_x = render(ns.bag, cam0, white, sh_degree=SH_DEGREE)
    torch.cuda.synchronize()
    render_launches = entry_launches()
    res = {"render": {"max_abs_diff": float((r_b.image - r_x.image).abs().max()),
                      "psnr_vs_exact": float(psnr(r_b.image, r_x.image)),
                      "finite": bool(torch.isfinite(r_b.image).all()),
                      "launches": render_launches}}
    log(f"[11d] render(attr_precision='bf16') of the teacher against the exact render: "
        f"{json.dumps(res['render'])}")
    if not (res["render"]["finite"] and res["render"]["psnr_vs_exact"] >= BF16_RENDER_PSNR):
        raise SystemExit("the bf16 render of the teacher is off the exact one")
    if render_launches != {"composite_fwd": 1, "composite_fwd_bf16": 1, "composite_bwd": 0,
                           "composite_bwd_round_pairs": 0, "composite_bwd_bf16": 0}:
        raise SystemExit(f"the renders launched {render_launches}")

    cfg = optimization_config("gs_mesh")
    cams = [(c, torch.as_tensor(g, device=dev)) for c, g in ns.scene.train_cameras]
    tests = [(c, torch.as_tensor(g, device=dev)) for c, g in ns.scene.test_cameras]
    eval_render = make_eval_render(mesh_model, SH_DEGREE)

    def run(attr: str, grad: str, iters: int) -> dict:
        state = make_train_state(ns.scene.init_model_state(mesh_model, SH_DEGREE), cfg,
                                 ns.scene.cameras_extent)
        step = make_train_step(mesh_model, cfg, SH_DEGREE,
                               render_kwargs=dict(attr_precision=attr, grad_precision=grad))
        cuda_build.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for i in range(iters):
            cam, gt = cams[i % len(cams)]
            state, metrics = step(state, cam, gt, white)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = entry_launches()
        losses = torch.stack(losses).tolist()
        window = min(20, iters // 3)  # steps at each end whose mean loss must fall
        test_psnr = statistics.mean(float(psnr(eval_render(state, c, white), g))
                                    for c, g in tests)
        r = {"steps": iters, "wall_s": wall, "loss_window": window,
             "loss_first": statistics.mean(losses[:window]),
             "loss_last": statistics.mean(losses[-window:]), "test_psnr": test_psnr,
             "launches": counts, "finite": bool(np.isfinite(losses).all())}
        log(f"[11d] {iters} gs_mesh steps in ({attr}, {grad}): {json.dumps(r)}")
        bf16 = attr == "bf16"
        rounds = grad == "bf16" and not bf16
        want = {"composite_fwd": 0 if bf16 else iters, "composite_fwd_bf16": iters if bf16 else 0,
                "composite_bwd": 0 if bf16 or rounds else iters,
                "composite_bwd_round_pairs": iters if rounds else 0,
                "composite_bwd_bf16": iters if bf16 else 0}
        if counts != want:
            raise SystemExit(f"({attr}, {grad}) training launched {counts}, expected {want}")
        if not (r["finite"] and r["loss_last"] < r["loss_first"]):
            raise SystemExit(f"({attr}, {grad}) training: the loss did not fall")
        return r

    res["exact"] = run("f32", "f32", BF16_ITERS)
    res["bf16"] = run("bf16", "bf16", BF16_ITERS)
    res["f32_bf16"] = run("f32", "bf16", BF16_GRAD_ITERS)
    res["psnr_gap_db"] = res["bf16"]["test_psnr"] - res["exact"]["test_psnr"]
    log(f"[11d] final test PSNR: bf16 {res['bf16']['test_psnr']:.4f} dB, exact "
        f"{res['exact']['test_psnr']:.4f} dB, gap {res['psnr_gap_db']:+.4f} dB "
        f"(bound {BF16_PSNR_GAP})")
    if abs(res["psnr_gap_db"]) > BF16_PSNR_GAP:
        raise SystemExit("the bf16 run's test PSNR is off the exact run's")
    return res


def bf16_modes(ns, dev, cases, ops: dict | None = None) -> dict:
    """Phase 11: the JAX rasterizer's bf16 pair-table modes on the CUDA path.
    (a) at the gs_mesh teacher's view (B1; B2 at the student's first step
    there, the training path's input) and the gs first step: B1 on the bf16
    table bit-equal to its plain version and to B1 on the float32 table of the
    rounded attributes; B2 in each mode within BF16_KERNEL_TOL (bf16 table)
    or BF16_PAIR_KERNEL_TOL (float32 table, pairs rounded) of its plain
    version and BF16_MODE_TOL of the exact B2, its one-pair Gaussians' sums
    bf16 values; the totals through the autograd Function bf16 values under
    attr "bf16"; a band of tile rows of a bf16 render bit-equal to the whole
    bf16 render's rows; (b) the gs_flame first step, kernels only: B1
    bit-equal to B1 on the rounded table, B2 on the bf16 table within
    BF16_KERNEL_TOL of B2 on the rounded float32 table, one-pair sums bf16
    values, (f32, bf16) within BF16_MODE_TOL of the exact B2, the attr
    "bf16" modes' distance from it held by `flame_gap`; (c) both kernels'
    times on both tables at the three inputs, with their bounds from phase
    2's operation counts `ops` (run alone, without them, the walks are
    replayed here); (d) `bf16_training`."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_fwd_cuda, rasterize_cuda)

    if ops is None:
        def counts(case):
            args, layout = cases[case]
            with torch.no_grad():
                return composite_op_counts(args, composite_fwd_cuda(*args, **layout)[1])[0]

        ops = {"gs_mesh": {"fwd": counts("full"), "bwd": counts("train")},
               "gs": dict.fromkeys(("fwd", "bwd"), counts("gs")),
               "flame": dict.fromkeys(("fwd", "bwd"), counts("flame"))}

    cam0, gt0 = ns.scene.train_cameras[0]
    gt0 = torch.as_tensor(gt0, device=dev)
    fgt = torch.as_tensor(ns.flame_scene.train_cameras[0][1], device=dev)
    out = {}
    t0 = time.perf_counter()
    log(f"[11a] B1 on the bf16 table (bit-equal), B2 in {BF16_MODES} (within "
        f"{BF16_KERNEL_TOL}*max|g| (bf16 table) or {BF16_PAIR_KERNEL_TOL}*max|g| (float32 "
        f"table) of the plain version, {BF16_MODE_TOL}*max|g| of exact B2; one-pair sums bf16)")
    with torch.no_grad():
        out["fwd"] = {"gs_mesh": check_b1_bf16("gs_mesh teacher 800x800", *cases["full"], True),
                      "gs": check_b1_bf16("gs first step 800x800", *cases["gs"], True),
                      "flame": check_b1_bf16("gs_flame first step 800x800", *cases["flame"],
                                             False)}
    out["bwd"] = {
        "gs_mesh": check_b2_bf16("gs_mesh student vs GT 800x800", *cases["train"], gt0, True),
        "gs": check_b2_bf16("gs first step vs GT 800x800", *cases["gs"], gt0, True),
        "flame": check_b2_bf16("gs_flame first step vs GT 800x800", *cases["flame"], fgt,
                               False, flame=True)}
    if not any(r["one_pair_not_bf16_exact_mode"] for r in out["bwd"].values()):
        raise SystemExit("no input has a one-pair Gaussian whose exact sums are not bf16 values")
    out["totals"] = function_totals(*cases["train"], gt0)
    bag = ns.bag
    kw = dict(bg=torch.ones(3, device=dev), shs=bag.shs, sh_degree=SH_DEGREE, alive=bag.alive,
              attr_precision="bf16", grad_precision="bf16")
    args = (bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam0)
    with torch.no_grad():
        whole = rasterize_cuda(*args, **kw)
        band = rasterize_cuda(*args, row_band=BAND, **kw)
    rows = slice(BAND[0] * 16, min(BAND[1] * 16, cam0.height))
    for k in ("image", "depth", "alpha"):
        if not torch.equal(getattr(band, k), getattr(whole, k)[rows]):
            raise SystemExit(f"bf16 mode with row_band={BAND}: {k} differs from the whole "
                             "render's rows")
    log(f"[11a] bf16 mode: tile rows {BAND} bit-equal to the whole render's rows; "
        f"(a, b) in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with torch.no_grad():
        out["times"] = {
            "gs_mesh": {**bf16_times(*cases["full"], gt0, {"fwd": ops["gs_mesh"]["fwd"]}),
                        **bf16_times(*cases["train"], gt0, {"bwd": ops["gs_mesh"]["bwd"]})},
            "gs": bf16_times(*cases["gs"], gt0, ops["gs"]),
            "flame": bf16_times(*cases["flame"], fgt, ops["flame"])}
    log(f"[11c] kernel times, float32 and bf16 table in turns (ms), bf16 bounds: "
        f"{json.dumps(out['times'])} ({time.perf_counter() - t0:.1f} s)")

    out["train"] = bf16_training(ns, dev)
    return out


def train_step_split(gs_type: str, state, cam, gt, bg, reps: int = 12, model=None) -> dict:
    """Device times (ms, median of `reps`) of a training path's own step
    (`train.loop.make_train_step`, as `apps.train` builds it) at `state`:
    the whole step and each stage, from CUDA events that the step's `mark`
    hook records at its stage boundaries. Also, at the same state, B2 alone
    and the loss's forward + backward alone. The steps it takes keep
    training the state. `model`: the gs_type's model where it is an
    instance (`gs_flame`), else the registry's."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import get_model
    from gaussian_mesh_splatting_tpu_torch.ops import rasterize_cuda as rc
    from gaussian_mesh_splatting_tpu_torch.train import make_train_step, optimization_config
    from gaussian_mesh_splatting_tpu_torch.train.loss import photometric_loss

    model = model if model is not None else get_model(gs_type)
    stages = ("to_bag", "render", "loss", "backward", "adam", "stats")
    events = {}

    def mark(stage):
        events[stage] = torch.cuda.Event(enable_timing=True)
        events[stage].record()

    step_fn = make_train_step(model, optimization_config(gs_type), SH_DEGREE, mark=mark)
    times = {f"{k}_ms": [] for k in ("step", *stages)}
    for _ in range(reps + 2):
        step_fn(state, cam, gt, bg)
        events["stats"].synchronize()
        times["step_ms"].append(events["start"].elapsed_time(events["stats"]))
        for prev, k in zip(("start", *stages), stages):
            times[f"{k}_ms"].append(events[prev].elapsed_time(events[k]))
    split = {k: statistics.median(v[2:]) for k, v in times.items()}

    with torch.no_grad():
        bag = model.to_bag(state.model_state())
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
    from it, and the fresh student's Gaussians; for the `gs` path the same
    cameras and GT images in a directory of its own with no `points3d.ply`
    (the Blender_Mesh reader leaves the mesh's points under that name), so
    that the Blender reader makes its 100,000 seeded points, and that path's
    first-step Gaussians in their 400,000-row buffer; the COLMAP dataset with
    its two meshes and GT from a gs_multi_mesh teacher; the FLAME pickle, its
    head's Blender dataset on the same cameras with GT from a gs_flame
    teacher, and that path's first-step Gaussians."""
    import types

    import torch

    from gaussian_mesh_splatting_tpu_torch.io.checkpoint import snapshot_dir
    from gaussian_mesh_splatting_tpu_torch.io.config_io import save_cfg
    from gaussian_mesh_splatting_tpu_torch.io.snapshots import save_snapshot
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.models import model_for, multi_mesh, vanilla
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
    render_gt_images(scene, bag)
    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=NUM_SPLATS, shuffle=False, device=dev)
    log(f"    gs_mesh scene: {bag.num_gaussians} Gaussians, "
        f"{state['consts']['faces'].shape[0]} faces, {SIZE}x{SIZE}, SH {SH_DEGREE}; "
        f"GT images rendered from the seed-42 teacher")
    gs_data_dir = os.path.join(WORK, "gs_scene")
    os.makedirs(gs_data_dir)
    for name in ("transforms_train.json", "transforms_test.json"):
        shutil.copyfile(os.path.join(data_dir, name), os.path.join(gs_data_dir, name))
    for split in ("train", "test"):
        shutil.copytree(os.path.join(data_dir, split), os.path.join(gs_data_dir, split))
    gs_scene = Scene(gs_data_dir, "gs", white_background=True, eval=True, shuffle=False,
                     device=dev)
    n_points = len(gs_scene.scene_info.point_cloud.points)
    if n_points != GS_POINTS or not os.path.exists(os.path.join(gs_data_dir, "points3d.ply")):
        raise SystemExit(f"the Blender reader made {n_points} points, expected {GS_POINTS}")
    with torch.no_grad():
        gs_bag = vanilla.to_bag(gs_scene.init_model_state(vanilla, SH_DEGREE,
                                                          capacity=GS_CAPACITY))
    log(f"    gs scene: {int(gs_bag.alive.sum())} Gaussians alive of {gs_bag.num_gaussians} "
        f"rows, from the Blender reader's seeded points; cameras extent "
        f"{gs_scene.cameras_extent:.3f}; the same cameras and GT images")

    # the COLMAP dataset: GT from a seed-43 gs_multi_mesh teacher, on black
    colmap_dir = os.path.join(WORK, "colmap_scene")
    write_colmap_dataset(colmap_dir)
    colmap_kw = dict(eval=True, num_splats=NUM_SPLATS, shuffle=False, device=dev)
    colmap_scene = Scene(colmap_dir, "gs_multi_mesh", **colmap_kw)
    mm_init = colmap_scene.init_model_state(multi_mesh, SH_DEGREE)
    with torch.no_grad():
        render_gt_images(colmap_scene, multi_mesh.to_bag(randomize_state(mm_init, seed=43)),
                         white=False)
    colmap_scene = Scene(colmap_dir, "gs_multi_mesh", **colmap_kw)
    n_mm = int(mm_init["alive"].shape[0])
    log(f"    COLMAP scene: {len(colmap_scene.train_cameras)} train + "
        f"{len(colmap_scene.test_cameras)} test PINHOLE views, "
        f"{[int(f.shape[0]) for f in mm_init['consts']['faces']]} faces, {n_mm} Gaussians, "
        f"{COLMAP_POINTS} points in points3D.bin; GT (RGB, black) from the seed-43 teacher")

    # the FLAME head: GT from a seed-44 teacher with an expression and the
    # jaw open, on the Blender scene's cameras (white background)
    flame_dir = os.path.join(WORK, "flame_scene")
    os.makedirs(flame_dir)
    flame_pkl = os.path.join(WORK, "flame_synthetic.pkl")
    write_flame_pickle(flame_pkl)
    for name in ("transforms_train.json", "transforms_test.json"):
        shutil.copyfile(os.path.join(data_dir, name), os.path.join(flame_dir, name))
    for split in ("train", "test"):
        shutil.copytree(os.path.join(data_dir, split), os.path.join(flame_dir, split))
    flame_model, rig = model_for("gs_flame", flame_pkl, dev)
    flame_kw = dict(eval=True, white_background=True, flame_rig=rig, shuffle=False, device=dev)
    flame_scene = Scene(flame_dir, "gs_flame", **flame_kw)
    flame_init = flame_scene.init_model_state(flame_model, SH_DEGREE)
    teacher = randomize_state(flame_init, seed=44)
    rng = np.random.default_rng(44)
    p = teacher["params"]
    p["flame_exp"] = torch.as_tensor(rng.normal(0, 1.0, (1, 50)).astype(np.float32), device=dev)
    p["flame_pose"] = torch.tensor([[0.0, 0.1, 0.0, 0.25, 0.0, 0.0]], device=dev)
    with torch.no_grad():
        render_gt_images(flame_scene, flame_model.to_bag(teacher))
        flame_bag = flame_model.to_bag(flame_init)
    flame_scene = Scene(flame_dir, "gs_flame", **flame_kw)
    log(f"    gs_flame scene: {rig.lbs_model.v_template.shape[0]} vertices, "
        f"{rig.lbs_model.faces.shape[0]} faces, {flame_bag.num_gaussians} Gaussians "
        f"({FLAME_SPLATS} per face); GT from the seed-44 teacher (an expression, the jaw open)")
    return types.SimpleNamespace(
        scene=scene, state=state, bag=bag, student_bag=student_bag, data_dir=data_dir,
        model_dir=model_dir, train_dir=train_dir, iteration=iteration,
        gs_scene=gs_scene, gs_bag=gs_bag, gs_data_dir=gs_data_dir,
        gs_train_dir=os.path.join(WORK, "gs_model"),
        gs_resume_dir=os.path.join(WORK, "gs_model_resumed"),
        flat_train_dir=os.path.join(WORK, "gs_flat_model"),
        colmap_dir=colmap_dir, colmap_scene=colmap_scene, mm_init=mm_init,
        mm_train_dir=os.path.join(WORK, "mm_model"),
        mm_resume_dir=os.path.join(WORK, "mm_model_resumed"),
        colmap_gs_dir=os.path.join(WORK, "colmap_gs_model"),
        flame_dir=flame_dir, flame_pkl=flame_pkl, flame_scene=flame_scene,
        flame_model=flame_model, flame_bag=flame_bag,
        flame_train_dir=os.path.join(WORK, "flame_model"))


def kernel_cases(ns, dev) -> dict:
    """The inputs the kernels are held against their plain versions on, as
    (args, layout) of `composite_inputs`: the render path's (teacher, train
    view 0), the training path's first step (fresh student, same view), the
    `gs` and `gs_flame` paths' first steps (same view), a non-aligned 803x611
    view, a dense scene that drives pixels to termination, and an empty (all
    culled) one."""
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
            "gs": composite_inputs(ns.gs_bag, cam0, SH_DEGREE)[2:],
            "flame": composite_inputs(ns.flame_bag, ns.flame_scene.train_cameras[0][0],
                                      SH_DEGREE)[2:],
            "nonaligned": composite_inputs(ns.bag, cam_na, SH_DEGREE)[2:],
            "dense": composite_inputs(dense_scene(4000, 2, dev), cam_dense, 3)[2:],
            "empty": composite_inputs(culled, cam_small, 3)[2:],
        }


def counted(fn):
    """Run fn() with every kernel entry's launch count cleared just before
    it; returns (its result, wall seconds to a synchronized end, B1
    launches, B2 launches on the float32 table)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

    cuda_build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, *(cuda_build.launches[e] for e in COMPOSITES))


def expect_launches(label: str, fwd: int, bwd: int, want_fwd: int, want_bwd: int) -> None:
    log(f"    {label}: composite_fwd launches {fwd}, composite_bwd launches {bwd}")
    if (fwd, bwd) != (want_fwd, want_bwd):
        raise SystemExit(f"{label}: expected {want_fwd} forward and {want_bwd} backward launches")


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im, dtype=np.int32)
    if img.shape != (SIZE, SIZE, 3) or img.std() < 1.0:
        raise SystemExit(f"bad frame {path}: shape {img.shape}, std {img.std():.3f}")
    return img


class _Tee:
    """A text stream that keeps what is written to it and passes it on."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def timed_train(argv: list[str], device: str = "cuda"):
    """apps.train.main(argv) with each train step timed on the host clock
    between two synchronizations of `device` (the step the app builds,
    through the train package's `make_train_step`) and its printed log kept;
    both kernels' launch counts are set to 0 just before it. Returns
    (result, log text, step ms list, wall s, B1 launches, B2 launches)."""
    import contextlib

    import torch

    import gaussian_mesh_splatting_tpu_torch.train as train_pkg
    from gaussian_mesh_splatting_tpu_torch.apps import train as train_app
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

    def sync():
        if device.startswith("cuda"):
            torch.cuda.synchronize()

    real_make, step_ms = train_pkg.make_train_step, []

    def timed_make(*a, **kw):
        step = real_make(*a, **kw)

        def timed(*args):
            sync()
            t0 = time.perf_counter()
            out = step(*args)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            return out

        return timed

    tee = _Tee(sys.stdout)
    cuda_build.launches.clear()
    train_pkg.make_train_step = timed_make
    try:
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            res = train_app.main(argv)
        sync()
        wall = time.perf_counter() - t0
    finally:
        train_pkg.make_train_step = real_make
    return (res, "".join(tee.parts), step_ms, wall,
            *(cuda_build.launches[e] for e in COMPOSITES))


def device_busy_share(trace_path: str) -> dict:
    """From a torch.profiler Chrome trace: the composite kernels' events, and
    the share of the traced window (first to last event of any kind) in
    which the device ran a kernel, a copy or a fill (the union of their
    intervals)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    busy, end = 0.0, lo
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {
        "window_ms": (hi - lo) / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / (hi - lo),
        "device_events": len(device),
        "kernel_events": len(kernels),
        "kernel_ms": sum(float(e.get("dur", 0)) for e in kernels) / 1e3,
        "composite_fwd_kernels": sum("composite_fwd_kernel" in e["name"] for e in kernels),
        "composite_bwd_kernels": sum("composite_bwd_kernel" in e["name"] for e in kernels),
    }


def viewer_message(cam, train: bool = True) -> dict:
    """The SIBR viewer's request for one frame of `cam` (a port Camera):
    its matrices row-major in glm's convention (the transposes)."""
    return {
        "resolution_x": cam.width, "resolution_y": cam.height, "train": train,
        "fov_x": 2 * float(np.arctan(float(cam.tanfovx))),
        "fov_y": 2 * float(np.arctan(float(cam.tanfovy))),
        "z_near": float(cam.znear), "z_far": float(cam.zfar), "shs_python": False,
        "rot_scale_python": False, "keep_alive": True, "scaling_modifier": 1.0,
        "view_matrix": cam.world_view.cpu().numpy().T.reshape(-1).astype(float).tolist(),
        "view_projection_matrix": cam.full_proj.cpu().numpy().T.reshape(-1).astype(float).tolist(),
    }


def gui_viewer(port: int, message: dict, n_bytes: int, got: dict):
    """A viewer thread: connect (the trainer binds the port at its start),
    ask for one frame, read the frame and the source path into `got`, close.
    Every socket operation has a deadline."""
    import socket
    import struct
    import threading

    def run():
        deadline = time.monotonic() + 300
        while True:
            try:
                c = socket.create_connection(("127.0.0.1", port), timeout=120)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

        def recv(n):
            out = b""
            while len(out) < n:
                chunk = c.recv(n - len(out))
                if not chunk:
                    raise ConnectionError("the trainer closed the connection")
                out += chunk
            return out

        with c:
            payload = json.dumps(message).encode("utf-8")
            c.sendall(struct.pack("<I", len(payload)) + payload)
            got["frame"] = recv(n_bytes)
            (n,) = struct.unpack("<I", recv(4))
            got["path"] = recv(n).decode()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def eval_and_edit(ns, dev, last_test_psnr: float) -> dict:
    """Phase 7: LPIPS on the card; apps.render --skip_train + apps.metrics and
    apps.full_eval; apps.train with --detect_anomaly, --profile_steps and
    --port; apps.render_animated, apps.render_mesh_morph and the pseudomesh
    pipeline. Returns the launch counts of each path ({"fwd": ..., "bwd":
    ...}) and the phase's numbers."""
    import socket

    import torch

    from gaussian_mesh_splatting_tpu_torch.apps import full_eval as full_eval_app
    from gaussian_mesh_splatting_tpu_torch.apps import metrics as metrics_app
    from gaussian_mesh_splatting_tpu_torch.apps import pseudomesh as pseudomesh_app
    from gaussian_mesh_splatting_tpu_torch.apps import render as render_app
    from gaussian_mesh_splatting_tpu_torch.apps import render_animated as animated_app
    from gaussian_mesh_splatting_tpu_torch.apps import render_mesh_morph as morph_app
    from gaussian_mesh_splatting_tpu_torch.apps import train as train_app
    from gaussian_mesh_splatting_tpu_torch.apps.network_gui import NetworkGUI
    from gaussian_mesh_splatting_tpu_torch.io.obj import load_obj, save_obj
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.ops import lpips as lpips_mod
    from gaussian_mesh_splatting_tpu_torch.renderer import render

    fwd, bwd, out = {}, {}, {}
    mesh_argv = ["--gs_type", "gs_mesh", "-s", ns.data_dir, "--num_splats", str(NUM_SPLATS),
                 "--sh_degree", str(SH_DEGREE), "--white_background", "--test_iterations", "-1"]

    # (a) LPIPS: VGG16-shaped weights from a seed, the scorer on the card
    # (with cuDNN's TF32 left on outside it) against the CPU
    weights = os.path.join(WORK, "lpips_synth.npz")
    np.savez(weights, **lpips_mod.synthetic_arrays(np.random.default_rng(LPIPS_SEED)))
    os.environ["GMS_LPIPS_WEIGHTS"] = weights
    a, b = (ns.scene.train_cameras[i][1] for i in (0, 1))
    params = {d: lpips_mod.load_params(device=d) for d in (dev, torch.device("cpu"))}
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            ga, gb = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
            card = float(lpips_mod.lpips(ga, gb, params[dev]))
            same = float(lpips_mod.lpips(ga, ga, params[dev]))
            cpu = float(lpips_mod.lpips(torch.as_tensor(a), torch.as_tensor(b),
                                        params[torch.device("cpu")]))
            lpips_ms = cuda_ms(lambda: lpips_mod.lpips(ga, gb, params[dev]), reps=5, warmup=1)
        tf32_restored = torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = False
    out["lpips"] = {"card": card, "cpu": cpu, "rel_diff": abs(card - cpu) / abs(cpu),
                    "identical_images": same, "ms_800x800": lpips_ms}
    log(f"[7a] LPIPS (VGG16, seeded weights; train views 0 and 1, 800x800): "
        f"{json.dumps(out['lpips'])}")
    if not (out["lpips"]["rel_diff"] <= 1e-4 and same == 0.0 and card > 0 and tf32_restored):
        raise SystemExit("LPIPS on the card disagrees with the CPU (1e-4 relative), scores "
                         "identical images above 0 or left cuDNN's TF32 switch changed")

    # (b) the trained gs_mesh model's test views, scored
    _, _, fwd["render_metrics"], bwd["render_metrics"] = counted(
        lambda: render_app.main(["-m", ns.train_dir, "--skip_train"]))
    expect_launches("apps.render --skip_train", fwd["render_metrics"], bwd["render_metrics"],
                    N_TEST, 0)
    _, metrics_s, f_m, b_m = counted(lambda: metrics_app.main(["-m", ns.train_dir]))
    with open(os.path.join(ns.train_dir, "results_gs_mesh.json")) as f:
        scores = json.load(f)[f"ours_{TRAIN_ITERS}"]["gs_mesh"]
    out["metrics"] = {**scores, "train_app_test_psnr": last_test_psnr, "seconds": metrics_s}
    log(f"[7b] apps.metrics on the gs_mesh model ({N_TEST} test views): "
        f"{json.dumps(out['metrics'])}")
    if not all(np.isfinite(scores[k]) for k in ("SSIM", "PSNR", "LPIPS")) or (f_m, b_m) != (0, 0):
        raise SystemExit("apps.metrics: SSIM, PSNR and LPIPS must be finite")
    if abs(scores["PSNR"] - last_test_psnr) > 0.5:
        raise SystemExit("apps.metrics' PSNR is over 0.5 dB from the train app's last test PSNR")

    # (c) apps.full_eval over a suite of symlinks to the gs_mesh dataset
    suite, eval_dir = os.path.join(WORK, "nerf_synthetic"), os.path.join(WORK, "full_eval")
    os.makedirs(suite)
    for name in full_eval_app.NERF_SYNTHETIC:
        os.symlink(ns.data_dir, os.path.join(suite, name))
    _, full_eval_s, fwd["full_eval"], bwd["full_eval"] = counted(lambda: full_eval_app.main(
        ["--gs_type", "gs_mesh", "-ns", suite, "-o", eval_dir,
         "--iterations", str(FULL_EVAL_ITERS)]))
    n_scenes = len(full_eval_app.NERF_SYNTHETIC)
    per_scene = {}
    for name in full_eval_app.NERF_SYNTHETIC:
        with open(os.path.join(eval_dir, name, "results_gs_mesh.json")) as f:
            per_scene[name] = json.load(f)[f"ours_{FULL_EVAL_ITERS}"]["gs_mesh"]
    out["full_eval"] = {"seconds": full_eval_s, "scenes": per_scene}
    log(f"[7c] apps.full_eval --gs_type gs_mesh, {n_scenes} scenes x {FULL_EVAL_ITERS} steps "
        f"in {full_eval_s:.1f} s: {json.dumps(per_scene)}")
    if not all(np.isfinite(v) for r in per_scene.values() for v in r.values()):
        raise SystemExit("apps.full_eval: a scene's scores are not finite")
    expect_launches("apps.full_eval", fwd["full_eval"], bwd["full_eval"],
                    n_scenes * (FULL_EVAL_ITERS + N_TEST), n_scenes * FULL_EVAL_ITERS)

    # (d) --detect_anomaly against a plain run of the same steps
    steps = {}
    for label, extra in (("plain", []), ("detect_anomaly", ["--detect_anomaly"])):
        res, _, step_ms, _, f_d, b_d = timed_train(
            [*mesh_argv, "-m", os.path.join(WORK, f"anomaly_{label}"),
             "--iterations", str(ANOMALY_ITERS), *extra])
        if (len(res.losses) != ANOMALY_ITERS or not np.isfinite(res.losses).all()
                or torch.is_anomaly_enabled()):
            raise SystemExit(f"apps.train {label}: not {ANOMALY_ITERS} finite losses, or "
                             "anomaly mode outlived the run")
        expect_launches(f"apps.train {label}", f_d, b_d, ANOMALY_ITERS, ANOMALY_ITERS)
        fwd[f"{label}_train"], bwd[f"{label}_train"] = f_d, b_d
        steps[label] = statistics.median(step_ms[2:])
    out["detect_anomaly"] = {"step_ms_plain": steps["plain"],
                             "step_ms_detect_anomaly": steps["detect_anomaly"],
                             "ratio": steps["detect_anomaly"] / steps["plain"]}
    log(f"[7d] gs_mesh step, median of steps 3-{ANOMALY_ITERS} (host clock between "
        f"synchronizations): {json.dumps(out['detect_anomaly'])}")

    # (e) --profile_steps: a torch.profiler trace of steps 10..15
    lo, hi = PROFILE_STEPS
    profile_dir = os.path.join(WORK, "profile_model")
    _, _, fwd["profile_train"], bwd["profile_train"] = counted(lambda: train_app.main(
        [*mesh_argv, "-m", profile_dir, "--iterations", str(hi), "--profile_steps", f"{lo}:{hi}"]))
    expect_launches("apps.train --profile_steps", fwd["profile_train"], bwd["profile_train"],
                    hi, hi)
    out["profile"] = device_busy_share(os.path.join(profile_dir, "profile", "trace.json"))
    log(f"[7e] trace of steps {lo}..{hi} (torch.profiler, CUPTI): {json.dumps(out['profile'])}")
    n_traced = hi - lo + 1
    if (out["profile"]["composite_fwd_kernels"], out["profile"]["composite_bwd_kernels"]) != \
            (n_traced, n_traced):
        raise SystemExit(f"the trace must name both composite kernels, {n_traced} times each")

    # (f) the network GUI: one 800x800 frame with train=True; the loop's
    # first poll waits for the viewer thread (up to 120 s)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = {}
    viewer = gui_viewer(port, viewer_message(ns.scene.test_cameras[0][0]), SIZE * SIZE * 3, got)
    real_try_connect, polls = NetworkGUI.try_connect, []

    def first_poll_waits(self, timeout=0.0):
        polls.append(timeout)
        return real_try_connect(self, 120.0 if len(polls) == 1 else timeout)

    NetworkGUI.try_connect = first_poll_waits
    try:
        _, _, fwd["gui_train"], bwd["gui_train"] = counted(lambda: train_app.main(
            [*mesh_argv, "-m", os.path.join(WORK, "gui_model"), "--iterations", str(GUI_ITERS),
             "--port", str(port)]))
    finally:
        NetworkGUI.try_connect = real_try_connect
    viewer.join(timeout=120)
    frame = np.frombuffer(got.get("frame", b""), np.uint8)
    log(f"[7f] apps.train --port {port}: {frame.size} frame bytes (std {frame.std():.2f}), "
        f"source path {got.get('path')!r}")
    if (viewer.is_alive() or frame.size != SIZE * SIZE * 3 or frame.std() < 1.0
            or got.get("path") != ns.data_dir):
        raise SystemExit("the GUI viewer did not get its 800x800 frame and the source path")
    expect_launches("apps.train --port", fwd["gui_train"], bwd["gui_train"], GUI_ITERS + 1,
                    GUI_ITERS)

    # (g) the mesh animated and morphed; frame 0 (t = 0) is apps.render's view
    ref = read_png(os.path.join(ns.train_dir, "test", f"ours_{TRAIN_ITERS}", "renders_gs_mesh",
                                "00000.png"))
    v, f = load_obj(os.path.join(ns.data_dir, "mesh.obj"))
    target = os.path.join(WORK, "morph_target.obj")
    save_obj(target, v + np.array([0.2, 0.0, 0.1], np.float32), f)
    out["edit"] = {}
    for key, app, argv, frames, sub in (
            ("render_animated", animated_app, ["--deform", "fly"], ANIMATED_FRAMES, "animated_fly"),
            ("render_mesh_morph", morph_app, ["--target_mesh", target], MORPH_FRAMES,
             "mesh_morph")):
        _, wall, fwd[key], bwd[key] = counted(lambda: app.main(
            ["-m", ns.train_dir, *argv, "--frames", str(frames)]))
        expect_launches(f"apps.{key}", fwd[key], bwd[key], frames, 0)
        imgs = [read_png(os.path.join(ns.train_dir, sub, f"{i:05d}.png")) for i in range(frames)]
        diff0 = int(np.abs(imgs[0] - ref).max())
        moved = int(max(np.abs(img - imgs[0]).max() for img in imgs[1:]))
        out["edit"][key] = {"frames": frames, "app_ms_per_frame": 1e3 * wall / frames,
                            "frame0_vs_render_max_diff_255": diff0, "max_move_255": moved}
        log(f"[7g] apps.{key} (wall, start-up included): {json.dumps(out['edit'][key])}")
        if diff0 > 1 or moved == 0:
            raise SystemExit(f"apps.{key}: frame 0 must equal apps.render's view within 1/255 "
                             "and a later frame must differ")
    # the animation's frame loop alone (the app's own, start-up excluded) and
    # the render inside it (to_bag from the deformed faces + render, CUDA events)
    cfg, state, scene = animated_app.load_mesh_model(ns.train_dir, -1, dev)
    cam = scene.test_cameras[0][0]
    verts = state["params"]["vertices"].detach().cpu().numpy()
    frames = [animated_app.transform_fly(verts, i / (ANIMATED_FRAMES - 1))
              for i in range(ANIMATED_FRAMES)]
    _, loop_s, _, _ = counted(lambda: animated_app.render_frames(
        os.path.join(WORK, "frame_loop"), frames, cfg, state, cam, dev))
    faces = state["consts"]["faces"].long()
    tris = torch.as_tensor(frames[1], device=dev)[faces]
    with torch.no_grad():
        render_ms = cuda_ms(lambda: render(mesh_model.to_bag(state, triangles=tris), cam,
                                           torch.ones(3, device=dev), sh_degree=SH_DEGREE),
                            reps=10)
    out["edit"]["frame_loop"] = {"ms_per_frame": 1e3 * loop_s / ANIMATED_FRAMES,
                                 "render_ms": render_ms}
    log(f"[7g] render_animated's frame loop, 800x800 (to_bag, render, copy to the host, PNG): "
        f"{json.dumps(out['edit']['frame_loop'])}")

    # (h) the pseudomesh pipeline on the gs_flat snapshot
    flat = ns.flat_train_dir
    tri_path = os.path.join(flat, "pseudomesh", "triangles.npz")
    dummy, edited = os.path.join(WORK, "pm_dummy.obj"), os.path.join(WORK, "pm_edited.obj")
    moved_soup = os.path.join(WORK, "pm_retargeted.npz")
    t0 = time.perf_counter()
    pseudomesh_app.main(["save", "-m", flat, "--sh_degree", str(SH_DEGREE)])
    pseudomesh_app.main(["dummy", "--triangles", tri_path, "--output", dummy,
                         "--alpha", str(DUMMY_ALPHA)])
    dv, df = load_obj(dummy)
    save_obj(edited, dv + np.array([0.1, 0.0, 0.0], np.float32), df)
    pseudomesh_app.main(["retarget", "--triangles", tri_path, "--estimated_mesh", dummy,
                         "--edited_mesh", edited, "--output", moved_soup])
    host_s = time.perf_counter() - t0
    tris, tris2 = np.load(tri_path)["triangles"], np.load(moved_soup)["triangles"]
    shift = float(np.median((tris2 - tris)[..., 0]))
    _, _, f_r, b_r = counted(lambda: pseudomesh_app.main(
        ["render", "-m", flat, "--triangles", moved_soup]))
    _, anim_s, f_a, b_a = counted(lambda: pseudomesh_app.main(
        ["animate", "-m", flat, "--frames", str(SOUP_FRAMES)]))
    fwd["pseudomesh"], bwd["pseudomesh"] = f_r + f_a, b_r + b_a
    for sub, n in (("renders_soup", N_TEST), ("soup_animated", SOUP_FRAMES)):
        names = sorted(os.listdir(os.path.join(flat, sub)))
        if names != [f"{i:05d}.png" for i in range(n)]:
            raise SystemExit(f"pseudomesh: expected {n} PNGs in {sub}, got {names}")
        for name in names:
            read_png(os.path.join(flat, sub, name))
    out["pseudomesh"] = {"triangles": int(tris.shape[0]), "dummy_vertices": int(dv.shape[0]),
                         "dummy_faces": int(df.shape[0]), "median_x_shift": shift,
                         "save_dummy_retarget_s": host_s,
                         "animate_app_ms_per_frame": 1e3 * anim_s / SOUP_FRAMES}
    log(f"[7h] pseudomesh save -> dummy -> retarget -> render, animate: "
        f"{json.dumps(out['pseudomesh'])}")
    if not (len(df) > 0 and abs(shift - 0.1) < 1e-3):
        raise SystemExit("pseudomesh: the dummy mesh has no faces or the retarget did not move "
                         "the soup with its mesh")
    expect_launches("pseudomesh render + animate", fwd["pseudomesh"], bwd["pseudomesh"],
                    N_TEST + SOUP_FRAMES, 0)
    return {"fwd": fwd, "bwd": bwd, **out}


# ---- phase 8: the parallel modes (spawned ranks on the one card) and io/native

@functools.lru_cache(maxsize=None)
def rank_scene(dev):
    """What a phase-8 rank loads, as apps.train would: the gs_mesh dataset
    (cameras, GT on the card), the fresh student's state and the seed-42
    teacher's bag (the render path's)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    scene = Scene(os.path.join(WORK, "scene"), "gs_mesh", eval=True, num_splats=NUM_SPLATS,
                  shuffle=False, device=dev)
    init = scene.init_model_state(mesh_model, SH_DEGREE)
    with torch.no_grad():
        teacher = mesh_model.to_bag(randomize_state(init, seed=42))
    gts = [torch.as_tensor(g, device=dev) for _, g in scene.train_cameras]
    return scene, init, teacher, gts


def params_checksum(params: dict) -> int:
    """The params' bits summed as int64 words, position-weighted: equal on
    two ranks when their params are bit-identical (up to collisions)."""
    import torch

    words = torch.cat([p.detach().reshape(-1).view(torch.int32).to(torch.int64)
                       for p in params.values()])
    weights = torch.arange(1, words.numel() + 1, device=words.device) % 65521
    return int((words * weights).sum())


def p8_render(rank, world, dev):
    """(a), (b): the teacher's view 0 row-sharded and Gaussian-sharded
    against the unsharded render on this rank; B1 launches per render; the
    renders' times (CUDA events, median of 5)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda
    from gaussian_mesh_splatting_tpu_torch.parallel import (
        create_mesh, render_gaussian_sharded, render_row_sharded)

    scene, _, teacher, _ = rank_scene(dev)
    cam, bg, mesh = scene.train_cameras[0][0], torch.ones(3, device=dev), create_mesh()
    out = {}
    with torch.no_grad():
        def full():
            return rasterize_cuda(teacher.xyz, teacher.scaling, teacher.rotation,
                                  teacher.opacity, cam, bg=bg, shs=teacher.shs,
                                  sh_degree=SH_DEGREE, alive=teacher.alive)

        ref = full()
        out["saturated_pixels"] = int(((1.0 - ref.alpha) <= SATURATED_T).sum())
        out["unsharded_ms"] = cuda_ms(full, reps=5)
        for shard, fn in (("rows", render_row_sharded), ("gaussians", render_gaussian_sharded)):
            def sharded(fn=fn):
                return fn(teacher, cam, bg, mesh, sh_degree=SH_DEGREE)

            cuda_build.launches.clear()
            torch.cuda.synchronize()
            img = sharded()
            torch.cuda.synchronize()
            out[shard] = {"bit_equal": bool(torch.equal(img, ref.image)),
                          "max_abs_err": float((img - ref.image).abs().max()),
                          "launches": tuple(cuda_build.launches[e] for e in COMPOSITES),
                          "ms": cuda_ms(sharded, reps=5)}
    return out


def p8_steps(rank, world, dev, *, mode):
    """(c)-(g): PAR_STEPS steps of `mode` from the fresh student: the first
    step's loss, statistics and (rank 0) gradients; the other steps' times
    (CUDA events); the launches of all; the losses; every rank's params
    checksum. mode: data (rank r takes camera r), rows / gaussians (camera
    0), composed ((world / 2) x 2 mesh, Gaussians sharded; model group d
    takes camera d); later steps take the next cameras."""
    import torch
    import torch.distributed as dist

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.parallel import (
        create_mesh, create_mesh2d, make_dp_train_step, make_sharded_train_step)
    from gaussian_mesh_splatting_tpu_torch.train import make_train_state, optimization_config

    scene, init, _, gts = rank_scene(dev)
    cfg = optimization_config("gs_mesh")
    state = make_train_state(init, cfg, scene.cameras_extent)
    if mode == "data":
        step, pick = make_dp_train_step(mesh_model, cfg, SH_DEGREE, create_mesh()), rank
    elif mode == "composed":
        mesh = create_mesh2d(world // 2, 2)
        step = make_sharded_train_step(mesh_model, cfg, SH_DEGREE, mesh, shard="gaussians",
                                       model_axis="model", data_axis="data")
        pick = mesh.get_local_rank("data")
    else:
        step, pick = make_sharded_train_step(mesh_model, cfg, SH_DEGREE, create_mesh(),
                                             shard=mode), 0
    cams, bg = scene.train_cameras, torch.ones(3, device=dev)
    cuda_build.launches.clear()
    _, metrics = step(state, cams[pick][0], gts[pick], bg)
    out = {"first_loss": float(metrics["loss"]),
           "stats": {k: getattr(state.stats, k).cpu().clone()
                     for k in ("grad_accum", "denom", "max_radii")},
           "losses": [float(metrics["loss"])], "step_ms": []}
    if rank == 0:
        out["grads"] = {k: p.grad.cpu().clone() for k, p in state.params.items()}
    for i in range(1, PAR_STEPS):
        c = (pick + i) % len(cams)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, metrics = step(state, cams[c][0], gts[c], bg)
        end.record()
        end.synchronize()
        out["step_ms"].append(start.elapsed_time(end))
        out["losses"].append(float(metrics["loss"]))
    out["launches"] = tuple(cuda_build.launches[e] for e in COMPOSITES)
    sums = [None] * world
    dist.all_gather_object(sums, params_checksum(state.params))
    out["checksums"] = sums
    return out


def p8_app(rank, world, dev, *, flag, model_dir):
    """(f): apps.train.main at world 2 (the group is up: the app joins it) for
    PAR_STEPS steps of a parallel mode: its losses, launches and a checksum
    of its final params on every rank."""
    import torch.distributed as dist

    from gaussian_mesh_splatting_tpu_torch.apps import train as train_app
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

    cuda_build.launches.clear()
    res = train_app.main(["--gs_type", "gs_mesh", "-s", os.path.join(WORK, "scene"),
                          "-m", model_dir, "--num_splats", str(NUM_SPLATS),
                          "--sh_degree", str(SH_DEGREE), "--white_background",
                          "--iterations", str(PAR_STEPS), "--test_iterations", "-1",
                          "--save_iterations", str(PAR_STEPS), *flag])
    sums = [None] * world
    dist.all_gather_object(sums, params_checksum(res.state.params))
    return {"losses": res.losses, "launches": tuple(cuda_build.launches[e] for e in COMPOSITES),
            "checksums": sums}


def p8_comm(rank, world, dev):
    """(g): the collectives alone, on the card's tensors over gloo (host
    clock, synchronised, median of 10): the gathers of a rows band and of a
    Gaussian slab's planes at 800x800, and the all-reduce of the gs_mesh
    step's gradients (params and mean2d_offset)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE
    from gaussian_mesh_splatting_tpu_torch.parallel import create_mesh
    from gaussian_mesh_splatting_tpu_torch.parallel.collectives import (
        all_reduce_flat, gather_portions)
    from gaussian_mesh_splatting_tpu_torch.parallel.row_sharded import band_tiles

    _, init, _, _ = rank_scene(dev)
    group = create_mesh().get_group()
    n_grad = sum(p.numel() for p in init["params"].values()) + 2 * init["alive"].shape[0]

    def host_ms(fn, reps=10):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    band = torch.rand((band_tiles(SIZE, world) * TILE, SIZE, 5), device=dev)
    slab = torch.rand((SIZE, SIZE, 5), device=dev)
    grads = [torch.rand((n_grad,), device=dev)]
    return {"gather_rows_band_ms": host_ms(lambda: gather_portions(band, group)),
            "rows_band_MB": band.numel() * 4 / 1e6,
            "gather_gaussian_slab_ms": host_ms(lambda: gather_portions(slab, group)),
            "gaussian_slab_MB": slab.numel() * 4 / 1e6,
            "all_reduce_grads_ms": host_ms(lambda: all_reduce_flat(grads, group)),
            "grads_MB": n_grad * 4 / 1e6}


def p8_scaling(rank, world, dev):
    """(g): multihost.measure_scaling of the DP step at widths 1 and 2."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.parallel import make_dp_train_step, multihost
    from gaussian_mesh_splatting_tpu_torch.train import make_train_state, optimization_config

    scene, init, _, gts = rank_scene(dev)
    cfg = optimization_config("gs_mesh")

    def builder(mesh):
        state = make_train_state(init, cfg, scene.cameras_extent)
        step = make_dp_train_step(mesh_model, cfg, SH_DEGREE, mesh)
        return step, (state, scene.train_cameras[rank][0], gts[rank], torch.ones(3, device=dev))

    return multihost.measure_scaling(builder, widths=[1, world], iters=5)


PARALLEL_CASES = {"render": p8_render, "steps": p8_steps, "app": p8_app, "comm": p8_comm,
                  "scaling": p8_scaling}


def parallel_rank(rank: int, world: int, out_dir: str, cases: dict, backend: str) -> None:
    """One spawned rank of phase 8: join the `backend` group (file store
    under `out_dir`) on cuda:0, run `cases` ({key: (case, kwargs)}) in
    order, save the results and the backend of the mesh's group to
    out_dir/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from gaussian_mesh_splatting_tpu_torch.parallel import create_mesh, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"file://{os.path.join(out_dir, 'store')}", world_size=world,
                         rank=rank, backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    results = {"backend": dist.get_backend(create_mesh().get_group())}
    for key, (name, kw) in cases.items():
        t0 = time.perf_counter()
        results[key] = PARALLEL_CASES[name](rank, world, dev, **kw)
        if rank == 0:
            log(f"    [8] rank 0: {key} in {time.perf_counter() - t0:.1f} s")
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn_ranks(cases: dict, world: int, name: str, timeout: float = 600.0,
                backend: str = "gloo") -> list:
    """Run `cases` on `world` spawned ranks sharing the card; returns each
    rank's results. A rank that fails ends the others and the script."""
    import multiprocessing

    import torch

    out_dir = os.path.join(WORK, "parallel", name)
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=parallel_rank, args=(r, world, out_dir, cases, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise SystemExit(f"phase 8 ({name}): rank exit codes {codes}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]


def unsharded_references(ns, dev) -> list:
    """The unsharded step (train/loop.make_train_step) from the fresh student
    on train views 0 and 1: loss, gradients and statistics (on the host)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.train import (
        make_train_state, make_train_step, optimization_config)

    cfg = optimization_config("gs_mesh")
    refs = []
    for c in (0, 1):
        state = make_train_state(ns.scene.init_model_state(mesh_model, SH_DEGREE), cfg,
                                 ns.scene.cameras_extent)
        cam, gt = ns.scene.train_cameras[c]
        _, metrics = make_train_step(mesh_model, cfg, SH_DEGREE)(
            state, cam, torch.as_tensor(gt, device=dev), torch.ones(3, device=dev))
        refs.append({"loss": float(metrics["loss"]),
                     "grads": {k: p.grad.cpu().clone() for k, p in state.params.items()},
                     "stats": {k: getattr(state.stats, k).cpu().clone()
                               for k in ("grad_accum", "denom", "max_radii")}})
    return refs


def check_first_step(label: str, got: dict, grads: dict, refs: list) -> dict:
    """A parallel step's first step against the unsharded steps `refs` (one:
    that step; more: their camera mean, the statistics summed, radii max).
    Returns every param key's gradient error (x max|g| of that key's
    reference) and the key with the largest."""
    import torch

    want_loss = sum(r["loss"] for r in refs) / len(refs)
    want_grads = {k: sum(r["grads"][k] for r in refs) / len(refs) for k in refs[0]["grads"]}
    want = {"grad_accum": sum(r["stats"]["grad_accum"] for r in refs),
            "denom": sum(r["stats"]["denom"] for r in refs),
            "max_radii": torch.stack([r["stats"]["max_radii"] for r in refs]).amax(0)}
    grad_err = {}
    for k, g in want_grads.items():
        scale = float(g.abs().max())
        grad_err[k] = float((grads[k] - g).abs().max()) / max(scale, 1e-30)
        if not torch.isfinite(grads[k]).all() or grad_err[k] > PAR_GRAD_TOL:
            raise SystemExit(f"[8] {label}: gradient of {k} off by {grad_err[k]:.3g} x max|g|")
    stats_err = float((got["stats"]["grad_accum"] - want["grad_accum"]).abs().max())
    if stats_err > PAR_STATS_TOL or not torch.equal(got["stats"]["denom"], want["denom"]) \
            or not torch.equal(got["stats"]["max_radii"], want["max_radii"]):
        raise SystemExit(f"[8] {label}: statistics disagree (grad_accum {stats_err:.3g})")
    loss_err = abs(got["first_loss"] - want_loss) / want_loss
    if loss_err > 1e-4:
        raise SystemExit(f"[8] {label}: loss {got['first_loss']} vs {want_loss}")
    worst = max(grad_err, key=grad_err.get)
    return {"max_grad_err_rel": grad_err[worst], "worst_key": worst, "grad_err_rel": grad_err,
            "grad_accum_err": stats_err, "loss_rel_err": loss_err}


def check_run(label: str, ranks: list, want_launches: tuple[int, int]) -> None:
    """Every rank's params bit-identical (checksums), launches as expected,
    the loss falling (mean of the last 5 steps below the first 5)."""
    sums = ranks[0]["checksums"]
    if len(set(sums)) != 1:
        raise SystemExit(f"[8] {label}: params differ across ranks (checksums {sums})")
    for r, res in enumerate(ranks):
        if tuple(res["launches"]) != want_launches:
            raise SystemExit(f"[8] {label}: rank {r} launched {res['launches']}, "
                             f"expected {want_launches}")
    losses = ranks[0]["losses"]
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise SystemExit(f"[8] {label}: the loss does not fall ({losses})")


def parallel_and_native(ns, dev, card: str) -> dict:
    """Phase 8: the parallel modes with their ranks spawned on the one card
    over gloo ((a)-(g)); on NCCL, one rank's renders and steps of every mode
    against the unsharded ones, and a world-1 torchrun launch of apps.train
    (h); and io/native (i). Returns the launch counts of each path ({"fwd",
    "bwd"}) and the phase's numbers."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.io import native
    from gaussian_mesh_splatting_tpu_torch.io.ply import read_ply
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import composite_fwd_cuda
    from gaussian_mesh_splatting_tpu_torch.parallel.row_sharded import row_band
    from gaussian_mesh_splatting_tpu_torch.scene.colmap_loader import read_points3D_binary

    shutil.rmtree(os.path.join(WORK, "parallel"), ignore_errors=True)
    fwd, bwd, out = {}, {}, {}
    log(f"[8] parallel modes: {PAR_WORLD} (and 4) ranks spawned as processes that share one "
        f"card ({card}) over gloo: times and efficiencies are of ranks sharing a card, not "
        "scaling figures")

    # the row bands' B1 alone, beside the whole image's (the cost of the
    # out-of-band tiles' empty blocks), on the teacher's view 0
    cam0 = ns.scene.train_cameras[0][0]
    with torch.no_grad():
        b1 = {}
        for label, band in [("whole", None)] + [
                (f"band{r}", row_band(SIZE, r, PAR_WORLD)) for r in range(PAR_WORLD)] + [
                ("no_tiles", (SIZE // 16, SIZE // 16))]:
            _, binning, args, layout = composite_inputs(ns.bag, cam0, SH_DEGREE, row_band=band)
            b1[label] = {"pairs": int(binning.pair_gaussian.shape[0]),
                         "queued_ms": cuda_ms_queued(
                             lambda: composite_fwd_cuda(*args, **layout), reps=20)}
    out["b1_bands"] = b1
    log(f"    B1 alone per row band, 800x800 (queued ms): {json.dumps(b1)}")

    refs = unsharded_references(ns, dev)
    cuda_build.launches.clear()  # the references' and the bands' launches are not a path's
    t0 = time.perf_counter()
    flags = {"data": ["--data_parallel"], "rows": ["--shard", "rows"],
             "gaussians": ["--shard", "gaussians"]}
    # in this order: the first steps' optimizer imports torch._dynamo (seconds
    # a process), which the ranks then do side by side
    cases = {"render": ("render", {}),
             **{f"steps_{m}": ("steps", {"mode": m}) for m in flags},
             **{f"app_{m}": ("app", {"flag": f, "model_dir": os.path.join(WORK, f"par_{m}")})
                for m, f in flags.items()},
             "comm": ("comm", {}), "scaling": ("scaling", {})}
    two = spawn_ranks(cases, PAR_WORLD, "world2")
    log(f"    world 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    four = spawn_ranks({"steps_composed": ("steps", {"mode": "composed"})}, 4, "world4")
    log(f"    world 4: {time.perf_counter() - t0:.1f} s")

    # (a), (b)
    for r, res in enumerate(two):
        rend = res["render"]
        if not rend["rows"]["bit_equal"]:
            raise SystemExit(f"[8a] rank {r}: the row-sharded render is not bit-equal "
                             f"(max err {rend['rows']['max_abs_err']})")
        if not rend["gaussians"]["max_abs_err"] <= PAR_SATURATION_TOL:
            raise SystemExit(f"[8b] rank {r}: the Gaussian-sharded render is off by "
                             f"{rend['gaussians']['max_abs_err']}")
        for shard in ("rows", "gaussians"):
            if tuple(rend[shard]["launches"]) != (1, 0):
                raise SystemExit(f"[8] rank {r}: {shard} render launched {rend[shard]['launches']}")
    rend = two[0]["render"]
    out["render"] = rend
    log(f"[8a] rows render (world 2) bit-equal to the unsharded one on every rank; "
        f"[8b] gaussians render max abs err {rend['gaussians']['max_abs_err']:.3g} "
        f"(bound {PAR_SATURATION_TOL}), {rend['saturated_pixels']} saturated pixels "
        f"(T <= {SATURATED_T}); render ms (rank 0, median of 5): rows "
        f"{rend['rows']['ms']:.3f}, gaussians {rend['gaussians']['ms']:.3f}, unsharded "
        f"{rend['unsharded_ms']:.3f}")
    fwd["rows_render"], bwd["rows_render"] = rend["rows"]["launches"]
    fwd["gaussians_render"], bwd["gaussians_render"] = rend["gaussians"]["launches"]

    # (c), (d), (e): first steps; (f), (g): runs, times
    out["steps"] = {}
    for mode, ranks in [("rows", two), ("gaussians", two), ("data", two), ("composed", four)]:
        got = [res[f"steps_{mode}"] for res in ranks]
        refs_m = refs[:1] if mode in ("rows", "gaussians") else refs
        errs = check_first_step(mode, got[0], got[0]["grads"], refs_m)
        for r, g in enumerate(got[1:], 1):
            check_first_step(f"{mode} rank {r}", g, got[0]["grads"], refs_m)
        check_run(f"{mode} step", got, (PAR_STEPS, PAR_STEPS))
        fwd[f"{mode}_step"], bwd[f"{mode}_step"] = got[0]["launches"]
        out["steps"][mode] = {
            **errs, "median_step_ms": {r: statistics.median(g["step_ms"][:PAR_TIMED])
                                       for r, g in enumerate(got)},
            "first_loss": got[0]["losses"][0], "last_loss": got[0]["losses"][-1]}
        log(f"[8] {mode} step (world {len(got)}): {json.dumps(out['steps'][mode])}")
    for mode in flags:
        got = [res[f"app_{mode}"] for res in two]
        check_run(f"apps.train {flags[mode]}", got, (PAR_STEPS, PAR_STEPS))
        fwd[f"{mode}_train"], bwd[f"{mode}_train"] = got[0]["launches"]
        log(f"[8f] apps.train {' '.join(flags[mode])} at world 2: {PAR_STEPS} steps, loss "
            f"{got[0]['losses'][0]:.5f} -> {got[0]['losses'][-1]:.5f}, params bit-identical "
            f"on both ranks, launches per rank {got[0]['launches']}")
    out["comm"], out["scaling"] = two[0]["comm"], two[0]["scaling"]
    log(f"[8g] collectives over gloo, cuda:0 tensors (ms): {json.dumps(out['comm'])}")
    log(f"[8g] measure_scaling, DP step (two ranks share one card: not a scaling figure): "
        f"{json.dumps(out['scaling'])}")

    # (h) NCCL: one card holds one NCCL rank, so the collectives run on NCCL
    # in a group of one: the renders and each mode's steps, held against the
    # unsharded ones as (a)-(d) are; then a world-1 torchrun launch of
    # apps.train (which trains a group of one as a single device does)
    t0 = time.perf_counter()
    modes = ("rows", "gaussians", "data")
    (one,) = spawn_ranks({"render": ("render", {}),
                          **{f"steps_{m}": ("steps", {"mode": m}) for m in modes}},
                         1, "nccl_world1", backend="nccl")
    if one["backend"] != "nccl":
        raise SystemExit(f"[8h] the world-1 mesh's group runs {one['backend']}, not nccl")
    if not one["render"]["rows"]["bit_equal"] \
            or not one["render"]["gaussians"]["max_abs_err"] <= PAR_SATURATION_TOL:
        raise SystemExit(f"[8h] NCCL renders disagree: {one['render']}")
    out["nccl_steps"] = {}
    for mode in modes:
        got = one[f"steps_{mode}"]
        out["nccl_steps"][mode] = check_first_step(f"nccl {mode}", got, got["grads"], refs[:1])
        check_run(f"nccl {mode} step", [got], (PAR_STEPS, PAR_STEPS))
        fwd[f"nccl_{mode}_step"], bwd[f"nccl_{mode}_step"] = got["launches"]
    out["nccl_s"] = time.perf_counter() - t0
    log(f"[8h] NCCL, one rank: rows render bit-equal, gaussians render max abs err "
        f"{one['render']['gaussians']['max_abs_err']:.3g}; {PAR_STEPS} steps of each mode, "
        f"first step vs make_train_step: {json.dumps(out['nccl_steps'])}; "
        f"{out['nccl_s']:.1f} s")
    for mode, errs in out["nccl_steps"].items():
        log(f"[8h] nccl {mode}: largest first-step gradient error on {errs['worst_key']} "
            f"({errs['max_grad_err_rel']:.3g} x max|g|)")
    t0 = time.perf_counter()
    tr_dir = os.path.join(WORK, "torchrun_model")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "gaussian_mesh_splatting_tpu_torch.apps.train", "--gs_type", "gs_mesh",
         "-s", ns.data_dir, "-m", tr_dir, "--num_splats", str(NUM_SPLATS),
         "--sh_degree", str(SH_DEGREE), "--white_background",
         "--iterations", str(TORCHRUN_ITERS), "--test_iterations", "-1", "--shard", "gaussians"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or "joined a process group of 1 (nccl)" not in proc.stdout \
            or not os.path.exists(os.path.join(tr_dir, "point_cloud",
                                               f"iteration_{TORCHRUN_ITERS}")):
        raise SystemExit(f"[8h] torchrun apps.train failed ({proc.returncode}):\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out["torchrun_s"] = time.perf_counter() - t0
    log(f"[8h] torchrun --nproc_per_node 1 apps.train --shard gaussians: joined a process group "
        f"of 1 (nccl) and trained it as a single device, {TORCHRUN_ITERS} steps, snapshot "
        f"written, {out['torchrun_s']:.1f} s")

    # (i) io/native against the numpy readers
    if native.fastio() is None:
        raise SystemExit("[8i] the fastio extension did not build")
    reads = {"points3D.bin": lambda: read_points3D_binary(
        os.path.join(ns.colmap_dir, "sparse", "0", "points3D.bin")),
        "points3d.ply": lambda: read_ply(os.path.join(ns.gs_data_dir, "points3d.ply"))}
    out["native"] = {}
    for name, read in reads.items():
        fast, fast_s = read(), []
        for _ in range(3):
            t1 = time.perf_counter()
            read()
            fast_s.append(time.perf_counter() - t1)
        real = native.fastio
        native.fastio = lambda: None
        try:
            slow, slow_s = read(), []
            for _ in range(3):
                t1 = time.perf_counter()
                read()
                slow_s.append(time.perf_counter() - t1)
        finally:
            native.fastio = real
        if isinstance(fast, dict):  # PLY columns by name
            if list(fast) != list(slow):
                raise SystemExit(f"[8i] fastio's {name} columns differ: {list(fast)}")
            fast, slow = list(fast.values()), list(slow.values())
        if not all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                   for a, b in zip(fast, slow)):
            raise SystemExit(f"[8i] fastio's {name} differs from the numpy reader's")
        out["native"][name] = {"fastio_ms": 1e3 * statistics.median(fast_s),
                               "numpy_ms": 1e3 * statistics.median(slow_s)}
    log(f"[8i] fastio equals the numpy readers byte for byte (host ms, median of 3): "
        f"{json.dumps(out['native'])}")
    return {"fwd": fwd, "bwd": bwd, **out}


# ---- phase 12: the projection kernels (csrc/preprocess.cu) ------------------

PROJECT_PLAIN_TOL = 1e-7  # x max|g| per leaf, every row: the VJP kernel against its plain version
PROJECT_GRAD_TOL = 1e-5  # x max|g|: rows of the VJP kernel this far from float32 autograd are counted
PROJECT_STEPS = 5  # training steps a path, for the launch counts
PROJECT_SH_SWEEP = (0, 1, 2, 4)  # the other SH degrees, on the gs_mesh input
LEAVES = ("means3d", "scales", "rotations", "opacities", "shs")


def bit_mismatches(a, b) -> int:
    """Entries of two same-shaped tensors whose bits differ (NaN meets NaN)."""
    import torch

    a, b = a.reshape(b.shape).contiguous(), b.contiguous()
    if a.dtype == torch.bool:
        return int((a != b).sum())
    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def projection_bytes(n: int, coeffs: int) -> dict:
    """Bytes the projection kernels must move at n Gaussians, each read or
    written once: forward, the five inputs (SH: the coefficients used), the
    mean2d offset and alive in, its nine outputs out; backward, the five
    inputs and five cotangents (10 floats) in, five gradient rows out (the
    shs gradient whole, 16 coefficients)."""
    inputs = 4 * (3 + 3 + 4 + 1 + 3 * coeffs)
    fwd = n * (inputs + 4 * 2 + 1 + 4 * (2 + 1 + 3 + 1 + 3 + 1 + 2) + 1)
    bwd = n * (inputs + 4 * 10 + 4 * (3 + 3 + 4 + 1 + 3 * 16))
    return {"fwd_bytes": fwd, "bwd_bytes": bwd}


def loss_cotangents(proj, cam, gt, bg) -> tuple:
    """The cotangents a training step hands the projection: the photometric
    loss against `gt` differentiated through B2 to the projected mean2d,
    depth, conic, opacity and colour."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops import rasterize_cuda as rc
    from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
    from gaussian_mesh_splatting_tpu_torch.train.loss import photometric_loss

    leaves = [t.detach().clone().requires_grad_() for t in
              (proj.mean2d, proj.depth, proj.conic, proj.opacity, proj.color)]
    binning = bin_gaussians(proj, tile_h=rc.TILE, tile_w=rc.TILE,
                            n_tiles_y=-(-cam.height // rc.TILE), n_tiles_x=-(-cam.width // rc.TILE))
    planes, _ = rc.composite(leaves[0], leaves[2], leaves[3], leaves[4], leaves[1], binning,
                             cam.height, cam.width)
    image = planes[:3].permute(1, 2, 0) + planes[3][..., None] * bg
    return torch.autograd.grad(photometric_loss(image, gt, 0.2)[0], leaves)


def vjp_errors(inputs, cam, aa: bool, mode: str, cots, sh_degree: int) -> dict:
    """Per leaf, in units of its max|g| (of the call's largest gradient entry
    where the leaf's is 0), the largest distance over rows: the VJP kernel
    from its plain version `preprocess_bwd_plain` on the card ("vs_plain"),
    from float32 autograd of the chain ("kernel") and from float64 autograd
    ("kernel_vs_f64"), float32 autograd from float64 ("autograd_vs_f64");
    the rows where the kernel is more than PROJECT_GRAD_TOL from float32
    autograd ("rows_past_autograd"), and the entries whose finiteness
    differs between the kernel and each of autograd and the plain version."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.projection import (
        preprocess, preprocess_bwd_plain, project_bwd_cuda)

    def autograd(dtype):
        leaves = [t.detach().to(dtype).requires_grad_() for t in inputs]
        proj = preprocess(*leaves[:4], cam, shs=leaves[4], sh_degree=sh_degree,
                          antialiasing=aa, radius_mode=mode)
        return torch.autograd.grad((proj.mean2d, proj.depth, proj.conic, proj.opacity,
                                    proj.color), leaves, tuple(c.to(dtype) for c in cots))

    ref32, ref64 = autograd(torch.float32), autograd(torch.float64)
    kern = project_bwd_cuda(*inputs, cam, cots, sh_degree=sh_degree, antialiasing=aa)
    plain = preprocess_bwd_plain(*inputs, cam, cots, sh_degree=sh_degree, antialiasing=aa)

    def largest(g):
        return float(g[torch.isfinite(g)].abs().max())

    # a leaf whose gradient is 0 throughout (the rotations of isotropic
    # Gaussians) is measured against the call's largest gradient entry
    floor = max(largest(r) for r in ref64)

    def rows(a, b):
        """Each row's largest |a - b| over the entries finite in both."""
        fin = torch.isfinite(a) & torch.isfinite(b)
        err = torch.where(fin, a.double() - b.double(), 0.0).abs()
        return err.reshape(err.shape[0], -1).amax(dim=1)

    out = {}
    for name, k, p, r, r64 in zip(LEAVES, kern, plain, ref32, ref64):
        scale = largest(r64) or floor
        mine = rows(k, r) / scale
        out[name] = {
            "vs_plain": float(rows(k, p).max()) / scale,
            "kernel": float(mine.max()),
            "kernel_vs_f64": float(rows(k, r64).max()) / scale,
            "autograd_vs_f64": float(rows(r, r64).max()) / scale,
            "rows_past_autograd": int((mine > PROJECT_GRAD_TOL).sum()),
            "nonfinite_mismatches": int((torch.isfinite(k) != torch.isfinite(r)).sum()),
            "nonfinite_vs_plain": int((torch.isfinite(k) != torch.isfinite(p)).sum()),
        }
    return out


def check_projection(label: str, bag, cam, gt, bg, dev, time_it: bool,
                     sh_degree: int = SH_DEGREE, shs=None) -> dict:
    """The projection kernels against the chain on one bag and camera (SH
    from `shs`, else the bag's): the forward (through
    `rasterize_cuda.project`, as the render path calls it) bit-equal to
    `preprocess` in all nine outputs, and the VJP kernel per leaf, in both
    radius modes with antialiasing off and on, under a seeded mean2d offset
    and the bag's alive mask. The VJP on two sets of cotangents, the
    training step's own (`loss_cotangents`) and seeded normal ones on every
    row (degenerate Gaussians included), each leaf (`vjp_errors`) within
    PROJECT_PLAIN_TOL x max|g| of its plain version on every row, with the
    same non-finite entries as it and as float32 autograd. Its distances
    from autograd of the chain in float32 and float64 are reported: two
    float32 evaluations of one derivative in different orders, they part
    by up to 4.3e-5 x max|g| on rows of gs_flame's scales, and by up to
    0.35 on degenerate edge-on rows, where float32 autograd is itself that
    far from float64 (H100, PERF.md).
    With `time_it`, each kernel alone (median of 10, and queued) beside its
    bound and the chain's times."""
    import itertools

    import torch

    from gaussian_mesh_splatting_tpu_torch.ops import projection as P
    from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess, preprocess_bwd_plain

    gen = torch.Generator().manual_seed(19)
    n = bag.num_gaussians
    offset = (torch.randn(n, 2, generator=gen) * 1e-3).to(dev)
    shs = bag.shs if shs is None else shs
    inputs = (bag.xyz, bag.scaling, bag.rotation, bag.opacity, shs)
    res = {"gaussians": n, "sh_degree": sh_degree, "fwd_mismatches": {}, "vjp_loss": {},
           "vjp_seeded": {}}
    for mode, aa in itertools.product(("tight", "cuda"), (False, True)):
        case = f"{mode}{'_aa' if aa else ''}"
        kw = dict(shs=shs, sh_degree=sh_degree, antialiasing=aa, mean2d_offset=offset,
                  alive=bag.alive, radius_mode=mode)
        with torch.no_grad():
            want = preprocess(*inputs[:4], cam, **kw)
            got = P.project(*inputs[:4], cam, **kw)
        torch.cuda.synchronize()
        res["fwd_mismatches"][case] = {f: bit_mismatches(a, b)
                                       for f, a, b in zip(want._fields, want, got)}
        res["vjp_loss"][case] = vjp_errors(inputs, cam, aa, mode,
                                           loss_cotangents(want, cam, gt, bg), sh_degree)
        seeded = tuple(torch.randn(t.shape, generator=gen).to(dev) for t in
                       (want.mean2d, want.depth, want.conic, want.opacity, want.color))
        res["vjp_seeded"][case] = vjp_errors(inputs, cam, aa, mode, seeded, sh_degree)
    log(f"[12] {label} ({n} Gaussians, SH {sh_degree}): forward bits differing "
        f"{json.dumps(res['fwd_mismatches'])}")
    for key in ("vjp_loss", "vjp_seeded"):
        log(f"     {key} (x max|g|): {json.dumps(res[key])}")
    if any(v for case in res["fwd_mismatches"].values() for v in case.values()):
        raise SystemExit(f"{label}: the projection kernel is not bit-equal to preprocess")
    for key in ("vjp_loss", "vjp_seeded"):
        for case, errs in res[key].items():
            for name, e in errs.items():
                ok = e["vs_plain"] <= PROJECT_PLAIN_TOL
                if e["nonfinite_mismatches"] or e["nonfinite_vs_plain"] or not ok:
                    raise SystemExit(f"{label} {key} {case}: the VJP kernel's {name} gradient "
                                     f"is off: {e}")
    if time_it:
        kw = dict(sh_degree=sh_degree)
        cots = seeded
        fwd = lambda: P.project_fwd_cuda(*inputs, cam, mean2d_offset=offset,  # noqa: E731
                                         alive=bag.alive, **kw)
        bwd = lambda: P.project_bwd_cuda(*inputs, cam, cots, **kw)  # noqa: E731
        leaves = [t.detach().clone().requires_grad_() for t in inputs]

        def chain_fwd_bwd():
            p = preprocess(*leaves[:4], cam, shs=leaves[4], sh_degree=sh_degree,
                           mean2d_offset=offset, alive=bag.alive, radius_mode="tight")
            torch.autograd.grad((p.mean2d, p.depth, p.conic, p.opacity, p.color), leaves, cots)

        nbytes = projection_bytes(n, (sh_degree + 1) ** 2)
        fwd_bound, bwd_bound = (bytes_and_bound(0, nbytes[k]) for k in ("fwd_bytes", "bwd_bytes"))
        with torch.no_grad():
            res["times"] = {
                "fwd_ms": cuda_ms(fwd, reps=10), "fwd_queued_ms": cuda_ms_queued(fwd, reps=50),
                "fwd_bound_ms": fwd_bound["bound_ms"], "fwd_bytes": nbytes["fwd_bytes"],
                "bwd_ms": cuda_ms(bwd, reps=10), "bwd_queued_ms": cuda_ms_queued(bwd, reps=50),
                "bwd_bound_ms": bwd_bound["bound_ms"], "bwd_bytes": nbytes["bwd_bytes"],
                "chain_fwd_ms": cuda_ms(lambda: preprocess(
                    *inputs[:4], cam, shs=shs, sh_degree=sh_degree, mean2d_offset=offset,
                    alive=bag.alive, radius_mode="tight"), reps=10),
                "plain_bwd_ms": cuda_ms(lambda: preprocess_bwd_plain(
                    *inputs, cam, cots, sh_degree=sh_degree), reps=10),
            }
        res["times"]["chain_fwd_bwd_ms"] = cuda_ms(chain_fwd_bwd, reps=10)
        log(f"     times (ms; bound from the bytes at 3.35 TB/s): {json.dumps(res['times'])}")
    return res


def projection_kernels(ns, dev) -> dict:
    """Phase 12: the projection kernels on phase 2's inputs (the gs_mesh
    teacher at train view 0, the gs path's first step in its 400,000 rows,
    the gs_flame first step), the gs_mesh input again at the other SH
    degrees (PROJECT_SH_SWEEP; degree 4 with seeded coefficients past the
    bag's 16), then their launches per path: apps.render of
    the gs_mesh model and PROJECT_STEPS steps of each training path through
    `make_train_step`, under the port's tracer (`project_kernel` 1 a render
    or step, and the host syncs a step beside it). Returns the phase's
    numbers."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.apps import render as render_app
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.models import vanilla
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.train import (
        make_train_state, make_train_step, optimization_config)
    from gaussian_mesh_splatting_tpu_torch.utils.profiling import Recording, tracing

    white = torch.ones(3, device=dev)
    cam0, gt0 = ns.scene.train_cameras[0]
    gt0 = torch.as_tensor(gt0, device=dev)
    flame_cam, flame_gt = ns.flame_scene.train_cameras[0]
    out = {"cases": {
        "gs_mesh": check_projection("gs_mesh teacher 800x800", ns.bag, cam0, gt0, white, dev,
                                    True),
        "gs": check_projection(f"gs first step 800x800 ({GS_POINTS} alive)", ns.gs_bag, cam0,
                               gt0, white, dev, True),
        "gs_flame": check_projection("gs_flame first step 800x800", ns.flame_bag, flame_cam,
                                     torch.as_tensor(flame_gt, device=dev), white, dev, True),
    }}
    n = ns.bag.num_gaussians
    gen = torch.Generator().manual_seed(4)
    higher = (torch.randn(n, 25 - ns.bag.shs.shape[2], 3, generator=gen) * 0.1).to(dev)
    shs4 = torch.cat([ns.bag.shs.transpose(1, 2), higher], dim=1).transpose(1, 2)
    for degree in PROJECT_SH_SWEEP:
        out["cases"][f"gs_mesh_sh{degree}"] = check_projection(
            "gs_mesh teacher 800x800", ns.bag, cam0, gt0, white, dev, False, sh_degree=degree,
            shs=shs4 if degree > SH_DEGREE else None)

    def launches():
        return {e: cuda_build.launches[e] for e in ("project_fwd", "project_bwd", *COMPOSITES)}

    paths = {}
    cuda_build.launches.clear()
    render_app.main(["-m", ns.model_dir])
    torch.cuda.synchronize()
    n_views = N_TRAIN + N_TEST
    paths["render"] = {"views": n_views, **launches()}
    if paths["render"]["project_fwd"] != n_views or paths["render"]["project_bwd"] != 0:
        raise SystemExit(f"apps.render launched the projection kernels {paths['render']}")
    for gs_type, scene, model, model_state in (
            ("gs_mesh", ns.scene, mesh_model, ns.scene.init_model_state(mesh_model, SH_DEGREE)),
            ("gs", ns.gs_scene, vanilla,
             ns.gs_scene.init_model_state(vanilla, SH_DEGREE, capacity=GS_CAPACITY)),
            ("gs_flame", ns.flame_scene, ns.flame_model,
             ns.flame_scene.init_model_state(ns.flame_model, SH_DEGREE))):
        state = make_train_state(model_state, optimization_config(gs_type), scene.cameras_extent)
        step = make_train_step(model, optimization_config(gs_type), SH_DEGREE)
        rec = Recording(dev)
        cuda_build.launches.clear()
        with tracing(rec):
            for i in range(PROJECT_STEPS):
                cam, gt = scene.train_cameras[i % len(scene.train_cameras)]
                state, _ = step(state, cam, torch.as_tensor(gt, device=dev), white)
        torch.cuda.synchronize()
        totals = rec.totals()
        paths[f"{gs_type}_train"] = {
            "steps": PROJECT_STEPS, **launches(),
            "project_kernel_per_step": totals.get("project_kernel", 0) / PROJECT_STEPS,
            "host_syncs_per_step": totals.get("host_syncs", 0) / PROJECT_STEPS}
        got = paths[f"{gs_type}_train"]
        if (got["project_fwd"], got["project_bwd"], got["project_kernel_per_step"]) != (
                PROJECT_STEPS, PROJECT_STEPS, 1.0):
            raise SystemExit(f"{gs_type} steps launched the projection kernels {got}")
        del state
    out["paths"] = paths
    log(f"[12] launches per path: {json.dumps(paths)}")
    return out


def projection_line(phase12: dict) -> list:
    """The kernels line's entries of the projection kernels (phase 12): their
    launches per path, the forward's differing bits and the VJP's largest
    error against the chain, and per input the times beside the bound and
    the chain's."""
    entries = []
    for name, key, chain in (("project_fwd", "fwd", "chain_fwd_ms"),
                             ("project_bwd", "bwd", "chain_fwd_bwd_ms")):
        cases = phase12["cases"]
        timed = {case: c for case, c in cases.items() if "times" in c}
        if key == "fwd":
            quality = {"max_bits_differing": max(
                v for c in cases.values() for m in c["fwd_mismatches"].values()
                for v in m.values())}
        else:
            quality = {f"max_rel_err_{k}": max(
                e[field] for c in cases.values() for m in c[key2].values() for e in m.values())
                for k, key2, field in (("loss_vs_plain", "vjp_loss", "vs_plain"),
                                       ("seeded_vs_plain", "vjp_seeded", "vs_plain"),
                                       ("loss", "vjp_loss", "kernel"),
                                       ("seeded", "vjp_seeded", "kernel"),
                                       ("seeded_vs_f64", "vjp_seeded", "kernel_vs_f64"),
                                       ("seeded_autograd_vs_f64", "vjp_seeded",
                                        "autograd_vs_f64"))}
            quality["max_rows_past_autograd"] = max(
                e["rows_past_autograd"] for c in cases.values()
                for key2 in ("vjp_loss", "vjp_seeded") for m in c[key2].values()
                for e in m.values())
        entries.append({
            "name": name, "route": "cuda",
            "source": "gaussian_mesh_splatting_tpu_torch/csrc/preprocess.cu",
            "replaces": None,  # XLA fuses the JAX package's preprocess: no TPU kernel
            **{f"launches_{path}": v[name] for path, v in phase12["paths"].items()},
            **quality,
            **{f"{case}_{k}": c["times"][k2] for case, c in timed.items()
               for k, k2 in (("ms", f"{key}_ms"), ("queued_ms", f"{key}_queued_ms"),
                             ("bound_ms", f"{key}_bound_ms"), ("chain_ms", chain))},
        })
    return entries



# ---- phase 13: the loss kernels (csrc/loss.cu) -------------------------------

LOSS_LAMBDA = 0.2  # the training loss's lambda_dssim
LOSS_PLAIN_TOL = 1e-6  # x max|g|: L2 against `photometric_vjp_plain`
LOSS_REL_TOL = 1e-6  # total and l1 against the chain's, relative
LOSS_RAGGED = ((797, 803), (37, 53), (7, 9))  # ragged tiles, rows of 3W % 4 != 0; under the window
LOSS_STEPS = 5  # training steps a path, for the launch counts


def loss_bytes(h: int, w: int) -> dict:
    """Bytes the loss kernels must move over an (h, w, 3) float32 pair,
    each read or written once: L1 reads the two images and writes the three
    derivative maps; L2 reads the maps and the images and writes the
    gradient."""
    image = 4 * h * w * 3
    return {"fwd_bytes": 5 * image, "bwd_bytes": 6 * image}


def loss_pairs(shape, dev, seed: int) -> dict:
    """Seeded (H, W, 3) pairs in [0, 1]: "random", and "ties", where a third
    of the rows are white in both images and a third of the other entries
    of the target equal the prediction's (sgn(0) = 0 in the VJP)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    pred, gt = (torch.rand(*shape, 3, generator=gen) for _ in range(2))
    tied_pred, tied_gt = pred.clone(), gt.clone()
    tie = torch.rand(*shape, 3, generator=gen) < 1 / 3
    tied_gt[tie] = tied_pred[tie]
    tied_pred[: shape[0] // 3] = 1.0
    tied_gt[: shape[0] // 3] = 1.0
    return {"random": (pred.to(dev), gt.to(dev)), "ties": (tied_pred.to(dev), tied_gt.to(dev))}


def kernel_device_ms(fn, reps: int) -> dict:
    """Each CUDA kernel's device ms a call of `fn`, from torch.profiler
    (CUPTI) over `reps` calls after a warm-up, by kernel name."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = us * 1e-3 / reps
    return out


def check_loss(label: str, pred, gt, time_it: bool) -> dict:
    """The loss kernels against the chain on one image pair: L1's SSIM map
    bit-equal to `ssim_map`'s, `total` and `l1` within LOSS_REL_TOL of the
    chain's (`photometric_loss_chain`); L2 on the cotangents (g_total, none),
    (g_total, g_l1) and (none, g_l1) within LOSS_PLAIN_TOL x max|g| of
    `photometric_vjp_plain`, its distances from autograd of the chain in
    float32 and float64 reported; a second run of both kernels the same
    bits. With `time_it`, each kernel alone (median of 20, queued, and its
    kernels' device time from the profiler) beside its bound from the
    bytes, the chain's forward and forward + backward, the Function's
    forward + backward and the plain VJP."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops import ssim as S
    from gaussian_mesh_splatting_tpu_torch.train.loss import photometric_loss_chain

    lam = LOSS_LAMBDA
    h, w, _ = pred.shape
    runs = [S.photometric_fwd_cuda(pred, gt, lam, with_map=True) for _ in range(2)]
    total, l1, maps, smap = runs[0]
    with torch.no_grad():
        want_map = S.ssim_map(pred, gt)
        want_total, want_l1 = photometric_loss_chain(pred, gt, lam)
    res = {"shape": [h, w], "map_bits_differing": bit_mismatches(smap, want_map),
           "total_rel_err": abs(float(total) - float(want_total)) / abs(float(want_total)),
           "l1_rel_err": abs(float(l1) - float(want_l1)) / abs(float(want_l1)),
           "total": float(total), "l1": float(l1),
           "repeat_bits_differing": sum(bit_mismatches(a, b) for a, b in zip(*runs)),
           "vjp": {}}
    one = torch.ones((), device=pred.device)
    for case, cots in (("total", (one, None)), ("total_l1", (one, 0.37 * one)),
                       ("l1", (None, 0.37 * one))):
        grads = [S.photometric_bwd_cuda(pred, gt, maps, lam, *cots) for _ in range(2)]
        plain = S.photometric_vjp_plain(pred, gt, lam, *cots)

        def autograd(dtype):
            leaf = pred.detach().to(dtype).requires_grad_()
            outs = photometric_loss_chain(leaf, gt.to(dtype), lam)
            outs, cs = zip(*[(o, c.to(dtype)) for o, c in zip(outs, cots) if c is not None])
            return torch.autograd.grad(outs, leaf, cs)[0]

        ref32, ref64 = autograd(torch.float32), autograd(torch.float64)
        scale = float(ref64.abs().max())

        def err(a, b):
            return float((a.double() - b.double()).abs().max()) / scale

        res["vjp"][case] = {
            "vs_plain": err(grads[0], plain), "bits_vs_plain": bit_mismatches(grads[0], plain),
            "vs_autograd": err(grads[0], ref32), "vs_f64": err(grads[0], ref64),
            "autograd_vs_f64": err(ref32, ref64),
            "repeat_bits_differing": bit_mismatches(grads[0], grads[1])}
    log(f"[13] {label} {h}x{w}: {json.dumps(res)}")
    if res["map_bits_differing"] or res["repeat_bits_differing"]:
        raise SystemExit(f"{label}: L1's map is not bit-equal to the chain's, or not repeatable")
    if max(res["total_rel_err"], res["l1_rel_err"]) > LOSS_REL_TOL:
        raise SystemExit(f"{label}: L1's total or l1 is off the chain's: {res}")
    for case, e in res["vjp"].items():
        if e["vs_plain"] > LOSS_PLAIN_TOL or e["repeat_bits_differing"]:
            raise SystemExit(f"{label} {case}: L2 is off its plain version, or not repeatable: {e}")
    if time_it:
        nbytes = loss_bytes(h, w)
        fwd_bound, bwd_bound = (bytes_and_bound(0, nbytes[k]) for k in ("fwd_bytes", "bwd_bytes"))
        fwd = lambda: S.photometric_fwd_cuda(pred, gt, lam)  # noqa: E731
        bwd = lambda: S.photometric_bwd_cuda(pred, gt, maps, lam, one)  # noqa: E731
        leaf = pred.detach().clone().requires_grad_()
        with torch.no_grad():
            res["times"] = {
                "fwd_ms": cuda_ms(fwd, reps=20), "fwd_queued_ms": cuda_ms_queued(fwd, reps=100),
                "fwd_bound_ms": fwd_bound["bound_ms"], "fwd_bytes": nbytes["fwd_bytes"],
                "bwd_ms": cuda_ms(bwd, reps=20), "bwd_queued_ms": cuda_ms_queued(bwd, reps=100),
                "bwd_bound_ms": bwd_bound["bound_ms"], "bwd_bytes": nbytes["bwd_bytes"],
                "chain_fwd_ms": cuda_ms(lambda: photometric_loss_chain(pred, gt, lam), reps=10),
                "plain_bwd_ms": cuda_ms(lambda: S.photometric_vjp_plain(pred, gt, lam, one),
                                        reps=10),
            }
        res["times"]["chain_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            photometric_loss_chain(leaf, gt, lam)[0], leaf), reps=10)
        res["times"]["kernels_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            S.photometric_loss_cuda(leaf, gt, lam)[0], leaf), reps=20)
        device = {**kernel_device_ms(fwd, reps=50), **kernel_device_ms(bwd, reps=50)}
        res["times"]["device_ms"] = {k: v for k, v in device.items() if "loss_" in k}
        res["times"]["fwd_device_ms"] = sum(v for k, v in device.items()
                                            if "loss_fwd" in k or "loss_reduce" in k)
        res["times"]["bwd_device_ms"] = sum(v for k, v in device.items() if "loss_bwd" in k)
        log(f"     times (ms; bound from the bytes at 3.35 TB/s): {json.dumps(res['times'])}")
    return res


def loss_kernels(ns, dev) -> dict:
    """Phase 13: the loss kernels at 800x800 (a seeded pair, the same with
    white rows and tied entries, and the gs_mesh student's first render
    against its GT), timed, and at the LOSS_RAGGED sizes; then their launches
    on LOSS_STEPS steps of the gs_mesh and gs_flame training paths through
    `make_train_step`, under the port's tracer (`loss_kernel` 1 a step).
    Returns the phase's numbers."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.renderer import render
    from gaussian_mesh_splatting_tpu_torch.train import (
        make_train_state, make_train_step, optimization_config)
    from gaussian_mesh_splatting_tpu_torch.utils.profiling import Recording, tracing

    white = torch.ones(3, device=dev)
    cam0, gt0 = ns.scene.train_cameras[0]
    gt0 = torch.as_tensor(gt0, device=dev)
    with torch.no_grad():
        student = render(ns.student_bag, cam0, white, sh_degree=SH_DEGREE).image.contiguous()
    cases = {f"{SIZE}_{k}": check_loss(f"{SIZE}x{SIZE} {k}", *pair, True)
             for k, pair in loss_pairs((SIZE, SIZE), dev, 13).items()}
    cases["gs_mesh_student"] = check_loss("gs_mesh student render vs GT", student, gt0, True)
    for shape in LOSS_RAGGED:
        for k, pair in loss_pairs(shape, dev, shape[0]).items():
            cases[f"{shape[0]}x{shape[1]}_{k}"] = check_loss(k, *pair, False)

    paths = {}
    for gs_type, scene, model, model_state in (
            ("gs_mesh", ns.scene, mesh_model, ns.scene.init_model_state(mesh_model, SH_DEGREE)),
            ("gs_flame", ns.flame_scene, ns.flame_model,
             ns.flame_scene.init_model_state(ns.flame_model, SH_DEGREE))):
        state = make_train_state(model_state, optimization_config(gs_type), scene.cameras_extent)
        step = make_train_step(model, optimization_config(gs_type), SH_DEGREE)
        rec = Recording(dev)
        cuda_build.launches.clear()
        with tracing(rec):
            for i in range(LOSS_STEPS):
                cam, gt = scene.train_cameras[i % len(scene.train_cameras)]
                state, _ = step(state, cam, torch.as_tensor(gt, device=dev), white)
        torch.cuda.synchronize()
        got = paths[f"{gs_type}_train"] = {
            "steps": LOSS_STEPS, "loss_fwd": cuda_build.launches["loss_fwd"],
            "loss_bwd": cuda_build.launches["loss_bwd"],
            "loss_kernel_per_step": rec.totals().get("loss_kernel", 0) / LOSS_STEPS}
        if (got["loss_fwd"], got["loss_bwd"], got["loss_kernel_per_step"]) != (
                LOSS_STEPS, LOSS_STEPS, 1.0):
            raise SystemExit(f"{gs_type} steps launched the loss kernels {got}")
        del state
    log(f"[13] launches per path: {json.dumps(paths)}")
    return {"cases": cases, "paths": paths}


def loss_line(phase13: dict) -> list:
    """The kernels line's entries of the loss kernels (phase 13): their
    launches per path, L1's differing map bits and largest relative error
    of total and l1, L2's largest error against its plain version and
    autograd, and per timed input the times beside the bound and the
    chain's."""
    cases = phase13["cases"]
    timed = {case: c for case, c in cases.items() if "times" in c}
    entries = []
    for name, key, chain in (("loss_fwd", "fwd", "chain_fwd_ms"),
                             ("loss_bwd", "bwd", "chain_fwd_bwd_ms")):
        if key == "fwd":
            quality = {"max_map_bits_differing": max(c["map_bits_differing"]
                                                     for c in cases.values()),
                       "max_total_rel_err": max(c["total_rel_err"] for c in cases.values()),
                       "max_l1_rel_err": max(c["l1_rel_err"] for c in cases.values())}
        else:
            quality = {f"max_rel_err_{field}": max(e[field] for c in cases.values()
                                                   for e in c["vjp"].values())
                       for field in ("vs_plain", "vs_autograd", "vs_f64", "autograd_vs_f64")}
            quality["max_bits_vs_plain"] = max(e["bits_vs_plain"] for c in cases.values()
                                               for e in c["vjp"].values())
        entries.append({
            "name": name, "route": "cuda", "source": "gaussian_mesh_splatting_tpu_torch/csrc/loss.cu",
            "replaces": None,  # XLA fuses the JAX package's SSIM: no TPU kernel
            **{f"launches_{path}": v[name] for path, v in phase13["paths"].items()},
            **quality,
            **{f"{case}_{k}": c["times"][k2] for case, c in timed.items()
               for k, k2 in (("ms", f"{key}_ms"), ("queued_ms", f"{key}_queued_ms"),
                             ("device_ms", f"{key}_device_ms"), ("bound_ms", f"{key}_bound_ms"),
                             ("chain_ms", chain),
                             ("plain_ms", "chain_fwd_ms" if key == "fwd" else "plain_bwd_ms"))},
            **({f"{case}_kernels_fwd_bwd_ms": c["times"]["kernels_fwd_bwd_ms"]
                for case, c in timed.items()} if key == "bwd" else {}),
        })
    return entries

def bf16_line_keys(phase11: dict, kernel: str) -> dict:
    """A kernel's bf16 keys of the kernels line (phase 11): per input (no
    prefix: gs_mesh; "gs_", "flame_") the times on both tables in turns, the
    bf16 kernel's bound, its largest error against its plain version and
    that plain call's time (on gs_flame: the error against the kernel on the
    float32 table of the rounded attributes, no plain call) and its
    difference from the exact mode (B1: r, g, b, T; B2: max err / max|g|);
    the bf16 entry points' launches on (d)'s paths."""
    keys = {}
    for prefix, case in (("", "gs_mesh"), ("gs_", "gs"), ("flame_", "flame")):
        t = phase11["times"][case][kernel]
        chk = phase11[kernel][case]
        chk = chk if kernel == "fwd" else chk["bf16_bf16"]
        keys.update({
            f"{prefix}bf16_ms": t["bf16_ms"], f"{prefix}bf16_queued_ms": t["bf16_queued_ms"],
            f"{prefix}f32_ms_beside_bf16": t["f32_ms"],
            f"{prefix}f32_queued_ms_beside_bf16": t["f32_queued_ms"],
            f"{prefix}bf16_bound_ms": t["bound_ms"], f"{prefix}bf16_bound_by": t["bound_by"],
            f"{prefix}bf16_max_abs_err": chk["max_abs_err"],
            f"{prefix}bf16_plain_ms": chk.get("plain_ms"),
            f"{prefix}bf16_vs_f32_rel_err": chk["max_abs_diff_exact_rgbT" if kernel == "fwd"
                                                else "rel_err_vs_exact"]})
    train = phase11["train"]
    if kernel == "fwd":
        keys.update(bf16_launches_train=train["bf16"]["launches"]["composite_fwd_bf16"],
                    bf16_launches_render=train["render"]["launches"]["composite_fwd_bf16"],
                    launches_train_f32_attrs_bf16_grads=train["f32_bf16"]["launches"][
                        "composite_fwd"])
    else:
        keys.update(bf16_launches_train=train["bf16"]["launches"]["composite_bwd_bf16"],
                    round_pairs_launches_train_f32_attrs_bf16_grads=train["f32_bf16"][
                        "launches"]["composite_bwd_round_pairs"])
    return keys


def main() -> int:
    import concurrent.futures

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 2
    from gaussian_mesh_splatting_tpu_torch import bench
    from gaussian_mesh_splatting_tpu_torch.apps import render as render_app
    from gaussian_mesh_splatting_tpu_torch.apps import render_flame as render_flame_app
    from gaussian_mesh_splatting_tpu_torch.apps import train as train_app
    from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.models import vanilla
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build, rasterize_cuda as rc

    launches = cuda_build.launches  # by entry name; cleared before each path
    from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians, tile_launch_order
    from gaussian_mesh_splatting_tpu_torch.ops.knn import knn_scale_init
    from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference
    from gaussian_mesh_splatting_tpu_torch.train import (
        densify_and_prune, make_train_state, optimization_config)

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
    kernel_names = ("composite_fwd", "composite_bwd", "preprocess", "loss")
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
        # the plain versions loop over the longest tile's pairs: at this
        # case's pair count a call takes seconds, so each is timed once
        gs_fwd = compare_composite(f"gs first step 800x800 ({GS_POINTS} alive of {GS_CAPACITY})",
                                   *cases["gs"], time_it=True, plain_reps=(1, 0))
        if gs_fwd["max_abs_err_rgbT"] != 0.0 or gs_fwd["max_abs_err_depth"] != 0.0:
            raise SystemExit("B1 is not bit-equal to its plain version on the gs case")
        flame_fwd = compare_composite(
            f"gs_flame first step 800x800 ({ns.flame_bag.num_gaussians} Gaussians)",
            *cases["flame"], time_it=True, plain_reps=(1, 0))
        if flame_fwd["max_abs_err_rgbT"] != 0.0 or flame_fwd["max_abs_err_depth"] != 0.0:
            raise SystemExit("B1 is not bit-equal to its plain version on the gs_flame case")
        fwd_walks = [full["walk"], gs_fwd["walk"], flame_fwd["walk"],
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
    gs_bwd = compare_composite_bwd(
        f"gs first step 800x800 ({GS_POINTS} alive of {GS_CAPACITY}, vs GT)", *cases["gs"], gt0,
        time_it=True, plain_reps=(1, 0), ops=gs_fwd["op_counts"])
    flame_gt0 = torch.as_tensor(ns.flame_scene.train_cameras[0][1], device=dev)
    flame_bwd = compare_composite_bwd(
        f"gs_flame first step 800x800 ({ns.flame_bag.num_gaussians} Gaussians, vs GT)",
        *cases["flame"], flame_gt0, time_it=True, plain_reps=(1, 0),
        ops=flame_fwd["op_counts"])
    compare_composite_bwd("gs_mesh 803x611", *cases["nonaligned"], random_teacher(611, 803), False)
    compare_composite_bwd("dense overlap 512x512", *cases["dense"], random_teacher(512, 512),
                          False)
    compare_composite_bwd("empty (all culled) 200x50", *cases["empty"], random_teacher(50, 200),
                          False)
    for key in ("tiles_ragged_over_two_batches", "tiles_with_idle_and_busy_warps"):
        if not any(walk[key] for walk in
                   fwd_walks + [full_bwd["walk"], gs_bwd["walk"], flame_bwd["walk"]]):
            raise SystemExit(f"no case has {key}: a path of the kernels went unchecked")
    grad_err = oracle_gradients(cam_small)
    log(f"  CUDA rasterizer gradients vs torch oracle autograd (96 Gaussians, 200x50): "
        f"max err / max|g| {grad_err:.3g}")
    log(f"    phase 2: {time.perf_counter() - t0:.1f} s")

    # ---- 3. the render path through the user's entry point -----------------
    log("[3] apps.render.main on the card")
    launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_app.main(["-m", model_dir])
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    render_launches = launches["composite_fwd"]
    render_bwd_launches = launches["composite_bwd"]
    n_views = N_TRAIN + N_TEST
    log(f"    {n_views} views in {app_s:.2f} s ({1e3 * app_s / n_views:.1f} ms per view, "
        f"scene load and PNG writes included); composite_fwd launches: {render_launches}, "
        f"composite_bwd launches: {render_bwd_launches}")
    if render_launches != n_views or render_bwd_launches != 0:
        raise SystemExit(f"expected {n_views} forward and 0 backward launches")
    from PIL import Image

    def check_pngs(model: str, it: int, gs_type: str = "gs_mesh",
                   views=(("train", N_TRAIN), ("test", N_TEST))) -> None:
        for split, n_cams in views:
            for i in range(n_cams):
                png = os.path.join(model, split, f"ours_{it}", f"renders_{gs_type}",
                                   f"{i:05d}.png")
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
    def train_run(label: str, argv: list[str], iters: int, n_evals: int, must_fall: float = 1.0):
        """apps.train.main(argv) with the launch counts set to 0 just before
        it; checks a finite loss that falls (the last 20 steps' mean below
        `must_fall` times the first 20's), a test PSNR that rises, B2 once per
        step, B1 once per step and eval view, and finite gradients at the
        last step. Returns (result, fwd launches, bwd launches)."""
        launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_app.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = launches["composite_fwd"], launches["composite_bwd"]
        first, last = float(np.mean(res.losses[:20])), float(np.mean(res.losses[-20:]))
        psnrs = [res.test_psnr[i] for i in sorted(res.test_psnr)]
        log(f"    {label}: {iters} steps in {wall:.2f} s ({1e3 * wall / iters:.1f} ms per step, "
            f"scene load, evals and snapshot included); mean loss first 20 {first:.5f}, "
            f"last 20 {last:.5f}; test PSNR {json.dumps(res.test_psnr)}; composite_fwd "
            f"launches {fwd}, composite_bwd launches {bwd}")
        if not np.isfinite(res.losses).all() or not last < must_fall * first:
            raise SystemExit(f"{label}: the training loss did not fall")
        if not psnrs[-1] > psnrs[0]:
            raise SystemExit(f"{label}: the test PSNR did not rise")
        if bwd != iters or fwd != iters + n_evals:
            raise SystemExit(f"{label}: expected {iters} backward and {iters + n_evals} "
                             "forward launches")
        if not all(bool(torch.isfinite(t.grad).all()) for v in res.state.params.values()
                   for t in (v if isinstance(v, list) else [v])):
            raise SystemExit(f"{label}: a gradient of the last train step is not finite")
        return res, fwd, bwd

    log(f"[4] apps.train.main on the card: {TRAIN_ITERS} steps, evals at {list(TEST_ITERS)}")
    result, fwd_launches, bwd_launches = train_run(
        "gs_mesh", ["--gs_type", "gs_mesh", "-s", data_dir, "-m", train_dir, "--eval",
                    "--num_splats", str(NUM_SPLATS), "--sh_degree", str(SH_DEGREE),
                    "--white_background", "--iterations", str(TRAIN_ITERS),
                    "--test_iterations", *map(str, TEST_ITERS),
                    "--save_iterations", str(TRAIN_ITERS)],
        TRAIN_ITERS, len(TEST_ITERS) * N_TEST, must_fall=0.8)
    launches.clear()
    render_app.main(["-m", train_dir])
    if launches["composite_fwd"] != n_views:
        raise SystemExit("the trained snapshot did not render through the kernel")
    check_pngs(train_dir, TRAIN_ITERS)
    log("    the trained snapshot renders through apps.render; all gradients finite")

    colmap_views = (("train", N_COLMAP - N_COLMAP_TEST), ("test", N_COLMAP_TEST))
    log(f"[4] apps.train.main --gs_type gs_multi_mesh on the card: the COLMAP dataset, "
        f"{MM_ITERS} steps, evals at {list(MM_TEST_ITERS)}, checkpoint at {MM_CHECKPOINT}")
    mm_argv = ["--gs_type", "gs_multi_mesh", "-s", ns.colmap_dir, "--eval", "--num_splats",
               str(NUM_SPLATS), "--sh_degree", str(SH_DEGREE)]
    mm_result, mm_fwd_launches, mm_bwd_launches = train_run(
        "gs_multi_mesh", [*mm_argv, "-m", ns.mm_train_dir, "--iterations", str(MM_ITERS),
                          "--test_iterations", *map(str, MM_TEST_ITERS),
                          "--save_iterations", str(MM_ITERS),
                          "--checkpoint_iterations", str(MM_CHECKPOINT)],
        MM_ITERS, len(MM_TEST_ITERS) * N_COLMAP_TEST)
    mm_state = mm_result.state
    moved = [float((a.detach() - a0).abs().max()) for a, a0 in
             zip(mm_state.params["alpha"], ns.mm_init["params"]["alpha"])]
    log(f"    {mm_state.alive.shape[0]} Gaussians over {len(moved)} meshes; largest alpha move "
        f"per mesh {moved}")
    if mm_state.alive.shape[0] != ns.mm_init["alive"].shape[0] or not min(moved) > 0:
        raise SystemExit("every mesh's alpha must move")
    launches.clear()
    mm_resumed = train_app.main([
        *mm_argv, "-m", ns.mm_resume_dir, "--iterations", str(MM_RESUME_ITERS),
        "--test_iterations", str(MM_RESUME_ITERS), "--save_iterations", str(MM_RESUME_ITERS),
        "--start_checkpoint", train_app.checkpoint_path(ns.mm_train_dir, MM_CHECKPOINT)])
    n_mm_resumed = MM_RESUME_ITERS - MM_CHECKPOINT
    log(f"    resumed from chkpnt{MM_CHECKPOINT}.pt: {len(mm_resumed.losses)} steps to step "
        f"{mm_resumed.state.step}; composite_bwd launches {launches["composite_bwd"]}")
    if (len(mm_resumed.losses) != n_mm_resumed or mm_resumed.state.step != MM_RESUME_ITERS
            or launches["composite_bwd"] != n_mm_resumed
            or launches["composite_fwd"] != n_mm_resumed + N_COLMAP_TEST
            or not np.isfinite(mm_resumed.losses).all()):
        raise SystemExit("the resumed gs_multi_mesh run did not begin at the checkpoint's step")
    launches.clear()
    render_app.main(["-m", ns.mm_train_dir])
    if launches["composite_fwd"] != N_COLMAP:
        raise SystemExit("the gs_multi_mesh snapshot did not render through the kernel")
    check_pngs(ns.mm_train_dir, MM_ITERS, "gs_multi_mesh", colmap_views)
    log(f"    the gs_multi_mesh snapshot renders through apps.render ({N_COLMAP} PNGs)")

    log(f"[4] apps.train.main --gs_type gs_flame on the card: {FLAME_ITERS} steps at "
        f"{FLAME_SPLATS} splats per face, evals at {list(FLAME_TEST_ITERS)}")
    flame_result, flame_fwd_launches, flame_bwd_launches = train_run(
        "gs_flame", ["--gs_type", "gs_flame", "-s", ns.flame_dir, "-m", ns.flame_train_dir,
                     "--flame_model", ns.flame_pkl, "--eval", "--white_background",
                     "--sh_degree", str(SH_DEGREE), "--iterations", str(FLAME_ITERS),
                     "--test_iterations", *map(str, FLAME_TEST_ITERS),
                     "--save_iterations", str(FLAME_ITERS)],
        FLAME_ITERS, len(FLAME_TEST_ITERS) * N_TEST)
    flame_state = flame_result.state
    flame_grads = {k: float(flame_state.params[k].grad.abs().max()) for k in FLAME_PARAMS}
    log(f"    {flame_state.alive.shape[0]} Gaussians; max |gradient| of the FLAME params at the "
        f"last step {json.dumps(flame_grads)}")
    if flame_state.alive.shape[0] != ns.flame_bag.num_gaussians:
        raise SystemExit("the gs_flame run has another Gaussian count than its scene")
    if not all(bool(torch.isfinite(flame_state.params[k].grad).all()) and g > 0
               for k, g in flame_grads.items()):
        raise SystemExit("every FLAME param needs a finite, nonzero gradient")
    launches.clear()
    render_flame_app.main(["-m", ns.flame_train_dir, "--animated", "--frames", str(FLAME_FRAMES),
                           "--dump_obj"])
    render_flame_launches = launches["composite_fwd"]
    out = os.path.join(ns.flame_train_dir, "renders_flame_animated")
    names = sorted(os.listdir(out))
    expect = [f"{i:05d}.png" for i in range(FLAME_FRAMES)] + \
        [f"head_{i:05d}.obj" for i in range(FLAME_FRAMES)]
    log(f"    apps.render_flame --animated --frames {FLAME_FRAMES} --dump_obj: {names}; "
        f"composite_fwd launches {render_flame_launches}")
    if names != expect or render_flame_launches != FLAME_FRAMES \
            or launches["composite_bwd"] != 0:
        raise SystemExit(f"apps.render_flame: expected {expect} and {FLAME_FRAMES} launches")
    for name in names[:FLAME_FRAMES]:
        with Image.open(os.path.join(out, name)) as im:
            img = np.asarray(im, dtype=np.float32)
        if img.shape != (SIZE, SIZE, 3) or img.std() < 1.0:
            raise SystemExit(f"bad render_flame frame {name}")

    # ---- 5. the gs training path (densification) through the entry points ---
    log(f"[5] apps.train.main --gs_type gs on the card: {GS_POINTS} points, capacity "
        f"{GS_CAPACITY}, {GS_ITERS} steps, schedule {json.dumps(GS_SCHEDULE)}, evals at "
        f"{list(GS_TEST_ITERS)}, checkpoint at {GS_CHECKPOINT}")
    gs_argv = ["--gs_type", "gs", "-s", ns.gs_data_dir, "--eval", "--sh_degree", str(SH_DEGREE),
               "--white_background", *(str(x) for kv in GS_SCHEDULE.items() for x in kv)]
    launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs_result = train_app.main([
        *gs_argv, "-m", ns.gs_train_dir, "--iterations", str(GS_ITERS),
        "--test_iterations", *map(str, GS_TEST_ITERS), "--save_iterations", str(GS_ITERS),
        "--checkpoint_iterations", str(GS_CHECKPOINT),
    ])
    torch.cuda.synchronize()
    gs_train_s = time.perf_counter() - t0
    gs_fwd_launches = launches["composite_fwd"]
    gs_bwd_launches = launches["composite_bwd"]
    gs_state, events = gs_result.state, gs_result.densify_events
    for e in events:
        log(f"    event {json.dumps(e)}")
    gs_losses = gs_result.losses
    gs_first, gs_last = float(np.mean(gs_losses[:20])), float(np.mean(gs_losses[-20:]))
    gs_psnrs = [gs_result.test_psnr[i] for i in GS_TEST_ITERS]
    n_gs_evals = len(GS_TEST_ITERS) * N_TEST
    alive_counts = [GS_POINTS] + [e["n_alive"] for e in events]
    log(f"    {GS_ITERS} steps in {gs_train_s:.2f} s ({1e3 * gs_train_s / GS_ITERS:.1f} ms per "
        f"step, scene load, KNN init, events, evals, checkpoint and snapshot included); mean "
        f"loss first 20 {gs_first:.5f}, last 20 {gs_last:.5f}; test PSNR "
        f"{json.dumps(dict(zip(GS_TEST_ITERS, gs_psnrs)))}; alive {alive_counts}; "
        f"composite_fwd launches {gs_fwd_launches}, composite_bwd launches {gs_bwd_launches}")
    expect_events = [it for it in range(1, GS_ITERS + 1)
                     if it > GS_SCHEDULE["--densify_from_iter"]
                     and it % GS_SCHEDULE["--densification_interval"] == 0]
    if [e["iteration"] for e in events] != expect_events or len(events) < 3:
        raise SystemExit(f"expected densify events at {expect_events}")
    sized = [e for e in events if e["iteration"] > GS_SCHEDULE["--opacity_reset_interval"]]
    if not sized or len(sized) == len(events):
        raise SystemExit("the run needs events with the size threshold off and on")
    if GS_ITERS // GS_SCHEDULE["--opacity_reset_interval"] < 1:
        raise SystemExit("the run holds no opacity reset")
    totals = {k: sum(e[k] for e in events) for k in ("n_clone", "n_split_rows", "n_pruned")}
    if min(totals.values()) <= 0:
        raise SystemExit(f"clones, split rows and prunes must all occur: {totals}")
    if len(set(alive_counts)) < 2 or max(alive_counts) > GS_CAPACITY:
        raise SystemExit("the alive count must change and stay within the capacity")
    if gs_state.alive.shape[0] != GS_CAPACITY or int(gs_state.alive.sum()) != alive_counts[-1]:
        raise SystemExit("the final state's rows disagree with the last event")
    if not all(bool(torch.isfinite(p).all()) for p in gs_state.params.values()):
        raise SystemExit("a param of the gs run is not finite")
    if not np.isfinite(gs_losses).all() or not gs_last < gs_first:
        raise SystemExit("the gs training loss did not fall")
    if not gs_psnrs[-1] > gs_psnrs[0]:
        raise SystemExit("the gs test PSNR did not rise")
    if gs_bwd_launches != GS_ITERS or gs_fwd_launches != GS_ITERS + n_gs_evals:
        raise SystemExit(f"expected {GS_ITERS} backward and {GS_ITERS + n_gs_evals} forward "
                         "launches")
    ckpt = train_app.checkpoint_path(ns.gs_train_dir, GS_CHECKPOINT)
    if not os.path.exists(ckpt):
        raise SystemExit(f"no checkpoint at {ckpt}")
    launches.clear()
    resumed = train_app.main([
        *gs_argv, "-m", ns.gs_resume_dir, "--iterations", str(GS_RESUME_ITERS),
        "--test_iterations", str(GS_RESUME_ITERS), "--save_iterations", str(GS_RESUME_ITERS),
        "--start_checkpoint", ckpt,
    ])
    alive_at_ckpt = [e["n_alive"] for e in events if e["iteration"] <= GS_CHECKPOINT][-1]
    n_resumed = GS_RESUME_ITERS - GS_CHECKPOINT
    log(f"    resumed from {os.path.relpath(ckpt, ROOT)}: {len(resumed.losses)} steps to step "
        f"{resumed.state.step}, {int(resumed.state.alive.sum())} alive of "
        f"{resumed.state.alive.shape[0]} rows (the event at {GS_CHECKPOINT} left "
        f"{alive_at_ckpt}); composite_bwd launches {launches["composite_bwd"]}")
    if (len(resumed.losses) != n_resumed or resumed.state.step != GS_RESUME_ITERS
            or int(resumed.state.alive.sum()) != alive_at_ckpt
            or resumed.state.alive.shape[0] != GS_CAPACITY
            or launches["composite_bwd"] != n_resumed
            or launches["composite_fwd"] != n_resumed + N_TEST):
        raise SystemExit("the resumed run did not begin at the checkpoint's step and rows")
    if not np.isfinite(resumed.losses).all():
        raise SystemExit("a loss of the resumed run is not finite")
    launches.clear()
    render_app.main(["-m", ns.gs_train_dir])
    if launches["composite_fwd"] != n_views:
        raise SystemExit("the gs snapshot did not render through the kernel")
    check_pngs(ns.gs_train_dir, GS_ITERS, "gs")
    log(f"    the gs snapshot renders through apps.render ({n_views} PNGs); all params finite")

    log(f"[5] apps.train.main --gs_type gs_flat on the card: {FLAT_ITERS} steps, the same "
        f"dataset and schedule, evals at {list(FLAT_TEST_ITERS)}")
    launches.clear()
    flat_result = train_app.main([
        "--gs_type", "gs_flat", *gs_argv[2:], "-m", ns.flat_train_dir,
        "--iterations", str(FLAT_ITERS), "--test_iterations", *map(str, FLAT_TEST_ITERS),
        "--save_iterations", str(FLAT_ITERS),
    ])
    flat_fwd_launches = launches["composite_fwd"]
    flat_bwd_launches = launches["composite_bwd"]
    flat_state, flat_events = flat_result.state, flat_result.densify_events
    flat_first = float(np.mean(flat_result.losses[:20]))
    flat_last = float(np.mean(flat_result.losses[-20:]))
    flat_psnrs = [flat_result.test_psnr[i] for i in FLAT_TEST_ITERS]
    log(f"    events {json.dumps(flat_events)}; mean loss first 20 {flat_first:.5f}, last 20 "
        f"{flat_last:.5f}; test PSNR {json.dumps(dict(zip(FLAT_TEST_ITERS, flat_psnrs)))}; "
        f"composite_fwd launches {flat_fwd_launches}, composite_bwd launches {flat_bwd_launches}")
    if (len(flat_events) != 1 or flat_events[0]["n_pruned"] <= 0
            or not 0 < flat_events[0]["n_alive"] <= GS_CAPACITY
            or int(flat_state.alive.sum()) != flat_events[0]["n_alive"]):
        raise SystemExit("the gs_flat run needs one event that prunes within the capacity")
    if tuple(flat_state.params["scaling"].shape) != (GS_CAPACITY, 2):
        raise SystemExit("a gs_flat state has two scaling columns")
    if not all(bool(torch.isfinite(p).all()) for p in flat_state.params.values()):
        raise SystemExit("a param of the gs_flat run is not finite")
    if not np.isfinite(flat_result.losses).all() or not flat_last < flat_first:
        raise SystemExit("the gs_flat training loss did not fall")
    if not flat_psnrs[-1] > flat_psnrs[0]:
        raise SystemExit("the gs_flat test PSNR did not rise")
    n_flat_evals = len(FLAT_TEST_ITERS) * N_TEST
    if flat_bwd_launches != FLAT_ITERS or flat_fwd_launches != FLAT_ITERS + n_flat_evals:
        raise SystemExit(f"expected {FLAT_ITERS} backward and {FLAT_ITERS + n_flat_evals} "
                         "forward launches")
    # the snapshot as flat Gaussians and as the triangle soup made from them
    launches.clear()
    render_app.main(["-m", ns.flat_train_dir])
    render_app.main(["-m", ns.flat_train_dir, "--gs_type", "gs_points"])
    if launches["composite_fwd"] != 2 * n_views:
        raise SystemExit("the gs_flat snapshot did not render through the kernel")
    check_pngs(ns.flat_train_dir, FLAT_ITERS, "gs_flat")
    check_pngs(ns.flat_train_dir, FLAT_ITERS, "gs_points")
    soup_diff = []
    for split, n_cams in [("train", N_TRAIN), ("test", N_TEST)]:
        for i in range(n_cams):
            pngs = [os.path.join(ns.flat_train_dir, split, f"ours_{FLAT_ITERS}",
                                 f"renders_{t}", f"{i:05d}.png") for t in ("gs_flat", "gs_points")]
            with Image.open(pngs[0]) as a, Image.open(pngs[1]) as b:
                soup_diff.append(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)))
    soup_diff = np.stack(soup_diff)
    soup = {"max_abs_diff_255": int(soup_diff.max()),
            "frac_pixels_over_1_255": float((soup_diff.max(axis=-1) > 1).mean())}
    log(f"    gs_points against gs_flat renders of the snapshot ({n_views} views; tolerance "
        f"{SOUP_TOL}/255 on every pixel): {json.dumps(soup)}")
    if soup["max_abs_diff_255"] > SOUP_TOL:
        raise SystemExit("the gs_points render of the soup differs from the gs_flat render")

    log(f"[5] apps.train.main --gs_type gs on the card: the COLMAP dataset's "
        f"{COLMAP_POINTS} points, {COLMAP_GS_ITERS} steps")
    colmap_gs_result, colmap_gs_fwd_launches, colmap_gs_bwd_launches = train_run(
        "gs on COLMAP", ["--gs_type", "gs", "-s", ns.colmap_dir, "-m", ns.colmap_gs_dir,
                         "--eval", "--sh_degree", str(SH_DEGREE),
                         "--iterations", str(COLMAP_GS_ITERS),
                         "--test_iterations", *map(str, COLMAP_GS_TEST_ITERS),
                         "--save_iterations", str(COLMAP_GS_ITERS)],
        COLMAP_GS_ITERS, len(COLMAP_GS_TEST_ITERS) * N_COLMAP_TEST)
    if int(colmap_gs_result.state.alive.sum()) != COLMAP_POINTS:
        raise SystemExit("the COLMAP gs run did not start from the points3D points")

    # ---- 6. timings ---------------------------------------------------------
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
    log(f"[6] render per view, 800x800: {json.dumps(split)}")
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
    step_split = train_step_split("gs_mesh", result.state, cam0, gt0, torch.ones(3, device=dev))
    log(f"    gs_mesh train step at step {TRAIN_ITERS}, 800x800: {json.dumps(step_split)}")
    gs_alive = int(gs_state.alive.sum())
    gs_split = train_step_split("gs", gs_state, cam0, gt0, torch.ones(3, device=dev))
    log(f"    gs train step at step {GS_ITERS} ({gs_alive} alive of {GS_CAPACITY} rows), "
        f"800x800: {json.dumps(gs_split)}")
    # the same step where the path begins: a fresh state, every point alive
    gs_fresh = make_train_state(
        ns.gs_scene.init_model_state(vanilla, SH_DEGREE, capacity=GS_CAPACITY),
        optimization_config("gs"), ns.gs_scene.cameras_extent)
    gs_split_first = train_step_split("gs", gs_fresh, cam0, gt0, torch.ones(3, device=dev))
    log(f"    gs train step at a fresh state ({int(gs_fresh.alive.sum())} alive of {GS_CAPACITY} "
        f"rows), 800x800: {json.dumps(gs_split_first)}")
    del gs_fresh
    mm_cam, mm_gt = ns.colmap_scene.train_cameras[0]
    mm_split = train_step_split("gs_multi_mesh", mm_state, mm_cam,
                                torch.as_tensor(mm_gt, device=dev), torch.zeros(3, device=dev))
    log(f"    gs_multi_mesh train step at step {MM_ITERS} ({mm_state.alive.shape[0]} Gaussians), "
        f"800x800: {json.dumps(mm_split)}")
    flame_split = train_step_split("gs_flame", flame_state, ns.flame_scene.train_cameras[0][0],
                                   flame_gt0, torch.ones(3, device=dev), model=ns.flame_model)
    log(f"    gs_flame train step at step {FLAME_ITERS} ({flame_state.alive.shape[0]} Gaussians; "
        f"to_bag runs the FLAME decoder), 800x800: {json.dumps(flame_split)}")
    # one densify event at the gs path's last state (it has the statistics of
    # the steps just timed) and the KNN scale init of the path's point cloud
    event_kw = dict(grad_threshold=2e-4, min_opacity=0.005, extent=ns.gs_scene.cameras_extent,
                    percent_dense=0.01, size_threshold=20.0, scaling_cols=3,
                    generator=torch.Generator(device=dev).manual_seed(0))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    _, info = densify_and_prune(gs_state, **event_kw)
    end.record()
    end.synchronize()
    points = torch.as_tensor(ns.gs_scene.scene_info.point_cloud.points, device=dev)
    gs_times = {
        "densify_event_ms": start.elapsed_time(end),
        "densify_event_counts": {k: int(v) for k, v in info.items()},
        "knn_scale_init_ms": cuda_ms(lambda: knn_scale_init(points), reps=2, warmup=1),
    }
    log(f"    gs path, {gs_alive} alive of {GS_CAPACITY} rows / {GS_POINTS} points: "
        f"{json.dumps(gs_times)}")
    bench_res = bench.run(n=100_000, size=SIZE, iters=10, device=dev)
    log(f"    bench (100k Gaussians, 800x800, SH 3, fwd+bwd+update): {json.dumps(bench_res)}")
    log(f"    script so far (wall): {time.perf_counter() - t_script:.1f} s")

    # ---- 7. evaluation and editing through the user's entry points ---------
    t0 = time.perf_counter()
    phase7 = eval_and_edit(ns, dev, result.test_psnr[TEST_ITERS[-1]])
    log(f"    phase 7: {time.perf_counter() - t0:.1f} s; script so far (wall): "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- 8. the parallel modes and io/native --------------------------------
    t0 = time.perf_counter()
    phase8 = parallel_and_native(ns, dev, card)
    log(f"    phase 8: {time.perf_counter() - t0:.1f} s; script so far (wall): "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- 9. gradient conformance at scale ------------------------------------
    t0 = time.perf_counter()
    phase9 = gradient_conformance(dev)
    log(f"    phase 9: {time.perf_counter() - t0:.1f} s; script so far (wall): "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- 10. radius_mode="cuda" and the toy scene ----------------------------
    t0 = time.perf_counter()
    phase10 = radius_mode_cuda(ns, dev)
    log(f"    phase 10: {time.perf_counter() - t0:.1f} s; script so far (wall): "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- 11. the bf16 pair-table modes ---------------------------------------
    t0 = time.perf_counter()
    phase11 = bf16_modes(ns, dev, cases, ops={
        "gs_mesh": {"fwd": full["op_counts"], "bwd": full_bwd["op_counts"]},
        "gs": {"fwd": gs_fwd["op_counts"], "bwd": gs_bwd["op_counts"]},
        "flame": {"fwd": flame_fwd["op_counts"], "bwd": flame_bwd["op_counts"]}})
    log(f"    phase 11: {time.perf_counter() - t0:.1f} s; script so far (wall): "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- 12. the projection kernels ------------------------------------------
    t0 = time.perf_counter()
    phase12 = projection_kernels(ns, dev)
    log(f"    phase 12: {time.perf_counter() - t0:.1f} s; script so far (wall): "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- 13. the loss kernels ------------------------------------------------
    t0 = time.perf_counter()
    phase13 = loss_kernels(ns, dev)
    log(f"    phase 13: {time.perf_counter() - t0:.1f} s; script so far (wall): "
        f"{time.perf_counter() - t_script:.1f} s")

    # ---- 14. output lines ---------------------------------------------------
    kernels = {"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "gaussian_mesh_splatting_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py:238",
        "launches": gs_fwd_launches,
        "launches_render": render_launches,
        "launches_train": fwd_launches,
        "launches_gs_train": gs_fwd_launches,
        "launches_gs_flat_train": flat_fwd_launches,
        "launches_multi_mesh_train": mm_fwd_launches,
        "launches_colmap_gs_train": colmap_gs_fwd_launches,
        "launches_flame_train": flame_fwd_launches,
        "launches_render_flame": render_flame_launches,
        **{f"launches_{k}": v for k, v in phase7["fwd"].items()},
        **{f"launches_{k}_per_rank": v for k, v in phase8["fwd"].items()},
        "launches_grad_conformance": phase9["fwd"],
        **{f"launches_{k}": v for k, v in phase10["fwd"].items()},
        "max_abs_err": max(full["max_abs_err_rgbT"], gs_fwd["max_abs_err_rgbT"],
                           flame_fwd["max_abs_err_rgbT"]),
        "ms": full["ms"],
        "queued_ms": full["queued_ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
        **{f"gs_{k}": gs_fwd[k] for k in ("pairs", "ms", "queued_ms", "plain_ms", "bound_ms",
                                          "bound_by")},
        **{f"flame_{k}": flame_fwd[k] for k in ("pairs", "ms", "queued_ms", "plain_ms",
                                                "bound_ms", "bound_by")},
        **{f"{p}radius_mode_{k}": phase10[case][v] for p, case in (("", "gs_mesh"),
                                                                   ("flame_", "flame"))
           for k, v in (("cuda_pairs", "pairs_cuda"), ("tight_pairs", "pairs_tight"),
                        ("cuda_ms", "fwd_ms_cuda"), ("tight_ms", "fwd_ms_tight"))},
        **bf16_line_keys(phase11, "fwd"),
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "gaussian_mesh_splatting_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py:405",
        "launches": gs_bwd_launches,
        "launches_render": render_bwd_launches,
        "launches_train": bwd_launches,
        "launches_gs_train": gs_bwd_launches,
        "launches_gs_flat_train": flat_bwd_launches,
        "launches_multi_mesh_train": mm_bwd_launches,
        "launches_colmap_gs_train": colmap_gs_bwd_launches,
        "launches_flame_train": flame_bwd_launches,
        "launches_render_flame": 0,
        **{f"launches_{k}": v for k, v in phase7["bwd"].items()},
        **{f"launches_{k}_per_rank": v for k, v in phase8["bwd"].items()},
        "launches_grad_conformance": phase9["bwd"],
        **{f"launches_{k}": v for k, v in phase10["bwd"].items()},
        "oracle_rel_err_at_scale": phase9["oracle"]["worst_rel_err"],
        "oracle_pairs_at_scale": phase9["oracle"]["n_pairs"],
        "fd_rel_err_full_scale": phase9["fd"]["worst_rel_err"],
        "max_abs_err": max(full_bwd["photometric"]["max_abs_err"],
                           gs_bwd["photometric"]["max_abs_err"],
                           flame_bwd["photometric"]["max_abs_err"]),
        "ms": full_bwd["ms"],
        "queued_ms": full_bwd["queued_ms"],
        "plain_ms": full_bwd["plain_ms"],
        "bound_ms": full_bwd["bound_ms"],
        "bound_by": full_bwd["bound_by"],
        "library_ms": None,
        **{f"gs_{k}": gs_bwd[k] for k in ("pairs", "ms", "queued_ms", "plain_ms", "bound_ms",
                                          "bound_by")},
        **{f"flame_{k}": flame_bwd[k] for k in ("pairs", "ms", "queued_ms", "plain_ms",
                                                "bound_ms", "bound_by")},
        **{f"{p}radius_mode_{k}": phase10[case][v] for p, case in (("", "gs_mesh"),
                                                                   ("flame_", "flame"))
           for k, v in (("cuda_ms", "bwd_ms_cuda"), ("tight_ms", "bwd_ms_tight"))},
        **bf16_line_keys(phase11, "bwd"),
    }, *projection_line(phase12), *loss_line(phase13)]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
