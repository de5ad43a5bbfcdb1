#!/usr/bin/env python3
"""The parallel modes of the PyTorch/CUDA port across several cards: one
process per card on NCCL, rank r on cuda:r, at the full width of the
`gs_mesh` scene of `tools_verify_scale.py` (5120 faces, 10 splats a face:
51,200 Gaussians, SH 3, 800x800; 8 train views, so that camera DP at world 4
has a view for every rank).

    python3 tools_torch_multicard.py [--worlds 2 4] [--out build/multicard/result.json]
    python3 tools_torch_multicard.py --device cpu [--worlds 2 4]   # gloo CPU ranks, tiny scene

Refuses to start (exit 2) unless `torch.cuda.device_count()` covers the
largest world; no rank falls back to gloo, to a shared card or to the CPU.
`--device cpu` runs the same cases on gloo CPU processes at a tiny scale (a
rehearsal: no time there is a device figure). `--worlds 1` runs the cases on
one card, where every collective is in a group of one.

For each world (ranks spawned as processes; a failing rank ends the run):
  (a) the teacher's view 0 row-sharded, bit-equal to the unsharded render,
      and (b) Gaussian-sharded, within chip_smoke.PAR_SATURATION_TOL;
  (c) the first step of rows, gaussians, camera DP and (world 4) the
      composed 2x2 step on every rank against `make_train_step` on one card,
      per param key within chip_smoke.PAR_GRAD_TOL * max|g|, the statistics
      within PAR_STATS_TOL (denom and max_radii equal), the loss 1e-4;
  (d) PAR_STEPS steps of each: the loss falls, the state is bit-identical
      on every rank (`multihost.state_digest`: params, Adam moments,
      statistics), B1 and B2 launch once a step a rank; the step times
      (CUDA events, median of PAR_TIMED, per rank);
  (e) the collectives alone: the gather of a rows band and of a Gaussian
      slab's planes at 800x800, the all-reduce of the step's gradients
      (host clock around synchronised calls, median of 10);
  (f) at the largest world, B1 and B2 against their plain versions on every
      card (the teacher's view 0; the student's first step);
  (g) `torchrun --nproc_per_node <world> -m ...apps.train` with
      `--data_parallel`, `--shard rows` and `--shard gaussians` on the
      `gs_mesh` scene; `--data_parallel` on the `gs` path of chip_smoke.py
      (100,000 seeded points in 400,000 rows, densify events at 200 and 300,
      opacity resets at 100 and 250); `--shard gaussians` on chip_smoke.py's
      synthetic FLAME head (`gs_flame`, 980,000 Gaussians); at world 4,
      `--data_parallel --port` with a viewer that pauses training. Each run
      must end with the app's replica check (`parallel.multihost.
      check_replicas`: the state bit-identical on every rank), rank r on
      cuda:r, every rank on its own card.
`--gap` adds, on one card, the first gaussians step against the unsharded one
per param key: the slab in depth order, in index order, and with the GT
moved off the elements where either image equals it exactly (the L1 term's
kink).

Prints the cards (`nvidia-smi --query-gpu=index,name,power.limit,pci.bus_id`
and `nvidia-smi topo -m`) and the host's cores, then a line per case, and
last one JSON line of results (also written to --out). Data is generated
from fixed seeds under the work directory (default build/multicard).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import functools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np

import chip_smoke as cs
from chip_smoke import (PAR_GRAD_TOL, PAR_SATURATION_TOL, PAR_STEPS, PAR_TIMED, SATURATED_T,
                        SH_DEGREE, log)

ROOT = os.path.dirname(os.path.abspath(__file__))
GROUP_TIMEOUT_S = 300  # a rank that waits this long in a collective fails the run
APP_TIMEOUT_S = 300  # an app launch takes 30-40 s on the card
PAUSE_S = 5.0  # the viewer's pause of a run of several processes


@dataclasses.dataclass(frozen=True)
class Scale:
    """What the scenes are cut to: the card runs the full width, the CPU a
    rehearsal."""

    size: int  # image edge
    num_splats: int
    n_train: int
    n_test: int
    flame_rings: int
    flame_segments: int
    gs_ply_points: int | None  # None: the Blender reader's 100,000 seeded points
    gs_iters: int
    gs_schedule: tuple  # (flag, value) pairs of apps.train
    app_iters: int


CARD = Scale(size=cs.SIZE, num_splats=cs.NUM_SPLATS, n_train=8, n_test=2,
             flame_rings=cs.FLAME_RINGS, flame_segments=cs.FLAME_SEGMENTS, gs_ply_points=None,
             gs_iters=300, gs_schedule=(("--densify_from_iter", 100),
                                        ("--densification_interval", 100),
                                        ("--opacity_reset_interval", 250)),
             app_iters=PAR_STEPS)
CPU = dataclasses.replace(CARD, size=64, num_splats=1, flame_rings=5, flame_segments=8,
                          gs_ply_points=300, gs_iters=30,
                          gs_schedule=(("--densify_from_iter", 10),
                                       ("--densification_interval", 10),
                                       ("--opacity_reset_interval", 25)),
                          app_iters=8)


# ---------------------------------------------------------------- the machine

def require_cards(n: int) -> None:
    """Exit 2 unless CUDA is available with at least n visible cards."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        print(f"{have} CUDA device(s) visible, {n} needed: one process per card, no card "
              "shared (--device cpu rehearses on gloo CPU processes)", file=sys.stderr)
        raise SystemExit(2)


def machine_lines(device: str) -> list[str]:
    """The cards (index, name, power limit, PCI bus id), their links
    (`nvidia-smi topo -m` and `nvlink -s`, where the machine lets nvidia-smi
    read them; which card can reach which directly, from CUDA) and the
    host's cores."""
    import torch

    lines = []
    if device == "cuda":
        lines += subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit,pci.bus_id",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                check=True, timeout=60).stdout.rstrip().splitlines()
        for query in (["topo", "-m"], ["nvlink", "-s"]):
            proc = subprocess.run(["nvidia-smi", *query], capture_output=True, text=True,
                                  timeout=60)
            if proc.returncode == 0:
                lines += proc.stdout.rstrip().splitlines()
            else:
                lines.append(f"nvidia-smi {' '.join(query)}: exit {proc.returncode} "
                             f"{(proc.stdout + proc.stderr).strip()[:200]}")
        n = torch.cuda.device_count()
        lines.append("peer access (CUDA): " + "; ".join(
            f"{i}->" + ",".join(str(j) for j in range(n)
                                if j != i and torch.cuda.can_device_access_peer(i, j))
            for i in range(n)))
    lines.append(f"host cores: {os.cpu_count()} ({len(os.sched_getaffinity(0))} usable)")
    return lines


def nccl_links(log_path: str) -> list[str]:
    """The distinct NCCL INFO lines of a rank's log that name its
    transports and the topology it found (NCCL_DEBUG=INFO, subsystems INIT
    and GRAPH): whether the cards talk over NVLink (NVL, P2P) or PCIe."""
    keep = []
    with open(log_path) as f:
        for line in f:
            if "NCCL INFO" not in line:
                continue
            text = line.split("NCCL INFO", 1)[1].strip()
            if (" via " in text or "type " in text or "NVLS" in text) and text not in keep:
                keep.append(text)
    return keep[:12]


# ---------------------------------------------------------------- scenes

@contextlib.contextmanager
def chip_smoke_constants(**values):
    """chip_smoke's module constants set to `values` inside the block: its
    dataset and FLAME writers read them when called."""
    saved = {k: getattr(cs, k) for k in values}
    for k, v in values.items():
        setattr(cs, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(cs, k, v)


def write_mesh_dataset(root: str, scale: Scale) -> None:
    """chip_smoke.write_dataset (mesh.obj, placeholder PNGs, the ring of
    cameras) with scale.n_train + scale.n_test views of scale.size."""
    with chip_smoke_constants(N_TRAIN=scale.n_train, N_TEST=scale.n_test, SIZE=scale.size):
        cs.write_dataset(root)


def copy_views(src: str, dst: str) -> None:
    """The cameras and GT images of the dataset `src`, in a directory of
    their own."""
    os.makedirs(dst)
    for name in ("transforms_train.json", "transforms_test.json"):
        shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))
    for split in ("train", "test"):
        shutil.copytree(os.path.join(src, split), os.path.join(dst, split))


def write_mesh_scene(work: str, scale: Scale, dev) -> tuple[str, int]:
    """The seeded `gs_mesh` dataset under work/scene, its GT rendered from
    chip_smoke's seed-42 teacher; returns its path and Gaussian count."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    data_dir = os.path.join(work, "scene")
    os.makedirs(data_dir)
    write_mesh_dataset(data_dir, scale)
    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=scale.num_splats, shuffle=False,
                  device=dev)
    with torch.no_grad():
        teacher = mesh_model.to_bag(cs.randomize_state(
            scene.init_model_state(mesh_model, SH_DEGREE), seed=42))
        cs.render_gt_images(scene, teacher)
    log(f"    gs_mesh scene: {teacher.num_gaussians} Gaussians, {scale.size}x{scale.size}, "
        f"SH {SH_DEGREE}, {scale.n_train} train + {scale.n_test} test views; GT from the "
        "seed-42 teacher")
    return data_dir, int(teacher.num_gaussians)


def write_scenes(work: str, scale: Scale, dev) -> types.SimpleNamespace:
    """The seeded datasets: `gs_mesh` (`write_mesh_scene`), `gs` (the same
    views; on the card no points3d.ply, so that the reader makes its
    100,000 points) and `gs_flame` (chip_smoke's synthetic FLAME pickle at
    scale.flame_rings x scale.flame_segments; GT from its seed-44 teacher
    with an expression and the jaw open)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.io.ply import store_point_cloud
    from gaussian_mesh_splatting_tpu_torch.models import model_for
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    data_dir, n_gaussians = write_mesh_scene(work, scale, dev)
    gs_dir = os.path.join(work, "gs_scene")
    copy_views(data_dir, gs_dir)
    if scale.gs_ply_points is not None:
        rng = np.random.default_rng(1)
        store_point_cloud(os.path.join(gs_dir, "points3d.ply"),
                          rng.random((scale.gs_ply_points, 3)) * 1.6 - 0.8,
                          rng.random((scale.gs_ply_points, 3)) * 255)

    flame_dir = os.path.join(work, "flame_scene")
    copy_views(data_dir, flame_dir)
    flame_pkl = os.path.join(work, "flame_synthetic.pkl")
    with chip_smoke_constants(FLAME_RINGS=scale.flame_rings,
                              FLAME_SEGMENTS=scale.flame_segments):
        cs.write_flame_pickle(flame_pkl)
    flame_model, rig = model_for("gs_flame", flame_pkl, dev)
    flame_scene = Scene(flame_dir, "gs_flame", eval=True, white_background=True, flame_rig=rig,
                        shuffle=False, device=dev)
    flame_teacher = cs.randomize_state(flame_scene.init_model_state(flame_model, SH_DEGREE),
                                       seed=44)
    rng = np.random.default_rng(44)
    p = flame_teacher["params"]
    p["flame_exp"] = torch.as_tensor(rng.normal(0, 1.0, (1, 50)).astype(np.float32), device=dev)
    p["flame_pose"] = torch.tensor([[0.0, 0.1, 0.0, 0.25, 0.0, 0.0]], device=dev)
    with torch.no_grad():
        flame_bag = flame_model.to_bag(flame_teacher)
        cs.render_gt_images(flame_scene, flame_bag)
    log(f"    gs_flame scene: {rig.lbs_model.faces.shape[0]} faces, {flame_bag.num_gaussians} "
        "Gaussians; GT from the seed-44 teacher")
    return types.SimpleNamespace(data_dir=data_dir, gs_dir=gs_dir, flame_dir=flame_dir,
                                 flame_pkl=flame_pkl, n_flame=int(flame_bag.num_gaussians),
                                 n_gaussians=n_gaussians)


@functools.lru_cache(maxsize=None)
def load_scene(data_dir: str, num_splats: int, dev):
    """What a rank loads, as apps.train would: the gs_mesh dataset (cameras,
    GT on the device), the fresh student's state and the seed-42 teacher's
    bag."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=num_splats, shuffle=False,
                  device=dev)
    init = scene.init_model_state(mesh_model, SH_DEGREE)
    with torch.no_grad():
        teacher = mesh_model.to_bag(cs.randomize_state(init, seed=42))
    gts = [torch.as_tensor(g, device=dev) for _, g in scene.train_cameras]
    return scene, init, teacher, gts


def unsharded_references(ctx, n_views: int) -> list:
    """The unsharded step (`make_train_step` on one device) from the fresh
    student on train views 0..n_views-1: loss, gradients and statistics on
    the host."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.train import (
        make_train_state, make_train_step, optimization_config)

    scene, init, _, gts = ctx.scene()
    cfg = optimization_config("gs_mesh")
    refs = []
    for c in range(n_views):
        state = make_train_state(scene.init_model_state(mesh_model, SH_DEGREE), cfg,
                                 scene.cameras_extent)
        _, metrics = make_train_step(mesh_model, cfg, SH_DEGREE)(
            state, scene.train_cameras[c][0], gts[c], torch.ones(3, device=ctx.dev))
        refs.append({"loss": float(metrics["loss"]),
                     "grads": {k: p.grad.cpu().clone() for k, p in state.params.items()},
                     "stats": {k: getattr(state.stats, k).cpu().clone()
                               for k in ("grad_accum", "denom", "max_radii")}})
    return refs


# ---------------------------------------------------------------- timing

def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int = 10) -> float:
    """Median of `reps` host-clock times (ms) of fn() between
    synchronisations, after one call."""
    fn()
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def device_ms(fn, dev, reps: int = 5) -> float:
    """CUDA events' median on a card (chip_smoke.cuda_ms); the host clock's
    on the CPU."""
    return cs.cuda_ms(fn, reps=reps) if dev.type == "cuda" else host_ms(fn, dev, reps)


def timed(fn, dev):
    """(fn(), its ms): one call between CUDA events on a card
    (chip_smoke.timed_once), on the host clock on the CPU."""
    if dev.type == "cuda":
        return cs.timed_once(fn)
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


# ---------------------------------------------------------------- rank cases

def case_render(ctx):
    """(a), (b): the teacher's view 0 row-sharded and Gaussian-sharded
    against the unsharded render on this rank; B1 launches per render; the
    renders' times (median of 5)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda
    from gaussian_mesh_splatting_tpu_torch.parallel import (
        create_mesh, render_gaussian_sharded, render_row_sharded)

    scene, _, teacher, _ = ctx.scene()
    cam, bg, mesh = scene.train_cameras[0][0], torch.ones(3, device=ctx.dev), create_mesh()
    out = {}
    with torch.no_grad():
        def full():
            return rasterize_cuda(teacher.xyz, teacher.scaling, teacher.rotation,
                                  teacher.opacity, cam, bg=bg, shs=teacher.shs,
                                  sh_degree=SH_DEGREE, alive=teacher.alive)

        ref = full()
        out["saturated_pixels"] = int(((1.0 - ref.alpha) <= SATURATED_T).sum())
        out["unsharded_ms"] = device_ms(full, ctx.dev)
        for shard, fn in (("rows", render_row_sharded), ("gaussians", render_gaussian_sharded)):
            def sharded(fn=fn):
                return fn(teacher, cam, bg, mesh, sh_degree=SH_DEGREE)

            cuda_build.launches.clear()
            img = sharded()
            sync(ctx.dev)
            out[shard] = {"bit_equal": bool(torch.equal(img, ref.image)),
                          "max_abs_err": float((img - ref.image).abs().max()),
                          "launches": tuple(cuda_build.launches[e] for e in cs.COMPOSITES),
                          "ms": device_ms(sharded, ctx.dev)}
    return out


def make_mode_step(ctx, mode: str):
    """(step, the train view this rank takes first) of a parallel mode: data
    (rank r takes view r), rows / gaussians (view 0), composed (a (world/2) x
    2 mesh, Gaussians sharded over the model axis; model group d takes view
    d)."""
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.parallel import (
        create_mesh, create_mesh2d, make_dp_train_step, make_sharded_train_step)
    from gaussian_mesh_splatting_tpu_torch.train import optimization_config

    cfg = optimization_config("gs_mesh")
    if mode == "data":
        return make_dp_train_step(mesh_model, cfg, SH_DEGREE, create_mesh()), ctx.rank
    if mode == "composed":
        mesh = create_mesh2d(ctx.world // 2, 2)
        return make_sharded_train_step(mesh_model, cfg, SH_DEGREE, mesh, shard="gaussians",
                                       model_axis="model",
                                       data_axis="data"), mesh.get_local_rank("data")
    return make_sharded_train_step(mesh_model, cfg, SH_DEGREE, create_mesh(), shard=mode), 0


def case_steps(ctx, mode: str):
    """(c), (d): PAR_STEPS steps of `mode` from the fresh student: the first
    step's loss, statistics and gradients; the other steps' times; the
    launches of all; the losses; every rank's state digest."""
    import torch
    import torch.distributed as dist

    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.parallel import multihost
    from gaussian_mesh_splatting_tpu_torch.train import make_train_state, optimization_config

    scene, init, _, gts = ctx.scene()
    state = make_train_state(init, optimization_config("gs_mesh"), scene.cameras_extent)
    step, pick = make_mode_step(ctx, mode)
    cams, bg = scene.train_cameras, torch.ones(3, device=ctx.dev)
    cuda_build.launches.clear()
    _, metrics = step(state, cams[pick][0], gts[pick], bg)
    out = {"first_loss": float(metrics["loss"]),
           "stats": {k: getattr(state.stats, k).cpu().clone()
                     for k in ("grad_accum", "denom", "max_radii")},
           "grads": {k: p.grad.cpu().clone() for k, p in state.params.items()},
           "losses": [float(metrics["loss"])], "step_ms": []}
    for i in range(1, PAR_STEPS):
        c = (pick + i) % len(cams)
        (_, metrics), ms = timed(lambda: step(state, cams[c][0], gts[c], bg), ctx.dev)
        out["step_ms"].append(ms)
        out["losses"].append(float(metrics["loss"]))
    out["launches"] = tuple(cuda_build.launches[e] for e in cs.COMPOSITES)
    sums = [None] * ctx.world
    dist.all_gather_object(sums, multihost.state_digest(state))
    out["checksums"] = sums
    return out


def case_comm(ctx):
    """(e): the collectives alone on this world's group (host clock around
    synchronised calls, median of 10): the gathers of a rows band and of a
    Gaussian slab's planes, the all-reduce of the gs_mesh step's gradients
    (params and mean2d_offset)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE
    from gaussian_mesh_splatting_tpu_torch.parallel import create_mesh
    from gaussian_mesh_splatting_tpu_torch.parallel.collectives import (
        all_reduce_flat, gather_portions)
    from gaussian_mesh_splatting_tpu_torch.parallel.row_sharded import band_tiles

    scene, init, _, _ = ctx.scene()
    size = scene.train_cameras[0][0].height
    group = create_mesh().get_group()
    n_grad = sum(p.numel() for p in init["params"].values()) + 2 * init["alive"].shape[0]
    band = torch.rand((band_tiles(size, ctx.world) * TILE, size, 5), device=ctx.dev)
    slab = torch.rand((size, size, 5), device=ctx.dev)
    grads = [torch.rand((n_grad,), device=ctx.dev)]
    return {"gather_rows_band_ms": host_ms(lambda: gather_portions(band, group), ctx.dev),
            "rows_band_MB": band.numel() * 4 / 1e6,
            "gather_gaussian_slab_ms": host_ms(lambda: gather_portions(slab, group), ctx.dev),
            "gaussian_slab_MB": slab.numel() * 4 / 1e6,
            "all_reduce_grads_ms": host_ms(lambda: all_reduce_flat(grads, group), ctx.dev),
            "grads_MB": n_grad * 4 / 1e6}


def case_kernels(ctx):
    """(f): B1 on the teacher's view 0 and B2 on the student's first step
    (seeded and photometric cotangents) against their plain versions on this
    rank's card (chip_smoke's comparisons and bounds)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model

    scene, init, teacher, gts = ctx.scene()
    cam0 = scene.train_cameras[0][0]
    with torch.no_grad():
        student = mesh_model.to_bag(init)
        fwd = cs.compare_composite(f"rank {ctx.rank} teacher view 0",
                                   *cs.composite_inputs(teacher, cam0, SH_DEGREE)[2:],
                                   time_it=False)
        bwd = cs.compare_composite_bwd(f"rank {ctx.rank} student first step",
                                       *cs.composite_inputs(student, cam0, SH_DEGREE)[2:],
                                       teacher=gts[0], time_it=False)
    return {"b1_max_abs_err": fwd["max_abs_err_rgbT"], "b1_nc_mismatches": fwd["nc_mismatches"],
            "b1_pairs": fwd["pairs"], "b2_pairs": bwd["pairs"],
            "b2_max_rel_err": max(bwd[c]["max_rel_err_per_col"]
                                  for c in ("seeded", "photometric"))}


def grad_errors(grads: dict, ref: dict) -> dict:
    """Each key's max |grads - ref| over max |ref| of that key."""
    return {k: float((grads[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            for k, g in ref.items()}


def case_gap(ctx):
    """`--gap` (one rank): the gaussians step's first-step gradients against
    the unsharded step's per key, (1) the slab in depth order, (2) in index
    order, (3) with the GT moved by 2^-10 wherever either image equals it
    exactly, for both steps; and the elements where one image equals the GT
    and the other does not."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.parallel import gaussian_sharded
    from gaussian_mesh_splatting_tpu_torch.renderer import render
    from gaussian_mesh_splatting_tpu_torch.train import (
        make_train_state, make_train_step, optimization_config, sh_degree_mask)

    if ctx.world != 1:
        raise SystemExit("the gap case runs on one rank")
    scene, _, _, gts = ctx.scene()
    cfg = optimization_config("gs_mesh")
    cam, gt, bg = scene.train_cameras[0][0], gts[0], torch.ones(3, device=ctx.dev)

    def first_step(step, target):
        state = make_train_state(scene.init_model_state(mesh_model, SH_DEGREE), cfg,
                                 scene.cameras_extent)
        step(state, cam, target, bg)
        return {k: p.grad.cpu().clone() for k, p in state.params.items()}

    with torch.no_grad():
        bag = mesh_model.to_bag(scene.init_model_state(mesh_model, SH_DEGREE))
        bag = dataclasses.replace(bag, shs=sh_degree_mask(bag.shs, 0))  # step 1's SH degree
        full = render(bag, cam, bg, sh_degree=SH_DEGREE).image
        group = ctx.group()
        sharded = gaussian_sharded.render_gaussians(bag, cam, bg, group, sh_degree=SH_DEGREE).image
    # an element where one image equals the GT and the other is off it:
    # L1's subgradient is 0 in one step and +-0.8/(3HW) in the other
    off = sharded != full
    out = {"image_elements_off_by_rounding": int(off.sum()),
           "max_image_diff": float((sharded - full).abs().max()),
           "unsharded_equals_gt_sharded_off": int(((full == gt) & off).sum()),
           "sharded_equals_gt_unsharded_off": int(((sharded == gt) & off).sum())}
    tie = (full == gt) | (sharded == gt)
    unsharded = make_train_step(mesh_model, cfg, SH_DEGREE)
    sharded_step, _ = make_mode_step(ctx, "gaussians")
    ref = first_step(unsharded, gt)
    out["depth_order"] = grad_errors(first_step(sharded_step, gt), ref)
    real = gaussian_sharded.depth_order
    gaussian_sharded.depth_order = lambda bag, cam, n: torch.arange(
        bag.xyz.shape[0], device=bag.xyz.device)
    try:
        out["index_order"] = grad_errors(first_step(sharded_step, gt), ref)
    finally:
        gaussian_sharded.depth_order = real
    moved = torch.where(tie, gt + 2.0 ** -10, gt)
    out["gt_off_the_kink"] = grad_errors(first_step(sharded_step, moved),
                                         first_step(unsharded, moved))
    return out


def case_scaling(ctx, mode: str, widths: list[int], iters: int):
    """`multihost.measure_scaling` of `mode`'s step from the fresh student
    at each width: data (one view a rank: rank r takes view r), rows or
    gaussians (view 0 on every rank)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.parallel import (
        make_dp_train_step, make_sharded_train_step, multihost)
    from gaussian_mesh_splatting_tpu_torch.train import make_train_state, optimization_config

    scene, init, _, gts = ctx.scene()
    cfg = optimization_config("gs_mesh")

    def builder(mesh):
        state = make_train_state(init, cfg, scene.cameras_extent)
        if mode == "data":
            step, view = make_dp_train_step(mesh_model, cfg, SH_DEGREE, mesh), ctx.rank
        else:
            step, view = make_sharded_train_step(mesh_model, cfg, SH_DEGREE, mesh, shard=mode), 0
        return step, (state, scene.train_cameras[view][0], gts[view],
                      torch.ones(3, device=ctx.dev))

    return multihost.measure_scaling(builder, widths=widths, iters=iters)


CASES = {"render": case_render, "steps": case_steps, "comm": case_comm,
         "kernels": case_kernels, "gap": case_gap, "scaling": case_scaling}


# ---------------------------------------------------------------- spawning

def rank_main(rank: int, world: int, out_dir: str, cases: dict, setup: dict) -> None:
    """One spawned rank: its output to out_dir/rank<r>.log; join the group
    (NCCL on cuda:rank, or gloo CPU processes), run `cases` ({key: (case
    name, kwargs)}) in order, save the results to out_dir/rank<r>.pt."""
    log_file = open(os.path.join(out_dir, f"rank{rank}.log"), "w", buffering=1)
    os.dup2(log_file.fileno(), 1)  # NCCL's own lines too
    os.dup2(log_file.fileno(), 2)
    sys.stdout = sys.stderr = log_file
    if setup["device"] == "cuda":
        os.environ.setdefault("NCCL_DEBUG", "INFO")
        os.environ.setdefault("NCCL_DEBUG_SUBSYS", "INIT,GRAPH")
    import torch
    import torch.distributed as dist

    from gaussian_mesh_splatting_tpu_torch.parallel import create_mesh, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = "nccl" if setup["device"] == "cuda" else "gloo"
    multihost.initialize(f"file://{os.path.join(out_dir, 'store')}", world_size=world,
                         rank=rank, backend=backend,
                         timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if setup["device"] == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index != rank:
            raise SystemExit(f"rank {rank} is on {dev}, not cuda:{rank}")
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    ctx = types.SimpleNamespace(
        rank=rank, world=world, dev=dev,
        scene=lambda: load_scene(setup["data_dir"], setup["num_splats"], dev),
        group=lambda: create_mesh().get_group())
    results = {"device": multihost.device_label(dev),
               "backend": dist.get_backend(create_mesh().get_group())}
    for key, (name, kw) in cases.items():
        t0 = time.perf_counter()
        results[key] = CASES[name](ctx, **kw)
        print(f"rank {rank}: {key} in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn(cases: dict, world: int, out_dir: str, setup: dict, timeout: float = 600.0) -> list:
    """Run `cases` on `world` spawned ranks; returns each rank's results. A
    rank that fails ends the others and the run (its log's tail printed)."""
    import multiprocessing

    import torch

    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, out_dir, cases, setup))
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
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.log")
            if os.path.exists(path):
                with open(path) as f:
                    log(f"---- rank {r} (exit {codes[r]}), last lines:\n" + "".join(
                        f.readlines()[-30:]))
        raise SystemExit(f"{os.path.basename(out_dir)}: rank exit codes {codes}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]


def check_devices(label: str, devices: list[str], device: str) -> None:
    """Rank r on cuda:r, every rank on its own card (PCI address)."""
    if device != "cuda":
        return
    for r, d in enumerate(devices):
        if not d.startswith(f"cuda:{r} "):
            raise SystemExit(f"{label}: rank {r} on {d}")
    if len(set(devices)) != len(devices):
        raise SystemExit(f"{label}: ranks share a card: {devices}")


# ---------------------------------------------------------------- torchrun

def torchrun(world: int, argv: list[str], viewer=None) -> str:
    """`torchrun --standalone --nproc_per_node world -m ...apps.train argv`
    in a session of its own (killed whole at APP_TIMEOUT_S); `viewer`, a
    function of nothing, runs beside it in a thread. Returns the standard
    output; a nonzero exit ends the run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), "-m", "gaussian_mesh_splatting_tpu_torch.apps.train", *argv]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    thread = None
    if viewer is not None:
        thread = threading.Thread(target=viewer, daemon=True)
        thread.start()
    try:
        stdout, stderr = proc.communicate(timeout=APP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
    if thread is not None:
        thread.join(60)
    if proc.returncode != 0:
        raise SystemExit(f"torchrun {' '.join(argv)} failed ({proc.returncode}):\n"
                         f"{stdout[-3000:]}\n{stderr[-3000:]}")
    return stdout


REPLICAS = re.compile(r"replicas bit-identical on (\d+) processes \(state digest (-?\d+)\): (.*)")


def check_app(label: str, stdout: str, world: int, device: str) -> dict:
    """The app joined a group of `world` on the expected backend and ended
    with its replica check; the ranks' devices."""
    backend = "nccl" if device == "cuda" else "gloo"
    if f"joined a process group of {world} ({backend})" not in stdout:
        raise SystemExit(f"{label}: no group of {world} on {backend}:\n{stdout[-2000:]}")
    if world == 1:  # a group of one trains as a single device: nothing to compare
        return {"digest": None, "devices": []}
    found = REPLICAS.search(stdout)
    if found is None or int(found.group(1)) != world:
        raise SystemExit(f"{label}: no replica check of {world} processes:\n{stdout[-2000:]}")
    devices = re.findall(r"rank \d+ on (cuda:\d+ \([^)]*\)|cpu)", found.group(3))
    check_devices(label, devices, device)
    return {"digest": int(found.group(2)), "devices": devices}


def pause_viewer(port: int, message: dict, n_bytes: int, got: dict):
    """A viewer for `torchrun`: connect (rank 0 binds the port at its
    start), uncheck "train" for PAUSE_S seconds taking frames, ask for one
    training frame, close. Records the frames and the pause in `got`."""
    import socket
    import struct

    def recv(c, n):
        out = b""
        while len(out) < n:
            chunk = c.recv(n - len(out))
            if not chunk:
                raise ConnectionError("the trainer closed the viewer's connection")
            out += chunk
        return out

    def request(c, train):
        payload = json.dumps({**message, "train": train}).encode()
        c.sendall(struct.pack("<I", len(payload)) + payload)
        recv(c, n_bytes)
        recv(c, struct.unpack("<I", recv(c, 4))[0])

    def run():
        deadline = time.monotonic() + 300
        while True:
            try:
                c = socket.create_connection(("127.0.0.1", port), timeout=300)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        with c:
            request(c, train=False)
            got["frames"], t0 = 1, time.monotonic()
            while time.monotonic() - t0 < PAUSE_S:
                request(c, train=False)
                got["frames"] += 1
            got["pause_s"] = time.monotonic() - t0
            request(c, train=True)

    return run


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def app_runs(world: int, work: str, scenes, scale: Scale, device: str, viewer_msg) -> dict:
    """(g): the apps.train launches at `world`."""
    from gaussian_mesh_splatting_tpu_torch.io.ply import read_ply

    common = ["--white_background", "--sh_degree", str(SH_DEGREE), "--test_iterations", "-1",
              "--device", device]
    mesh = ["--gs_type", "gs_mesh", "-s", scenes.data_dir, "--num_splats", str(scale.num_splats),
            "--iterations", str(scale.app_iters), *common]
    runs = {
        "gs_mesh_data": [*mesh, "--data_parallel"],
        "gs_mesh_rows": [*mesh, "--shard", "rows"],
        "gs_mesh_gaussians": [*mesh, "--shard", "gaussians"],
        "gs_data": ["--gs_type", "gs", "-s", scenes.gs_dir, "--iterations", str(scale.gs_iters),
                    *(str(x) for kv in scale.gs_schedule for x in kv), *common,
                    "--data_parallel"],
        "gs_flame_gaussians": ["--gs_type", "gs_flame", "-s", scenes.flame_dir, "--flame_model",
                               scenes.flame_pkl, "--iterations", str(scale.app_iters), *common,
                               "--shard", "gaussians"],
    }
    if world == 4:
        runs["gs_mesh_data_port"] = [*mesh, "--data_parallel"]
    out = {}
    for name, argv in runs.items():
        model_dir = os.path.join(work, f"app_w{world}_{name}")
        viewer, got = None, {}
        if name.endswith("_port"):
            port = free_port()
            argv = [*argv, "--port", str(port)]
            viewer = pause_viewer(port, viewer_msg, scale.size * scale.size * 3, got)
        t0 = time.perf_counter()
        stdout = torchrun(world, [*argv, "-m", model_dir], viewer)
        res = {**check_app(f"world {world} {name}", stdout, world, device),
               "wall_s": time.perf_counter() - t0}
        if name == "gs_data":  # the snapshot holds the alive rows
            res["points"] = [len(read_ply(os.path.join(model_dir, *path))["x"]) for path in (
                ("input.ply",),
                ("point_cloud", f"iteration_{scale.gs_iters}", "point_cloud.ply"))]
            if res["points"][0] == res["points"][1]:
                raise SystemExit(f"world {world} gs: the densify events changed nothing "
                                 f"({res['points']} points)")
        if viewer is not None:
            if got.get("pause_s", 0.0) < PAUSE_S:
                raise SystemExit(f"world {world} {name}: the viewer did not pause ({got})")
            res["viewer"] = got
        out[name] = res
        log(f"[g] world {world} apps.train {name}: {json.dumps(res)}")
    return out


# ---------------------------------------------------------------- main

def world_cases(world: int, largest: bool, device: str) -> dict:
    modes = ["rows", "gaussians", "data"] + (["composed"] if world == 4 else [])
    cases = {"render": ("render", {}),
             **{f"steps_{m}": ("steps", {"mode": m}) for m in modes},
             "comm": ("comm", {})}
    if largest and device == "cuda":
        cases["kernels"] = ("kernels", {})
    return cases


def check_world(world: int, ranks: list, refs: list, device: str) -> dict:
    """(a)-(f) of one world's ranks: raises on any bound; returns the
    figures."""
    out = {"devices": [r["device"] for r in ranks]}
    check_devices(f"world {world}", out["devices"], device)
    backend = "nccl" if device == "cuda" else "gloo"
    if any(r["backend"] != backend for r in ranks):
        raise SystemExit(f"world {world}: groups on {[r['backend'] for r in ranks]}")
    launches_per_render = (1, 0) if device == "cuda" else (0, 0)
    for r, res in enumerate(ranks):
        rend = res["render"]
        if not rend["rows"]["bit_equal"]:
            raise SystemExit(f"[a] world {world} rank {r}: the row-sharded render is not "
                             f"bit-equal (max err {rend['rows']['max_abs_err']})")
        if not rend["gaussians"]["max_abs_err"] <= PAR_SATURATION_TOL:
            raise SystemExit(f"[b] world {world} rank {r}: the Gaussian-sharded render is off "
                             f"by {rend['gaussians']['max_abs_err']}")
        for shard in ("rows", "gaussians"):
            if tuple(rend[shard]["launches"]) != launches_per_render:
                raise SystemExit(f"world {world} rank {r}: {shard} render launched "
                                 f"{rend[shard]['launches']}")
    rend = ranks[0]["render"]
    out["render"] = {"gaussians_max_abs_err": rend["gaussians"]["max_abs_err"],
                     "saturated_pixels": rend["saturated_pixels"],
                     "ms": {r: {s: res["render"][s]["ms"] for s in ("rows", "gaussians")}
                            for r, res in enumerate(ranks)},
                     "unsharded_ms": rend["unsharded_ms"]}
    log(f"[a] world {world}: rows render bit-equal on every rank; [b] gaussians max abs err "
        f"{rend['gaussians']['max_abs_err']:.3g} (bound {PAR_SATURATION_TOL}); "
        f"{json.dumps(out['render'])}")
    out["steps"] = {}
    want_launches = (PAR_STEPS, PAR_STEPS) if device == "cuda" else (0, 0)
    n_views = {"rows": 1, "gaussians": 1, "data": world, "composed": world // 2}
    for mode in [m for m in ("rows", "gaussians", "data", "composed") if f"steps_{m}" in ranks[0]]:
        got = [res[f"steps_{mode}"] for res in ranks]
        errs = [cs.check_first_step(f"world {world} {mode} rank {r}", g, g["grads"],
                                    refs[:n_views[mode]]) for r, g in enumerate(got)]
        cs.check_run(f"world {world} {mode} step", got, want_launches)
        worst = max(range(world), key=lambda r: errs[r]["max_grad_err_rel"])
        out["steps"][mode] = {
            "grad_err_rel": errs[worst]["grad_err_rel"], "worst_key": errs[worst]["worst_key"],
            "max_grad_err_rel": errs[worst]["max_grad_err_rel"],
            "grad_accum_err": max(e["grad_accum_err"] for e in errs),
            "loss_rel_err": max(e["loss_rel_err"] for e in errs),
            "median_step_ms": {r: statistics.median(g["step_ms"][:PAR_TIMED])
                               for r, g in enumerate(got)},
            "first_loss": got[0]["losses"][0], "last_loss": got[0]["losses"][-1],
            "launches_per_rank": list(got[0]["launches"])}
        log(f"[c,d] world {world} {mode}: first step within {PAR_GRAD_TOL} x max|g| on every "
            f"key and rank, params bit-identical after {PAR_STEPS} steps: "
            f"{json.dumps(out['steps'][mode])}")
    out["comm"] = {r: res["comm"] for r, res in enumerate(ranks)}
    log(f"[e] world {world} collectives ({backend}, ms, rank 0): "
        f"{json.dumps(ranks[0]['comm'])}")
    if "kernels" in ranks[0]:
        out["kernels"] = {r: res["kernels"] for r, res in enumerate(ranks)}
        log(f"[f] world {world}: B1 and B2 equal their plain versions on every card: "
            f"{json.dumps(out['kernels'])}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--worlds", type=int, nargs="+", default=[2, 4], choices=[1, 2, 4])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--work", default=os.path.join(ROOT, "build", "multicard"))
    p.add_argument("--out", default=None, help="the results' JSON (default: <work>/result.json)")
    p.add_argument("--gap", action="store_true",
                   help="the gaussians step's first-step gap on one rank, per key")
    args = p.parse_args(argv)
    worlds = sorted(set(args.worlds))
    if args.device == "cuda":
        require_cards(max(worlds))
    import torch

    for line in machine_lines(args.device):
        log(line)
    t_script = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    scale = CARD if args.device == "cuda" else CPU
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    if args.device == "cuda":
        import concurrent.futures

        from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

        names = ("composite_fwd", "composite_bwd")
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            for name, (path, s, _) in zip(names, pool.map(cuda_build.build, names)):
                log(f"built {os.path.relpath(path, ROOT)} in {s:.2f} s (one library, loaded "
                    "by every rank)")
    scenes = write_scenes(args.work, scale, dev)
    setup = {"device": args.device, "data_dir": scenes.data_dir, "num_splats": scale.num_splats}
    parent = types.SimpleNamespace(
        dev=dev, scene=lambda: load_scene(scenes.data_dir, scale.num_splats, dev))
    refs = unsharded_references(parent, max(worlds))
    viewer_msg = cs.viewer_message(parent.scene()[0].test_cameras[0][0])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    results = {"device": args.device, "machine": machine_lines(args.device),
               "scale": dataclasses.asdict(scale), "n_gaussians": scenes.n_gaussians,
               "n_flame": scenes.n_flame, "worlds": {}}
    if args.gap:
        t0 = time.perf_counter()
        (gap,) = spawn({"gap": ("gap", {})}, 1, os.path.join(args.work, "gap"), setup)
        results["gap"] = {"device": gap["device"], **gap["gap"]}
        log(f"[gap] gaussians first step vs the unsharded one, per key (x max|g|), on "
            f"{gap['device']}: {json.dumps(results['gap'])} ({time.perf_counter() - t0:.1f} s)")
    for world in worlds:
        t0 = time.perf_counter()
        ranks = spawn(world_cases(world, world == max(worlds), args.device), world,
                      os.path.join(args.work, f"world{world}"), setup)
        res = check_world(world, ranks, refs, args.device)
        res["cases_s"] = time.perf_counter() - t0
        if args.device == "cuda":
            res["nccl_links"] = nccl_links(os.path.join(args.work, f"world{world}", "rank0.log"))
            log(f"world {world} NCCL links (rank 0): {json.dumps(res['nccl_links'])}")
        log(f"world {world}: ranks on {res['devices']}; cases {res['cases_s']:.1f} s")
        t0 = time.perf_counter()
        res["apps"] = app_runs(world, args.work, scenes, scale, args.device, viewer_msg)
        res["apps_s"] = time.perf_counter() - t0
        results["worlds"][str(world)] = res
    results["wall_s"] = time.perf_counter() - t_script
    out_path = args.out or os.path.join(args.work, "result.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    log(f"wrote {out_path}; wall {results['wall_s']:.1f} s")
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
