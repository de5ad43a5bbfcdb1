#!/usr/bin/env python3
"""The two composite kernels on the card, beside an earlier design of them.

Builds csrc/composite_fwd.cu (B1) and csrc/composite_bwd.cu (B2) and times
them on the main-path inputs of chip_smoke.py (B1: the seed-42 teacher's
render of train view 0; B2: the first training step of the fresh student
against the GT), 800x800, 51,200 Gaussians. Every build is first held
against the plain PyTorch version (B1: 2e-5 on r, g, b, T and no `nc`
mismatch; B2: within chip_smoke.GRAD_TOL). Builds are timed in turns (a, b,
..., b, a; the median of the two rounds' times), each launch between its own
CUDA events (`ms`: the median of `--reps`) and with `--reps` launches queued
back to back (`queued_ms`: the device time without the host's share of a
single launch), on the whole input, on its longest tile alone (a tile's walk
is serial, so that is the critical path) and with every tile empty (what a
launch costs before any pair is walked). The present build is also timed
with the tiles in index order instead of `Binning.tile_order`.

With `--baseline-csrc DIR` it also builds DIR/composite_fwd.cu and
DIR/composite_bwd.cu, an earlier design of the same kernels, and times them
in the same turns, so that two designs are compared on one card in one run.
Sources that do not name `tile_order` are taken to have the earlier C
interface (separate attribute arrays, no tile order, (N, 10) gradients):

    mkdir -p build/baseline_csrc
    git show <commit>:gaussian_mesh_splatting_tpu_torch/csrc/composite_fwd.cu \\
        > build/baseline_csrc/composite_fwd.cu      # and composite_bwd.cu
    python3 tools_torch_composite_probe.py --baseline-csrc build/baseline_csrc

Prints one JSON line per kernel and build, the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys

import chip_smoke as cs

BASELINE_FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
BASELINE_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def build(kernel: str, name: str, src_dir: str | None):
    """nvcc of one source with the port's flags. Returns (library, what ptxas
    said about registers, shared memory and spills)."""
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cs.ROOT, "build", "composite_probe")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{kernel}_{name}.so")
    src = os.path.join(src_dir or cuda_build.CSRC_DIR, f"{kernel}.cu")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{proc.stdout}\n{proc.stderr}")
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(out), ptxas


def tile_grid(h: int, w: int) -> tuple[int, int]:
    return -(-w // 16), -(-h // 16) * -(-w // 16)


def launch_fwd(lib, baseline: bool, args, layout):
    import torch

    mean2d, conic, opacity, color, depth, pg, ts, te, h, w = args
    planes = torch.empty((5, h, w), dtype=torch.float32, device=mean2d.device)
    nc = torch.empty((h, w), dtype=torch.int32, device=mean2d.device)
    stream = torch.cuda.current_stream().cuda_stream
    if baseline:
        err = lib.composite_fwd(pg.data_ptr(), ts.data_ptr(), te.data_ptr(), mean2d.data_ptr(),
                                conic.data_ptr(), opacity.data_ptr(), color.data_ptr(),
                                depth.data_ptr(), h, w, *tile_grid(h, w), planes.data_ptr(),
                                nc.data_ptr(), stream)
    else:
        err = lib.composite_fwd(pg.data_ptr(), ts.data_ptr(), te.data_ptr(),
                                layout["tile_order"].data_ptr(), layout["attrs"].data_ptr(),
                                h, w, *tile_grid(h, w), planes.data_ptr(), nc.data_ptr(), stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return planes, nc


def launch_bwd(lib, baseline: bool, args, layout, t_final, nc, cot):
    import torch

    mean2d, conic, opacity, color, depth, pg, ts, te, h, w = args
    n = mean2d.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    if baseline:
        grads = torch.zeros((n, 10), dtype=torch.float32, device=mean2d.device)
        err = lib.composite_bwd(pg.data_ptr(), ts.data_ptr(), te.data_ptr(), mean2d.data_ptr(),
                                conic.data_ptr(), opacity.data_ptr(), color.data_ptr(),
                                depth.data_ptr(), t_final.data_ptr(), nc.data_ptr(),
                                cot.data_ptr(), h, w, *tile_grid(h, w), grads.data_ptr(), stream)
    else:
        grads = torch.zeros((n, 12), dtype=torch.float32, device=mean2d.device)
        err = lib.composite_bwd(pg.data_ptr(), ts.data_ptr(), te.data_ptr(),
                                layout["tile_order"].data_ptr(), layout["attrs"].data_ptr(),
                                t_final.data_ptr(), nc.data_ptr(), cot.data_ptr(),
                                h, w, *tile_grid(h, w), grads.data_ptr(), stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return grads[:, :10]


def time_in_turns(runs: dict, reps: int, timer=None) -> dict:
    """name -> median over two rounds (forward order, then backward) of the
    median time of `reps` launches (`timer`: cs.cuda_ms, each launch between
    its own events, or cs.cuda_ms_queued, the launches queued back to back)."""
    timer = timer or cs.cuda_ms
    names = list(runs)
    times: dict = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(timer(runs[name], reps=reps))
    return {name: statistics.median(t) for name, t in times.items()}


def probe(kernel: str, libs: dict, launch, check, args, layout, longest_tile: int, reps: int):
    """Holds every build of `kernel` against the plain version (`check` of
    what `launch(lib, old_interface, args, layout)` returns gives the row's
    error columns or raises), times the builds in turns on the whole input,
    on the longest tile alone and with every tile empty, and prints a row
    for each. `libs`: build name -> (library, whether it has the earlier C
    interface)."""
    import torch

    rows = {name: check(name, launch(lib, old, args, layout)) for name, (lib, old) in libs.items()}
    alone, alone_order = cs.one_tile(args, longest_tile)
    no_tiles = (*args[:6], torch.zeros_like(args[6]), torch.zeros_like(args[7]), *args[8:])
    in_index_order = {**layout, "tile_order": torch.arange(
        layout["tile_order"].shape[0], dtype=torch.int32, device=args[0].device)}

    def runs(args, layout):
        return {name: (lambda lib=lib, old=old: launch(lib, old, args, layout))
                for name, (lib, old) in libs.items()}

    whole = runs(args, layout)
    whole["default, tiles in index order"] = runs(args, in_index_order)["default"]
    rows["default, tiles in index order"] = {}
    cols = {}
    for key, which in (("ms", whole),
                       ("longest_tile_alone_ms", runs(alone, {**layout, "tile_order": alone_order})),
                       ("all_tiles_empty_ms", runs(no_tiles, layout))):
        cols[key] = time_in_turns(which, reps)
        cols["queued_" + key] = time_in_turns(which, reps, cs.cuda_ms_queued)
    for name, row in rows.items():
        print(json.dumps({"kernel": kernel, "build": name, **row,
                          **{key: col.get(name) for key, col in cols.items()}}), flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-csrc", default=None,
                        help="directory with an earlier design's two sources")
    parser.add_argument("--reps", type=int, default=20)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build, rasterize_cuda as rc

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    print(subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-2], flush=True)

    jobs = [(k, "default", None) for k in ("composite_fwd", "composite_bwd")]
    if opts.baseline_csrc:
        jobs += [(k, "baseline", opts.baseline_csrc) for k in ("composite_fwd", "composite_bwd")]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda job: build(*job), jobs))
    libs: dict = {"composite_fwd": {}, "composite_bwd": {}}
    for (kernel, name, src_dir), (lib, ptxas) in zip(jobs, built):
        old = False
        if src_dir:
            with open(os.path.join(src_dir, f"{kernel}.cu")) as f:
                old = "tile_order" not in f.read()
        fn = getattr(lib, kernel)
        fn.restype = ctypes.c_int
        fn.argtypes = {("composite_fwd", False): rc.FWD_ARGTYPES,
                       ("composite_fwd", True): BASELINE_FWD_ARGTYPES,
                       ("composite_bwd", False): rc.BWD_ARGTYPES,
                       ("composite_bwd", True): BASELINE_BWD_ARGTYPES}[kernel, old]
        libs[kernel][name] = (lib, old)
        print(json.dumps({"kernel": kernel, "build": name, "ptxas": ptxas}), flush=True)

    ns = cs.build_scene(dev)
    cases = cs.kernel_cases(ns, dev)
    gt0 = torch.as_tensor(ns.scene.train_cameras[0][1], device=dev)

    # ---- B1 on the render path's inputs -------------------------------------
    args, layout = cases["full"]
    with torch.no_grad():
        planes_p, nc_p = rc.composite_fwd_plain(*args)
        _, fwd_steps = cs.composite_op_counts(args, nc_p)
    walk = cs.walk_shape(args, nc_p, fwd_steps)
    print(json.dumps({"kernel": "composite_fwd", "walk": walk}), flush=True)

    def check_fwd(name, result):
        planes, nc = result
        row = {"max_abs_err_rgbT": (planes[:4] - planes_p[:4]).abs().max().item(),
               "max_abs_err_depth": (planes[4] - planes_p[4]).abs().max().item(),
               "nc_mismatches": int((nc != nc_p).sum().item())}
        if row["max_abs_err_rgbT"] > 2e-5 or row["nc_mismatches"]:
            raise SystemExit(f"B1 build {name} differs from the plain version: {row}")
        return row

    probe("composite_fwd", libs["composite_fwd"], launch_fwd, check_fwd, args, layout,
          walk["fwd_steps"]["argmax"], opts.reps)

    # ---- B2 on the training path's first step -------------------------------
    args, layout = cases["train"]
    planes, nc = rc.composite_fwd_cuda(*args, **layout)
    cot = cs.photometric_cotangent(planes, gt0, torch.ones(3, device=dev))
    t_final = planes[3]
    g_p = rc.composite_bwd_plain(*args, t_final, nc, cot)
    scale = g_p.abs().amax(dim=0)
    walk = cs.walk_shape(args, nc)
    print(json.dumps({"kernel": "composite_bwd", "walk": walk}), flush=True)

    def check_bwd(name, g):
        rel = ((g - g_p).abs().amax(dim=0) / torch.clamp_min(scale, 1e-30)).max().item()
        if not rel <= cs.GRAD_TOL:
            raise SystemExit(f"B2 build {name} differs from the plain version: {rel}")
        return {"max_rel_err_per_col": rel}

    probe("composite_bwd", libs["composite_bwd"],
          lambda lib, old, args, layout: launch_bwd(lib, old, args, layout, t_final, nc, cot),
          check_bwd, args, layout, walk["bwd_steps"]["argmax"], opts.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
