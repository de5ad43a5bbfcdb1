#!/usr/bin/env python3
"""Gradient conformance of the port at the scale users train, on one CUDA
card (the counterpart of the JAX package's `tools_verify_grads.py`).

    python3 tools_torch_verify_grads.py [--out build/verify_grads/result.json]

Two checks of the whole loss's gradient, both through the CUDA path
(`rasterize_cuda`: B1 `csrc/composite_fwd.cu` forward, B2
`csrc/composite_bwd.cu` backward):

1. `oracle_grad_check`: against the sequential torch oracle's autograd
   (`rasterize_reference`, folded in checkpointed groups of 500:
   `scan_chunk`) on 40,000 Gaussians at 512x512, at the kernels' 16x16
   binning tile. Both sides share `preprocess`, so the difference isolates
   the composite kernels, whose float32 atomic sums grow with the pair
   count. Bound: every key within GRAD_TOL * max|g|, the losses within
   1e-6 relative.
2. `fd_checks`: two-sided finite differences of the whole loss along
   gradient-aligned directions (the gradient, and each key's block of it)
   at 100,000 Gaussians, 800x800, at eps 2e-3, 1e-3 and 4e-3 (a miss that
   moves with eps is truncation; one that does not is the gradient).
   Bound: every direction's relative error at most 0.1 at eps 2e-3.

The scene is the JAX tool's: `xyz` N(0, 0.5^2), `scales_log` N(-3.5,
0.3^2), `q` N(0, 1), `opacity_raw` N(0, 1), SH degree 3 with DC U(-0.5,
1.5) and the rest N(0, 0.01^2), one numpy generator; identity rotation,
camera at (0, 0, 4), fov 0.8 both ways; black target and background; the
loss `train/loss.photometric_loss` at lambda 0.2. Runs only on a card
(exits 2 without one); prints the card's name and power limit and writes
one JSON object to `--out`. Exits 1 if a bound is missed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from chip_smoke import GRAD_TOL

ROOT = os.path.dirname(os.path.abspath(__file__))
LOSS_RTOL = 1e-6  # CUDA path against the oracle, relative
FD_TOL = 0.1  # relative error of a finite difference at FD_EPS[0]
FD_EPS = (2e-3, 1e-3, 4e-3)
KEYS = ("xyz", "scales_log", "q", "opacity_raw", "shs")


def scene_arrays(n: int, seed: int = 0, scale_mean: float = -3.5) -> dict:
    """The raw parameters (float32 numpy), drawn as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    params = {
        "xyz": rng.normal(0.0, 0.5, (n, 3)),
        "scales_log": rng.normal(scale_mean, 0.3, (n, 3)),
        "q": rng.normal(0.0, 1.0, (n, 4)),
        "opacity_raw": rng.normal(0.0, 1.0, (n, 1)),
        "shs": np.concatenate([rng.uniform(-0.5, 1.5, (n, 3, 1)),
                               rng.normal(0.0, 0.01, (n, 3, 15))], axis=-1),
    }
    return {k: v.astype(np.float32) for k, v in params.items()}


def make_scene(n: int, width: int, height: int, device="cuda", scale_mean: float = -3.5):
    """(params, camera, target): params as leaf tensors on `device`."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera

    params = {k: torch.tensor(v, device=device)
              for k, v in scene_arrays(n, scale_mean=scale_mean).items()}
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, width, height,
                      device=device)
    return params, cam, torch.zeros((height, width, 3), device=device)


def bag_of(p: dict, n: int):
    import torch

    from gaussian_mesh_splatting_tpu_torch.models.gaussian_bag import GaussianBag

    return GaussianBag(
        xyz=p["xyz"], scaling=torch.exp(p["scales_log"]),
        rotation=p["q"] / torch.linalg.norm(p["q"], dim=-1, keepdim=True),
        opacity=torch.sigmoid(p["opacity_raw"]), shs=p["shs"],
        alive=torch.ones((n,), dtype=torch.bool, device=p["xyz"].device))


def loss_fn_factory(cam, target, n: int, backend: str, **kw):
    """params -> the photometric loss of one render (`backend` "auto": the
    composite kernels on CUDA tensors; "reference": the oracle)."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.renderer import render
    from gaussian_mesh_splatting_tpu_torch.train.loss import photometric_loss

    def loss_fn(p):
        out = render(bag_of(p, n), cam, torch.zeros(3, device=target.device), sh_degree=3,
                     backend=backend, **kw)
        return photometric_loss(out.image, target, 0.2)[0]
    return loss_fn


def value_and_grad(loss_fn, params: dict):
    """(loss, {key: gradient}) of `loss_fn` at `params`, detached."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(p)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in p.items()}


def pair_count(params: dict, cam, n: int) -> int:
    """Pairs the kernels walk: `preprocess` + `bin_gaussians` at their tile."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
    from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE

    bag = bag_of(params, n)
    with torch.no_grad():
        proj = preprocess(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam, shs=bag.shs,
                          sh_degree=3, alive=bag.alive, radius_mode="tight")
        b = bin_gaussians(proj, tile_h=TILE, tile_w=TILE, n_tiles_y=-(-cam.height // TILE),
                          n_tiles_x=-(-cam.width // TILE))
    return int((b.tile_end - b.tile_start).sum())


def launches() -> dict:
    """The composite kernels' launch counts in this process (0 on the CPU,
    where the wrappers take the plain versions). Read, not cleared: a
    caller may count a span that holds several checks."""
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

    return {e: cuda_build.launches[e] for e in ("composite_fwd", "composite_bwd")}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def oracle_grad_check(n: int = 40_000, width: int = 512, height: int = 512, *,
                      scan_chunk: int = 500, device="cuda") -> dict:
    """The CUDA path's loss and gradients against the chunked oracle's, per
    key: max abs error, max|g| and their ratio; `ok` if every ratio is at
    most GRAD_TOL and the losses agree within LOSS_RTOL."""
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE

    params, cam, target = make_scene(n, width, height, device=device)
    times = {}
    t0, before = time.perf_counter(), launches()
    loss_fast, g_fast = value_and_grad(loss_fn_factory(cam, target, n, "auto"), params)
    _sync(device)
    times["fast_s"] = time.perf_counter() - t0
    times["launches"] = _since(before)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss_ref, g_ref = value_and_grad(loss_fn_factory(
        cam, target, n, "reference", tile_size=(TILE, TILE), scan_chunk=scan_chunk), params)
    _sync(device)
    times["oracle_s"] = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        times["oracle_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    lf, lr = float(loss_fast), float(loss_ref)
    report = {"n_gaussians": n, "image": [height, width], "tile": TILE,
              "scan_chunk": scan_chunk, "n_pairs": pair_count(params, cam, n),
              "loss_fast": lf, "loss_oracle": lr,
              "loss_rel_err": abs(lf - lr) / max(abs(lr), 1e-30), "per_param": {}, **times}
    for k in KEYS:
        a = g_fast[k].double().cpu().numpy().ravel()
        b = g_ref[k].double().cpu().numpy().ravel()
        scale = float(np.abs(b).max())
        max_abs = float(np.abs(a - b).max())
        report["per_param"][k] = {"max_abs_err": max_abs, "grad_scale": scale,
                                  "max_rel_err_vs_scale": max_abs / max(scale, 1e-30),
                                  "finite": bool(np.isfinite(a).all())}
    report["worst_rel_err"] = max(v["max_rel_err_vs_scale"] for v in report["per_param"].values())
    report["ok"] = bool(
        report["loss_rel_err"] <= LOSS_RTOL and report["worst_rel_err"] <= GRAD_TOL
        and all(v["finite"] and v["grad_scale"] > 0 for v in report["per_param"].values()))
    return report


def fd_checks(n: int = 100_000, width: int = 800, height: int = 800, *,
              eps: tuple = FD_EPS, scale_mean: float = -3.5, device="cuda") -> dict:
    """Two-sided differences of the loss along gradient-aligned directions.

    The directions are the gradient and each key's block of it: a random
    unit direction in the ~5.9 M-dimensional parameter space has a
    derivative of about ||g|| / sqrt(dim), whose difference at any eps small
    enough to stay linear falls below the float32 ulp of the loss. Along
    g / ||g|| the derivative is ||g|| itself. Each direction records the
    loss delta at eps[0] in ulps of the loss (`delta_ulps`); `ok` if every
    direction's relative error at eps[0] is at most FD_TOL."""
    import torch

    params, cam, target = make_scene(n, width, height, device=device, scale_mean=scale_mean)
    before = launches()
    loss_fn = loss_fn_factory(cam, target, n, "auto")
    loss0, g = value_and_grad(loss_fn, params)
    ulp = float(np.spacing(np.float32(float(loss0))))

    def check(tag: str, v: dict) -> dict:
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in v.values()))
        v = {k: (x.double() / norm).float() for k, x in v.items()}
        analytic = float(sum((g[k].double() * v[k].double()).sum() for k in KEYS))
        row = {"dir": tag, "analytic": analytic}
        for e in eps:
            with torch.no_grad():
                plus = float(loss_fn({k: params[k] + e * v[k] for k in KEYS}))
                minus = float(loss_fn({k: params[k] - e * v[k] for k in KEYS}))
            fd = (plus - minus) / (2 * e)
            row[f"fd@{e:g}"] = fd
            row[f"rel_err@{e:g}"] = abs(fd - analytic) / max(abs(fd), abs(analytic), 1e-12)
            if e == eps[0]:
                row["delta_ulps"] = abs(plus - minus) / ulp
        return row

    rows = [check("grad", g)]
    for k in KEYS:
        if float((g[k] ** 2).sum()) > 0.0:
            rows.append(check(f"grad/{k}", {kk: g[kk] if kk == k else torch.zeros_like(g[kk])
                                            for kk in KEYS}))
    worst = max(r[f"rel_err@{eps[0]:g}"] for r in rows)
    return {"n_gaussians": n, "image": [height, width], "eps": list(eps),
            "loss": float(loss0), "loss_ulp": ulp, "directions": rows,
            "worst_rel_err": worst, "launches": _since(before), "ok": bool(worst <= FD_TOL)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("tools_torch_verify_grads")
    p.add_argument("--out", default=os.path.join(ROOT, "build", "verify_grads", "result.json"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tools_torch_verify_grads: no CUDA device; this script checks the kernels on "
              "the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    report["oracle_grads"] = oracle_grad_check()
    print("oracle_grads:", json.dumps(report["oracle_grads"]), flush=True)
    report["fd_checks"] = fd_checks()
    print("fd_checks:", json.dumps(report["fd_checks"]), flush=True)
    report["wall_s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}; oracle ok {report['oracle_grads']['ok']}, "
          f"fd ok {report['fd_checks']['ok']}, {report['wall_s']:.1f} s", flush=True)
    return 0 if report["oracle_grads"]["ok"] and report["fd_checks"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
