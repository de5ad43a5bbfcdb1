"""Fwd+bwd+update throughput of the port's rasterizer (the counterpart of the
repository's root `bench.py`): pixels per second for a chained training-like
step on 100k random Gaussians at 800x800, SH degree 3.

    python -m gaussian_mesh_splatting_tpu_torch.bench [--device cpu --n 256 --size 64]

Each step renders (preprocess, binning, the forward composite kernel), takes
the photometric loss against a black target, runs the backward (the backward
composite kernel, then autograd through projection and SH) and updates
p <- p - 1e-7 * g, so the next step starts from the updated params. It
refuses to print a number when the gradients are zero: a backward that
produced none would make any timing a forward-only number. Prints one JSON
line {"metric", "value", "unit", "vs_baseline", "device", ...}.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# the reference trains gs_flat on an 800x800 scene in ~10 min on an RTX 2070:
# 30_000 iterations * 640_000 pixels / 600 s ~= 32 M fwd+bwd pixels/s
BASELINE_PIXELS_PER_S = 32e6


def make_params(n: int, seed: int, device) -> dict[str, torch.Tensor]:
    """Random Gaussians with a converged scene's scale distribution (most a
    few pixels across), as leaf tensors that require grad."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device, requires_grad=True)

    return {
        "xyz": t(rng.standard_normal((n, 3)) * 0.5),
        "scales_log": t(rng.standard_normal((n, 3)) * 0.3 - 3.5),
        "q": t(rng.standard_normal((n, 4))),
        "opacity_raw": t(rng.standard_normal((n, 1))),
        "shs": t(np.concatenate([rng.random((n, 3, 1)) * 2 - 0.5,
                                 rng.standard_normal((n, 3, 15)) * 0.01], axis=-1)),
    }


def make_step(params: dict, size: int, device):
    """The chained step: params -> (loss, grad L1 norm), updating params."""
    from .core.camera import make_camera
    from .models.gaussian_bag import GaussianBag
    from .renderer import render
    from .train.loss import photometric_loss

    n = params["xyz"].shape[0]
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, size, size, device=device)
    target = torch.zeros((size, size, 3), device=device)
    bg = torch.zeros(3, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)

    def step():
        p = params
        offset = torch.zeros((n, 2), device=device, requires_grad=True)
        bag = GaussianBag(
            xyz=p["xyz"], scaling=torch.exp(p["scales_log"]),
            rotation=p["q"] / torch.linalg.vector_norm(p["q"], dim=-1, keepdim=True),
            opacity=torch.sigmoid(p["opacity_raw"]), shs=p["shs"], alive=alive,
        )
        out = render(bag, cam, bg, sh_degree=3, mean2d_offset=offset)
        loss, _ = photometric_loss(out.image, target, 0.2)
        grads = torch.autograd.grad(loss, [*p.values(), offset])
        with torch.no_grad():
            for v, g in zip(p.values(), grads):
                v -= 1e-7 * g
            grad_norm = sum(g.abs().sum() for g in grads)
        return loss.detach(), grad_norm

    return step


def run(n: int = 100_000, size: int = 800, iters: int = 10, seed: int = 0,
        device: str | torch.device | None = None) -> dict:
    from .device import resolve_device

    dev = resolve_device(device)
    params = make_params(n, seed, dev)
    step = make_step(params, size, dev)
    _, grad_norm = step()  # warm-up (builds the kernels on the card)
    gn = float(grad_norm)
    if not gn > 1e-3:
        raise SystemExit(
            f"BENCH REFUSED: the rasterizer backward produced ~zero gradients "
            f"(|g|_1 = {gn}); a timing of this build would not be a fwd+bwd number"
        )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, grad_norm = step()
    float(loss)  # waits for the last step
    dt = (time.perf_counter() - t0) / iters
    pixels_per_s = size * size / dt
    return {
        "metric": "pixels_per_s_fwd_bwd",
        "value": pixels_per_s,
        "unit": "pixels/s",
        "vs_baseline": pixels_per_s / BASELINE_PIXELS_PER_S,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "gaussians": n,
        "size": size,
        "step_ms": dt * 1e3,
        "grad_l1": gn,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("bench")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    res = run(args.n, args.size, args.iters, device=args.device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
