"""Offline metrics CLI (port of `gaussian_mesh_splatting_tpu/apps/metrics.py`).

Walks {model}/test/ours_N/renders_{gs_type} against gt/, computes SSIM
(`ops/ssim`), PSNR (`train/loss.psnr`) and LPIPS (`ops/lpips`) on the device,
and writes results_{gs_type}.json and per_view_{gs_type}.json in the JAX
app's layout. LPIPS needs the weights file (`ops/lpips.py`); when it is
absent the score is null, with a note. Runs on the CUDA device unless
`--device cpu` is given.

    python -m gaussian_mesh_splatting_tpu_torch.apps.metrics -m <model> [<model> ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _load_image(path: str, device: torch.device) -> torch.Tensor:
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return torch.as_tensor(img, device=device)


def _lpips_fn(device: torch.device):
    """An LPIPS(vgg) scorer on `device`; None when the weights file is absent."""
    from ..ops import lpips as lpips_mod

    params = lpips_mod.load_params(device=device)
    if params is None:
        print(
            "[metrics] LPIPS weights not found at "
            f"{lpips_mod.default_weights_path()}; reporting null. The file is the "
            "documented .npz of ops/lpips.py (the JAX package's "
            "ops.lpips.convert_torch_checkpoint() writes it offline)."
        )
        return None

    def score(a: torch.Tensor, b: torch.Tensor) -> float:
        return float(lpips_mod.lpips(a, b, params))

    return score


@torch.no_grad()
def evaluate(model_paths: list[str], device: str | torch.device = "cuda") -> None:
    from ..device import resolve_device
    from ..ops.ssim import ssim
    from ..train.loss import psnr as psnr_fn

    dev = resolve_device(device)
    lpips = _lpips_fn(dev)
    for model_path in model_paths:
        print(f"evaluating {model_path}")
        test_dir = os.path.join(model_path, "test")
        full_results, per_view = {}, {}
        for method in sorted(os.listdir(test_dir)):
            method_dir = os.path.join(test_dir, method)
            renders_dirs = [d for d in os.listdir(method_dir) if d.startswith("renders")]
            for rd in renders_dirs:
                gs_type = rd.replace("renders_", "") or "gs"
                r_dir = os.path.join(method_dir, rd)
                g_dir = os.path.join(method_dir, "gt")
                names = sorted(os.listdir(r_dir))
                ssims, psnrs, lpipss = [], [], []
                for name in names:
                    render = _load_image(os.path.join(r_dir, name), dev)
                    gt = _load_image(os.path.join(g_dir, name), dev)
                    ssims.append(float(ssim(render, gt)))
                    psnrs.append(float(psnr_fn(render, gt)))
                    lpipss.append(lpips(render, gt) if lpips else None)
                full_results.setdefault(method, {})[gs_type] = {
                    "SSIM": float(np.mean(ssims)),
                    "PSNR": float(np.mean(psnrs)),
                    "LPIPS": float(np.mean(lpipss)) if lpips else None,
                }
                per_view.setdefault(method, {})[gs_type] = {
                    "SSIM": dict(zip(names, ssims)),
                    "PSNR": dict(zip(names, psnrs)),
                    "LPIPS": dict(zip(names, lpipss)),
                }
                print(f"  {method}/{gs_type}: SSIM {np.mean(ssims):.4f} "
                      f"PSNR {np.mean(psnrs):.2f}")
                with open(os.path.join(model_path, f"results_{gs_type}.json"), "w") as f:
                    json.dump(full_results, f, indent=2)
                with open(os.path.join(model_path, f"per_view_{gs_type}.json"), "w") as f:
                    json.dump(per_view, f, indent=2)


def main(argv=None):
    p = argparse.ArgumentParser("metrics")
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    evaluate(args.model_paths, args.device)


if __name__ == "__main__":
    main()
