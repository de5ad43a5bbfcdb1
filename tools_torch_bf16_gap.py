#!/usr/bin/env python3
"""Where the bf16 attribute table's gradients part from the exact ones.

On chip_smoke.py's B2 inputs (the gs_mesh student's first step, the gs and
gs_flame first steps, train view 0 at 800x800, the photometric cotangent
of the exact forward against the GT), B2 on the bf16 table
(attr_precision="bf16": pairs and per-Gaussian totals rounded) is held
against B2 on the float32 table (the exact mode). Per Gaussian: the largest
error over the ten columns as a share of that column's max|g| (the measure
of chip_smoke.BF16_MODE_TOL), and its own (pixel, pair)s whose part in B2
differs between the two tables (`chip_smoke.inclusion_flips`: included by
one and not the other, or clamped at alpha 0.99 by one only). Then the
Gaussians past the bound split by whether they have such a flip, the
largest error of the Gaussians that have none, and the worst Gaussians'
attributes. Also the sources of the gap: B2 on float32 tables with the
pairs and totals rounded as in the mode and the attributes rounded as the
bf16 table rounds them, but one group (mean2d, conic, opacity, colour,
depth) exact in turn, or that group alone rounded, or none rounded.

    python3 tools_torch_bf16_gap.py [--out PATH]   # on a card; under a minute

Prints the card's name and power limit, then one JSON line per input, and
writes them to PATH (default build/bf16_gap.json).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

import chip_smoke as cs

WORST = 8  # the worst Gaussians whose attributes are printed
ATTR_GROUPS = ("mean2d", "conic", "opacity", "color", "depth")


def gap(label: str, args, layout, teacher) -> dict:
    import torch

    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
        composite_bwd_cuda, composite_fwd_cuda, round_attributes)

    b = cs.bf16_inputs(args, layout)
    rest = args[5:]
    planes_x, nc_x = composite_fwd_cuda(*args, **layout)
    planes_r, nc_r = composite_fwd_cuda(*args, **b["layout"])
    cot = cs.photometric_cotangent(planes_x, teacher, torch.ones(3, device=args[0].device))
    g_exact = composite_bwd_cuda(*args, planes_x[3], nc_x, cot, **layout)
    g_mode = composite_bwd_cuda(*args, planes_r[3], nc_r, cot, **b["layout"],
                                round_pairs=True).to(torch.bfloat16).float()
    rel = cs.rel_per_gaussian(g_mode, g_exact)
    over = rel > cs.BF16_MODE_TOL
    flips = cs.inclusion_flips(args, b["rounded"], nc_x, nc_r)
    own = (flips["inclusion_flips"] > 0) | (flips["clamp_flips"] > 0)
    res = {"case": label, "gaussians": int(args[0].shape[0]), "pairs": int(args[5].shape[0]),
           "rel_err_vs_exact": float(rel.max()),
           "worst_column": cs.GRAD_COL_NAMES[int(((g_mode - g_exact).abs().amax(dim=0) / g_exact
                                                  .abs().amax(dim=0).clamp_min(1e-30)).argmax())],
           "gaussians_over_mode_tol": int(over.sum()),
           "over_with_inclusion_flip": int((over & (flips["inclusion_flips"] > 0)).sum()),
           "over_with_clamp_flip": int((over & (flips["clamp_flips"] > 0)).sum()),
           "over_without_own_flip": int((over & ~own).sum()),
           "gaussians_with_own_flip": int(own.sum()),
           "rel_err_without_own_flip": float(rel[~own].max()) if bool((~own).any()) else 0.0,
           "inclusion_flips": int(flips["inclusion_flips"].sum()),
           "clamp_flips": int(flips["clamp_flips"].sum()),
           "included_exact": int(flips["included_exact"].sum()),
           "included_rounded": int(flips["included_rounded"].sum()),
           "nc_differs_pixels": int((nc_x != nc_r).sum())}
    for q in (1e-3, 1e-2, cs.BF16_MODE_TOL):
        res[f"over_{q}"] = int((rel > q).sum())
        res[f"over_{q}_without_own_flip"] = int(((rel > q) & ~own).sum())

    pairs_per = torch.bincount(args[5].long(), minlength=args[0].shape[0])
    conic = args[1]
    det = conic[:, 0] * conic[:, 2] - conic[:, 1] ** 2
    worst = []
    for i in torch.argsort(rel, descending=True)[:WORST].tolist():
        col = int(((g_mode[i] - g_exact[i]).abs() / torch.clamp_min(
            g_exact.abs().amax(dim=0), 1e-30)).argmax())
        worst.append({
            "gaussian": i, "rel_err": float(rel[i]), "column": cs.GRAD_COL_NAMES[col],
            "g_exact": float(g_exact[i, col]), "g_mode": float(g_mode[i, col]),
            "col_max_abs": float(g_exact[:, col].abs().max()),
            "pairs": int(pairs_per[i]), "included_exact": int(flips["included_exact"][i]),
            "included_rounded": int(flips["included_rounded"][i]),
            "inclusion_flips": int(flips["inclusion_flips"][i]),
            "clamp_flips": int(flips["clamp_flips"][i]),
            "mean2d": args[0][i].tolist(), "conic": conic[i].tolist(),
            "conic_det_over_ac": float(det[i] / (conic[i, 0] * conic[i, 2])),
            "opacity": float(args[2][i])})
    res["worst"] = worst

    rounded = round_attributes(*args[:5])
    sources = {}
    for name, keep in (("none_rounded", range(5)),
                       *((f"{n}_exact", (i,)) for i, n in enumerate(ATTR_GROUPS)),
                       *((f"only_{n}_rounded", tuple(j for j in range(5) if j != i))
                         for i, n in enumerate(ATTR_GROUPS))):
        attrs = tuple(args[i] if i in keep else rounded[i] for i in range(5))
        sources[name] = float(cs.rel_per_gaussian(
            cs.rounded_b2(attrs, rest, layout["tile_order"], cot), g_exact).max())
    res["sources"] = sources
    return res


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(cs.ROOT, "build", "bf16_gap.json"))
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # one nvcc per source
        list(pool.map(cuda_build.build, ("composite_fwd", "composite_bwd")))
    ns = cs.build_scene(dev)
    cases = cs.kernel_cases(ns, dev)
    gt0 = torch.as_tensor(ns.scene.train_cameras[0][1], device=dev)
    fgt = torch.as_tensor(ns.flame_scene.train_cameras[0][1], device=dev)
    rows = []
    with torch.no_grad():
        for label, key, teacher in (("gs_mesh student first step", "train", gt0),
                                    ("gs first step", "gs", gt0),
                                    ("gs_flame first step", "flame", fgt)):
            rows.append(gap(label, *cases[key], teacher))
            print(json.dumps(rows[-1]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
