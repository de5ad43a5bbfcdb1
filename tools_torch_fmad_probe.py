#!/usr/bin/env python3
"""Does floating-point contraction (FMA) change what the composite kernel
includes? Builds csrc/composite_fwd.cu twice, with the port's flags
(-fmad=false) and with nvcc's default contraction (-fmad=true), and holds
both against the plain PyTorch version on the card on the scenes of
chip_smoke.py: max |error| on r, g, b, T and depth, `nc` mismatches, and the
kernel time of each build (CUDA events, median of 20, builds timed in turns).

    python3 tools_torch_fmad_probe.py      # on a CUDA card; prints JSON lines
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

import chip_smoke as cs


def build_variant(fmad: bool) -> ctypes.CDLL:
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import FWD_ARGTYPES

    flags = [f for f in cuda_build.NVCC_FLAGS if not f.startswith("-fmad")]
    flags.append(f"-fmad={'true' if fmad else 'false'}")
    out_dir = os.path.join(cs.ROOT, "build", "fmad_probe")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"libcomposite_fwd_fmad_{fmad}.so")
    subprocess.run([cuda_build._nvcc(), *flags, "-o", out,
                    os.path.join(cuda_build.CSRC_DIR, "composite_fwd.cu")],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(out)
    lib.composite_fwd.restype = ctypes.c_int
    lib.composite_fwd.argtypes = FWD_ARGTYPES
    return lib


def launch(lib, args, layout):
    import torch

    mean2d, pg, ts, te, h, w = args[0], *args[5:]
    planes = torch.empty((5, h, w), dtype=torch.float32, device=mean2d.device)
    nc = torch.empty((h, w), dtype=torch.int32, device=mean2d.device)
    err = lib.composite_fwd(pg.data_ptr(), ts.data_ptr(), te.data_ptr(),
                            layout["tile_order"].data_ptr(), layout["attrs"].data_ptr(),
                            h, w, -(-w // 16), -(-h // 16) * -(-w // 16),
                            planes.data_ptr(), nc.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return planes, nc


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from gaussian_mesh_splatting_tpu_torch.core.camera import focal2fov, fov2focal, make_camera
    from gaussian_mesh_splatting_tpu_torch.models import mesh as mesh_model
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import composite_fwd_plain
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    dev = torch.device("cuda")
    libs = {"fmad=false": build_variant(False), "fmad=true": build_variant(True)}
    data_dir = os.path.join(cs.ROOT, "build", "fmad_probe", "scene")
    os.makedirs(data_dir, exist_ok=True)
    cs.write_dataset(data_dir)
    scene = Scene(data_dir, "gs_mesh", eval=True, num_splats=cs.NUM_SPLATS, shuffle=False,
                  device=dev)
    state = cs.randomize_state(scene.init_model_state(mesh_model, cs.SH_DEGREE), seed=42)
    info = scene.scene_info.train_cameras[0]
    with torch.no_grad():
        bag = mesh_model.to_bag(state)
        cases = {
            "gs_mesh 800x800": (bag, scene.train_cameras[0][0], cs.SH_DEGREE),
            "gs_mesh 803x611": (bag, make_camera(
                np.asarray(info.R), np.asarray(info.T), cs.FOVX,
                focal2fov(fov2focal(cs.FOVX, 803), 611), 803, 611, device=dev), cs.SH_DEGREE),
            "dense overlap 512x512": (cs.dense_scene(4000, 2, dev), make_camera(
                np.eye(3), np.array([0.0, 0.0, 3.0]), 0.8, 0.8, 512, 512, device=dev), 3),
        }
        for label, (b, cam, deg) in cases.items():
            args, layout = cs.composite_inputs(b, cam, deg)[2:]
            planes_p, nc_p = composite_fwd_plain(*args)
            row = {"case": label}
            for name, lib in libs.items():
                planes, nc = launch(lib, args, layout)
                row[name] = {
                    "max_abs_err_rgbT": (planes[:4] - planes_p[:4]).abs().max().item(),
                    "max_abs_err_depth": (planes[4] - planes_p[4]).abs().max().item(),
                    "nc_mismatches": int((nc != nc_p).sum().item()),
                }
            order = list(libs) + list(libs)[::-1]
            times: dict = {name: [] for name in libs}
            for name in order:
                times[name].append(cs.cuda_ms(lambda: launch(libs[name], args, layout), reps=20))
            for name in libs:
                row[name]["ms"] = float(np.median(times[name]))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
