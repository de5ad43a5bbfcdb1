"""Build, load, bind and launch the port's CUDA kernels: the one module that
touches a kernel library.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc` for
sm_90a into `build/kernels/` at the repository root (listed in .gitignore),
under a file name keyed on a hash of the source, the headers (`csrc/*.cuh`)
and the flags, and loaded
with `ctypes`. The build happens at first use, in the process that launches
the kernel; nothing is built when a module is imported.

`ENTRIES` names every C entry with its source and its ctypes argtypes
(`tests/test_torch_cuda_seam.py` holds them to the `extern "C"`
signatures). `entry(name)` binds one once; `launch(name, device, *args)`
calls it with PyTorch's current stream of `device` as its last argument,
raises RuntimeError on a CUDA error and counts the launch in `launches`
under the entry's name (clear it to reset). The wrappers beside each
kernel's plain version (`ops/rasterize_cuda`, `ops/projection`, `ops/ssim`)
check their inputs (`check_inputs`), allocate the outputs and call `launch`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

# No fast math; -fmad=false keeps every product and sum rounded as PyTorch's
# separate operations round them (see the note in csrc/composite_fwd.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_digest(name: str) -> str:
    """The build key of csrc/<name>.cu: a hash of the flags, the source and
    every header beside it (a source includes them by name)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"), *headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def build(name: str) -> tuple[str, float, str]:
    """Compile csrc/<name>.cu unless a build of this exact source exists.

    Returns (library path, build seconds (0 if cached), compiler log)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}-{source_digest(name)}.so")
    if os.path.exists(out):
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out, seconds, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library of csrc/<name>.cu (built if needed)."""
    path, _, _ = build(name)
    return ctypes.CDLL(path)


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# composite_fwd.cu: pair_gaussian, tile_start, tile_end, tile_order, attrs;
#   height, width, n_tiles_x, n_tiles; out, out_nc, stream
_COMPOSITE_FWD = [_P] * 5 + [_I] * 4 + [_P] * 3
# composite_bwd.cu: pair_gaussian, tile_start, tile_end, tile_order, attrs,
#   t_final, nc, grad_planes; height, width, n_tiles_x, n_tiles; grads, stream
_COMPOSITE_BWD = [_P] * 8 + [_I] * 4 + [_P] * 2
# preprocess.cu, fwd: means3d, scales, rotations, opacities, shs; shs's three
#   strides; mean2d_offset, alive; the camera's world_view, full_proj,
#   cam_center, tanfovx, tanfovy; n, sh_degree; scale_modifier; antialiasing,
#   tight, width, height; mean2d, depth, conic, opacity, color, radius, valid,
#   radius_x, radius_y; stream
_PROJECT_FWD = [_P] * 5 + [_LL] * 3 + [_P] * 7 + [_I] * 2 + [_F] + [_I] * 4 + [_P] * 10
# preprocess.cu, bwd: means3d, scales, rotations, opacities, shs; shs's
#   strides; the camera's five tensors; n, sh_degree; scale_modifier;
#   antialiasing, width, height; the five cotangents, each (pointer, row
#   stride); the gradients of means3d, scales, rotations, opacities, shs; the
#   last one's strides; its coefficients; stream
_PROJECT_BWD = ([_P] * 5 + [_LL] * 3 + [_P] * 5 + [_I] * 2 + [_F] + [_I] * 3
                + [_P, _LL] * 5 + [_P] * 5 + [_LL] * 3 + [_I, _P])
# loss.cu, fwd: pred, gt; h, w; window (host); c1, c2, 1 - lambda, lambda;
#   ssim_map (may be null), d_mu, d_xx, d_xy, partials, total, l1, stream
_LOSS_FWD = [_P] * 2 + [_I] * 2 + [_P] + [_F] * 4 + [_P] * 8
# loss.cu, bwd: pred, gt, d_mu, d_xx, d_xy; h, w; window (host); g_total,
#   g_l1 (each may be null); the three coefficients; grad, stream
_LOSS_BWD = [_P] * 5 + [_I] * 2 + [_P] * 3 + [_F] * 3 + [_P] * 2

# entry -> (source, argtypes); every entry returns a CUDA error code (int)
ENTRIES = {
    # B1 on the (N, 12) float32 attribute table, and on the (N, 16) bf16 one
    "composite_fwd": ("composite_fwd", _COMPOSITE_FWD),
    "composite_fwd_bf16": ("composite_fwd", _COMPOSITE_FWD),
    # B2: float32 rows; float32 rows with each pair's gradient rounded to
    # bf16; bf16 rows (pairs rounded)
    "composite_bwd": ("composite_bwd", _COMPOSITE_BWD),
    "composite_bwd_round_pairs": ("composite_bwd", _COMPOSITE_BWD),
    "composite_bwd_bf16": ("composite_bwd", _COMPOSITE_BWD),
    # P1, P2
    "project_fwd": ("preprocess", _PROJECT_FWD),
    "project_bwd": ("preprocess", _PROJECT_BWD),
    # a query, not a launch: the blocks of a loss_fwd launch over (h, w)
    "loss_blocks": ("loss", [_I, _I]),
    # L1 with its reduction, L2
    "loss_fwd": ("loss", _LOSS_FWD),
    "loss_bwd": ("loss", _LOSS_BWD),
}

# successful launches by entry name since the last clear()
launches: collections.Counter = collections.Counter()


@functools.cache
def entry(name: str):
    """The C entry `name` of its library (built and loaded at first use),
    bound to its argtypes once."""
    source, argtypes = ENTRIES[name]
    fn = getattr(load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Call the kernel entry `name` with `args` and PyTorch's current stream
    of `device` (a CUDA device, made current for the call); count it in
    `launches`. Raises RuntimeError naming the entry and the CUDA error if
    the launch fails (nothing is counted then)."""
    fn = entry(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def check_inputs(expect: dict, dev: torch.device) -> None:
    """Every tensor of `expect` ({name: (tensor, dtype, shape)}) on `dev` (a
    CUDA device), of its dtype and shape, and contiguous; raises ValueError
    otherwise."""
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
