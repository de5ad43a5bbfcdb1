"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc` for
sm_90a into `build/kernels/` at the repository root (listed in .gitignore),
under a file name keyed on a hash of the source, the headers (`csrc/*.cuh`)
and the flags, and loaded
with `ctypes`. The build happens at first use, in the process that launches
the kernel; nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

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
