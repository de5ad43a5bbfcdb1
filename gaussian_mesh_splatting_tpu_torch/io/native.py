"""Build and load the `fastio` C extension (csrc/fastio.c; port of
`gaussian_mesh_splatting_tpu/io/native.py`).

It is compiled with `cc` (or $CC) at first use into `build/native/` at the
repository root (git-ignored), under a file name keyed on a hash of the
source, the flags, the interpreter and numpy, as `ops/cuda_build.py` keys the
kernels; nothing is built at import. Without a compiler (or the Python and
numpy headers) `fastio()` is None and the callers take their numpy paths.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fastio.c")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
CFLAGS = ("-O3", "-shared", "-fPIC", "-Wall")


def _includes() -> list[str]:
    import numpy as np

    return [f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}"]


def library_path(build_dir: str = BUILD_DIR) -> str:
    """Where the build of this exact source, for this interpreter and numpy,
    lives."""
    import numpy as np

    digest = hashlib.sha256(" ".join((*CFLAGS, *_includes(), sys.version, np.__version__))
                            .encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(build_dir, f"fastio-{digest.hexdigest()[:16]}{suffix}")


def build(build_dir: str = BUILD_DIR, cc: str | None = None) -> str | None:
    """Compile csrc/fastio.c unless this exact build exists. Returns its
    path, or None when it cannot be compiled."""
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cc or os.environ.get("CC", "cc"), *CFLAGS, *_includes(), SOURCE, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def load(build_dir: str = BUILD_DIR, cc: str | None = None):
    """The fastio module (built if needed), or None when unavailable."""
    path = build(build_dir, cc)
    if path is None:
        return None
    spec = importlib.util.spec_from_file_location("fastio", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except ImportError:
        return None
    return mod


@functools.cache
def fastio():
    """The fastio module, or None when unavailable (built and loaded once
    per process)."""
    return load()
