"""The one seam between the port and its CUDA kernels (`ops/cuda_build`), on
the CPU: the entry table against the `extern "C"` signatures of `csrc/`
(the kernels themselves build and run only on a card), `launch` against a
stand-in library and stream, and that no other module of the package binds,
launches or counts a kernel itself."""
import collections
import contextlib
import ctypes
import glob
import os
import re
import types

import pytest
import torch

from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

PKG_DIR = os.path.dirname(cuda_build.CSRC_DIR)
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def _exported_signatures() -> dict:
    """{entry: (source, [parameter declarations])} of every `extern "C"`
    function of csrc/*.cu, an entry made by a macro once for each of the
    macro's uses."""
    found = {}
    for path in sorted(glob.glob(os.path.join(cuda_build.CSRC_DIR, "*.cu"))):
        source = os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            text = re.sub(r"//[^\n]*", "", f.read()).replace("\\\n", "\n")
        macros = {m.group(1): m.group(2).split(",")[0].strip()
                  for m in re.finditer(r"#define\s+(\w+)\(([^)]*)\)", text)}
        for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            made_by = [mac for mac, first in macros.items() if first == m.group(1)]
            names = [m.group(1)] if not made_by else [
                use.group(1) for mac in made_by
                for use in re.finditer(rf"^\s*{mac}\(\s*(\w+)\s*,", text, re.MULTILINE)]
            for name in names:
                assert name not in found, f"{name} is exported twice"
                found[name] = (source, params)
    return found


def _ctype(param: str):
    """A C parameter declaration's ctypes type: any pointer c_void_p, else by
    its type name."""
    type_name = re.match(r"(.*?)\s*\b\w+$", param).group(1).strip()
    if "*" in type_name:
        return ctypes.c_void_p
    assert type_name in C_TYPES, f"no ctypes type for {param!r}"
    return C_TYPES[type_name]


def test_entry_table_matches_the_c_signatures():
    """Every exported entry is in `ENTRIES` and every entry is exported, by
    the source the table names, and each argtypes list is its signature,
    parameter by parameter: pointer, int, long long, float."""
    found = _exported_signatures()
    assert {"composite_bwd", "composite_bwd_round_pairs", "composite_bwd_bf16"} <= set(found)
    assert set(found) == set(cuda_build.ENTRIES)
    for name, (source, params) in found.items():
        table_source, argtypes = cuda_build.ENTRIES[name]
        assert table_source == source, name
        want = [_ctype(p) for p in params]
        assert len(argtypes) == len(want), (name, len(argtypes), len(want))
        for i, (got, expect) in enumerate(zip(argtypes, want)):
            assert got is expect, f"{name} parameter {i} ({params[i]!r}): {got} vs {expect}"
        if name != "loss_blocks":  # a query; every launch takes the stream last
            assert params[-1] == "void* stream", name


@pytest.fixture
def stand_in(monkeypatch):
    """A stand-in library for `load` and a stand-in stream of the device:
    each call to an entry records its arguments and whether the device was
    current; the launch counter starts empty. `entry`'s cache is cleared on
    both sides."""
    rec = types.SimpleNamespace(loads=[], calls=[], current=[], streams=[], err=0)

    def loss_bwd(*args):
        rec.calls.append((args, list(rec.current)))
        return rec.err

    def loss_blocks(h, w):
        return h * w

    @contextlib.contextmanager
    def device(dev):
        rec.current.append(dev)
        yield
        rec.current.pop()

    def current_stream(dev):
        rec.streams.append(dev)
        return types.SimpleNamespace(cuda_stream=0xC0FFEE)

    def load(source):
        rec.loads.append(source)
        return types.SimpleNamespace(loss_bwd=loss_bwd, loss_blocks=loss_blocks)

    monkeypatch.setattr(cuda_build, "load", load)
    monkeypatch.setattr(cuda_build, "launches", collections.Counter())
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    rec.loss_bwd = loss_bwd
    cuda_build.entry.cache_clear()
    yield rec
    cuda_build.entry.cache_clear()


def test_launch_binds_once_passes_the_stream_and_counts(stand_in):
    dev = torch.device("cuda", 1)
    cuda_build.launch("loss_bwd", dev, 1, 2.5, None)
    cuda_build.launch("loss_bwd", dev, 3, 4.5, None)
    assert stand_in.loads == ["loss"]  # bound once, then cached
    fn = cuda_build.entry("loss_bwd")
    assert fn is stand_in.loss_bwd and stand_in.loads == ["loss"]
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == cuda_build.ENTRIES["loss_bwd"][1]
    # the stream of `dev` last, with `dev` current during the call
    assert stand_in.calls == [((1, 2.5, None, 0xC0FFEE), [dev]), ((3, 4.5, None, 0xC0FFEE), [dev])]
    assert stand_in.streams == [dev, dev] and stand_in.current == []
    assert cuda_build.launches == {"loss_bwd": 2}
    # a query goes through `entry`, uncounted
    assert cuda_build.entry("loss_blocks")(3, 4) == 12
    assert stand_in.loads == ["loss", "loss"] and cuda_build.launches == {"loss_bwd": 2}


def test_launch_failure_names_the_entry_and_counts_nothing(stand_in):
    stand_in.err = 700
    with pytest.raises(RuntimeError, match=r"loss_bwd kernel launch failed: CUDA error 700"):
        cuda_build.launch("loss_bwd", torch.device("cuda", 0), 1)
    assert len(stand_in.calls) == 1 and cuda_build.launches == {}
    with pytest.raises(KeyError):
        cuda_build.launch("no_such_entry", torch.device("cuda", 0))


def test_only_the_seam_touches_a_kernel_library():
    """Outside ops/cuda_build.py no module of the package loads a kernel
    library, reads a stream handle for a launch, calls `ctypes.CDLL` or sets
    a launch counter on a function."""
    banned = re.compile(r"cuda_build\.load\(|\.cuda_stream\b|ctypes\.CDLL|\.launches\w*\s*\+?=")
    offenders = []
    for path in glob.glob(os.path.join(PKG_DIR, "**", "*.py"), recursive=True):
        if os.path.samefile(path, cuda_build.__file__):
            continue
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if banned.search(line):
                    offenders.append(f"{os.path.relpath(path, PKG_DIR)}:{i}: {line.strip()}")
    assert offenders == []
