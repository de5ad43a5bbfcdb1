"""PLY codec (a copy of `gaussian_mesh_splatting_tpu/io/ply.py`), writing
byte-compatible files; binary vertex columns of 1 and 4 bytes are split by
the `fastio` C extension where it builds (`io/native.py`), else by numpy.

Two schemas are used by the pipeline:
  * point clouds: x y z nx ny nz red green blue (u1 colors)
    (scene/dataset_readers.py:115-130 storePly / 107-113 fetchPly);
  * trained Gaussians: x y z nx ny nz f_dc_* f_rest_* opacity scale_*
    rot_* all float32 (scene/gaussian_model.py:177-216).

The reader is generic: it parses any binary_little_endian or ascii PLY
with scalar properties into {name: np.ndarray} columns.
"""
from __future__ import annotations

import io
import os
from typing import Mapping

import numpy as np

_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "ushort": np.uint16, "uint16": np.uint16,
    "short": np.int16, "int16": np.int16,
    "uint": np.uint32, "uint32": np.uint32,
    "int": np.int32, "int32": np.int32,
}
_NAMES = {
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
    np.dtype(np.uint8): "uchar", np.dtype(np.int8): "char",
    np.dtype(np.uint16): "ushort", np.dtype(np.int16): "short",
    np.dtype(np.uint32): "uint", np.dtype(np.int32): "int",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Parse a PLY 'vertex' element into named columns."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = None
    count = 0
    props: list[tuple[str, np.dtype]] = []
    in_vertex = False
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == "property" and in_vertex:
            if tok[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tok[2], np.dtype(_DTYPES[tok[1]])))

    if fmt == "binary_little_endian":
        from .native import fastio

        nat = fastio()
        if nat is not None and all(d.itemsize in (1, 4) for _, d in props):
            cols = nat.parse_ply_vertices(data, header_end, count,
                                          [int(d.itemsize) for _, d in props])
            return {name: col.view(d) for (name, d), col in zip(props, cols)}
        rec = np.dtype([(n, d.newbyteorder("<")) for n, d in props])
        arr = np.frombuffer(body[: count * rec.itemsize], dtype=rec, count=count)
    elif fmt == "ascii":
        txt = np.loadtxt(io.BytesIO(body), max_rows=count, ndmin=2)
        rec = np.dtype([(n, d) for n, d in props])
        arr = np.zeros(count, rec)
        for i, (n, d) in enumerate(props):
            arr[n] = txt[:, i].astype(d)
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return {n: np.ascontiguousarray(arr[n]) for n, _ in props}


def write_ply(path: str, columns: Mapping[str, np.ndarray]) -> None:
    """Write named columns (all same length) as binary_little_endian PLY."""
    names = list(columns)
    count = len(next(iter(columns.values())))
    rec = np.dtype(
        [(n, np.dtype(np.asarray(columns[n]).dtype).newbyteorder("<")) for n in names]
    )
    arr = np.zeros(count, rec)
    for n in names:
        col = np.asarray(columns[n]).reshape(count)
        arr[n] = col
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {count}\n".encode())
        for n in names:
            f.write(f"property {_NAMES[np.dtype(np.asarray(columns[n]).dtype)]} {n}\n".encode())
        f.write(b"end_header\n")
        f.write(arr.tobytes())


# ---------------------------------------------------------------- schemas

def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """storePly schema (scene/dataset_readers.py:115-130); rgb in [0,255]."""
    zeros = np.zeros_like(xyz, dtype=np.float32)
    write_ply(
        path,
        {
            "x": xyz[:, 0].astype(np.float32),
            "y": xyz[:, 1].astype(np.float32),
            "z": xyz[:, 2].astype(np.float32),
            "nx": zeros[:, 0], "ny": zeros[:, 1], "nz": zeros[:, 2],
            "red": rgb[:, 0].astype(np.uint8),
            "green": rgb[:, 1].astype(np.uint8),
            "blue": rgb[:, 2].astype(np.uint8),
        },
    )


def fetch_point_cloud(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """fetchPly: returns (points, colors in [0,1], normals)."""
    c = read_ply(path)
    pts = np.stack([c["x"], c["y"], c["z"]], axis=1).astype(np.float32)
    cols = np.stack([c["red"], c["green"], c["blue"]], axis=1).astype(np.float32) / 255.0
    if "nx" in c:
        nrm = np.stack([c["nx"], c["ny"], c["nz"]], axis=1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return pts, cols, nrm


def save_gaussians_ply(
    path: str,
    xyz: np.ndarray,
    f_dc: np.ndarray,  # (N, 1, 3)
    f_rest: np.ndarray,  # (N, K-1, 3)
    opacity: np.ndarray,  # (N, 1) raw
    scaling: np.ndarray,  # (N, 2 or 3) raw log-scale
    rotation: np.ndarray,  # (N, 4) raw quat
    eps_s0: float = 1e-8,
) -> None:
    """Reference-compatible trained-Gaussian PLY
    (scene/gaussian_model.py:177-216). 2-column scalings are padded with
    log(eps_s0) like the flat model (gaussian_model.py:203-205)."""
    n = xyz.shape[0]
    cols: dict[str, np.ndarray] = {}
    for i, name in enumerate("xyz"):
        cols[name] = xyz[:, i].astype(np.float32)
    for i, name in enumerate(["nx", "ny", "nz"]):
        cols[name] = np.zeros(n, np.float32)
    fdc = np.asarray(f_dc).transpose(0, 2, 1).reshape(n, -1)  # channel-major
    for i in range(fdc.shape[1]):
        cols[f"f_dc_{i}"] = fdc[:, i].astype(np.float32)
    fr = np.asarray(f_rest).transpose(0, 2, 1).reshape(n, -1)
    for i in range(fr.shape[1]):
        cols[f"f_rest_{i}"] = fr[:, i].astype(np.float32)
    cols["opacity"] = np.asarray(opacity).reshape(n).astype(np.float32)
    sc = np.asarray(scaling)
    if sc.shape[1] == 2:
        sc = np.concatenate([np.full((n, 1), np.log(eps_s0), np.float32), sc], axis=1)
    for i in range(sc.shape[1]):
        cols[f"scale_{i}"] = sc[:, i].astype(np.float32)
    rt = np.asarray(rotation)
    for i in range(rt.shape[1]):
        cols[f"rot_{i}"] = rt[:, i].astype(np.float32)
    write_ply(path, cols)


def load_gaussians_ply(path: str, max_sh_degree: int = 3) -> dict[str, np.ndarray]:
    """Inverse of save_gaussians_ply (scene/gaussian_model.py:226-267).

    Returns raw params {xyz, f_dc (N,1,3), f_rest (N,K-1,3), opacity (N,1),
    scaling (N,S), rotation (N,4)}."""
    c = read_ply(path)
    n = len(c["x"])
    xyz = np.stack([c["x"], c["y"], c["z"]], axis=1).astype(np.float32)
    f_dc = np.stack([c["f_dc_0"], c["f_dc_1"], c["f_dc_2"]], axis=1).reshape(n, 3, 1)
    rest_names = sorted(
        [k for k in c if k.startswith("f_rest_")], key=lambda s: int(s.split("_")[-1])
    )
    expected = 3 * (max_sh_degree + 1) ** 2 - 3
    if len(rest_names) != expected:
        raise ValueError(
            f"{path}: {len(rest_names)} f_rest columns, expected {expected} for "
            f"SH degree {max_sh_degree}"
        )
    if rest_names:
        f_rest = np.stack([c[k] for k in rest_names], axis=1).reshape(
            n, 3, (max_sh_degree + 1) ** 2 - 1
        )
    else:
        f_rest = np.zeros((n, 3, 0), np.float32)
    scale_names = sorted(
        [k for k in c if k.startswith("scale_")], key=lambda s: int(s.split("_")[-1])
    )
    rot_names = sorted(
        [k for k in c if k.startswith("rot_")], key=lambda s: int(s.split("_")[-1])
    )
    return {
        "xyz": xyz,
        "f_dc": f_dc.transpose(0, 2, 1).astype(np.float32),  # (N, 1, 3)
        "f_rest": f_rest.transpose(0, 2, 1).astype(np.float32),  # (N, K-1, 3)
        "opacity": c["opacity"].reshape(n, 1).astype(np.float32),
        "scaling": np.stack([c[k] for k in scale_names], axis=1).astype(np.float32),
        "rotation": np.stack([c[k] for k in rot_names], axis=1).astype(np.float32),
    }
