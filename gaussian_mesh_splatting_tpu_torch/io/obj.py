"""Minimal Wavefront OBJ mesh codec, pure numpy (a copy of
`gaussian_mesh_splatting_tpu/io/obj.py`)."""
from __future__ import annotations

import os

import numpy as np


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse vertices and triangular faces (fans triangulate n-gons).

    Handles `v x y z` and `f a b c ...` with `a/b/c`-style index tuples;
    indices may be negative (relative). Returns (V,3) float32, (F,3) int32.
    """
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32).reshape(-1, 3),
    )


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray | None = None) -> None:
    """ASCII v/f export (write_mesh_obj,
    games/flame_splatting/utils/general_utils.py:17-31). `faces` may be
    None for a point/soup dump of stacked triangles (N,3,3)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    vertices = np.asarray(vertices)
    with open(path, "w") as f:
        if vertices.ndim == 3:  # triangle soup (N, 3, 3)
            for tri in vertices:
                for v in tri:
                    f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for i in range(vertices.shape[0]):
                f.write(f"f {3*i+1} {3*i+2} {3*i+3}\n")
        else:
            for v in vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            if faces is not None:
                for face in np.asarray(faces):
                    f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")
