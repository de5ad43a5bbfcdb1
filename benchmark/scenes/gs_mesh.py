"""The geometry of a `gs_mesh` configuration: a mesh (an icosphere with a
lumpy radius, `mesh.subdivisions` times subdivided) whose vertices are the
model's `vertices` parameter."""
from __future__ import annotations

import numpy as np
import torch

from . import check_counts


def icosphere(subdivisions: int) -> tuple[np.ndarray, np.ndarray]:
    """An icosphere in Blender's axes, subdivided `subdivisions` times, with
    a lumpy radius."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array(
        [[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
         [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
         [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        vlist = [tuple(v) for v in verts]
        cache: dict = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                cache[key] = len(vlist)
                vlist.append(tuple(m / np.linalg.norm(m)))
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts, faces = np.array(vlist), np.array(new_faces)
    bump = 1.0 + 0.25 * np.sin(4 * verts[:, 0]) * np.cos(3 * verts[:, 1]) \
        + 0.15 * np.sin(5 * verts[:, 2])
    return (verts * bump[:, None]).astype(np.float32), faces


def geometry(config: dict, gen: torch.Generator, dev) -> dict:
    verts, faces = icosphere(config["mesh"]["subdivisions"])
    verts = verts[:, [0, 2, 1]] * np.array([1.0, -1.0, 1.0], np.float32)  # Blender -> scene axes
    check_counts(config["mesh"], {"faces": faces.shape[0], "vertices": verts.shape[0]})
    return {"params": {"vertices": torch.as_tensor(verts, device=dev)},
            "faces": torch.as_tensor(faces, device=dev), "rig": None,
            "n_vertices": int(verts.shape[0])}
