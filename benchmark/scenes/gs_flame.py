"""The geometry of a `gs_flame` configuration: a FLAME-format head rig made
from the configuration and the seed (no FLAME model file is in the
repository). The template is a head-sized ellipsoid meshed with FLAME's
counts of vertices and faces, open at the neck and at two eyes as FLAME's
mesh is; the blendshape and corrective bases are smooth seeded fields;
FLAME's five joints (global, neck, jaw, eyes) have a regressor and skinning
weights that follow their regions."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import check_counts


def _ring_sizes(n: int, neck: int, neck_polar: float) -> list[int]:
    """Vertices of each ring from the crown down to the neck: the neck ring
    has `neck`, the others as the sine of their polar angle, so that the
    triangles are about as tall as wide, `n` in all."""
    def sizes(rings):
        polar = neck_polar * np.arange(1, rings) / rings
        raw = np.sin(polar) * (n - neck) / np.sin(polar).sum()
        out = np.floor(raw).astype(int)
        out[np.argsort(out - raw)[:n - neck - out.sum()]] += 1
        return [max(3, int(k)) for k in out] + [neck]

    # isotropic where the ring spacing (neck_polar / rings) matches the
    # spacing along the equator (2 pi / its ring's size), about at r0
    r0 = neck_polar * math.sqrt(n / (2 * math.pi * (1 - math.cos(neck_polar))))
    rings = min(range(max(3, int(r0 / 2)), int(2 * r0) + 4),
                key=lambda r: abs(max(sizes(r)) - 2 * math.pi * r / neck_polar))
    out = sizes(rings)
    if sum(out) != n:
        raise ValueError(f"cannot mesh {n} ring vertices with a neck of {neck}")
    return out


def _zip(a: list[int], b: list[int], polar_a: float, polar_b: float):
    """The triangles between two rings of vertex ids (each evenly spread in
    azimuth from 0), in azimuth order, with each triangle's mean azimuth."""
    na, nb = len(a), len(b)
    i = j = 0
    out = []
    while i < na or j < nb:
        if j >= nb or (i < na and (i + 1) / na <= (j + 1) / nb):
            tri, az = (a[i], b[j % nb], a[(i + 1) % na]), (i + 0.5) / na
            i += 1
        else:
            tri, az = (a[i % na], b[j], b[(j + 1) % nb]), (j + 0.5) / nb
            j += 1
        out.append((tri, 2 * math.pi * az))
    return out


def head_mesh(n_vertices: int, n_faces: int, neck_deg: float, eye_faces: int,
              eye_polar_deg: float, eye_azimuth_deg: float) -> tuple[np.ndarray, np.ndarray]:
    """A unit-sphere head in FLAME's axes (y up, z forward): a vertex at the
    crown, rings down to an open neck `neck_deg` from the crown, and two eye
    holes of `eye_faces` faces each, `eye_polar_deg` from the crown and
    `eye_azimuth_deg` to either side of the front. Its counts are exact: a
    surface open at the neck and at two slots has
    faces = 2 vertices - 2 - neck ring - the slots' faces, which sets the
    neck ring."""
    neck = 2 * n_vertices - 2 - n_faces - 2 * eye_faces
    if neck < 3:
        raise ValueError(f"{n_vertices} vertices and {n_faces} faces leave a neck of {neck}")
    neck_polar = math.radians(neck_deg)
    sizes = _ring_sizes(n_vertices - 1, neck, neck_polar)
    rings, first, verts = len(sizes), 1, [[0.0, 1.0, 0.0]]
    ids = []
    for k, m in enumerate(sizes, start=1):
        theta = neck_polar * k / rings
        phi = 2 * np.pi * np.arange(m) / m
        verts += np.stack([np.sin(theta) * np.cos(phi), np.full(m, np.cos(theta)),
                           np.sin(theta) * np.sin(phi)], 1).tolist()
        ids.append(list(range(first, first + m)))
        first += m
    faces = [(0, ids[0][(j + 1) % len(ids[0])], ids[0][j]) for j in range(len(ids[0]))]
    eye_band = min(range(1, rings - 2), key=lambda k: abs(neck_deg * (k + 0.5) / rings
                                                            - eye_polar_deg))
    for k in range(rings - 1):
        band = _zip(ids[k], ids[k + 1], 0, 0)
        tris = [(t[0], t[2], t[1]) for t, _ in band]
        if k == eye_band:
            drop = set()
            for side in (-1, 1):  # the front is +z, azimuth pi / 2
                centre = math.pi / 2 + side * math.radians(eye_azimuth_deg)
                near = min(range(len(band)), key=lambda t: abs(
                    math.remainder(band[t][1] - centre, 2 * math.pi)))
                drop.update((near - eye_faces // 2 + t) % len(band) for t in range(eye_faces))
            tris = [t for n, t in enumerate(tris) if n not in drop]
        faces += tris
    verts, faces = np.asarray(verts, np.float64), np.asarray(faces, np.int64)
    if verts.shape[0] != n_vertices or faces.shape[0] != n_faces or len(
            np.unique(faces)) != n_vertices:
        raise ValueError("the head mesh missed its counts")
    return verts, faces


def smooth_fields(gen: torch.Generator, verts: torch.Tensor, n: int, amp: float) -> torch.Tensor:
    """n smooth displacement fields over the vertices, (V, 3, n): each a sine
    of the position along a random direction, along another."""
    dev = verts.device
    scale = float(verts.abs().max())
    freq = torch.randn((n, 3), generator=gen, device=dev) * 2.0 / scale
    phase = torch.rand((n,), generator=gen, device=dev) * 2 * math.pi
    along = torch.randn((n, 3), generator=gen, device=dev)
    along = along / torch.linalg.vector_norm(along, dim=1, keepdim=True)
    return amp * torch.sin(verts @ freq.T + phase)[:, None, :] * along.T[None]


def head_rig(f: dict) -> dict:
    """The template (the head mesh scaled to `radius` times `axes`), the
    faces, a joint regressor (each joint a weighted mean of its region) and
    skinning weights that follow the regions."""
    unit, faces = head_mesh(f["vertices"], f["faces"], f["neck_deg"], f["eye_faces"],
                            f["eye_polar_deg"], f["eye_azimuth_deg"])
    r = f["radius"]
    verts = unit * r * np.asarray(f["axes"])
    centres = np.array([[0, 0, 0], [0, -0.8 * r, -0.1 * r], [0, -0.45 * r, 0.55 * r],
                        [-0.35 * r, 0.25 * r, 0.85 * r], [0.35 * r, 0.25 * r, 0.85 * r]])
    near = np.exp(-((verts[:, None] - centres[None]) ** 2).sum(-1)
                  / (2 * (np.array([10.0, 0.4, 0.35, 0.15, 0.15]) * r) ** 2))
    weights = near * np.array([1.0, 0.5, 2.0, 1.5, 1.5])
    return {"v_template": verts, "faces": faces, "j_regressor": (near / near.sum(0)).T,
            "lbs_weights": weights / weights.sum(1, keepdims=True)}


def geometry(config: dict, gen: torch.Generator, dev) -> dict:
    f = config["flame"]
    head = head_rig(f)
    check_counts(f, {"faces": head["faces"].shape[0], "vertices": head["v_template"].shape[0]})
    template = torch.as_tensor(head["v_template"], dtype=torch.float32, device=dev)
    shapedirs = torch.cat([smooth_fields(gen, template, f["shape_space"], f["shape_amplitude"]),
                           smooth_fields(gen, template, f["expression_space"],
                                         f["expression_amplitude"])], dim=2)
    n_pose = 9 * (len(f["parents"]) - 1)
    posedirs = smooth_fields(gen, template, n_pose, f["corrective_amplitude"])
    rig = {"v_template": template, "shapedirs": shapedirs,
           "posedirs": posedirs.reshape(-1, n_pose).T.contiguous(),
           "j_regressor": torch.as_tensor(head["j_regressor"], dtype=torch.float32, device=dev),
           "lbs_weights": torch.as_tensor(head["lbs_weights"], dtype=torch.float32, device=dev),
           "parents": tuple(f["parents"])}
    z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    params = {"flame_shape": z(1, f["shape_params"]), "flame_exp": z(1, f["expression_params"]),
              "flame_pose": z(1, 6), "flame_neck_pose": z(1, 3), "flame_trans": z(1, 3),
              "vertices_enlargement": torch.full((template.shape[0], 3), f["vertices_enlargement"],
                                                 device=dev)}
    return {"params": params, "faces": torch.as_tensor(head["faces"], device=dev), "rig": rig,
            "n_vertices": int(template.shape[0])}
