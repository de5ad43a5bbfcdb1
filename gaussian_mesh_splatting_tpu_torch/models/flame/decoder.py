"""FLAME head-model decoder in PyTorch (port of
`gaussian_mesh_splatting_tpu/models/flame/decoder.py`): given shape (100),
expression (50), pose (6: global + jaw), neck pose (3) and translation,
produce the (V, 3) head mesh by LBS, and the landmarks where the rig has
their embedding (static, and the dynamic neck-contour selection).

The rig loads from the standard `flame2023.pkl` / `generic_model.pkl` pickle,
which is MPI-licensed and not in the repository: the user supplies it.
`make_random_flame_like_rig` builds a small rig of the same structure for
tests.
"""
from __future__ import annotations

import math
import pickle
from typing import NamedTuple

import numpy as np
import torch

from .lbs import LbsModel, batch_rodrigues, lbs, vertices2landmarks

SHAPE_SPACE = 300
EXPR_SPACE = 100
NUM_JOINTS = 5  # global, neck, jaw, left eye, right eye
FLAME_PARENTS = (-1, 0, 1, 1, 1)


class FlameRig(NamedTuple):
    lbs_model: LbsModel
    parents: tuple  # static
    lmk_faces_idx: torch.Tensor | None = None  # (L,) int64 static landmarks
    lmk_bary_coords: torch.Tensor | None = None  # (L, 3)
    dynamic_lmk_faces_idx: torch.Tensor | None = None  # (79, Lc) int64 contour
    dynamic_lmk_bary_coords: torch.Tensor | None = None  # (79, Lc, 3)


def _dense(x) -> np.ndarray:
    if hasattr(x, "todense"):  # scipy sparse
        x = x.todense()
    if hasattr(x, "r"):  # chumpy array
        x = x.r
    return np.asarray(x, dtype=np.float64)


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def load_flame_pickle(path: str) -> FlameRig:
    """Parse the FLAME model pickle, on the CPU (a `FlameGaussianModel`
    holds the rig on its device). The file's root parent may be 2**32 - 1
    and its posedirs are (V, 3, P): both are brought to the rig's form."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    parents = tuple(int(p) for p in np.asarray(data["kintree_table"])[0].astype(np.int64))
    parents = (-1,) + parents[1:] if parents[0] != -1 else parents
    posedirs = _dense(data["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (P, V*3)
    model = LbsModel(
        v_template=_f32(_dense(data["v_template"])),
        shapedirs=_f32(_dense(data["shapedirs"])),
        posedirs=_f32(posedirs),
        j_regressor=_f32(_dense(data["J_regressor"])),
        parents=torch.tensor(parents, dtype=torch.int64),
        lbs_weights=_f32(_dense(data["weights"])),
        faces=torch.tensor(np.asarray(data["f"]).astype(np.int64)),
    )
    return FlameRig(model, parents)


def load_static_landmarks(rig: FlameRig, path: str) -> FlameRig:
    """Attach the static landmark embedding (a pickle with `lmk_face_idx`
    and `lmk_b_coords`)."""
    with open(path, "rb") as f:
        emb = pickle.load(f, encoding="latin1")
    return rig._replace(
        lmk_faces_idx=torch.tensor(np.asarray(emb["lmk_face_idx"]).astype(np.int64)),
        lmk_bary_coords=_f32(np.asarray(emb["lmk_b_coords"], np.float32)),
    )


def load_dynamic_landmarks(rig: FlameRig, path: str) -> FlameRig:
    """Attach the dynamic neck-contour embedding: a .npy holding
    {lmk_face_idx (79, L), lmk_b_coords (79, L, 3)}, indexed by the
    discretized neck yaw."""
    data = np.load(path, allow_pickle=True, encoding="latin1")[()]
    return rig._replace(
        dynamic_lmk_faces_idx=torch.tensor(np.asarray(data["lmk_face_idx"]).astype(np.int64)),
        dynamic_lmk_bary_coords=_f32(np.asarray(data["lmk_b_coords"], np.float32)),
    )


def make_random_flame_like_rig(
    generator: torch.Generator | None = None,
    n_verts: int = 128,
    shape_dim: int = SHAPE_SPACE,
    expr_dim: int = EXPR_SPACE,
) -> FlameRig:
    """A tiny rig with FLAME's exact parameter structure, for tests, drawn
    from `generator` (on the CPU)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g)

    v = normal(n_verts, 3) * 0.1
    shapedirs = normal(n_verts, 3, shape_dim + expr_dim) * 0.01
    posedirs = normal(9 * (NUM_JOINTS - 1), n_verts * 3) * 0.001
    jr = torch.softmax(normal(NUM_JOINTS, n_verts), dim=-1)
    w = torch.softmax(normal(n_verts, NUM_JOINTS) * 2, dim=-1)
    f = torch.randint(0, n_verts, (2 * n_verts, 3), generator=g)  # any triangulation
    model = LbsModel(
        v_template=v, shapedirs=shapedirs, posedirs=posedirs, j_regressor=jr,
        parents=torch.tensor(FLAME_PARENTS), lbs_weights=w, faces=f,
    )
    return FlameRig(model, FLAME_PARENTS)


def _rot_mat_to_yaw_euler(R: torch.Tensor) -> torch.Tensor:
    """smplx rot_mat_to_euler: the y rotation that selects the contour.
    (B, 3, 3) -> (B,)."""
    sy = torch.sqrt(R[:, 0, 0] * R[:, 0, 0] + R[:, 1, 0] * R[:, 1, 0])
    return torch.atan2(-R[:, 2, 0], sy)


def find_dynamic_lmk_idx_and_bcoords(
    rig: FlameRig,
    full_pose: torch.Tensor,  # (B, J*3)
    dynamic_lmk_faces_idx: torch.Tensor,  # (A, L)
    dynamic_lmk_bary_coords: torch.Tensor,  # (A, L, 3)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Neck-yaw-dependent contour landmark selection: the yaw in degrees,
    clipped above at 39 and rounded half to even, picks one of 79 buckets."""
    B = full_pose.shape[0]
    chain = []  # the neck joint (1) up to the root
    cur = 1
    while cur != -1:
        chain.append(cur)
        cur = rig.parents[cur]
    aa = full_pose.reshape(B, -1, 3)[:, torch.tensor(chain, device=full_pose.device)]
    rots = batch_rodrigues(aa.reshape(-1, 3)).reshape(B, len(chain), 3, 3)
    rel = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device).expand(B, 3, 3)
    for i in range(len(chain)):
        rel = rots[:, i] @ rel
    y_deg = torch.clamp(-_rot_mat_to_yaw_euler(rel) * 180.0 / math.pi, max=39.0)
    y = torch.round(y_deg).to(torch.int64)
    y_idx = torch.where(y < 0, torch.where(y < -39, 78, 39 - y), y)
    return dynamic_lmk_faces_idx[y_idx], dynamic_lmk_bary_coords[y_idx]


def flame_forward(
    rig: FlameRig,
    shape_params: torch.Tensor,  # (B, n_shape <= 300)
    expression_params: torch.Tensor,  # (B, n_expr <= 100)
    pose_params: torch.Tensor,  # (B, 6) = [global(3), jaw(3)]
    neck_pose: torch.Tensor,  # (B, 3)
    eye_pose: torch.Tensor | None = None,  # (B, 6)
    transl: torch.Tensor | None = None,  # (B, 3)
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Decode vertices (B, V, 3), and landmarks where the rig has an
    embedding. betas = [shape | pad | expr | pad], full_pose = [global,
    neck, jaw, eyes]."""
    m = rig.lbs_model
    B = shape_params.shape[0]
    n_dirs = m.shapedirs.shape[-1]
    shape_space = n_dirs - EXPR_SPACE if n_dirs > EXPR_SPACE else n_dirs // 2
    expr_space = n_dirs - shape_space
    dtype, dev = shape_params.dtype, shape_params.device

    def pad_to(x, width):
        return torch.cat([x, torch.zeros((B, width - x.shape[1]), dtype=dtype, device=dev)], dim=1)

    betas = torch.cat(
        [pad_to(shape_params, shape_space), pad_to(expression_params, expr_space)], dim=1)
    if eye_pose is None:
        eye_pose = torch.zeros((B, 6), dtype=dtype, device=dev)
    full_pose = torch.cat([pose_params[:, :3], neck_pose, pose_params[:, 3:], eye_pose], dim=1)
    vertices, _ = lbs(betas, full_pose, m.v_template, m.shapedirs, m.posedirs,
                      m.j_regressor, rig.parents, m.lbs_weights)
    landmarks = None
    if rig.lmk_faces_idx is not None:
        lmk_idx = rig.lmk_faces_idx[None].expand(B, -1)
        lmk_b = rig.lmk_bary_coords[None].expand(B, -1, -1)
        if rig.dynamic_lmk_faces_idx is not None:
            dyn_idx, dyn_b = find_dynamic_lmk_idx_and_bcoords(
                rig, full_pose, rig.dynamic_lmk_faces_idx, rig.dynamic_lmk_bary_coords)
            lmk_idx = torch.cat([dyn_idx, lmk_idx], dim=1)
            lmk_b = torch.cat([dyn_b, lmk_b], dim=1)
        landmarks = vertices2landmarks(vertices, m.faces, lmk_idx, lmk_b)
    if transl is not None:
        vertices = vertices + transl[:, None, :]
        if landmarks is not None:
            landmarks = landmarks + transl[:, None, :]
    return vertices, landmarks


def transform_flame_vertices(vertices: torch.Tensor, enlargement: torch.Tensor) -> torch.Tensor:
    """Blender -> scene axes and the per-vertex enlargement: squeeze the
    batch, [x, z, -y], then multiply by the (trainable) enlargement."""
    v = vertices.reshape(-1, 3)[:, [0, 2, 1]]
    v = v * torch.tensor([1.0, -1.0, 1.0], dtype=v.dtype, device=v.device)
    return v * enlargement
