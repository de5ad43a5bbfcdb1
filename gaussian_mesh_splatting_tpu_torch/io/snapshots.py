"""Model snapshots: reference-compatible PLY, plus an npz sidecar for the
mesh models.

Port of `gaussian_mesh_splatting_tpu/io/snapshots.py`, in the same format, so
a snapshot written by either package loads in the other. `gs` and `gs_flat`
save the raw params of their alive rows and no sidecar. The other models'
PLY carries the derived Gaussian attributes (renderable by any 3DGS viewer)
and the sidecar their parameterization (`gs_mesh`: vertices, alpha, scale;
`gs_multi_mesh`: the same per mesh, as `vertices/0`, `vertices/1`, ...;
`gs_flame`: the FLAME params, the enlargement, alpha and scale).
`gs_points` loads a `gs_flat` PLY.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..models import GS_TYPES
from ..models.gaussian_bag import shs_to_features
from .checkpoint import load_sidecar, save_sidecar, unflatten_sidecar
from .ply import load_gaussians_ply, save_gaussians_ply

SIDECAR_NAME = "model_params.npz"
POINT_GS_TYPES = ("gs", "gs_flat", "gs_points")  # the PLY holds the raw params


def _check_gs_type(gs_type: str) -> None:
    if gs_type not in GS_TYPES:
        raise ValueError(f"unknown gs_type {gs_type!r}; snapshots exist for {GS_TYPES}")


def save_snapshot(gs_type: str, model, state: dict, dirpath: str) -> str:
    """Write point_cloud.ply (and the sidecar). Returns the ply path."""
    _check_gs_type(gs_type)
    os.makedirs(dirpath, exist_ok=True)
    ply_path = os.path.join(dirpath, "point_cloud.ply")
    p = state["params"]

    def np_(t):
        return t.detach().cpu().numpy()

    if gs_type in ("gs", "gs_flat"):
        alive = np_(state["alive"])
        save_gaussians_ply(ply_path, *(np_(p[k])[alive] for k in (
            "xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")))
        return ply_path

    with torch.no_grad():
        bag = model.to_bag(state)
        f_dc, f_rest = shs_to_features(bag.shs)
        save_gaussians_ply(
            ply_path,
            np_(bag.xyz),
            np_(f_dc),
            np_(f_rest),
            np_(p["opacity"]),
            np.log(np.maximum(np_(bag.scaling), 1e-30)),
            np_(bag.rotation),
        )
    sidecar = {k: v for k, v in p.items() if k not in ("f_dc", "f_rest", "opacity")}
    save_sidecar(os.path.join(dirpath, SIDECAR_NAME), sidecar)
    return ply_path


def load_snapshot(
    gs_type: str,
    dirpath: str,
    sh_degree: int = 3,
    consts: dict | None = None,
    *,
    device: str | torch.device | None = None,
) -> dict:
    """Rebuild a model state from a snapshot directory, on `device`
    (CUDA unless the caller asks for another). A sidecar's lists (the
    per-mesh params) become lists of tensors. `consts` (the mesh faces) do
    not travel in the snapshot; the caller supplies them."""
    _check_gs_type(gs_type)
    dev = resolve_device(device)
    cols = load_gaussians_ply(os.path.join(dirpath, "point_cloud.ply"), max_sh_degree=sh_degree)
    if gs_type in POINT_GS_TYPES:
        params = dict(cols)
        if gs_type != "gs":
            # the flat models keep 2 scaling columns; the PLY stores the padded 3
            params["scaling"] = np.ascontiguousarray(params["scaling"][:, -2:])
    else:
        sidecar_path = os.path.join(dirpath, SIDECAR_NAME)
        if not os.path.exists(sidecar_path):
            raise FileNotFoundError(f"{gs_type} snapshot needs its sidecar {sidecar_path}")
        params = {k: cols[k] for k in ("f_dc", "f_rest", "opacity")}
        params.update(unflatten_sidecar(load_sidecar(sidecar_path)))
    n = cols["xyz"].shape[0]
    return {
        "params": {k: [torch.as_tensor(x, device=dev) for x in v] if isinstance(v, list)
                   else torch.as_tensor(v, device=dev) for k, v in params.items()},
        "consts": dict(consts or {}),
        "alive": torch.ones((n,), dtype=torch.bool, device=dev),
    }
