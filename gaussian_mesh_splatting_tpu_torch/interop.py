"""Carry model states, training states, cameras and FLAME rigs from the JAX
package into the port.

The functions take plain numpy arrays (what `np.asarray` gives for a JAX
array), so this module, like the rest of the port, never imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.camera import Camera
from .device import resolve_device
from .models import GS_TYPES
from .models.flame.decoder import FlameRig
from .models.flame.lbs import LbsModel
from .train.state import DensifyStats, TrainState, make_train_state, param_leaves

_CAMERA_TENSOR_FIELDS = (
    "world_view", "full_proj", "cam_center", "tanfovx", "tanfovy", "znear", "zfar",
)


def _tree_to_torch(tree, dev: torch.device):
    if isinstance(tree, Mapping):
        return {k: _tree_to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, dev) for v in tree]
    return torch.tensor(np.asarray(tree), device=dev)  # copies: JAX's buffers are read-only


def state_from_numpy(
    gs_type: str, state: Mapping, *, device: str | torch.device | None = None
) -> dict:
    """A JAX-package model state ({"params", "alive" and, for the mesh
    models, "consts"}, arrays as numpy; a param or the faces may be a list,
    one array per mesh) -> the port's state of torch tensors on `device`.
    Point-cloud states carry over as they are: padded capacity buffers with
    their `alive` mask, two scaling columns for `gs_flat`. Faces become
    int64."""
    if gs_type not in GS_TYPES:
        raise ValueError(f"unknown gs_type {gs_type!r}")
    dev = resolve_device(device)
    out = {k: _tree_to_torch(state.get(k, {}) if k == "consts" else state[k], dev)
           for k in ("params", "consts", "alive")}
    if "faces" in out["consts"]:
        faces = out["consts"]["faces"]
        out["consts"]["faces"] = [f.long() for f in faces] if isinstance(faces, list) \
            else faces.long()
    return out


def flame_rig_from_numpy(rig: Mapping, *, device: str | torch.device | None = None) -> FlameRig:
    """A JAX-package FLAME rig, given as a mapping of numpy arrays (the
    `LbsModel` fields and, where the rig has them, the landmark fields of
    `FlameRig`), -> the port's FlameRig on `device`."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(rig[name]), dtype=dtype, device=dev)

    ints = ("parents", "faces", "lmk_faces_idx", "dynamic_lmk_faces_idx")
    model = LbsModel(*(t(k, torch.int64 if k in ints else torch.float32)
                       for k in LbsModel._fields))
    landmarks = [t(k, torch.int64 if k in ints else torch.float32)
                 if rig.get(k) is not None else None for k in FlameRig._fields[2:]]
    return FlameRig(model, tuple(int(p) for p in np.asarray(rig["parents"])), *landmarks)


def camera_from_numpy(
    fields: Mapping, *, device: str | torch.device | None = None
) -> Camera:
    """A JAX-package Camera, given as a mapping of its fields (arrays as
    numpy; `width` and `height` as ints) -> the port's Camera on `device`."""
    dev = resolve_device(device)
    tensors = {
        k: torch.tensor(np.asarray(fields[k], np.float32), device=dev)
        for k in _CAMERA_TENSOR_FIELDS
    }
    return Camera(**tensors, width=int(fields["width"]), height=int(fields["height"]))


def train_state_from_numpy(
    gs_type: str,
    tstate: Mapping,
    config,
    spatial_lr_scale: float = 1.0,
    *,
    device: str | torch.device | None = None,
) -> TrainState:
    """A JAX-package TrainState, given as a mapping of numpy arrays, -> the
    port's TrainState on `device`, Adam moments included.

    `tstate` holds "params", "consts", "alive" (as for `state_from_numpy`),
    "step" and "active_sh_degree" (ints), "stats" ({"grad_accum", "denom",
    "max_radii"}) and "adam": {param key: {"count": int, "mu": array,
    "nu": array}}, the optax Adam state of each param group (for a key that
    holds a list, "mu" and "nu" are lists, as optax keeps them)."""
    state = make_train_state(state_from_numpy(gs_type, tstate, device=device), config,
                             spatial_lr_scale)
    dev = state.alive.device
    state.step = int(tstate["step"])
    state.active_sh_degree = int(tstate["active_sh_degree"])
    state.stats = DensifyStats(**{k: torch.tensor(np.asarray(tstate["stats"][k]), device=dev)
                                  for k in ("grad_accum", "denom", "max_radii")})
    for group in state.optimizer.param_groups:
        adam = tstate["adam"][group["name"]]
        for p, mu, nu in zip(group["params"], param_leaves(adam["mu"]),
                             param_leaves(adam["nu"])):
            state.optimizer.state[p] = {
                "step": torch.tensor(float(adam["count"]), dtype=torch.float32),
                "exp_avg": torch.tensor(np.asarray(mu), device=dev),
                "exp_avg_sq": torch.tensor(np.asarray(nu), device=dev),
            }
    return state
