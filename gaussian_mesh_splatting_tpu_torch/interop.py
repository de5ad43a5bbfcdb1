"""Carry model states, training states and cameras from the JAX package
into the port.

The functions take plain numpy arrays (what `np.asarray` gives for a JAX
array), so this module, like the rest of the port, never imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.camera import Camera
from .device import resolve_device
from .models import get_model
from .train.state import DensifyStats, TrainState, make_train_state

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
    models, "consts"}, arrays as numpy) -> the port's state of torch tensors
    on `device`. Point-cloud states carry over as they are: padded capacity
    buffers with their `alive` mask, two scaling columns for `gs_flat`."""
    get_model(gs_type)  # raises for a gs_type that is not ported
    dev = resolve_device(device)
    out = {k: _tree_to_torch(state.get(k, {}) if k == "consts" else state[k], dev)
           for k in ("params", "consts", "alive")}
    if gs_type == "gs_mesh":
        out["consts"]["faces"] = out["consts"]["faces"].long()
    return out


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
    "nu": array}}, the optax Adam state of each param group."""
    state = make_train_state(state_from_numpy(gs_type, tstate, device=device), config,
                             spatial_lr_scale)
    dev = state.alive.device
    state.step = int(tstate["step"])
    state.active_sh_degree = int(tstate["active_sh_degree"])
    state.stats = DensifyStats(**{k: torch.tensor(np.asarray(tstate["stats"][k]), device=dev)
                                  for k in ("grad_accum", "denom", "max_radii")})
    for group in state.optimizer.param_groups:
        adam = tstate["adam"][group["name"]]
        (p,) = group["params"]
        state.optimizer.state[p] = {
            "step": torch.tensor(float(adam["count"]), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(adam["mu"]), device=dev),
            "exp_avg_sq": torch.tensor(np.asarray(adam["nu"]), device=dev),
        }
    return state
