"""Carry model states and cameras from the JAX package into the port.

Both functions take plain numpy arrays (what `np.asarray` gives for a JAX
array), so this module, like the rest of the port, never imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.camera import Camera
from .device import resolve_device
from .models import get_model

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
    """A JAX-package model state ({"params", "consts", "alive"}, arrays as
    numpy) -> the port's state of torch tensors on `device`."""
    get_model(gs_type)  # raises for a gs_type that is not ported
    dev = resolve_device(device)
    out = {k: _tree_to_torch(state[k], dev) for k in ("params", "consts", "alive")}
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
