"""Snapshot sidecar helpers (the snapshot half of
`gaussian_mesh_splatting_tpu/io/checkpoint.py`; training checkpoints come
with the training slice).

A model snapshot is `point_cloud/iteration_{N}/point_cloud.ply` in the
reference-compatible layout plus a `model_params.npz` sidecar for the params
that do not fit the PLY schema (mesh alpha and vertices). Keys of the npz
are /-joined paths into the parameter tree.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _flatten_params(params: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(_flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(_flatten_params(v, f"{prefix}{i}/"))
    elif isinstance(params, torch.Tensor):
        out[prefix[:-1]] = params.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def save_sidecar(path: str, tree: Any) -> None:
    """npz sidecar for non-PLY params."""
    flat = _flatten_params(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_sidecar(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def unflatten_sidecar(flat: dict[str, np.ndarray]) -> dict:
    """Rebuild a nested dict (integer segments -> lists)."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[k]) for k in sorted(keys, key=int)]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def snapshot_dir(model_path: str, iteration: int) -> str:
    return os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
