"""Training checkpoints (full-state resume) and snapshot sidecar helpers
(port of `gaussian_mesh_splatting_tpu/io/checkpoint.py`).

  (a) A training checkpoint is the whole TrainState in one file, written by
      `torch.save` as a plain dict of tensors and ints and read back with
      `torch.load(weights_only=True)` (no pickled code): params (a key may
      hold a list of tensors), the Adam moments and step of every tensor of
      each group, in order, the densification statistics, `alive`,
      `consts`, `step`, `active_sh_degree`. The JAX package writes an orbax
      directory; the two formats do not read each other.
  (b) A model snapshot is `point_cloud/iteration_{N}/point_cloud.ply` in the
      reference-compatible layout plus, for the mesh models, a
      `model_params.npz` sidecar for the params that do not fit the PLY
      schema (mesh alpha and vertices). Keys of the npz are /-joined paths
      into the parameter tree. Either package reads the other's snapshots.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..train.state import DensifyStats, TrainState, optimizer_like, param_leaves

_STATS = ("grad_accum", "denom", "max_radii")


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write `state` to the file `path`."""
    optimizer = state.optimizer
    # a tensor that has taken no step yet has no moments
    adam = {group["name"]: [{k: v.detach() for k, v in optimizer.state.get(p, {}).items()}
                            for p in group["params"]]
            for group in optimizer.param_groups}
    params = {k: [t.detach() for t in v] if isinstance(v, list) else v.detach()
              for k, v in state.params.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "step": int(state.step),
        "active_sh_degree": int(state.active_sh_degree),
        "params": params,
        "adam": adam,
        "stats": {k: getattr(state.stats, k) for k in _STATS},
        "alive": state.alive,
        "consts": dict(state.consts),
    }, path)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """The TrainState saved at `path`, on the template's device. The
    template (a fresh state of the same model and config) gives the device
    and each Adam group's settings; the restored buffers have the
    checkpoint's capacity, whatever the template's."""
    dev = template.alive.device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    if set(ckpt["params"]) != set(template.params):
        raise ValueError(f"{path} holds params {sorted(ckpt['params'])}, "
                         f"the model has {sorted(template.params)}")
    lengths = {k: len(v) for k, v in ckpt["params"].items() if isinstance(v, list)}
    expected = {k: len(v) for k, v in template.params.items() if isinstance(v, list)}
    if lengths != expected:
        raise ValueError(f"{path} holds per-mesh lists of lengths {lengths}, "
                         f"the model has {expected}")
    params = {}
    for k in template.params:
        v = ckpt["params"][k]
        params[k] = [t.requires_grad_(True) for t in v] if isinstance(v, list) \
            else v.requires_grad_(True)
    optimizer = optimizer_like(template.optimizer, params)
    for name, moments in ckpt["adam"].items():
        for p, m in zip(param_leaves(params[name]), moments):
            if m:
                # Adam keeps "step" on the host unless it is capturable
                optimizer.state[p] = {k: v.cpu() if k == "step" else v for k, v in m.items()}
    return TrainState(
        step=int(ckpt["step"]),
        params=params,
        optimizer=optimizer,
        alive=ckpt["alive"],
        consts=ckpt["consts"],
        stats=DensifyStats(**{k: ckpt["stats"][k] for k in _STATS}),
        active_sh_degree=int(ckpt["active_sh_degree"]),
    )


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
