"""Training state (port of `gaussian_mesh_splatting_tpu/train/state.py`).

The JAX package's optax `multi_transform` becomes one `torch.optim.Adam`
with one param group per top-level param key (a key may hold a list of
tensors, as `gs_multi_mesh`'s per-mesh params do: they share the key's
group, as optax labels by top-level key), each at its reference learning
rate, with optax's defaults betas (0.9, 0.999) and the reference's
eps = 1e-15. For `OptimizationConfig` the `xyz` group carries the
log-linear position schedule (scaled by the scene extent) under the group
key "lr_schedule"; `apply_lr_schedules` sets each such group's lr for the
step about to be taken, as optax evaluates a schedule at the update count.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.lr_schedule import make_expon_lr_schedule
from .config import (
    FlameOptimizationConfig,
    MeshOptimizationConfig,
    OptimizationConfig,
)

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-15  # the reference's eps


@dataclasses.dataclass
class DensifyStats:
    """Screen-space gradient statistics driving density control."""

    grad_accum: torch.Tensor  # (C,) accumulated ||dL/dmean2d_ndc||
    denom: torch.Tensor  # (C,) number of visible observations
    max_radii: torch.Tensor  # (C,) max screen radius ever seen

    @classmethod
    def zeros(cls, capacity: int, device=None) -> "DensifyStats":
        def z():
            return torch.zeros((capacity,), dtype=torch.float32, device=device)

        return cls(grad_accum=z(), denom=z(), max_radii=z())


@dataclasses.dataclass
class TrainState:
    """Mutable training state: the train step updates it in place."""

    step: int
    params: dict[str, torch.Tensor | list[torch.Tensor]]  # leaves with requires_grad
    optimizer: torch.optim.Adam
    alive: torch.Tensor  # (C,) bool
    consts: dict  # non-trainable constants (faces, ...)
    stats: DensifyStats
    active_sh_degree: int

    def model_state(self) -> dict:
        return {"params": self.params, "consts": self.consts, "alive": self.alive}


def param_leaves(value) -> list[torch.Tensor]:
    """The tensors of one param key: a list as it is, a tensor as [tensor]."""
    return list(value) if isinstance(value, (list, tuple)) else [value]


def group_learning_rates(config, spatial_lr_scale: float = 1.0) -> dict[str, Any]:
    """Param key -> constant lr, or the schedule step -> lr for `xyz`."""
    if isinstance(config, OptimizationConfig):
        # vanilla / flat (gaussian_model.py:154-167)
        return {
            "xyz": make_expon_lr_schedule(
                config.position_lr_init * spatial_lr_scale,
                config.position_lr_final * spatial_lr_scale,
                lr_delay_mult=config.position_lr_delay_mult,
                max_steps=config.position_lr_max_steps,
            ),
            "f_dc": config.feature_lr,
            "f_rest": config.feature_lr / 20.0,
            "opacity": config.opacity_lr,
            "scaling": config.scaling_lr,
            "rotation": config.rotation_lr,
        }
    if isinstance(config, MeshOptimizationConfig):
        # gs_mesh / gs_multi_mesh (gaussian_mesh_model.py:174-183)
        return {
            "vertices": config.vertices_lr,
            "alpha": config.alpha_lr,
            "f_dc": config.feature_lr,
            "f_rest": config.feature_lr / 20.0,
            "opacity": config.opacity_lr,
            "scale": config.scaling_lr,
        }
    if isinstance(config, FlameOptimizationConfig):
        # gs_flame (gaussian_flame_model.py:209-230)
        return {
            "flame_shape": config.flame_shape_lr,
            "flame_exp": config.flame_exp_lr,
            "flame_pose": config.flame_pose_lr,
            "flame_neck_pose": config.flame_neck_pose_lr,
            "flame_trans": config.flame_trans_lr,
            "vertices_enlargement": config.vertices_enlargement_lr,
            "alpha": config.alpha_lr,
            "f_dc": config.feature_lr,
            "f_rest": config.feature_lr / 20.0,
            "opacity": config.opacity_lr,
            "scale": config.scaling_lr,
        }
    raise TypeError(f"unknown config type {type(config)}")


def make_optimizer(
    params: dict[str, torch.Tensor | list[torch.Tensor]],
    config,
    spatial_lr_scale: float = 1.0,
) -> torch.optim.Adam:
    """One Adam param group per top-level param key (named by "name"),
    holding the key's tensors."""
    lrs = group_learning_rates(config, spatial_lr_scale)
    missing = set(params) - set(lrs)
    if missing:
        raise ValueError(f"no learning rate for params {sorted(missing)}")
    groups = []
    for name, p in params.items():
        lr = lrs[name]
        group = {"params": param_leaves(p), "name": name}
        if callable(lr):
            group["lr_schedule"] = lr
            group["lr"] = lr(0)
        else:
            group["lr"] = lr
        groups.append(group)
    return torch.optim.Adam(groups, betas=ADAM_BETAS, eps=ADAM_EPS)


def optimizer_like(optimizer: torch.optim.Adam, params: dict) -> torch.optim.Adam:
    """A fresh Adam (no moments) over `params`, new leaf tensors keyed like
    the old optimizer's groups, with each group's settings (lr, schedule,
    betas, eps) as they stand in `optimizer`: what replaces an optimizer when
    the params change shape (`grow_capacity`, a restored checkpoint)."""
    groups = [{**{k: v for k, v in group.items() if k != "params"},
               "params": param_leaves(params[group["name"]])}
              for group in optimizer.param_groups]
    return torch.optim.Adam(groups, betas=ADAM_BETAS, eps=ADAM_EPS)


def apply_lr_schedules(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Set the lr of every scheduled group for update number `step`
    (0-based), as optax evaluates a schedule at its update count."""
    for group in optimizer.param_groups:
        schedule = group.get("lr_schedule")
        if schedule is not None:
            group["lr"] = schedule(step)


def make_train_state(
    model_state: dict,
    config,
    spatial_lr_scale: float = 1.0,
) -> TrainState:
    """A fresh TrainState. The params become leaf tensors that require
    grad (detached copies of the model state's; a list stays a list). Their rows may be a capacity
    buffer (`alive` marks the live ones): densification statistics and Adam
    moments cover every row. `spatial_lr_scale` is the scene extent
    (`Scene.cameras_extent`), which scales the `xyz` schedule."""
    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    params = {k: [leaf(t) for t in v] if isinstance(v, (list, tuple)) else leaf(v)
              for k, v in model_state["params"].items()}
    alive = model_state["alive"]
    return TrainState(
        step=0,
        params=params,
        optimizer=make_optimizer(params, config, spatial_lr_scale),
        alive=alive,
        consts=model_state.get("consts", {}),
        stats=DensifyStats.zeros(alive.shape[0], device=alive.device),
        active_sh_degree=0,
    )
