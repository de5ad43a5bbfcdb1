"""Optimization hyperparameter groups, one per gs_type (a copy of
`gaussian_mesh_splatting_tpu/train/config.py`, which is pure data) — the
equivalent of the reference's `OptimizationParams`
(arguments/__init__.py:72-91), `OptimizationParamsMesh` and
`OptimizationParamsFlame` (arguments_games/__init__.py:17-49), selected by
gs_type via a registry like games/__init__.py:27-33.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Vanilla/flat 3DGS hyperparameters (arguments/__init__.py:72-91)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    random_background: bool = False
    densify: bool = True


@dataclasses.dataclass(frozen=True)
class MeshOptimizationConfig:
    """gs_mesh / gs_multi_mesh (arguments_games/__init__.py:17-29).

    Constant LRs (the mesh model's update_learning_rate is a no-op,
    gaussian_mesh_model.py:185-187) and no densification."""

    iterations: int = 30_000
    vertices_lr: float = 0.0  # 0.00016 to co-train the mesh
    alpha_lr: float = 0.001
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2
    random_background: bool = False
    use_mesh: bool = True
    densify: bool = False


@dataclasses.dataclass(frozen=True)
class FlameOptimizationConfig:
    """gs_flame (arguments_games/__init__.py:32-49)."""

    iterations: int = 30_000
    alpha_lr: float = 0.001
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    flame_shape_lr: float = 0.01
    flame_exp_lr: float = 0.001
    flame_pose_lr: float = 0.001
    flame_neck_pose_lr: float = 0.001
    flame_trans_lr: float = 0.001
    vertices_enlargement_lr: float = 0.0002
    lambda_dssim: float = 0.2
    random_background: bool = False
    use_mesh: bool = True
    densify: bool = False


OPTIM_CONFIGS = {
    "gs": OptimizationConfig(),
    "gs_flat": OptimizationConfig(),
    "gs_mesh": MeshOptimizationConfig(),
    "gs_multi_mesh": MeshOptimizationConfig(),
    "gs_flame": FlameOptimizationConfig(),
}


def optimization_config(gs_type: str, **overrides):
    cfg = OPTIM_CONFIGS[gs_type]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
