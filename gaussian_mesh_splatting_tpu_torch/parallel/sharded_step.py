"""Sharded training steps (port of
`gaussian_mesh_splatting_tpu/parallel/sharded_step.py`): row- (tile) and
Gaussian- (model) sharded rendering wired into the whole train step: loss,
backward, Adam and the densification statistics.

Each rank renders only its portion of one camera (a band of tile rows, or a
depth slab of the Gaussians; `row_sharded.render_rows`,
`gaussian_sharded.render_gaussians`), the portions meet in one all_gather,
and every rank computes the same loss on the assembled image. The gather's
backward hands each rank its own portion's cotangent, so each rank's
gradients are its portion's share, and one all-reduce (SUM over the model
group, of the params' and mean2d_offset's gradients in one buffer)
reassembles the gradient of the single loss. The loss runs on the assembled
image, so SSIM's windows see across the bands: sharded and unsharded losses
agree up to the kernels' reassociation.

Composed 2-D parallelism (`data` x `model`): cameras over `data`, portions
over `model`; the gradients are summed over `model` (one camera), then
averaged over `data` (the cameras), as `make_dp_train_step` does.
"""
from __future__ import annotations

from typing import Callable

from ..train.loop import make_train_step
from .data_parallel import GroupReduction
from .gaussian_sharded import render_gaussians
from .row_sharded import render_rows

_PORTION_RENDERERS = {"rows": render_rows, "gaussians": render_gaussians}


def make_sharded_train_step(
    model,
    config,
    sh_degree_max: int,
    mesh,
    shard: str = "gaussians",
    model_axis: str | None = None,
    data_axis: str | None = None,
    render_kwargs: dict | None = None,
) -> Callable:
    """The sharded step: (state, cam, gt, bg) -> (state, metrics), as
    `train/loop.make_train_step`.

    `shard` in {"rows", "gaussians"} picks what a rank renders. On a 1-D
    mesh its one axis is the model axis and every rank passes the same
    camera. With `data_axis` naming a second axis, the ranks of one model
    group (one coordinate on `data_axis`) pass the same camera, and
    different groups different cameras. `render_kwargs` forward to the
    rasterizer (e.g. `pair_capacity=`)."""
    if shard not in _PORTION_RENDERERS:
        raise ValueError(f"shard must be one of {sorted(_PORTION_RENDERERS)}, got {shard!r}")
    render_portion = _PORTION_RENDERERS[shard]
    render_kwargs = render_kwargs or {}
    if model_axis is None:
        model_axis = mesh.mesh_dim_names[-1]
    model_group = mesh.get_group(model_axis)

    def render_fn(bag, cam, bg, mean2d_offset):
        return render_portion(bag, cam, bg, model_group, sh_degree=sh_degree_max,
                              mean2d_offset=mean2d_offset, **render_kwargs)

    reduce = GroupReduction(
        model_group=model_group,
        data_group=None if data_axis is None else mesh.get_group(data_axis),
        may_overflow=render_kwargs.get("pair_capacity") is not None)
    return make_train_step(model, config, sh_degree_max, render_fn=render_fn, reduce=reduce)
