"""Camera data parallelism (port of
`gaussian_mesh_splatting_tpu/parallel/data_parallel.py`), and the
collectives that every parallel mode adds to the train step.

One process per device: each rank renders its own camera against the
replicated params; the gradients are all-reduced over the `data` group and
divided by its size (the mean over cameras) before the replicated Adam
update; the densification statistics are SUMMED over the cameras (each
reference iteration accumulates one camera, gaussian_model.py:416-418) and
the screen radii take the MAX. Every rank then holds the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..train.loop import make_train_step
from .collectives import all_reduce_flat


@dataclasses.dataclass(frozen=True)
class GroupReduction:
    """The `reduce` hook of `train.loop.make_train_step` for the parallel
    modes.

    With a `model_group` (the ranks that render portions of one camera) the
    portions' gradients, of the params and of mean2d_offset, are SUMMED over
    it. With a `data_group` (one camera a rank, or a model group) the param
    gradients are then averaged over it and the statistics' increments
    summed (radii: max); the metrics are averaged (loss, l1, psnr) or summed
    (num_visible). `overflow`, a host int, is summed over all ranks of the
    step, so that all grow the pair capacity together; `may_overflow=False`
    (no pair capacity set: it is 0 everywhere) skips that collective."""

    model_group: object = None
    data_group: object = None
    may_overflow: bool = False

    def portions(self, grads: list, g_offset: torch.Tensor):
        if self.model_group is None:
            return grads, g_offset
        *grads, g_offset = all_reduce_flat([*grads, g_offset], self.model_group)
        return grads, g_offset

    def cameras(self, grads: list, adds: tuple, metrics: dict):
        if self.data_group is None:
            return grads, adds, metrics
        n_data = dist.get_world_size(self.data_group)
        grad_add, denom_add, radii = adds
        scalars = torch.stack([metrics["loss"], metrics["l1"], metrics["psnr"],
                               metrics["num_visible"].to(torch.float32)])
        *grads, grad_add, denom_add, scalars = all_reduce_flat(
            [*grads, grad_add, denom_add, scalars], self.data_group)
        dist.all_reduce(radii, op=dist.ReduceOp.MAX, group=self.data_group)
        metrics = {"loss": scalars[0] / n_data, "l1": scalars[1] / n_data,
                   "psnr": scalars[2] / n_data, "num_visible": scalars[3].to(torch.int64)}
        return [g / n_data for g in grads], (grad_add, denom_add, radii), metrics

    def overflow(self, overflow: int) -> int:
        if not self.may_overflow:
            return overflow
        t = torch.tensor([overflow], dtype=torch.int64,
                         device="cuda" if dist.get_backend() == "nccl" else "cpu")
        for group in (self.model_group, self.data_group):
            if group is not None:
                dist.all_reduce(t, group=group)
        return int(t.item())


def make_dp_train_step(
    model,
    config,
    sh_degree_max: int,
    mesh,
    backend: str = "auto",
    axis_name: str = "data",
    render_kwargs: dict | None = None,
) -> Callable:
    """The camera-DP step over the mesh axis `axis_name`: (state, cam, gt,
    bg) -> (state, metrics), `cam` and `gt` this rank's camera and image
    (pick one camera per rank a step: `local_batch_slice`). `render_kwargs`
    forward to the renderer (e.g. `pair_capacity=`)."""
    render_kwargs = render_kwargs or {}
    reduce = GroupReduction(data_group=mesh.get_group(axis_name),
                            may_overflow=render_kwargs.get("pair_capacity") is not None)
    return make_train_step(model, config, sh_degree_max, backend=backend,
                           render_kwargs=render_kwargs, reduce=reduce)
