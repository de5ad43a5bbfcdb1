"""The training step (port of `gaussian_mesh_splatting_tpu/train/loop.py`):
to_bag -> SH-degree mask -> render with `mean2d_offset` -> loss ->
backward -> Adam step -> densification statistics.

As in the JAX package:
  * derived state (mesh alpha, scaling, rotation) is recomputed from the
    params in every step;
  * screen-space positional gradients are the gradient w.r.t. an all-zeros
    `mean2d_offset` input;
  * the SH-degree warm-up masks coefficients above the active degree.
Unlike it, the step updates the TrainState in place (PyTorch's optimizers
own their moments) and returns it with the metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.camera import Camera
from ..renderer import render
from .loss import photometric_loss, psnr
from .state import TrainState, apply_lr_schedules


def sh_degree_mask(shs: torch.Tensor, active_degree: int) -> torch.Tensor:
    """Zero coefficients above the active SH degree."""
    k_idx = torch.arange(shs.shape[-1], device=shs.device)
    return shs * (k_idx < (active_degree + 1) ** 2)


def one_up_sh_degree(state: TrainState, max_degree: int) -> TrainState:
    state.active_sh_degree = min(state.active_sh_degree + 1, max_degree)
    return state


def _masked_bag(model, state: TrainState, to_bag_kwargs: Callable | None = None):
    # the keyword arguments are constants of the step, as in the JAX package
    # (its loss differentiates the params, not the state they are made from)
    with torch.no_grad():
        extra = to_bag_kwargs(state) if to_bag_kwargs else {}
    bag = model.to_bag(state.model_state(), **extra)
    return dataclasses.replace(bag, shs=sh_degree_mask(bag.shs, state.active_sh_degree))


def make_train_step(
    model,
    config,
    sh_degree_max: int,
    backend: str = "auto",
    render_kwargs: dict | None = None,
    mark: Callable[[str], None] | None = None,
    render_fn: Callable | None = None,
    reduce=None,
    to_bag_kwargs: Callable[[TrainState], dict] | None = None,
) -> Callable:
    """Build the step fn: (state, cam, gt, bg) -> (state, metrics).

    `model` is a registry module exposing to_bag; `gt` is (H, W, 3) on the
    state's device. `to_bag_kwargs`, if given, maps the state to keyword
    arguments of `model.to_bag`, called in every step (e.g. `triangles=` of
    a mesh animated while training); no gradient flows through them.
    `render_kwargs` forward to the rasterizer (e.g.
    `pair_capacity=`, so the training loop can grow the pair list when
    `metrics["overflow"]` is nonzero). The metrics are 0-d tensors on the
    device, except `overflow`, a host int. `mark`, if given, is called with
    "start" and then with the name of each stage as it ends ("to_bag",
    "render", "loss", "backward", "adam", "stats"): a timing hook, e.g. one
    that records a CUDA event.

    The parallel modes (`parallel/`) run this same step with two hooks:
    `render_fn(bag, cam, bg, mean2d_offset)` renders this process's portion
    and returns the assembled RenderOutput (default: `render` of the whole
    camera with `backend` and `render_kwargs`), and `reduce` joins the
    processes' work (default: nothing to join;
    `parallel.data_parallel.GroupReduction`):
      * `reduce.portions(grads, g_offset)`, right after the backward: the
        portion's param and mean2d_offset gradients -> the camera's;
      * `reduce.cameras(grads, adds, metrics)`, before Adam: the param
        gradients, the statistics' increments (grad_add, denom_add, radii)
        and the metrics of this process's camera -> the step's;
      * `reduce.overflow(n)`: the pairs this process dropped -> the step's,
        the same on every process."""
    render_kwargs = render_kwargs or {}
    mark = mark or (lambda stage: None)
    if render_fn is None:
        def render_fn(bag, cam, bg, mean2d_offset):
            return render(bag, cam, bg, sh_degree=sh_degree_max, backend=backend,
                          mean2d_offset=mean2d_offset, **render_kwargs)

    def train_step(state: TrainState, cam: Camera, gt: torch.Tensor, bg: torch.Tensor):
        mark("start")
        capacity = state.alive.shape[0]
        offset = torch.zeros((capacity, 2), dtype=torch.float32, device=state.alive.device,
                             requires_grad=True)
        bag = _masked_bag(model, state, to_bag_kwargs)
        mark("to_bag")
        out = render_fn(bag, cam, bg, offset)
        mark("render")
        loss, l1 = photometric_loss(out.image, gt, config.lambda_dssim)
        mark("loss")

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mark("backward")
        with torch.no_grad():
            params = [p for group in state.optimizer.param_groups for p in group["params"]
                      if p.grad is not None]
            grads, g_offset = [p.grad for p in params], offset.grad
            if reduce is not None:
                grads, g_offset = reduce.portions(grads, g_offset)
            # densification statistics (gaussian_model.py:416-418): the
            # norm of the NDC-space positional gradient of visible rows; the
            # reference's dL/dmean2D is the pixel gradient scaled by
            # (0.5 W, 0.5 H), the CUDA backward's ddelx_dx factor
            visible = out.radii > 0
            scale_vec = torch.tensor([0.5 * cam.width, 0.5 * cam.height],
                                     dtype=torch.float32, device=offset.device)
            gnorm = torch.linalg.vector_norm(g_offset * scale_vec, dim=-1)
            adds = (torch.where(visible, gnorm, 0.0), visible.to(torch.float32),
                    out.radii.to(torch.float32))
            metrics = {"loss": loss.detach(), "l1": l1.detach(), "psnr": psnr(out.image, gt),
                       "num_visible": visible.sum()}
            if reduce is not None:
                grads, adds, metrics = reduce.cameras(grads, adds, metrics)
                for p, g in zip(params, grads):
                    p.grad = g
        apply_lr_schedules(state.optimizer, state.step)
        state.optimizer.step()
        mark("adam")

        with torch.no_grad():
            grad_add, denom_add, radii = adds
            stats = state.stats
            stats.grad_accum += grad_add
            stats.denom += denom_add
            torch.maximum(stats.max_radii, radii, out=stats.max_radii)
        # pairs dropped by the capacity-bounded binning this step: nonzero
        # means the training loop must grow pair_capacity
        overflow = out.overflow if out.overflow is not None else 0
        metrics["overflow"] = overflow if reduce is None else reduce.overflow(overflow)
        mark("stats")
        state.step += 1
        return state, metrics

    return train_step


def make_eval_render(model, sh_degree_max: int, backend: str = "auto") -> Callable:
    """Eval render: (state, cam, bg) -> image (H, W, 3) clamped to [0, 1]."""

    @torch.no_grad()
    def eval_render(state: TrainState, cam: Camera, bg: torch.Tensor) -> torch.Tensor:
        bag = _masked_bag(model, state)
        out = render(bag, cam, bg, sh_degree=sh_degree_max, backend=backend)
        return torch.clamp(out.image, 0.0, 1.0)

    return eval_render
