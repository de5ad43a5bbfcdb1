"""The system under test, driven through its own entry points: the port's
training step as `apps/train` builds it (`train.loop.make_train_step`) and
its renderer as `apps/render` calls it, with the model of each kind made
by `program/<gs_type>.py` (`model(scene)`, `OPTIMIZATION`, and optionally
`consts(scene)`, the model state's constants, by default the scene's
faces), and density control (densify and prune, opacity resets) on
`apps/train`'s schedule (`Trainer.density_control`). The only modules of the
benchmark that import the program; they hand the program the inputs that
`scenes` made and take back what the program produces."""
from __future__ import annotations

import importlib

import torch

from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
from gaussian_mesh_splatting_tpu_torch.renderer import render
from gaussian_mesh_splatting_tpu_torch.train import loop as train_loop
from gaussian_mesh_splatting_tpu_torch.train.densify import densify_and_prune, reset_opacity
from gaussian_mesh_splatting_tpu_torch.train import make_train_state, optimization_config

PACKAGE = "gaussian_mesh_splatting_tpu_torch"
KERNELS = {"fwd": "composite_fwd_kernel", "bwd": "composite_bwd_kernel"}


def exact_float32() -> None:
    """What `apps/train` sets before it trains: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cameras(scene, dev) -> list:
    return [make_camera(R, T, scene.fovx, scene.fovy, scene.width, scene.height, device=dev)
            for R, T in scene.views]


def _kind(scene):
    return importlib.import_module(f".{scene.kind}", __name__)


def model_for(scene):
    """The port's model of the scene's kind, from `program/<kind>.py`."""
    return _kind(scene).model(scene)


def optimization_for(scene) -> dict:
    """The port's optimization settings of the scene's kind (`program/<kind>.py`
    names them: `OPTIMIZATION`, a gs_type of the port)."""
    return optimization_config(_kind(scene).OPTIMIZATION)


def model_state(scene) -> dict:
    kind = _kind(scene)
    consts = kind.consts(scene) if hasattr(kind, "consts") else {"faces": scene.faces}
    return {"params": scene.params, "consts": consts, "alive": scene.alive}


# the keys of the density-control schedule that a traffic may override
SCHEDULE = ("densification_interval", "densify_from_iter", "densify_until_iter",
            "opacity_reset_interval")


def density_events(cfg, it: int, white_background: bool) -> tuple[bool, bool]:
    """(densify and prune, reset the opacity) after step `it`, as
    `apps/train` schedules them from the optimization config."""
    if not getattr(cfg, "densify", False) or it >= cfg.densify_until_iter:
        return False, False
    densify = it > cfg.densify_from_iter and it % cfg.densification_interval == 0
    reset = it % cfg.opacity_reset_interval == 0 or (
        white_background and it == cfg.densify_from_iter)
    return densify, reset


# the split samples a split row gives: `densify_and_prune`'s default, which
# `apps/train` keeps
N_SPLIT = 2


def density_event(state, plan: dict, generator: torch.Generator | None = None, noise=None):
    """(state, counts) of one density-control event as `apps/train` runs it:
    `densify_and_prune(**plan["densify"])` where that is not None, its
    counts read to the host in one read, then `reset_opacity` where
    `plan["reset"]` ("opacity_reset" 1 among the counts); empty counts where
    nothing ran."""
    event = {}
    if plan["densify"] is not None:
        state, info = densify_and_prune(state, **plan["densify"], generator=generator,
                                        noise=noise)
        event = dict(zip(info, torch.stack(list(info.values())).tolist()))
    if plan["reset"]:
        state = reset_opacity(state)
        event["opacity_reset"] = 1
    return state, event


def snapshot(state) -> dict:
    """A copy of what a density-control event reads and writes: "params"
    (each group's tensor), "alive", "stats" ("grad_accum", "denom",
    "max_radii"), "moments" (each group's "exp_avg" and "exp_avg_sq",
    where it has taken a step) and "step", the tensors on the host."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    opt = state.optimizer
    groups = {g["name"]: g["params"][0] for g in opt.param_groups}
    return {"params": {k: host(p) for k, p in groups.items()},
            "alive": host(state.alive),
            "stats": {k: host(getattr(state.stats, k))
                      for k in ("grad_accum", "denom", "max_radii")},
            "moments": {k: {m: host(opt.state[p][m]) for m in ("exp_avg", "exp_avg_sq")}
                        for k, p in groups.items() if "exp_avg" in opt.state.get(p, {})},
            "step": state.step}


class Trainer:
    """The port's training state and step. `render_kwargs` go to the
    rasterizer (the precision modes of a control run); `mark` is the step's
    stage hook; `density`, where not None, switches density control on, on
    the kind's own schedule with the `SCHEDULE` keys it names replaced."""

    def __init__(self, scene, render_kwargs: dict | None = None, mark=None,
                 density: dict | None = None):
        exact_float32()
        dev = scene.alive.device
        self.scene = scene
        self.density = None
        if density is not None:
            if set(density) - set(SCHEDULE):
                raise ValueError(f"density control takes only {SCHEDULE}, not "
                                 f"{sorted(set(density) - set(SCHEDULE))}")
            self.density = optimization_config(_kind(scene).OPTIMIZATION, **density)
            self.white_background = bool((scene.bg == 1).all())
        self.cams = cameras(scene, dev)
        self.state = make_train_state(model_state(scene), optimization_for(scene),
                                      scene.cameras_extent)
        self.state.step = scene.start_step
        self.state.active_sh_degree = scene.sh_degree
        self.step_fn = train_loop.make_train_step(model_for(scene), optimization_for(scene),
                                                  scene.sh_degree, render_kwargs=render_kwargs,
                                                  mark=mark)

    def step(self, i: int) -> torch.Tensor:
        """One step on view i; its loss, a 0-d tensor on the device."""
        _, metrics = self.step_fn(self.state, self.cams[i], self.scene.gt[i], self.scene.bg)
        return metrics["loss"]

    def density_plan(self) -> dict:
        """What density control does after step `state.step`, as `apps/train`
        schedules it: "densify", `densify_and_prune`'s keyword arguments as
        `apps/train` passes them, or None where it does not run; "reset",
        whether the opacity is reset after it."""
        if self.density is None:
            return {"densify": None, "reset": False}
        cfg = self.density
        densify, reset = density_events(cfg, self.state.step, self.white_background)
        args = None
        if densify:
            args = dict(grad_threshold=cfg.densify_grad_threshold, min_opacity=cfg.min_opacity,
                        extent=self.scene.cameras_extent, percent_dense=cfg.percent_dense,
                        # screen/world-size pruning starts after the first opacity reset
                        size_threshold=20.0 if self.state.step > cfg.opacity_reset_interval
                        else 0.0,
                        scaling_cols=self.state.params["scaling"].shape[1], n_split=N_SPLIT)
        return {"densify": args, "reset": reset}

    def density_due(self) -> bool:
        """Whether density control acts after step `state.step`."""
        return self.density is not None and any(
            density_events(self.density, self.state.step, self.white_background))

    def steps_to_density(self) -> int | None:
        """How many steps from `state.step` on until the first step after
        which density control acts; None where none does."""
        if self.density is None:
            return None
        return next((it - self.state.step
                     for it in range(self.state.step + 1, self.density.densify_until_iter)
                     if any(density_events(self.density, it, self.white_background))), None)

    def density_control(self, generator: torch.Generator | None = None, noise=None) -> dict:
        """Density control after step `state.step`, as `apps/train` runs it
        (`density_plan`): `densify_and_prune`, its split samples' noise
        `noise` where given, else drawn from `generator`, then
        `reset_opacity`. The counts of what ran; empty where nothing did."""
        self.state, event = density_event(self.state, self.density_plan(), generator, noise)
        return event

    def params(self) -> dict:
        return {g["name"]: g["params"][0] for g in self.state.optimizer.param_groups}

    def adam_first_moments(self) -> dict:
        """Each parameter's Adam first moment, or None before its first
        update."""
        opt = self.state.optimizer
        return {g["name"]: opt.state.get(g["params"][0], {}).get("exp_avg")
                for g in opt.param_groups}

    @property
    def beta1(self) -> float:
        return self.state.optimizer.param_groups[0]["betas"][0]


class Renderer:
    """The port's render path: the bag made once, as `apps/render` makes it,
    then one `render(..., backend="auto")` a view."""

    def __init__(self, scene, render_kwargs: dict | None = None):
        dev = scene.alive.device
        self.scene = scene
        self.cams = cameras(scene, dev)
        self.kwargs = render_kwargs or {}
        with torch.no_grad():
            self.bag = model_for(scene).to_bag(model_state(scene))

    @torch.no_grad()
    def view(self, i: int) -> torch.Tensor:
        """View i clamped to [0, 1], on the device."""
        out = render(self.bag, self.cams[i], self.scene.bg, sh_degree=self.scene.sh_degree,
                     backend="auto", **self.kwargs)
        return torch.clamp(out.image, 0.0, 1.0)
