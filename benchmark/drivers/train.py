"""Training traffic: one state and the port's training step
(`make_train_step`, as `apps/train` builds it), one view a step in the
traffic's order. Set-up runs the checked steps through the window's own
call and feed, then the warm-up steps; the window runs steps for
`seconds`. A traffic that names "density_control" (true, or an object
that replaces keys of the schedule, `program.SCHEDULE`) runs density
control (`program.Trainer.density_control`) on `apps/train`'s schedule
after every warm-up step, window step and traced step, its split samples
drawn from the seed; the checked steps, which the reference follows, must
fall where the schedule does nothing. There the warm-up runs on, past its
steps where need be, to the first event, which is checked: its state is
copied to the host before and after it, its split noise drawn here, and
the plain reference (`reference/densify.py`) replays it on the copy from
before (`density_numbers`). In a traced run the step's `mark` events time
its stages in the window, two more time each density-control event there,
and a stretch under the profiler follows, as long as the window up to
`tracing.PROFILED_S`. The reference follows the checked steps and the
checked event once the program is freed."""
from __future__ import annotations

import math
import statistics
import time

import torch

from . import free, peak_bytes, steady_host, sync, timed, walk
from .. import program, scenes, tracing
from ..counts import ops
from ..reference import exact_float32
from ..reference.densify import density_event
from ..reference.train import train_steps

# the numbers of the checked density-control event (`density_numbers`), which
# the limits of a traffic with "density_control" must hold
DENSITY_NUMBERS = ("density_alive_mismatch", "density_count_gap", "density_param_gap",
                   "density_moment_gap")


def _norms(tensors: dict) -> dict:
    return {k: (0.0 if v is None else float(torch.linalg.vector_norm(v.detach().float())))
            for k, v in tensors.items()}


def _leaf_gaps(got: dict, want: dict, keys) -> dict:
    """Each leaf's |got - want| against want or the median leaf's reading,
    whichever is larger."""
    med = statistics.median(want.values())
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}


def _worst(gaps: dict) -> tuple[float, str]:
    return max(((v, k) for k, v in gaps.items()), default=(0.0, ""))


def _elem_median(got: dict, want: dict) -> float:
    """The median, over every element of every leaf where the reference's
    first gradient is not 0, of |got - want| / |want|: a rounding of every
    Gaussian's gradient moves it, the few Gaussians whose (pixel, pair)
    inclusions flip at a cut-off do not. 1 where the program has no
    gradient."""
    if any(got[k] is None for k in want):
        return 1.0
    rel = [((got[k] - want[k]).abs() / want[k].abs())[want[k] != 0].flatten() for k in want]
    return float(torch.cat(rel).float().median())


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(compared numbers, diagnostics) of the training check: each step's
    loss (and the first step's alone, which no update has touched), the
    first gradient's norm and the change's norm after the checked
    steps, and the norm of the first gradient's difference, each leaf's
    against the reference's reading or the median leaf's, the worst leaf;
    and the median leaf's reading of each of the three gradient and change
    numbers, which a single leaf cannot move.
    Leaves whose reference gradient is under 1e-3 of the median leaf's move
    by round-off alone and are left out of the change."""
    g_ref = _norms(ref["first_grad"])
    g_med = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    grad_gaps = _leaf_gaps(_norms(prog["first_grad"]), g_ref, g_ref)
    grad, grad_leaf = _worst(grad_gaps)
    change_gaps = _leaf_gaps(_norms(prog["change"]), _norms(ref["change"]), moving)
    change, change_leaf = _worst(change_gaps)
    diff = {k: float(torch.linalg.vector_norm((prog["first_grad"][k] - ref["first_grad"][k]).float()))
            if prog["first_grad"][k] is not None else g_ref[k] for k in g_ref}
    diff_gaps = {k: diff[k] / max(g_ref[k], g_med, 1e-30) for k in g_ref}
    diff_gap, diff_leaf = _worst(diff_gaps)
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "loss1_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
        "grad1_elem_median": _elem_median(prog["first_grad"], ref["first_grad"]),
        "grad1_norm_gap": grad,
        "grad1_norm_median_gap": statistics.median(grad_gaps.values()),
        "change3_norm_gap": change,
        "change3_median_gap": statistics.median(change_gaps.values()) if change_gaps else 0.0,
        "grad1_diff": diff_gap,
        "grad1_diff_median": statistics.median(diff_gaps.values()),
    }
    diagnostics = {"losses": prog["losses"], "reference_losses": ref["losses"],
                   "grad1_norm_gap_leaf": grad_leaf, "change3_norm_gap_leaf": change_leaf,
                   "grad1_diff_leaf": diff_leaf, "grad1_diff_leaves": diff_gaps,
                   "grad1_norm_gap_leaves": grad_gaps,
                   "change3_gap_leaves": change_gaps,
                   "left_out_of_change": sorted(set(g_ref) - set(moving)),
                   "grad_norms": _norms(prog["first_grad"]), "reference_grad_norms": g_ref}
    return numbers, diagnostics


def _rel_gap(got: torch.Tensor | None, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, over every element; inf where the
    program has no such tensor."""
    if got is None:
        return math.inf
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def density_numbers(got: dict, want: dict) -> tuple[dict, dict]:
    """(compared numbers, diagnostics) of a density-control event: `got`
    the program's state after it (`program.snapshot`, with its "counts"),
    `want` the reference's (`reference.densify.density_event`): the rows
    whose alive flag differs, the largest gap of a count, and the worst
    parameter's and the worst Adam moment's `_rel_gap` over every row, dead
    ones included."""
    params = {k: _rel_gap(got["params"].get(k), v) for k, v in want["params"].items()}
    moments = {f"{k}.{m}": _rel_gap(got["moments"].get(k, {}).get(m), v)
               for k, pair in want["moments"].items() for m, v in pair.items()}
    counts = {k: abs(got["counts"].get(k, 0) - want["counts"].get(k, 0))
              for k in set(got["counts"]) | set(want["counts"])}
    param_gap, param_leaf = _worst(params)
    moment_gap, moment_leaf = _worst(moments)
    numbers = {"density_alive_mismatch": float((got["alive"] != want["alive"]).sum()),
               "density_count_gap": float(max(counts.values(), default=0)),
               "density_param_gap": param_gap, "density_moment_gap": moment_gap}
    diagnostics = {"counts": got["counts"], "reference_counts": want["counts"],
                   "param_gap_leaf": param_leaf, "moment_gap_leaf": moment_leaf,
                   "param_gaps": params, "moment_gaps": moments}
    return numbers, diagnostics


def _to(tree, dev):
    """`tree` (dicts of tensors and numbers) with its tensors on `dev`."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _sample(scene, position: int, view_index: int, params: dict, alive: torch.Tensor) -> dict:
    """The counts of a sampled step, from the snapshot of its state before
    it (`params`, `alive`): Adam over every row, the rest over live rows."""
    counts = walk(scene, params, alive, view_index)
    n_params = sum(int(p.numel()) for p in params.values())
    live = int(alive.sum())
    model = ops.model_flops(scene.kind, live, int(scene.faces.shape[0]), scene.n_vertices)
    return {"position": position, "view": view_index, "rows": int(alive.shape[0]),
            "live": live, "walk": counts,
            "flops": ops.step_flops(model, live, n_params, scene.height, scene.width, counts)}


def run(c: dict, scene, seed: int, seconds: float, trace: bool, dev, phases: dict,
        render_kwargs: dict | None) -> dict:
    traffic = c["traffic"]
    marks = tracing.StageMarks(dev) if trace else None
    density = traffic.get("density_control")
    density = ({} if density is True else density) if density else None
    trainer = program.Trainer(scene, render_kwargs, mark=marks, density=density)
    phases["program"] = time.perf_counter()
    order = scenes.view_order(seed, len(scene.views), traffic["order"])
    checked = [next(order) for _ in range(traffic["checked_steps"])]
    losses = []
    for j, i in enumerate(checked):
        losses.append(float(trainer.step(i)))
        if trainer.density_due():
            raise ValueError(f"density control acts after checked step {trainer.state.step}; "
                             "the configuration's start_step must place it later")
        if j == 0:
            first_grad = {k: None if m is None else m / (1 - trainer.beta1)
                          for k, m in trainer.adam_first_moments().items()}
    change = {k: p.detach() - scene.params[k] for k, p in trainer.params().items()}
    prog = {"losses": losses, "first_grad": first_grad, "change": change}
    phases["checked_steps"] = time.perf_counter()
    density_gen = torch.Generator(device=dev)
    density_gen.manual_seed(seed % (1 << 63))
    events = []  # each density-control event's counts, stretch and position

    def control(n, stretch):
        if not trainer.density_due():
            return
        timing = trace and stretch != "warmup"
        if timing:
            marks.density("start")
        event = trainer.density_control(density_gen)
        if timing:
            marks.density("end")
        events.append(dict(event, stretch=stretch, position=n))

    def checked_control(n) -> dict:
        """The checked event: the state before and after it, on the host;
        its split noise drawn here, as the program would draw it."""
        plan = trainer.density_plan()
        before = program.snapshot(trainer.state)
        noise = None
        if plan["densify"] is not None:
            noise = torch.randn((plan["densify"]["n_split"], before["alive"].shape[0], 3),
                                generator=density_gen, device=dev)
        event = trainer.density_control(noise=noise)
        events.append(dict(event, stretch="warmup", position=n))
        return {"plan": plan, "before": before, "noise": None if noise is None else noise.cpu(),
                "after": dict(program.snapshot(trainer.state), counts=event)}

    warmup, first_event, checked_event = traffic["warmup_steps"], None, None
    if density is not None:
        first_event = trainer.steps_to_density()
        if first_event is None:
            raise ValueError(f"density control never acts after step {trainer.state.step}")
        warmup = max(warmup, first_event)
    for n in range(warmup):
        trainer.step(next(order))
        if first_event is not None and n == first_event - 1:
            checked_event = checked_control(n)
        else:
            control(n, "warmup")
    sync(dev)

    window_losses = []

    def train(n, i, stretch):
        window_losses.append(trainer.step(i))
        control(n, stretch)

    def step(n):
        train(n, next(order), "window")

    first = len(marks.steps) if trace else 0
    first_timed = len(marks.events) if trace else 0
    phases["window"] = time.perf_counter()
    with steady_host():
        host_shares = {}
        steps, window_s, tenths = timed(seconds, step, dev, host_shares)
    ctx = {"steps": steps, "window_s": window_s}
    if trace:
        ctx["stage_ms"] = marks.stage_ms(first, len(marks.steps))
        if density is not None:
            ctx["density_ms"] = marks.density_ms(first_timed, len(marks.events))
            ctx["density_events"] = [e for e in events if e["stretch"] == "window"]
        sample = set(traffic["sample_launches"])
        snapshots = []

        def traced_step(n):
            i = next(order)
            if n in sample:
                snapshots.append((n, i, {k: p.detach().clone()
                                         for k, p in trainer.params().items()},
                                  trainer.state.alive.clone()))
            train(n, i, "traced")

        with steady_host(), tracing.Profiled(dev) as profiled:
            marks.timeline = profiled.timeline
            timed(min(seconds, tracing.PROFILED_S), traced_step, dev)
        marks.timeline = None
        ctx["trace"] = profiled.summarize(c["trace_dir"])
        del profiled
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    attempted = len(window_losses)
    peak = peak_bytes(dev)
    del trainer, window_losses
    free(dev)

    exact_float32()
    if trace:
        ctx["samples"] = [_sample(scene, *snapshot) for snapshot in snapshots]
        del snapshots
        free(dev)
    ref = train_steps(scene, checked)
    numbers, diagnostics = train_numbers(prog, ref)
    del ref
    if checked_event is not None:
        noise = checked_event["noise"]
        want = density_event(_to(checked_event["before"], dev), checked_event["plan"],
                             None if noise is None else noise.to(dev))
        event_numbers, diagnostics["density_check"] = density_numbers(
            _to(checked_event["after"], dev), want)
        numbers.update(event_numbers)
        del checked_event, want
        free(dev)
    diagnostics["window_rate_tenths"] = tenths
    diagnostics["window_host"] = host_shares
    if density is not None:
        diagnostics["density_events"] = events
        diagnostics["alive_at_setup"] = int(scene.alive.sum())
    if trace:
        diagnostics["sampled_rows"] = [[s["position"], s["rows"], s["live"]]
                                       for s in ctx["samples"]]
    return {"e2e": {"train_step_ms": 1e3 * window_s / steps},
            "attempted": attempted, "failed": failed, "peak": peak, "numbers": numbers,
            "diagnostics": diagnostics, "ctx": ctx}
