"""The arithmetic the per-layer readers share: a kernel's share of its
roofline over the sampled launches, a step's or view's share of the float32
peak, the device's idle share and a stage's mean time. Each returns None
where the run has nothing to read."""
from __future__ import annotations

import statistics

from . import H100_F32_FLOPS


def stage_mean_ms(ctx: dict, stage: str) -> float | None:
    times = ctx.get("stage_ms", {}).get(stage)
    return statistics.fmean(times) if times else None


def roofline_percent(ctx: dict, kernel: str) -> float | None:
    """100 x (least seconds of the sampled launches of `kernel`, "fwd" or
    "bwd", from their walk counts) / (their device seconds in the trace).
    Launch i of the kernel in the profiled stretch belongs to its step or
    view i."""
    if "trace" not in ctx or not ctx.get("samples"):
        return None
    name = ctx["kernels"][kernel]
    launches = [s for n, s in ctx["trace"]["launches"] if name in n]
    pairs = [(sample["walk"][kernel]["least_s"], launches[sample["position"]])
             for sample in ctx["samples"] if sample["position"] < len(launches)]
    if not pairs:
        return None
    return 100.0 * sum(a for a, _ in pairs) / sum(b for _, b in pairs)


def peak_percent(ctx: dict) -> float | None:
    """100 x the sampled steps' (or views') mean counted operations over the
    window's time per step, against the float32 peak."""
    if "trace" not in ctx or not ctx.get("samples") or not ctx["steps"]:
        return None
    flops = statistics.fmean(s["flops"] for s in ctx["samples"])
    return 100.0 * flops / (ctx["window_s"] / ctx["steps"]) / H100_F32_FLOPS


def idle_percent(ctx: dict) -> float | None:
    if "trace" not in ctx or ctx["trace"]["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["trace"]["window_s"])
