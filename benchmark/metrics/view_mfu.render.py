"""A rendered view's share of the float32 peak: the sampled views' counted
operations over the time per view of a traced run's window (no profiler
running)."""
from benchmark.counts.shares import peak_percent

LAYER = "step"
UNIT = "%"
MOVES = "render_views_per_s"


def read(ctx: dict) -> float | None:
    return peak_percent(ctx)
