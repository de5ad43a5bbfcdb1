"""Mean time of the train step's `render` stage (projection with SH, binning,
the attribute table and B1) per step of a traced run's window (no profiler
running), from the `mark` events."""
from benchmark.counts.shares import stage_mean_ms

LAYER = "renderer"
UNIT = "ms"
MOVES = "train_step_ms"


def read(ctx: dict) -> float | None:
    return stage_mean_ms(ctx, "render")
