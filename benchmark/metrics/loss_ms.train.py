"""Mean time of the train step's `loss` stage (L1 + SSIM forward) per step
of a traced run's window (no profiler running), from the `mark` events."""
from benchmark.counts.shares import stage_mean_ms

LAYER = "loss"
UNIT = "ms"
MOVES = "train_step_ms"


def read(ctx: dict) -> float | None:
    return stage_mean_ms(ctx, "loss")
