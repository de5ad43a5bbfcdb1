"""Mean time of the train step's `backward` stage (autograd through the loss,
B2, projection, SH and the model) per step of a traced run's window (no
profiler running), from the `mark` events."""
from benchmark.counts.shares import stage_mean_ms

LAYER = "backward"
UNIT = "ms"
MOVES = "train_step_ms"


def read(ctx: dict) -> float | None:
    return stage_mean_ms(ctx, "backward")
