"""Mean time of the train step's `adam` stage (the statistics' inputs, the
learning-rate schedules and `torch.optim.Adam`) per step of a traced run's
window (no profiler running), from the `mark` events."""
from benchmark.counts.shares import stage_mean_ms

LAYER = "optimizer"
UNIT = "ms"
MOVES = "train_step_ms"


def read(ctx: dict) -> float | None:
    return stage_mean_ms(ctx, "adam")
