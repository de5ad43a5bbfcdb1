"""Mean device-timeline time of the train step's `to_bag` stage (the mesh's
face frames, or the FLAME decode with LBS, and the SH mask) per step of a
traced run's window (no profiler running), from the step's `mark` events."""
from benchmark.counts.shares import stage_mean_ms

LAYER = "model"
UNIT = "ms"
MOVES = "train_step_ms"


def read(ctx: dict) -> float | None:
    return stage_mean_ms(ctx, "to_bag")
