"""The whole train step's share of the float32 peak: the sampled steps'
counted operations (`counts/ops.py`) over the time per step of a traced
run's window (no profiler running)."""
from benchmark.counts.shares import peak_percent

LAYER = "step"
UNIT = "%"
MOVES = "train_step_ms"


def read(ctx: dict) -> float | None:
    return peak_percent(ctx)
