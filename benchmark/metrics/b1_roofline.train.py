"""B1's (`csrc/composite_fwd.cu`) share of its roofline in training: the
least time of the sampled launches, from the frozen walk count on the
benchmark's own pairs, over their device time in the trace."""
from benchmark.counts.shares import roofline_percent

LAYER = "kernels"
UNIT = "%"
MOVES = "train_step_ms"


def read(ctx: dict) -> float | None:
    return roofline_percent(ctx, "fwd")
