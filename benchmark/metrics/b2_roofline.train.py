"""B2's (`csrc/composite_bwd.cu`) share of its roofline in training, as
`b1_roofline.train`."""
from benchmark.counts.shares import roofline_percent

LAYER = "kernels"
UNIT = "%"
MOVES = "train_step_ms"


def read(ctx: dict) -> float | None:
    return roofline_percent(ctx, "bwd")
