"""B1's share of its roofline on the render path, as `b1_roofline.train`."""
from benchmark.counts.shares import roofline_percent

LAYER = "kernels"
UNIT = "%"
MOVES = "render_views_per_s"


def read(ctx: dict) -> float | None:
    return roofline_percent(ctx, "fwd")
