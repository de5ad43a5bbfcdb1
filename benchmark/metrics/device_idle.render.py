"""The share of the profiled render stretch in which the device ran no
kernel, copy or fill (the profiler's trace of device activity alone)."""
from benchmark.counts.shares import idle_percent

LAYER = "device"
UNIT = "%"
MOVES = "render_views_per_s"


def read(ctx: dict) -> float | None:
    return idle_percent(ctx)
