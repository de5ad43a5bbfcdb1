"""The drivers of a cell's run, one file a kind of traffic
(`drivers/<driver>.py`, named by the traffic mix's "driver"): each has
`run(c, scene, seed, seconds, trace, dev, phases, render_kwargs)`, which
drives the program through the checked steps or views and the measured
window and returns the window's numbers and what `correct` compares. What
they share is here."""
from __future__ import annotations

import gc
import time

import torch

from ..counts.walk import walk_counts
from ..reference.camera import make_view
from ..reference.models import bag_for
from ..reference.render import bin_tiles, project


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def walk(scene, params: dict, alive: torch.Tensor, view_index: int) -> dict:
    """The walk counts of the reference's own projection and binning of the
    rows of `params` that `alive` marks, through view `view_index`."""
    with torch.no_grad():
        bag = bag_for(scene.kind, params, scene.faces, scene.rig, alive)
        view = make_view(*scene.views[view_index], scene.fovx, scene.fovy, scene.width,
                         scene.height, scene.alive.device)
        proj = project(bag, view, scene.sh_degree)
        return walk_counts(proj, bin_tiles(proj, scene.height, scene.width), scene.height,
                           scene.width)


class steady_host:
    """A context for a measured stretch: what set-up left collected and its
    objects frozen, so that the collector's full passes in the stretch do
    not walk them; unfrozen afterwards."""

    def __enter__(self):
        gc.collect()
        gc.freeze()
        return self

    def __exit__(self, *exc):
        gc.unfreeze()


def _probe_ms() -> float:
    """Milliseconds of a fixed piece of Python work: the host's own speed."""
    t, x = time.perf_counter(), 0
    for i in range(200_000):
        x += i * i % 7
    return 1e3 * (time.perf_counter() - t)


def timed(seconds: float, step, dev, host: dict | None = None) -> tuple[int, float, list]:
    """Call `step(position)` from position 0 until `seconds` have passed on
    the host clock, then wait for the device: (steps, seconds, the rate in
    each tenth of the stretch, steps a second by the host clock). Where
    `host` is a dict, the host's part goes into it: the CPU time of the
    calling thread and of the process as shares of the stretch, and
    `_probe_ms` before and after it."""
    before = _probe_ms() if host is not None else None
    thread0, process0 = time.thread_time(), time.process_time()
    n, t0, ends = 0, time.perf_counter(), []
    while True:
        step(n)
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    sync(dev)
    elapsed = time.perf_counter() - t0
    if host is not None:
        host.update(thread_cpu=(time.thread_time() - thread0) / elapsed,
                    process_cpu=(time.process_time() - process0) / elapsed,
                    probe_ms=[before, _probe_ms()])
    tenths = [0] * 10
    for t in ends:
        tenths[min(9, int(10 * t / ends[-1]))] += 1
    return n, elapsed, [10 * k / ends[-1] for k in tenths]
