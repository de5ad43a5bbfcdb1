"""Render traffic: one viewer of a trained scene. The program's bag is made
once, as `apps/render` makes it; each view is rendered, clamped and copied
into one page-locked host buffer, reused, so that the copy neither stages
through pageable memory nor faults in fresh pages each view. Set-up renders
the warm-up passes over every view; the window renders views in the
traffic's order for `seconds`, and a traced run follows it with a stretch
under the profiler, as long as the window up to `tracing.PROFILED_S`. The
check compares the traffic's `checked_views` views, drawn from the seed
among the window's first `check_among`, with the reference's render, once
the program is freed."""
from __future__ import annotations

import random
import statistics
import time

import torch

from . import free, peak_bytes, steady_host, timed, walk
from .. import program, scenes, tracing
from ..counts import ops
from ..reference import exact_float32
from ..reference.camera import make_view
from ..reference.models import bag_for
from ..reference.render import render as reference_render


def run(c: dict, scene, seed: int, seconds: float, trace: bool, dev, phases: dict,
        render_kwargs: dict | None) -> dict:
    traffic = c["traffic"]
    renderer = program.Renderer(scene, render_kwargs)
    phases["program"] = time.perf_counter()
    n_views = len(scene.views)
    host = torch.empty((scene.height, scene.width, 3), pin_memory=dev.type == "cuda")
    for _ in range(traffic["warmup_passes"]):
        for i in range(n_views):
            host.copy_(renderer.view(i))
    positions = set(random.Random(f"{seed}:check").sample(range(traffic["check_among"]),
                                                          traffic["checked_views"]))
    order = scenes.view_order(seed, n_views, traffic["order"])
    kept, latencies = {}, []
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def view(n):
        i = next(order)
        t = time.perf_counter()
        image = renderer.view(i)
        host.copy_(image)
        latencies.append(time.perf_counter() - t)
        bad.add_((~torch.isfinite(image)).any())
        if n in positions:
            kept[i] = host.clone()

    phases["window"] = time.perf_counter()
    with steady_host():
        host_shares = {}
        views, window_s, tenths = timed(seconds, view, dev, host_shares)
    ctx = {"steps": views, "window_s": window_s}
    attempted = views
    if trace:
        sample = set(traffic["sample_launches"])
        sampled = []

        def traced_view(n):
            i = next(order)
            if n in sample:
                sampled.append((n, i))
            profiled.timeline.record("render")
            image = renderer.view(i)
            profiled.timeline.record("copy")
            host.copy_(image)
            profiled.timeline.record(tracing.BETWEEN)
            bad.add_((~torch.isfinite(image)).any())

        with steady_host(), tracing.Profiled(dev) as profiled:
            attempted += timed(min(seconds, tracing.PROFILED_S), traced_view, dev)[0]
        ctx["trace"] = profiled.summarize(c["trace_dir"])
        del profiled
    failed = int(bad)
    peak = peak_bytes(dev)
    del renderer
    free(dev)

    exact_float32()
    if trace:
        ctx["samples"] = []
        live = int(scene.alive.sum())
        for position, i in sampled:
            counts = walk(scene, scene.params, scene.alive, i)
            ctx["samples"].append({"position": position, "view": i, "walk": counts,
                                   "flops": ops.view_flops(live, scene.height, scene.width,
                                                           counts)})
        free(dev)
    if not kept:
        raise RuntimeError("the window rendered none of the views to check")
    mean, rms, worst = 0.0, 0.0, 0.0
    with torch.no_grad():
        bag = bag_for(scene.kind, scene.params, scene.faces, scene.rig, scene.alive)
        for i, image in sorted(kept.items()):
            v = make_view(*scene.views[i], scene.fovx, scene.fovy, scene.width, scene.height, dev)
            want = torch.clamp(reference_render(bag, v, scene.bg, scene.sh_degree), 0, 1).cpu()
            d = (image.float() - want).abs()
            mean = max(mean, float(d.mean()))
            rms = max(rms, float(d.square().mean().sqrt()))
            worst = max(worst, float(d.max()))
    q = statistics.quantiles(latencies, n=100) if views > 1 else [latencies[0]] * 99
    return {"e2e": {"render_views_per_s": views / window_s, "render_ms_p95": 1e3 * q[94]},
            "attempted": attempted, "failed": failed, "peak": peak,
            "numbers": {"image_mean_gap": mean},
            "diagnostics": {"checked_views": sorted(kept), "image_rms_gap": rms,
                            "image_max_gap": worst, "render_ms_p50": 1e3 * q[49],
                            "window_rate_tenths": tenths, "window_host": host_shares},
            "ctx": ctx}
