#!/usr/bin/env python3
"""The port's tracer on the benchmark's cells: where the render stage and
the backward spend the host's time, what the tracer costs, and where the
host waits for the device. One process, one card, the cells in turn:

    python3 tools_torch_span_split.py --workloads gs_mesh.train gs_flame.train \\
        gs_mesh.render --seed 4200000301 --out build/span_split.jsonl

Each cell is built as `benchmark/run.py` builds it (`benchmark.scenes`, the
program through `benchmark.program`), warmed up, then:
  1. the sync audit: `--audit` steps or views under
     `torch.cuda.set_sync_debug_mode("warn")`, every warning put down to the
     innermost line of the port (or of this script) that led to it, beside
     the `host_syncs` the program counted over the same steps;
  2. windows of `--seconds` on the host clock, in turns (`--rounds`
     rounds, plain, marks, traced and the next one backwards): "plain" as an
     untraced benchmark run steps, "marks" with the `mark` hook's CUDA
     events of a benchmark `--trace 1` window (the render cell has no such
     hook: its "marks" are "plain"), "traced" with the port's `Recording`
     sink as well. The traced windows give the split, a mean
     per step or view on the host clock: `project_ms`, `bin_ms`,
     `bin_sync_ms`, `bwd_loss_ms` (the backward up to B2's span),
     `bwd_composite_ms`, `bwd_geometry_ms` (after it), `pairs`,
     `host_syncs`, `project_kernel`, `loss_kernel`; beside them the `mark`
     stages (CUDA events) and the spans' own device-clock times; the
     sink's cost, as the median over rounds of traced over plain and over
     marks, and one span's host cost;
  3. a stretch of `--profile_seconds` under `torch.profiler` (device
     activity alone, `benchmark.tracing.Profiled`) with the sink on: the
     idle gaps labelled by the benchmark's stage boundaries, and again by
     the innermost open span under them (`render/bin/bin_sync`,
     `backward/loss`, ...), so that the labels under one stage sum to it.
A render view is a top-level span `render` (and the copy to the host one
`copy`), as the benchmark's render driver brackets it. Prints the card's
name and power limit, and one JSON line a cell. `--device cpu` rehearses at
the tiny sizes of `benchmark/tests/tiny.py` (host clock; no audit).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "gaussian_mesh_splatting_tpu_torch"
# a span's own time before its first child and after its last, by path
OWN = {"backward": ("loss", "geometry")}


def split_of(rec, steps: int) -> dict:
    """The per-step (or per-view) means of a recording, on the host clock."""
    total: dict = {}

    def add(key, ns):
        total[key] = total.get(key, 0.0) + ns * 1e-6

    for i, s in enumerate(rec.spans):
        if s.name in ("project", "bin", "bin_sync"):
            add(f"{s.name}_ms", s.end_ns - s.start_ns)
        elif s.name == "backward":
            child = next((c for c in rec.spans[i + 1:] if c.parent == i
                          and c.name == "composite_bwd"), None)
            if child is not None:
                add("bwd_loss_ms", child.start_ns - s.start_ns)
                add("bwd_composite_ms", child.end_ns - child.start_ns)
                add("bwd_geometry_ms", s.end_ns - child.end_ns)
    out = {k: v / steps for k, v in sorted(total.items())}
    out.update({k: v / steps for k, v in sorted(rec.totals().items())})
    return out


def device_ms(rec, steps: int) -> dict:
    """Each span name's device-clock milliseconds a step (CUDA recordings)."""
    out: dict = {}
    for s in rec.spans:
        if s.start_event is not None:
            out[s.name] = out.get(s.name, 0.0) + s.start_event.elapsed_time(s.end_event) / steps
    return out


def nested_boundaries(stage_marks: list, rec, first, cuda: bool) -> list:
    """The profiled stretch's boundaries for `benchmark.tracing.summarize`:
    the stage boundaries (label, microseconds after the first) refined by
    the recording's, each piece labelled by the innermost open span's path
    where that path lies under the stage, with a span's own time named by
    OWN; the last boundary ("end") stays last."""
    def offset(ns, event):
        return 1e3 * first.elapsed_time(event) if cuda else ns * 1e-3 - first * 1e6

    # equal device times are common (no kernel between two boundaries):
    # the host's order decides among them
    spans = [(offset(ns, ev), 1, k, path) for k, (path, ns, ev) in enumerate(rec.timeline())]
    marks = sorted([(off, 0, k, label) for k, (label, off) in enumerate(stage_marks[:-1])]
                   + spans)
    out, stage, path, prev = [], None, "", ""
    for off, is_span, _, label in marks:
        if is_span:
            prev, path = path, label
        else:
            stage = label
        if path and path.split("/")[0] == stage:
            own = OWN.get(path)
            name = path if own is None else f"{path}/{own[prev.startswith(path + '/')]}"
        else:
            name = stage
        out.append((name, off))
    return out + [stage_marks[-1]]


def _stack_site(stack) -> str:
    """The innermost frame of the port (else of this script) in a stack."""
    for want in (os.sep + PACKAGE + os.sep, os.path.basename(__file__)):
        for frame in reversed(stack):
            if want in frame.filename:
                return f"{os.path.relpath(frame.filename, ROOT)}:{frame.lineno}"
    return "elsewhere"


def sync_audit(run_one, n: int) -> dict:
    """{site: warnings} over n calls of run_one under the sync debug mode."""
    sites: dict = {}

    def show(message, category, filename, lineno, file=None, line=None):
        site = _stack_site(traceback.extract_stack()[:-1])
        sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        # the backward on the calling thread, so that its syncs keep their stack
        torch.autograd.set_multithreading_enabled(False)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k in range(n):
                run_one(k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            torch.autograd.set_multithreading_enabled(True)
    return sites


def span_cost_us(dev, n: int = 20000) -> float:
    """Host microseconds of one span (enter and exit) of a `Recording`."""
    from gaussian_mesh_splatting_tpu_torch.utils.profiling import Recording, span, tracing

    rec = Recording(dev)
    with tracing(rec):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("x"):
                pass
        cost = (time.perf_counter_ns() - t0) * 1e-3 / n
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return cost


class _Switch:
    """The step's `mark` hook: forwards to `target` while one is set."""

    def __init__(self):
        self.target = None

    def __call__(self, stage):
        if self.target is not None:
            self.target(stage)


def measure(c: dict, seed: int, seconds: float, rounds: int, profile_seconds: float,
            audit: int, dev) -> dict:
    """The cell `c` (as `benchmark.harness.load_cell` gives it) on `dev`."""
    from benchmark import program, scenes, tracing
    from benchmark.drivers import steady_host, sync, timed
    from gaussian_mesh_splatting_tpu_torch.utils.profiling import Recording, span
    from gaussian_mesh_splatting_tpu_torch.utils.profiling import tracing as installed

    cuda = dev.type == "cuda"
    traffic = c["traffic"]
    scene = scenes.build(c["config"], traffic, seed, dev)
    kwargs = {k: c["config"][k] for k in ("attr_precision", "grad_precision")}
    order = scenes.view_order(seed, len(scene.views), traffic["order"])
    train = traffic["driver"] == "train"
    switch = _Switch()
    if train:
        trainer = program.Trainer(scene, kwargs, mark=switch)

        def one(n, timeline=None):
            trainer.step(next(order))
    else:
        renderer = program.Renderer(scene, kwargs)
        host = torch.empty((scene.height, scene.width, 3), pin_memory=cuda)

        def one(n, timeline=None):
            i = next(order)
            if timeline is not None:
                timeline.record("render")
            with span("render", request=n):
                image = renderer.view(i)
            if timeline is not None:
                timeline.record("copy")
            with span("copy", request=n):
                host.copy_(image)
            if timeline is not None:
                timeline.record(tracing.BETWEEN)

    for n in range(3 if train else len(scene.views)):
        one(n)
    sync(dev)
    out = {"workload": c["cell"]["name"], "seed": seed, "gaussians": scene.n_gaussians}
    if audit and cuda:
        rec = Recording(dev)
        with installed(rec):
            out["sync_sites"] = sync_audit(one, audit)
        out["audit_steps"] = audit
        out["audit_host_syncs"] = rec.totals().get("host_syncs", 0)

    windows = {"plain": [], "marks": [], "traced": []}
    splits, stages, dev_ms = [], [], []
    for r in range(rounds):
        for side in ("plain", "marks", "traced")[::1 if r % 2 == 0 else -1]:
            marks = tracing.StageMarks(dev) if side != "plain" else None
            switch.target = marks if train else None
            rec = Recording(dev) if side == "traced" else None
            with steady_host(), installed(rec) if rec else contextlib.nullcontext():
                steps, window_s, _ = timed(seconds, one, dev)
            switch.target = None
            windows[side].append(1e3 * window_s / steps)
            if rec is not None:
                splits.append(split_of(rec, steps))
                dev_ms.append(device_ms(rec, steps))
                if train:
                    stages.append({s: statistics.fmean(v) for s, v in
                                   marks.stage_ms(0, len(marks.steps)).items()})
            del rec, marks
    out["ms_per_step"] = {k: statistics.median(v) for k, v in windows.items()}
    out["ms_per_step_windows"] = windows
    for base in ("plain", "marks"):  # by round: each round holds one window a side
        ratios = [t / b - 1 for t, b in zip(windows["traced"], windows[base])]
        out[f"traced_over_{base}"] = statistics.median(ratios)
        out[f"traced_over_{base}_rounds"] = ratios
    out["span_cost_us"] = span_cost_us(dev)
    out["split"] = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    out["split_windows"] = splits
    out["span_device_ms"] = {k: statistics.median(d[k] for d in dev_ms)
                             for k in dev_ms[0]} if cuda else {}
    if train:
        out["stage_ms"] = {k: statistics.median(s[k] for s in stages) for k in stages[0]}

    marks = tracing.StageMarks(dev)
    switch.target = marks if train else None
    rec = Recording(dev)
    with steady_host(), installed(rec), tracing.Profiled(dev) as profiled:
        marks.timeline = profiled.timeline
        steps = timed(profile_seconds, lambda n: one(n, profiled.timeline), dev)[0]
    switch.target = None
    os.makedirs(c["trace_dir"], exist_ok=True)
    path = os.path.join(c["trace_dir"], "span_split_trace.json")
    profiled.prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    stage_marks = profiled.timeline.offsets_us()
    first = profiled.timeline.marks[0][1]
    old = tracing.summarize(events, stage_marks, marker=cuda, top=64)
    new = tracing.summarize(events, nested_boundaries(stage_marks, rec, first, cuda),
                            marker=cuda, top=64)
    out["profiled"] = {"steps": steps, "window_s": old["window_s"], "busy_s": old["busy_s"],
                       "idle_gaps": dict(old["breakdown"]["idle_gaps"]),
                       "nested_idle_gaps": dict(new["breakdown"]["idle_gaps"]),
                       "device_ops": old["breakdown"]["device_ops"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("span_split")
    p.add_argument("--workloads", nargs="+", default=["gs_mesh.train", "gs_flame.train",
                                                      "gs_mesh.render"])
    p.add_argument("--seed", type=int, default=4200000301)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--profile_seconds", type=float, default=10.0)
    p.add_argument("--audit", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness, program
    from benchmark.drivers import free

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("span_split: no CUDA device", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip()
        print(f"card: {card}", flush=True)
    else:
        card = "cpu"
    program.exact_float32()
    root = ROOT
    if dev.type == "cpu":
        import tempfile

        from benchmark.tests.tiny import CELLS, make_copy
        root = make_copy(tempfile.mkdtemp(prefix="span_split_"))
        args.workloads = [CELLS.get(w, w) for w in args.workloads]
    for k, w in enumerate(args.workloads):
        c = harness.load_cell(root, w)
        t0 = time.perf_counter()
        out = measure(c, args.seed + k, args.seconds, args.rounds, args.profile_seconds,
                      args.audit, dev)
        free(dev)  # the cell's scene and program, before the next is built
        out["seconds"] = time.perf_counter() - t0
        out["card"] = card
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
