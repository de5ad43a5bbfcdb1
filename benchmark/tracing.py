"""The traced run's instruments, all in the benchmark's own files.

Stage times come from CUDA events that the train step's `mark` hook
records at each stage boundary, over steps that no profiler slows
(`StageMarks`); a density-control event's time from two more, which the
driver records around it (`StageMarks.density`). The device's busy share,
the kernels' times and the breakdown come from a later stretch under
`torch.profiler` that records device activity alone (`Profiled`): no CPU
activity, so that the host runs at its own speed. The stretch's idle gaps
are put down to what the host was doing by the boundaries it recorded as
CUDA events (`Boundaries`), placed on the trace's clock by a marker
launched at the first of them.
"""
from __future__ import annotations

import json
import math
import os
import time

import torch

STAGES = ("to_bag", "render", "loss", "backward", "adam", "stats")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BETWEEN = "between"  # the host outside every labelled part
DENSIFY = "densify"  # a density-control event, its host read of the counts included
# the longest profiled stretch of a traced run: what it gives are times and
# shares a step or view, which a longer stretch does not change, while the
# trace to reduce grows with it
PROFILED_S = 20.0


class Boundaries:
    """The boundaries of what the host does, in the host's order: each
    `record(label)` marks where `label` starts, as a CUDA event on the card
    (the host clock in a CPU rehearsal)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def record(self, label: str) -> None:
        self.marks.append((label, _now(self.cuda)))

    def offsets_us(self) -> list:
        """[(label, microseconds after the first boundary)] (the events must
        have completed)."""
        first = self.marks[0][1]
        return [(label, 1e3 * _elapsed_ms(first, ev, self.cuda)) for label, ev in self.marks]


def _now(cuda: bool):
    """A CUDA event recorded on the current stream, or in a CPU rehearsal the
    host clock."""
    if not cuda:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _elapsed_ms(a, b, cuda: bool) -> float:
    """Milliseconds from `_now` reading a to b (the events must have
    completed)."""
    return a.elapsed_time(b) if cuda else 1e3 * (b - a)


class StageMarks:
    """`mark` hook of `make_train_step`: a CUDA event at each stage boundary
    of each step, and, while `timeline` is set, the same boundaries in it
    (labelled with the stage that starts there). `density` marks a
    density-control event alike."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.steps: list[dict] = []
        self.events: list[dict] = []  # each density-control event's "start" and "end"
        self.timeline: Boundaries | None = None

    def __call__(self, stage: str) -> None:
        if stage == "start":
            self.steps.append({})
        self.steps[-1][stage] = _now(self.cuda)
        if self.timeline is not None:
            following = (STAGES[0] if stage == "start" else BETWEEN if stage == STAGES[-1]
                         else STAGES[STAGES.index(stage) + 1])
            self.timeline.record(following)

    def stage_ms(self, first: int, last: int) -> dict:
        """Stage -> its device-timeline milliseconds in each of steps
        first..last-1 (the events must have completed)."""
        out = {s: [] for s in STAGES}
        for ev in self.steps[first:last]:
            prev = ev["start"]
            for s in STAGES:
                out[s].append(_elapsed_ms(prev, ev[s], self.cuda))
                prev = ev[s]
        return out

    def density(self, edge: str) -> None:
        """`density("start")` just before a density-control event and
        `density("end")` just after it: a CUDA event each, and, while
        `timeline` is set, the boundary DENSIFY before it and BETWEEN after
        it."""
        if edge == "start":
            self.events.append({})
        self.events[-1][edge] = _now(self.cuda)
        if self.timeline is not None:
            self.timeline.record(DENSIFY if edge == "start" else BETWEEN)

    def density_ms(self, first: int, last: int) -> list:
        """The device-timeline milliseconds of density-control events
        first..last-1 (the events must have completed)."""
        return [_elapsed_ms(ev["start"], ev["end"], self.cuda) for ev in self.events[first:last]]


class Profiled:
    """A stretch under `torch.profiler` (device activity alone on the card)
    whose boundaries go into `timeline`: the first ("between") is recorded
    with a marker op right behind it, the last ("end") closes the stretch."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        activity = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[activity.CUDA if self.cuda else activity.CPU])
        self.timeline = Boundaries(device)
        self._marker = torch.zeros(1, device=device) if self.cuda else None

    def __enter__(self) -> "Profiled":
        _sync(self.device)
        self.prof.__enter__()
        self.timeline.record(BETWEEN)
        if self.cuda:
            self._marker.add_(1)
        return self

    def __exit__(self, *exc) -> None:
        self.timeline.record("end")
        _sync(self.device)
        self.prof.__exit__(*exc)

    def summarize(self, directory: str) -> dict:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "trace.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return summarize(events, self.timeline.offsets_us(), marker=self.cuda)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals, lo, hi):
    """Total length of the union of intervals clipped to [lo, hi], and the
    gaps between them there as (start, end)."""
    busy, end, gaps = 0.0, lo, []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= end:
            continue
        if a > end:
            gaps.append((end, a))
        busy += b - max(a, end)
        end = b
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def _label_gaps(gaps, marks) -> dict:
    """Seconds of idle device by what the host was doing: each gap split at
    the boundaries inside it, each piece put down to the boundary before it.
    `gaps` and `marks` ((time, label), with times as the gaps') in time
    order."""
    idle: dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while j + 1 < len(marks) and marks[j + 1][0] <= a:
            j += 1
        start, k = a, j
        while start < b:
            label = marks[k][1] if marks and marks[k][0] <= start else BETWEEN
            nxt = marks[k + 1][0] if k + 1 < len(marks) else math.inf
            end = min(b, nxt)
            idle[label] = idle.get(label, 0.0) + (end - start) * 1e-6
            start = end
            if end == nxt:
                k += 1
    return idle


def summarize(events: list, boundaries: list, marker: bool, top: int = 10) -> dict:
    """Reduce a stretch's Chrome trace events to seconds: the stretch (from
    the first boundary to "end", the last), the device's busy time in it
    (the union of kernels, copies and fills), every device operation as
    (name, seconds) in launch order, and the breakdown. With `marker`, the
    first device operation is the marker launched at the first boundary: it
    places the boundaries on the trace's clock and is left out."""
    device = sorted((e for e in events if e.get("ph") == "X" and "dur" in e
                     and e.get("cat") in DEVICE_CATS), key=lambda e: float(e["ts"]))
    lo = 0.0
    if marker:
        if not device:
            raise RuntimeError("the trace holds no device operation")
        lo = float(device[0]["ts"])
        device = device[1:]
    hi = lo + boundaries[-1][1]
    device = [e for e in device if lo <= float(e["ts"]) < hi]
    busy, gaps = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device],
                        lo, hi)
    launches, by_op = [], {}
    for e in device:
        launches.append((e["name"], float(e["dur"]) * 1e-6))
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    idle = _label_gaps(gaps, [(lo + off, label) for label, off in boundaries[:-1]])
    rank = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6, "launches": launches,
            "breakdown": {"device_ops": [[n[:120], s] for n, s in rank],
                          "idle_gaps": [[n[:120], s] for n, s in
                                        sorted(idle.items(), key=lambda kv: -kv[1])[:top]]}}
