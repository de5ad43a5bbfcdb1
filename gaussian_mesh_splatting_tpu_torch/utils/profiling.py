"""Timing, tracing and metrics logging for training (port of
`gaussian_mesh_splatting_tpu/utils/profiling.py`): the port's one tracer
(`span`, `count`, `tracing`, `Recording`), a `torch.profiler` trace of a
region (the counterpart of the JAX package's XProf `xprof_trace`), and JSON
lines in `{model}/metrics.jsonl` plus TensorBoard when its writer imports.

The tracer. The program opens `span(name)` at its layer boundaries and calls
`count(name, value)` where work happens; both forward to one module-global
sink, installed by `with tracing(sink):`. It is global, not per thread: the
backward's spans open on the autograd engine's device thread while the
caller's thread waits in `backward()`. With no sink each boundary costs a
global read and an `is None` test: nothing is allocated, no CUDA event is
made and no tensor is read. `Recording` is the sink that keeps everything in
memory until the run ends.

Spans of the program: the train step's stages `to_bag`, `render`, `loss`,
`backward`, `adam`, `stats` (`train/loop.py`; request id: the step);
`project` (cov3d, projection and SH), `bin`, its child `bin_sync` (the wait
for the pair count) and `composite_fwd` (the attribute table and B1) in
`ops/rasterize_cuda.py` and `ops/binning.py`; `composite_bwd` (B2) in the
composite's backward. Counters: `pairs` (a render's pair-list length),
`host_syncs` (each place the host blocks on the device),
`project_kernel` (1 a render whose projection ran as the CUDA kernels, 0
where `preprocess` ran) and `loss_kernel` (1 a loss that ran as the CUDA
kernels of `ops/ssim.py`, 0 where the chain ran; `train/loss.py`)."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

_sink = None  # the installed sink, or None: tracing is off


class _Off:
    """The span of every boundary while tracing is off: does nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, request: int | None = None):
    """`with span(name):` around one layer's work, recorded by the
    installed sink. `request` (the train step, the rendered view) is taken
    by a top-level span; a nested span takes its parent's."""
    sink = _sink
    if sink is None:
        return _OFF
    return sink.span(name, request)


def count(name: str, value: int = 1) -> None:
    """Add `value` (a host number) to the counter `name` in the installed
    sink, if any."""
    sink = _sink
    if sink is not None:
        sink.count(name, value)


@contextlib.contextmanager
def tracing(sink):
    """Install `sink` (an object with `span(name, request)`, which opens the
    span and returns the context manager that closes it, and `count(name,
    value)`) for the enclosed region; the sink that was installed before
    comes back at its end."""
    global _sink
    previous, _sink = _sink, sink
    try:
        yield sink
    finally:
        _sink = previous


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span: `parent` is the index of the enclosing span in
    `Recording.spans` (None at the top); host times from
    `time.perf_counter_ns`; the CUDA events recorded on the current stream
    at its start and end (a recording on a CUDA device)."""
    name: str
    parent: int | None
    request: int
    start_ns: int
    end_ns: int | None = None
    start_event: object = None
    end_event: object = None


class Recording:
    """A sink that keeps every span, in the order they open, and every count
    in memory. A span starts when `span()` is called and ends when the
    `with` block it opens does. On a CUDA `device` each span also records a
    CUDA event at both ends, which puts it on the device's clock (read them
    after the device has caught up)."""

    def __init__(self, device=None):
        device = torch.device("cpu" if device is None else device)
        self.cuda = device.type == "cuda"
        if self.cuda:
            self._index = torch.cuda.current_device() if device.index is None else device.index
        self._streams: dict = {}  # raw stream handle -> torch.cuda.Stream
        self.spans: list[Span] = []
        self.counts: list[tuple[str, float, int | None]] = []  # (name, value, span)
        self._open: list[int] = []
        # in host order, span i's start as i and its end as ~i: no object
        # for the collector to walk
        self._boundaries: list[int] = []
        self._requests = 0
        self._closer = _Closer(self)

    def span(self, name: str, request: int | None = None) -> "_Closer":
        parent = self._open[-1] if self._open else None
        if parent is not None:
            request = self.spans[parent].request
        elif request is None:
            request = self._requests
        self._requests = max(self._requests, request + 1)
        index = len(self.spans)
        self._open.append(index)
        self._boundaries.append(index)
        self.spans.append(Span(name, parent, request, time.perf_counter_ns(),
                               start_event=self._event()))
        return self._closer

    def count(self, name: str, value: float) -> None:
        self.counts.append((name, value, self._open[-1] if self._open else None))

    def _event(self):
        if not self.cuda:
            return None
        # torch.cuda.current_stream() builds a Stream object a call (~8 us on
        # the card's host): keep one for each stream the spans meet
        raw = torch._C._cuda_getCurrentRawStream(self._index)
        stream = self._streams.get(raw)
        if stream is None:
            stream = self._streams[raw] = torch.cuda.current_stream(self._index)
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        return event

    def _end(self) -> None:
        index = self._open.pop()
        self._boundaries.append(~index)
        s = self.spans[index]
        s.end_event = self._event()
        s.end_ns = time.perf_counter_ns()

    def path(self, index: int) -> str:
        """The span's name behind its ancestors' ("render/bin/bin_sync")."""
        names = []
        while index is not None:
            names.append(self.spans[index].name)
            index = self.spans[index].parent
        return "/".join(reversed(names))

    def timeline(self) -> list[tuple[str, int, object]]:
        """Every span's start and end in the host's order, as (the path of
        the innermost span open after it, "" outside every span; host ns;
        its CUDA event or None)."""
        out, open_ = [], []
        for b in self._boundaries:
            if b >= 0:
                open_.append(b)
                ns, event = self.spans[b].start_ns, self.spans[b].start_event
            else:
                open_.pop()
                ns, event = self.spans[~b].end_ns, self.spans[~b].end_event
            out.append((self.path(open_[-1]) if open_ else "", ns, event))
        return out

    def totals(self) -> dict:
        """Counter -> its sum over the recording."""
        out: dict = {}
        for name, value, _ in self.counts:
            out[name] = out.get(name, 0) + value
        return out

    def to_json(self) -> dict:
        """Spans (host microseconds after the first span's start and, on a
        CUDA device, device microseconds after its start event) and counts."""
        t0 = self.spans[0].start_ns if self.spans else 0
        first = self.spans[0].start_event if self.spans and self.cuda else None
        spans = []
        for i, s in enumerate(self.spans):
            row = {"name": s.name, "path": self.path(i), "parent": s.parent,
                   "request": s.request, "host_start_us": (s.start_ns - t0) / 1e3,
                   "host_end_us": (s.end_ns - t0) / 1e3}
            if first is not None:
                row["device_start_us"] = 1e3 * first.elapsed_time(s.start_event)
                row["device_end_us"] = 1e3 * first.elapsed_time(s.end_event)
            spans.append(row)
        counts = [{"name": n, "value": v, "span": i} for n, v, i in self.counts]
        return {"spans": spans, "counts": counts, "totals": self.totals()}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


class _Closer:
    """Ends the innermost open span of a `Recording` at the end of a `with`
    block (one for the recording: a span allocates no context manager)."""

    def __init__(self, recording: Recording):
        self.recording = recording

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        self.recording._end()
        return False


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Trace the enclosed region with `torch.profiler` (the host's operators
    and, where a card is present, its kernels through CUPTI) and write it as
    a Chrome trace to `logdir/trace.json`. The caller synchronizes the
    device at both ends, so the window holds the region's device work."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricsLogger:
    """JSONL metrics sink + optional TensorBoard writer (the reference's
    SummaryWriter usage, behind the same import guard)."""

    def __init__(self, model_path: str, tensorboard: bool = True):
        self.jsonl = open(os.path.join(model_path, "metrics.jsonl"), "a")
        self.tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("Tensorboard not available: not logging progress")
            else:
                self.tb = SummaryWriter(model_path)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.jsonl.write(json.dumps({"step": step, tag: float(value)}) + "\n")
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), step)

    def image(self, tag: str, img, step: int) -> None:
        if self.tb is not None:
            self.tb.add_image(tag, np.asarray(img).transpose(2, 0, 1), step)

    def histogram(self, tag: str, values, step: int) -> None:
        if self.tb is not None:
            self.tb.add_histogram(tag, np.asarray(values), step)

    def flush(self) -> None:
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
