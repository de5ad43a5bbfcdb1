"""Timing, tracing and metrics logging for training (port of
`gaussian_mesh_splatting_tpu/utils/profiling.py`): a host-side EMA step
timer, a `torch.profiler` trace of a region (the counterpart of the JAX
package's XProf `xprof_trace`), and JSON lines in `{model}/metrics.jsonl`
plus TensorBoard when its writer imports."""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch


class StepTimer:
    """Exponential-moving-average step timer (host clock). The caller
    synchronizes the device inside the timed region: CUDA work returns
    before it is done."""

    def __init__(self, beta: float = 0.9):
        self.beta = beta
        self.ema_ms: float | None = None
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter() - self._t0) * 1000
        self.ema_ms = dt if self.ema_ms is None else (
            self.beta * self.ema_ms + (1 - self.beta) * dt
        )
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
