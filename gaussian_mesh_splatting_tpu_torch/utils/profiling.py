"""Metrics logging for training (the `MetricsLogger` of
`gaussian_mesh_splatting_tpu/utils/profiling.py`): JSON lines in
`{model}/metrics.jsonl`, plus TensorBoard when its writer imports."""
from __future__ import annotations

import json
import os

import numpy as np


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
