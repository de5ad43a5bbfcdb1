"""General utilities (port of `gaussian_mesh_splatting_tpu/utils/general.py`):
reproducibility and stdout decoration, the reference's `safe_state`."""
from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


def safe_state(silent: bool = False, seed: int = 0) -> None:
    """Seed the python, numpy and torch generators (`torch.manual_seed`
    seeds every CUDA device too) and timestamp the lines written to stdout,
    or drop them when `silent`. Replaces `sys.stdout` for the process."""
    old_stdout = sys.stdout

    class _F:
        def __init__(self, silent):
            self.silent = silent

        def write(self, x):
            if not self.silent:
                if x.endswith("\n"):
                    ts = datetime.now().strftime("%d/%m %H:%M:%S")
                    old_stdout.write(x.replace("\n", f" [{ts}]\n"))
                else:
                    old_stdout.write(x)

        def flush(self):
            old_stdout.flush()

    sys.stdout = _F(silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
