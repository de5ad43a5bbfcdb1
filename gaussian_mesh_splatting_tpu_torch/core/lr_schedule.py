"""Learning-rate schedules (port of
`gaussian_mesh_splatting_tpu/core/lr_schedule.py`).

`expon_lr` is the Plenoxels/JaxNeRF log-linear decay with an optional sine
delay warm-up that the reference uses for Gaussian positions, as a function
of a Python step. It computes in float32 with the JAX package's operations,
so the two agree to float32 rounding; the result is a Python float for a
`torch.optim` param group's "lr".
"""
from __future__ import annotations

import functools
import math

import torch


def expon_lr(
    step: int,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> float:
    """Log-linearly interpolated LR: lr_init at step 0 -> lr_final at max_steps."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if step < 0:
        return 0.0

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    s = f32(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(s / lr_delay_steps, 0, 1)
        )
    else:
        delay_rate = 1.0
    t = torch.clamp(s / max_steps, 0, 1)
    log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t) + torch.log(f32(lr_final)) * t)
    return float(delay_rate * log_lerp)


def make_expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """The schedule step -> lr, as a picklable partial of `expon_lr`."""
    return functools.partial(
        expon_lr, lr_init=lr_init, lr_final=lr_final, lr_delay_steps=lr_delay_steps,
        lr_delay_mult=lr_delay_mult, max_steps=max_steps,
    )
