"""Float operations of a whole training step or rendered view, from shapes:
the composites' counts from `walk.walk_counts`, everything else from the
plain formulas of `reference/` counted once each (a multiply-add is two).

Per Gaussian, forward: projection to the pixel and view z 28, the
covariance from rotation and scales 45, its EWA image and dilation 50, the
conic and radii 25, the view direction 10, degree-3 spherical harmonics
(the basis 30, 16 x 3 multiply-adds 96, + 0.5 and the clamp 6): 290.
The model's own work, from its shapes, is counted by
`counts/models/<kind>.py`. SSIM a pixel and channel: five separable 11-tap
blurs (220), six products, the map (15), three differences: 244; L1 3; the
image over the background 2. A backward pass is counted as twice its
forward. Adam: 12 a parameter; the densification statistics 12 a Gaussian.
"""
from __future__ import annotations

import importlib

PROJECT_SH = 290
SSIM_PIXEL, L1_PIXEL, COMPOSE_PIXEL = 244, 3, 2
ADAM_PARAM, STATS_GAUSSIAN = 12, 12
BACKWARD = 2


def model_flops(kind: str, n_gaussians: int, n_faces: int, n_vertices: int) -> int:
    """The model's forward work, from `counts/models/<kind>.py`."""
    return importlib.import_module(f".models.{kind}", __package__).model_flops(
        n_gaussians, n_faces, n_vertices)


def view_flops(n_gaussians: int, height: int, width: int, walk: dict) -> int:
    """One rendered view of a bag made once: projection, colour, B1, the
    image over the background and its clamp."""
    return (PROJECT_SH * n_gaussians + walk["fwd"]["flops"]
            + (COMPOSE_PIXEL + 2) * 3 * height * width)


def step_flops(model: int, n_gaussians: int, n_params: int, height: int, width: int,
               walk: dict) -> int:
    """One training step: the model's forward work `model` (`model_flops`)
    and the render forward and backward (B1, B2 from the walk), the loss
    forward and backward, Adam over every parameter, the statistics."""
    forward = model + PROJECT_SH * n_gaussians + COMPOSE_PIXEL * 3 * height * width
    loss = (SSIM_PIXEL + L1_PIXEL) * 3 * height * width
    return ((1 + BACKWARD) * (forward + loss) + walk["fwd"]["flops"] + walk["bwd"]["flops"]
            + ADAM_PARAM * n_params + STATS_GAUSSIAN * n_gaussians)
