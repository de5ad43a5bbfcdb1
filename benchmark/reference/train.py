"""Training steps of the reference: render one view of the live rows, the
photometric loss, its gradient by autograd, then Adam (betas 0.9, 0.999,
eps 1e-15, the 3DGS code's) at each parameter's learning rate for the
step."""
from __future__ import annotations

import torch

from . import exact_float32
from .camera import make_view
from .loss import photometric
from .models import bag_for
from .render import render

BETAS = (0.9, 0.999)
EPS = 1e-15


def adam_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, t: int,
              lr: float) -> None:
    m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
    v.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
    denom = (v / (1 - BETAS[1] ** t)).sqrt() + EPS
    p.sub_(lr * (m / (1 - BETAS[0] ** t)) / denom)


def train_steps(scene, views: list[int]) -> dict:
    """Steps from the scene's initial params, one a view of `views`, the
    first numbered `scene.start_step`: the loss of each, the first step's
    gradient of each parameter and each parameter's change over all of
    them. A dead row is in no bag: its gradient is 0 and it does not move."""
    exact_float32()
    init = scene.params
    params = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in init.items()}
    losses, first = [], None
    for t, i in enumerate(views, start=1):
        view = make_view(*scene.views[i], scene.fovx, scene.fovy, scene.width, scene.height,
                         init["opacity"].device)
        bag = bag_for(scene.kind, params, scene.faces, scene.rig, scene.alive)
        image = render(bag, view, scene.bg, scene.sh_degree)
        loss = photometric(image, scene.gt[i], scene.lambda_dssim)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(params, grads)}
        lr = scene.learning_rates(scene.start_step + t - 1)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                adam_step(p, g, *moments[k], t, lr[k])
        del bag, image, loss, grads
    change = {k: (params[k].detach() - init[k]) for k in params}
    return {"losses": losses, "first_grad": first, "change": change}
