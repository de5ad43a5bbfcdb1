"""Faults planted in the program under test, for the checks that `correct`
must catch (the CPU tests and `control.py`): each a context manager that
breaks the timed path underneath the harness and restores it on exit."""
from __future__ import annotations

import contextlib

import torch

from . import program


@contextlib.contextmanager
def state_unchanged():
    """Every training step returns its state unchanged: the optimizer's
    update is skipped."""
    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


@contextlib.contextmanager
def half_batch():
    """The loss leaves out half of the step's batch (the lower half of the
    image's rows) and takes the mean over the rest."""
    loop = program.train_loop
    loss = loop.photometric_loss

    def halved(pred, gt, lambda_dssim=0.2):
        rows = pred.shape[0] // 2
        return loss(pred[:rows], gt[:rows], lambda_dssim)

    loop.photometric_loss = halved
    try:
        yield
    finally:
        loop.photometric_loss = loss


@contextlib.contextmanager
def answer_altered():
    """Each rendered view comes out with the 16x16 tile at its centre
    inverted (x -> 1 - x), where the renderer produces it."""
    view = program.Renderer.view

    def altered(self, i):
        image = view(self, i).clone()
        h, w = image.shape[0] // 2, image.shape[1] // 2
        image[h - 8:h + 8, w - 8:w + 8] = 1.0 - image[h - 8:h + 8, w - 8:w + 8]
        return image

    program.Renderer.view = altered
    try:
        yield
    finally:
        program.Renderer.view = view


@contextlib.contextmanager
def densify_skipped():
    """Each density-control event returns the state as it found it, with the
    counts of the event that it did not keep."""
    densify = program.densify_and_prune

    def skipped(state, **kwargs):
        kept = program.snapshot(state)
        state, info = densify(state, **kwargs)
        dev = state.alive.device
        with torch.no_grad():
            for g in state.optimizer.param_groups:
                p = g["params"][0]
                p.copy_(kept["params"][g["name"]].to(dev))
                for name, m in kept["moments"].get(g["name"], {}).items():
                    state.optimizer.state[p][name].copy_(m.to(dev))
        state.alive = kept["alive"].to(dev)
        for name, v in kept["stats"].items():
            setattr(state.stats, name, v.to(dev))
        return state, info

    program.densify_and_prune = skipped
    try:
        yield
    finally:
        program.densify_and_prune = densify


@contextlib.contextmanager
def split_unsampled():
    """Each density-control event places its split samples at their
    parent's centre: the split noise zeroed."""
    densify = program.densify_and_prune

    def unsampled(state, *, n_split=2, generator=None, noise=None, **kwargs):
        zeros = torch.zeros((n_split, state.alive.shape[0], 3), device=state.alive.device)
        return densify(state, n_split=n_split, noise=zeros, **kwargs)

    program.densify_and_prune = unsampled
    try:
        yield
    finally:
        program.densify_and_prune = densify


PRECISION_CONTROL = {"attr_precision": "bf16", "grad_precision": "bf16"}
FAULTS = {"unchanged": state_unchanged, "half": half_batch, "answer": answer_altered,
          "densify_skipped": densify_skipped, "split_unsampled": split_unsampled}
