"""The collectives of the parallel modes, on `torch.distributed` process
groups: the gather that assembles a render from its portions (with the
gradient rule of a replicated loss) and one all-reduce over many tensors."""
from __future__ import annotations

import torch
import torch.distributed as dist


class _GatherPortions(torch.autograd.Function):
    """Forward: every rank's portion, stacked in group-rank order. Backward:
    the cotangent of this rank's own portion, with no collective.

    Every rank computes the same loss on the gathered result, so the
    cotangent that reaches each rank is the single loss's cotangent of the
    whole; the rank's share of it is its own portion's slice. (Summing the
    ranks' cotangents instead, as the all_gather of
    `torch.distributed.nn` does, would count the loss once per rank.) The
    gradient of a replicated input is then the SUM over the group of the
    ranks' gradients: `all_reduce_flat`."""

    @staticmethod
    def forward(ctx, part, group):
        parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, part.contiguous(), group=group)
        ctx.index = dist.get_rank(group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.index], None


def gather_portions(part: torch.Tensor, group) -> torch.Tensor:
    """(D, *part.shape): the portions of the D ranks of `group`, stacked;
    differentiable (see `_GatherPortions`)."""
    return _GatherPortions.apply(part, group)


@torch.no_grad()
def all_gather_stacked(t: torch.Tensor, group) -> torch.Tensor:
    """(D, *t.shape): every rank's `t`, stacked in group-rank order; no
    gradient."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


@torch.no_grad()
def all_reduce_flat(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The SUM over `group` of each tensor (one dtype, one device), as ONE
    all-reduce of their concatenation; returns new tensors of the inputs'
    shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                               tensors)]
