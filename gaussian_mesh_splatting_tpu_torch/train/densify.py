"""Adaptive density control on fixed-capacity buffers (port of
`gaussian_mesh_splatting_tpu/train/densify.py`).

The JAX package's contract, kept row for row: the params are C-row buffers
under an `alive` mask; one event clones, splits and prunes by *recompaction*.
Survivors keep their rows; the free rows (every other row, in row order) are
filled with the taken candidates in queue order: clones first, then split
samples (both samples of a row side by side), each by falling gradient;
candidates beyond the free rows are dropped and counted. Adam moments follow
their rows and start at zero on new rows; the statistics are zeroed.

  clone  : avg grad >= threshold and max scale <= percent_dense * extent
           -> the row is duplicated;
  split  : avg grad >= threshold and max scale >  percent_dense * extent
           -> n_split samples ~ N(xyz, Sigma), scale / (0.8 n_split), the
           original pruned;
  prune  : opacity < min_opacity, or (with size_threshold > 0) screen radius
           > threshold or world scale > 0.1 * extent;
  reset  : opacity <- min(opacity, 0.01), the opacity group's moments zeroed.

A row that dies keeps its params and moments (its source is its own row), so
it goes on moving under Adam's momentum; nothing cleans it, and the two
packages agree over the whole buffer, dead rows included.

In PyTorch's idiom the event works in place under `torch.no_grad()`: shapes
do not change, so the leaf params and the optimizer keep their identity.
Every sort is stable: ties are the normal case (every non-candidate ranks
inf), and an unstable sort would put other Gaussians in other rows.
`grow_capacity` does change shapes and so makes new leaves and a new Adam.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.transforms import inverse_sigmoid, quat_to_rotmat
from ..models.vanilla import pad_rows
from .state import DensifyStats, TrainState, optimizer_like

_MOMENTS = ("exp_avg", "exp_avg_sq")


def _row_moments(state: TrainState, capacity: int):
    """Every Adam moment tensor with one row per Gaussian. A param that has
    taken no optimizer step yet has none."""
    for p in state.params.values():
        moments = state.optimizer.state.get(p, {})
        for name in _MOMENTS:
            if name in moments and moments[name].shape[0] == capacity:
                yield moments[name]


def _f32_product(a: float, b: float) -> float:
    """a * b in float32: the size thresholds are float32 products in the JAX
    package, and a float64 product could flip a row that sits on one."""
    return float(np.float32(a) * np.float32(b))


@torch.no_grad()
def densify_and_prune(
    state: TrainState,
    *,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    percent_dense: float,
    size_threshold: float,  # 0 disables screen/world-size pruning
    scaling_cols: int,  # 3 for gs, 2 for gs_flat
    n_split: int = 2,
    generator: torch.Generator | None = None,
    noise=None,
) -> tuple[TrainState, dict]:
    """One density-control event, in place. Returns (state, info counts as
    0-d tensors on the state's device: n_clone, n_split_rows, n_pruned,
    n_alive, overflow, n_pruned_opacity, n_pruned_screen, n_pruned_world).

    The split samples' standard-normal noise (n_split, C, 3) is `noise`
    (array or tensor) where given, else drawn from `generator`, which must
    live on the state's device. A CPU and a CUDA generator give different
    streams from one seed, and neither gives `jax.random.normal`'s."""
    p = state.params
    alive = state.alive
    capacity = alive.shape[0]
    dev = alive.device
    stats = state.stats

    grads = stats.grad_accum / torch.clamp_min(stats.denom, 1.0)
    grads = torch.where(torch.isnan(grads), 0.0, grads)

    scaling_act = torch.exp(p["scaling"])  # (C, scaling_cols)
    max_scale = scaling_act.amax(dim=-1)
    opacity_act = torch.sigmoid(p["opacity"][:, 0])

    opacity_prune = alive & (opacity_act < min_opacity)
    size_on = size_threshold > 0
    big_vs = stats.max_radii > size_threshold
    big_ws = max_scale > _f32_product(0.1, extent)
    prune_mask = opacity_prune | (alive & (big_vs | big_ws)) if size_on else opacity_prune

    # only opacity-pruned rows are kept from densifying: their children would
    # inherit the disqualifying opacity. Size-pruned rows still densify (their
    # split children carry scale / 1.6 and zeroed statistics); keeping them
    # out let an 800x800 scene die out after the first opacity reset
    dense_limit = _f32_product(percent_dense, extent)
    hot = alive & (grads >= grad_threshold) & ~opacity_prune
    clone_mask = hot & (max_scale <= dense_limit)
    split_mask = hot & (max_scale > dense_limit)

    survivors = alive & ~prune_mask & ~split_mask
    n_surv = survivors.sum()
    free = capacity - n_surv

    # rank: candidates first, higher gradient first; everything else ties at inf
    clone_rank = torch.where(clone_mask, -grads, torch.inf)
    split_rank = torch.where(split_mask, -grads, torch.inf)

    # split sample geometry: x = mean + R @ eps, eps ~ N(0, diag(scale)); the
    # product is summed elementwise (no matrix product: no TF32 on the card)
    full_scaling = scaling_act
    if scaling_cols == 2:  # the flat model's frozen first axis
        full_scaling = torch.cat(
            [torch.full((capacity, 1), 1e-8, dtype=torch.float32, device=dev), scaling_act], dim=1)
    if noise is None:
        noise = torch.randn((n_split, capacity, 3), generator=generator, device=dev,
                            dtype=torch.float32)
    else:
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        if tuple(noise.shape) != (n_split, capacity, 3):
            raise ValueError(f"noise must be {(n_split, capacity, 3)}, got {tuple(noise.shape)}")
    noise = noise * full_scaling[None]
    R = quat_to_rotmat(p["rotation"])
    split_xyz = p["xyz"][None] + torch.sum(R[None] * noise[:, :, None, :], dim=-1)
    split_scaling_raw = torch.log(torch.clamp_min(scaling_act / (0.8 * n_split), 1e-30))

    # ---- the candidate queue: clones by rank, then split samples by rank, the
    # samples of one row side by side (flat index m -> sample m % n_split of
    # source m // n_split); clones take the free rows first
    clone_src = torch.argsort(clone_rank, stable=True)
    split_order = torch.argsort(split_rank, stable=True)
    n_clone = clone_mask.sum()
    n_split_rows = split_mask.sum() * n_split
    clone_budget = torch.minimum(n_clone, free)
    split_budget = torch.clamp_min(free - clone_budget, 0)

    ci = torch.arange(capacity, device=dev)
    m = torch.arange(n_split * capacity, device=dev)
    split_src = split_order[m // n_split]
    clone_taken = (ci < clone_budget) & (clone_rank[clone_src] < torch.inf)
    split_taken = (m < split_budget) & (split_rank[split_src] < torch.inf)

    cand_src = torch.cat([clone_src, split_src])
    cand_taken = torch.cat([clone_taken, split_taken])
    cand_is_split = torch.cat([torch.zeros_like(clone_taken), torch.ones_like(split_taken)])
    cand_k = torch.cat([torch.zeros_like(clone_src), m % n_split])
    # taken candidates first, in queue order; at most C can be placed
    queue = torch.argsort((~cand_taken).to(torch.uint8), stable=True)[:capacity]
    fill_src, fill_taken = cand_src[queue], cand_taken[queue]
    fill_is_split, fill_k = cand_is_split[queue], cand_k[queue]

    # ---- destinations: the free rows in row order come first in this stable
    # sort; the i-th of them takes the i-th queue entry, if that one is taken
    fill_pos = torch.argsort(survivors.to(torch.uint8), stable=True)
    really_fill = (ci < free) & fill_taken

    src = ci.clone()  # default: a row keeps its own values, dead or alive
    src[fill_pos] = torch.where(really_fill, fill_src, fill_pos)
    is_new = torch.zeros_like(alive)
    is_new[fill_pos] = really_fill
    new_alive = survivors | is_new
    took_split = torch.zeros_like(alive)
    took_split[fill_pos] = really_fill & fill_is_split
    sample_k = torch.zeros_like(ci)
    sample_k[fill_pos] = torch.where(really_fill, fill_k, 0)

    # ---- params: rows gathered in place, split-born rows get their sample
    born_xyz = split_xyz[sample_k, src]
    born_scaling = split_scaling_raw[src]
    for leaf in p.values():
        if leaf.shape[0] == capacity:
            leaf.copy_(leaf[src])
    p["xyz"].copy_(torch.where(took_split[:, None], born_xyz, p["xyz"]))
    p["scaling"].copy_(torch.where(took_split[:, None], born_scaling, p["scaling"]))

    # ---- Adam moments follow their rows; new rows start at zero ("step" stays)
    for moment in _row_moments(state, capacity):
        gathered = moment[src]
        gathered[is_new] = 0.0
        moment.copy_(gathered)

    info = {
        "n_clone": torch.minimum(n_clone, clone_budget),
        "n_split_rows": torch.minimum(n_split_rows, split_budget),
        "n_pruned": (alive & (prune_mask | split_mask)).sum(),
        "n_alive": new_alive.sum(),
        "overflow": torch.clamp_min(n_clone + n_split_rows - free, 0),
        # the prune reasons apart: a die-out after an opacity reset looks like
        # healthy cleanup in n_pruned alone
        "n_pruned_opacity": opacity_prune.sum(),
        "n_pruned_screen": (alive & big_vs).sum() if size_on else torch.zeros_like(n_clone),
        "n_pruned_world": (alive & big_ws).sum() if size_on else torch.zeros_like(n_clone),
    }
    state.alive = new_alive
    state.stats = DensifyStats.zeros(capacity, device=dev)
    return state, info


@torch.no_grad()
def reset_opacity(state: TrainState) -> TrainState:
    """opacity <- min(opacity, 0.01), in place, with the opacity group's two
    Adam moments zeroed (where it has taken a step; its "step" stays)."""
    opacity = state.params["opacity"]
    opacity.copy_(inverse_sigmoid(torch.clamp_max(torch.sigmoid(opacity), 0.01)))
    moments = state.optimizer.state.get(opacity, {})
    for name in _MOMENTS:
        if name in moments:
            moments[name].zero_()
    return state


@torch.no_grad()
def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Enlarge the buffers to `new_capacity` rows: new leaf params (old rows,
    then dead rows padded as `models.vanilla.pad_rows` pads them), a new Adam
    with the old groups' settings, each group's moments padded with zeros
    and its "step" carried over, `alive` and the statistics padded."""
    capacity = state.alive.shape[0]
    if new_capacity <= capacity:
        raise ValueError(f"new_capacity {new_capacity} must exceed the capacity {capacity}")
    pad = new_capacity - capacity

    def padded(x):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], dim=0)

    old_params, old_optimizer = state.params, state.optimizer
    rows = {k: v.detach() for k, v in old_params.items() if v.shape[0] == capacity}
    rows, alive = pad_rows(rows, state.alive, new_capacity)
    params = {k: rows.get(k, v.detach().clone()).requires_grad_(True)
              for k, v in old_params.items()}
    optimizer = optimizer_like(old_optimizer, params)
    for key, new_p in params.items():
        moments = old_optimizer.state.get(old_params[key], {})
        if moments:
            optimizer.state[new_p] = {
                name: padded(t) if name in _MOMENTS and t.shape[0] == capacity else t.clone()
                for name, t in moments.items()}
    state.params, state.optimizer, state.alive = params, optimizer, alive
    state.stats = DensifyStats(grad_accum=padded(state.stats.grad_accum),
                               denom=padded(state.stats.denom),
                               max_radii=padded(state.stats.max_radii))
    return state
