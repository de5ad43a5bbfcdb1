"""One density-control event of 3D Gaussian Splatting (Kerbl et al., ACM TOG
42(4), 2023, arXiv 2308.04079, section 5.2, and its code's
`densify_and_prune` and `reset_opacity`), in plain PyTorch at float32,
written from the contract of the program's event with explicit index
lists. It replays one event on a copy of the state before it.

  clone : average screen gradient >= threshold, largest scale <=
          percent_dense * extent -> one copy of the row;
  split : average screen gradient >= threshold, largest scale >
          percent_dense * extent -> n_split samples x = xyz + R (eps * s),
          eps ~ N(0, 1), at scale s / (0.8 n_split); the row itself dies;
  prune : opacity < min_opacity, or (where size_threshold > 0) largest
          screen radius > size_threshold or largest scale > 0.1 * extent;
  reset : opacity <- min(opacity, 0.01), its Adam moments zeroed.

Where the contract departs from the paper's code:
- A fixed capacity. The Gaussians live in C rows under an `alive` mask,
  and rows never move: a survivor keeps its row; the new Gaussians take
  the free rows (every row that is not a survivor, in row order) in queue
  order: the clones by falling gradient, then the split samples by falling
  gradient, the samples of one row side by side. What finds no free row is
  dropped and counted (`overflow`). The paper's arrays grow without bound
  and are compacted.
- A row that dies keeps its parameters and moments: nothing clears it. The
  opacity reset acts on every row, dead ones included.
- The masks are taken on the rows before the event: a new row is never
  pruned in the event that made it (the code prunes clones and samples
  below the opacity in the same call), and a row pruned for its opacity
  does not densify; a row pruned for its size still does.
- The size thresholds 0.1 * extent and percent_dense * extent are float32
  products.
- A flat Gaussian (2 scale columns) samples its split children with a
  first axis of 1e-8, its frozen one.
- The statistics are zeroed over every row; the new rows' moments start at
  zero, every other row keeps its own.
"""
from __future__ import annotations

import torch

def _f32(a: float, b: float) -> float:
    """a * b in float32."""
    return float(torch.tensor(a, dtype=torch.float32) * torch.tensor(b, dtype=torch.float32))


def _rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) quaternions (w, x, y, z), normalised here -> (N, 3, 3)."""
    w, x, y, z = (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       dim=-1).reshape(q.shape[0], 3, 3)


def _by_falling_gradient(mask: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """The rows of `mask`, by falling gradient, ties in row order."""
    rows = torch.nonzero(mask).flatten()
    return rows[torch.sort(grads[rows], descending=True, stable=True).indices]


def densify(state: dict, *, grad_threshold: float, min_opacity: float, extent: float,
            percent_dense: float, size_threshold: float, scaling_cols: int, n_split: int,
            noise: torch.Tensor) -> dict:
    """Clone, split and prune on `state` ("params", "alive", "stats",
    "moments": each parameter's "exp_avg" and "exp_avg_sq"); sample k of
    split row i draws noise[k, i] of `noise` (n_split, C, 3). A new state
    and its "counts"."""
    p, alive, stats = state["params"], state["alive"], state["stats"]
    capacity = alive.shape[0]
    grads = stats["grad_accum"] / torch.clamp(stats["denom"], min=1.0)
    grads[grads.isnan()] = 0.0
    scale = torch.exp(p["scaling"])
    max_scale = scale.max(dim=1).values
    opacity = torch.sigmoid(p["opacity"][:, 0])

    low = alive & (opacity < min_opacity)
    size_on = size_threshold > 0
    big_screen = alive & (stats["max_radii"] > size_threshold)
    big_world = alive & (max_scale > _f32(0.1, extent))
    pruned = low | big_screen | big_world if size_on else low
    hot = alive & (grads >= grad_threshold) & ~low
    dense = _f32(percent_dense, extent)
    clone, split = hot & (max_scale <= dense), hot & (max_scale > dense)
    survivors = alive & ~pruned & ~split

    free = torch.nonzero(~survivors).flatten()
    clone_rows = _by_falling_gradient(clone, grads)
    split_rows = _by_falling_gradient(split, grads).repeat_interleave(n_split)
    split_k = torch.arange(len(split_rows), device=alive.device) % n_split
    queue = torch.cat([clone_rows, split_rows])
    placed = min(len(queue), len(free))
    dest, src = free[:placed], queue[:placed]
    n_clones = min(len(clone_rows), placed)
    samples_dest, samples_src = dest[n_clones:], src[n_clones:]
    samples_k = split_k[:placed - n_clones]

    params = {}
    for key, leaf in p.items():
        leaf = leaf.clone()
        if leaf.shape[0] == capacity:
            leaf[dest] = p[key][src]
        params[key] = leaf
    full_scale = scale if scaling_cols == 3 else torch.cat(
        [torch.full_like(scale[:, :1], 1e-8), scale], dim=1)
    eps = noise[samples_k, samples_src] * full_scale[samples_src]
    offset = torch.bmm(_rotation(p["rotation"][samples_src]), eps[:, :, None])[:, :, 0]
    params["xyz"][samples_dest] = p["xyz"][samples_src] + offset
    params["scaling"][samples_dest] = torch.log(scale[samples_src] / (0.8 * n_split))

    moments = {}
    for key, pair in state["moments"].items():
        moments[key] = {}
        for name, m in pair.items():
            m = m.clone()
            if m.shape[0] == capacity:
                m[dest] = 0.0
            moments[key][name] = m

    new_alive = survivors.clone()
    new_alive[dest] = True
    counts = {"n_clone": n_clones, "n_split_rows": placed - n_clones,
              "n_pruned": int((alive & (pruned | split)).sum()), "n_alive": int(new_alive.sum()),
              "overflow": max(len(queue) - len(free), 0), "n_pruned_opacity": int(low.sum()),
              "n_pruned_screen": int(big_screen.sum()) if size_on else 0,
              "n_pruned_world": int(big_world.sum()) if size_on else 0}
    return {"params": params, "alive": new_alive, "moments": moments,
            "stats": {k: torch.zeros_like(v) for k, v in stats.items()}, "counts": counts}


def reset_opacity(state: dict) -> dict:
    """opacity <- logit(min(sigmoid(opacity), 0.01)) on every row, the
    opacity's moments zeroed; the counts gain "opacity_reset" 1."""
    o = torch.clamp(torch.sigmoid(state["params"]["opacity"]), max=0.01)
    params = dict(state["params"], opacity=torch.log(o / (1 - o)))
    moments = dict(state["moments"])
    if "opacity" in moments:
        moments["opacity"] = {k: torch.zeros_like(v) for k, v in moments["opacity"].items()}
    return dict(state, params=params, moments=moments,
                counts=dict(state.get("counts", {}), opacity_reset=1))


def density_event(state: dict, plan: dict, noise: torch.Tensor | None) -> dict:
    """The event that `plan` names on `state`: `densify(**plan["densify"])`
    where that is not None, then `reset_opacity` where `plan["reset"]`. The
    state after it, with the "counts" of what ran."""
    out = dict(state, counts={})
    if plan["densify"] is not None:
        out = densify(out, **plan["densify"], noise=noise)
    if plan["reset"]:
        out = reset_opacity(out)
    return out
