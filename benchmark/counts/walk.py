"""Operations and bytes of the forward (B1) and backward (B2) composite
kernels on one view: every (pixel, pair) evaluation the kernels' walks make
on these inputs, by how far it gets, times the float operations of that
far. A frozen copy of `chip_smoke.py`'s FWD_FLOPS / BWD_FLOPS count and its
byte count, replayed over the benchmark's own projection and tight binning
(`reference.render.project`, `bin_tiles`), never over the program's pairs.

B1, every pair a pixel walks before it is done: dx, dy, power (11); where
power <= 0: exp, op*G, min (3); where also alpha >= 1/255: 1-alpha, T*() (2);
where the pair is composited: w = T*alpha and four accumulations (9).
B2, every pair of rank below the pixel's nc (the rank of its last
composited pair): dx, dy, power (11); where power <= 0: exp, op*G, min (3);
where the pair was composited: 1-alpha, T/(1-alpha), w (3), u (7),
dalpha (3), S += w u (2), the colour and depth terms (4), the ten terms' sum
over the tile (10), 29 in all; where also alpha_raw < 0.99: dpower (1), the
six geometry terms (17).
Bytes: each input read once and each output written once: B1 the pair list
(4 P), the tile ranges (8 T), ten attributes (40 N), five planes and nc out
(24 HW); B2 the same inputs, T_final, nc and five cotangent planes (28 HW)
and the (N, 10) gradients out (40 N).
"""
from __future__ import annotations

import torch

from ..reference.render import ALPHA_MAX, ALPHA_MIN, T_EPS, TILE, chunks, tile_pixels
from . import least_seconds

FWD_FLOPS = (11, 3, 2, 9)
BWD_FLOPS = (11, 3, 29, 18)


def _evaluate(proj, g, px, py):
    dx = proj["mean2d"][g, 0][..., None] - px[:, None, :]
    dy = proj["mean2d"][g, 1][..., None] - py[:, None, :]
    a, b, c = (proj["conic"][g, i][..., None] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha_raw = proj["opacity"][g][..., None] * torch.exp(power)
    return power, alpha_raw, torch.clamp_max(alpha_raw, ALPHA_MAX)


@torch.no_grad()
def walk_counts(proj: dict, bins: dict, height: int, width: int) -> dict:
    """The eight evaluation counts, each kernel's operations, bytes and least
    seconds, for one view of `proj` binned as `bins`."""
    dev = proj["depth"].device
    n_tiles = bins["n_tx"] * bins["n_ty"]
    px_all, py_all = tile_pixels(bins["order"], bins["n_tx"])
    inside = (px_all < width) & (py_all < height)
    t = torch.ones((n_tiles, TILE * TILE), device=dev)
    done = ~inside
    nc = torch.zeros((n_tiles, TILE * TILE), dtype=torch.long, device=dev)
    fwd = torch.zeros(4, dtype=torch.long, device=dev)
    for k0, k, n, g, valid in chunks(bins):
        power, _, alpha = _evaluate(proj, g, px_all[:n], py_all[:n])
        near = power <= 0
        hit = valid[..., None] & near & (alpha >= ALPHA_MIN)
        one_m = torch.where(hit, 1 - alpha, 1.0)
        term = hit & (t[:n, None, :] * torch.cumprod(one_m, dim=1) < T_EPS)
        before = torch.cumsum(term.to(torch.int32), dim=1) - term.to(torch.int32) > 0
        walked = valid[..., None] & ~(done[:n, None, :] | before)
        composited = walked & hit & ~term
        fwd += torch.stack([walked.sum(), (walked & near).sum(), (walked & hit).sum(),
                            composited.sum()])
        rank = k0 + 1 + torch.arange(k, device=dev)[None, :, None]
        nc[:n] = torch.maximum(nc[:n], torch.where(composited, rank, 0).amax(dim=1))
        t[:n] = t[:n] * torch.where(composited, one_m, 1.0).prod(dim=1)
        done[:n] = done[:n] | (walked & term).any(dim=1)
    bwd = torch.zeros(4, dtype=torch.long, device=dev)
    for k0, k, n, g, valid in chunks(bins):
        power, alpha_raw, alpha = _evaluate(proj, g, px_all[:n], py_all[:n])
        rank = k0 + torch.arange(k, device=dev)[None, :, None]
        below = valid[..., None] & (rank < nc[:n, None, :])
        near = below & (power <= 0)
        hit = near & (alpha >= ALPHA_MIN)
        bwd += torch.stack([below.sum(), near.sum(), hit.sum(), (hit & (alpha_raw < ALPHA_MAX)).sum()])
    f, b = fwd.tolist(), bwd.tolist()
    if b[2] != f[3]:
        raise RuntimeError(f"B2's inclusion rule disagrees with the forward walk: {f} {b}")
    n_pairs, n = int(bins["gaussian"].shape[0]), int(proj["depth"].shape[0])
    fwd_flops = sum(w * c for w, c in zip(FWD_FLOPS, f))
    bwd_flops = sum(w * c for w, c in zip(BWD_FLOPS, b))
    fwd_bytes = 4 * n_pairs + 8 * n_tiles + 40 * n + 24 * height * width
    bwd_bytes = 4 * n_pairs + 8 * n_tiles + 40 * n + 28 * height * width + 40 * n
    return {"evaluations": {"fwd": f, "bwd": b}, "pairs": n_pairs,
            "fwd": {"flops": fwd_flops, "bytes": fwd_bytes,
                    "least_s": least_seconds(fwd_flops, fwd_bytes)},
            "bwd": {"flops": bwd_flops, "bytes": bwd_bytes,
                    "least_s": least_seconds(bwd_flops, bwd_bytes)}}
