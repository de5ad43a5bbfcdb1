"""3D Gaussian splatting of a bag through one view, in plain PyTorch:

  * projection: view z, the pixel centre ((ndc + 1) * size - 1) / 2, the
    covariance R S S^T R^T, its EWA image with the view's x/y clamped to
    1.3 times the frustum tangents and 0.3 px^2 of dilation, the conic;
    culled at view z <= 0.2 or a determinant <= 0;
  * colour: real spherical harmonics up to degree 3 at the direction from
    the camera centre, + 0.5, clamped at 0;
  * tight binning: 16x16 tiles, each Gaussian binned over the per-axis extent
    of its alpha >= 1/255 ellipse inside the 3-sigma circle, + 1 px, pairs
    ordered by tile and then by depth (stable);
  * the composite: per pixel front to back, alpha = min(0.99, o exp(power)),
    skipped where power > 0 or alpha < 1/255, stopping before the pair that
    would bring T under 1e-4; image = C + T bg.

The composite runs on chunks of every tile's pair list (the tiles that
still have pairs, K ranks at a time), each chunk under a checkpoint, so that
autograd holds one carry per chunk and not a tensor per pair.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .camera import View

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR = 0.2
DILATION = 0.3
CHUNK_ELEMENTS = 1 << 24  # (tile, rank, pixel) evaluations per chunk

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """(N, 3) unit directions -> (N, (degree + 1)^2) basis values."""
    x, y, z = d.unbind(-1)
    out = [torch.full_like(x, SH_C0)]
    if degree > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * xz,
                SH_C2[4] * (xx - yy)]
    if degree > 2:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
                SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def project(bag: dict, view: View, sh_degree: int = 3) -> dict:
    """Screen-space attributes of every Gaussian of the bag."""
    n = bag["xyz"].shape[0]
    hom = torch.cat([bag["xyz"], bag["xyz"].new_ones(n, 1)], dim=1)
    p_view = hom @ view.world_view.T
    clip = hom @ view.full_proj.T
    w = 1.0 / (clip[:, 3] + 1e-7)
    mean2d = torch.stack([((clip[:, 0] * w + 1) * view.width - 1) * 0.5,
                          ((clip[:, 1] * w + 1) * view.height - 1) * 0.5], dim=1)
    depth = p_view[:, 2]

    m = bag["rot"] * bag["scale"][:, None, :]
    cov3 = m @ m.transpose(1, 2)
    tz = torch.where(depth.abs() < 1e-6, 1e-6, depth)
    lx, ly = 1.3 * view.tan_x, 1.3 * view.tan_y
    tx = torch.clamp(p_view[:, 0] / tz, -lx, lx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -ly, ly) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([torch.stack([view.focal_x / tz, zero, -view.focal_x * tx / (tz * tz)], 1),
                       torch.stack([zero, view.focal_y / tz, -view.focal_y * ty / (tz * tz)], 1)], 1)
    t = jac @ view.world_view[:3, :3]  # (N, 2, 3)
    cov2 = t @ cov3 @ t.transpose(1, 2)
    a, b, c = cov2[:, 0, 0] + DILATION, cov2[:, 0, 1], cov2[:, 1, 1] + DILATION
    det = a * c - b * b
    ok = det > 0
    inv = 1.0 / torch.where(ok, det, 1.0)
    conic = torch.stack([c * inv, -b * inv, a * inv], dim=1)

    opacity = bag["opacity"]
    with torch.no_grad():
        mid = 0.5 * (a + c)
        sigma = torch.sqrt(torch.clamp_min(mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1)), 0))
        lim = torch.clamp_min(2.0 * torch.log(torch.clamp_min(255.0 * opacity, 1e-12)), 0)
        rx = torch.ceil(torch.minimum(torch.sqrt(lim * torch.clamp_min(a, 0)), 3 * sigma)) + 1
        ry = torch.ceil(torch.minimum(torch.sqrt(lim * torch.clamp_min(c, 0)), 3 * sigma)) + 1
        valid = (depth > NEAR) & ok & (opacity * 255.0 > 1.0)

    k = (sh_degree + 1) ** 2
    d = bag["xyz"] - view.center
    d = d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-12)
    rgb = torch.einsum("nk,nkc->nc", sh_basis(d, sh_degree), bag["sh"][:, :k]) + 0.5
    return {"mean2d": mean2d, "conic": conic, "opacity": opacity, "color": torch.clamp_min(rgb, 0),
            "depth": depth, "rx": torch.where(valid, rx, 0), "ry": torch.where(valid, ry, 0),
            "valid": valid}


@torch.no_grad()
def bin_tiles(proj: dict, height: int, width: int) -> dict:
    """Pairs (tile, Gaussian), by tile and front to back within a tile, and
    the tiles by falling pair count (`order`), with their starts and counts
    in that order."""
    n_tx, n_ty = -(-width // TILE), -(-height // TILE)
    dev = proj["depth"].device
    valid = proj["valid"]
    order = torch.argsort(torch.where(valid, proj["depth"], torch.inf), stable=True)
    mx, my = proj["mean2d"][order, 0], proj["mean2d"][order, 1]
    rx, ry = proj["rx"][order], proj["ry"][order]
    x0 = torch.clamp(torch.floor((mx - rx) / TILE), 0, n_tx).long()
    x1 = torch.clamp(torch.floor((mx + rx + TILE - 1) / TILE), 0, n_tx).long()
    y0 = torch.clamp(torch.floor((my - ry) / TILE), 0, n_ty).long()
    y1 = torch.clamp(torch.floor((my + ry + TILE - 1) / TILE), 0, n_ty).long()
    sx = torch.clamp_min(x1 - x0, 0)
    span = torch.where(valid[order] & (rx > 0) & (ry > 0), sx * torch.clamp_min(y1 - y0, 0), 0)
    total = int(span.sum())
    rank = torch.repeat_interleave(torch.arange(order.shape[0], device=dev), span,
                                   output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(span, 0) - span)[rank]
    tile = (y0[rank] + local // sx[rank]) * n_tx + x0[rank] + local % sx[rank]
    key, _ = torch.sort(tile * order.shape[0] + rank)
    tile, rank = key // order.shape[0], key % order.shape[0]
    count = torch.bincount(tile, minlength=n_tx * n_ty)
    start = torch.cumsum(count, 0) - count
    tiles = torch.argsort(count, descending=True, stable=True)
    return {"gaussian": order[rank], "order": tiles, "start": start[tiles], "count": count[tiles],
            "n_tx": n_tx, "n_ty": n_ty}


def chunks(bins: dict, elements: int = CHUNK_ELEMENTS):
    """(k0, K, n_active, gaussian ids (n_active, K), valid (n_active, K)) over
    the ranks of every tile's list: the tiles with more than k0 pairs are the
    first n_active in `order`."""
    counts = bins["count"].tolist()
    if not counts or counts[0] == 0:
        return
    dev = bins["count"].device
    n_pairs = bins["gaussian"].shape[0]
    k0, n_active = 0, len(counts)
    while k0 < counts[0]:
        while counts[n_active - 1] <= k0:
            n_active -= 1
        k = 1 << max(3, min(12, int(math.log2(max(1, elements // (n_active * TILE * TILE))))))
        ranks = k0 + torch.arange(k, device=dev)
        valid = ranks[None, :] < bins["count"][:n_active, None]
        idx = torch.clamp_max(bins["start"][:n_active, None] + ranks[None, :], n_pairs - 1)
        yield k0, k, n_active, bins["gaussian"][idx], valid
        k0 += k


def tile_pixels(tiles: torch.Tensor, n_tx: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, 256) float pixel coordinates of tiles, row-major in the tile."""
    lin = torch.arange(TILE * TILE, device=tiles.device)
    px = (tiles % n_tx)[:, None] * TILE + lin % TILE
    py = (tiles // n_tx)[:, None] * TILE + lin // TILE
    return px.float(), py.float()


def _chunk(t, c, done, mx, my, ca, cb, cc, op, col, valid, px, py):
    dx = mx[..., None] - px[:, None, :]
    dy = my[..., None] - py[:, None, :]
    power = -0.5 * (ca[..., None] * dx * dx + cc[..., None] * dy * dy) - cb[..., None] * dx * dy
    alpha = torch.clamp_max(op[..., None] * torch.exp(power), ALPHA_MAX)
    contrib = valid[..., None] & (power <= 0) & (alpha >= ALPHA_MIN)
    one_m = torch.where(contrib, 1 - alpha, 1.0)
    after = torch.cumprod(one_m, dim=1)
    with torch.no_grad():
        term = contrib & (t[:, None, :] * after < T_EPS)
        stopped = torch.cumsum(term.to(torch.int32), dim=1) > 0  # the terminator and after it
        include = contrib & ~stopped & ~done[:, None, :]
    before = t[:, None, :] * torch.cat([torch.ones_like(after[:, :1]), after[:, :-1]], dim=1)
    w = torch.where(include, before * alpha, 0.0)
    c = c + torch.einsum("akp,akc->apc", w, col)
    t = t * torch.where(include, one_m, 1.0).prod(dim=1)
    return t, c, done | stopped[:, -1]


def composite(proj: dict, bins: dict, height: int, width: int, bg: torch.Tensor,
              elements: int = CHUNK_ELEMENTS) -> torch.Tensor:
    """The (H, W, 3) image over `bg`; differentiable in the projected
    attributes. `elements` sizes the chunks (it changes no result)."""
    dev = proj["depth"].device
    n_tiles = bins["n_tx"] * bins["n_ty"]
    t = torch.ones((n_tiles, TILE * TILE), device=dev)
    c = torch.zeros((n_tiles, TILE * TILE, 3), device=dev)
    done = torch.zeros((n_tiles, TILE * TILE), dtype=torch.bool, device=dev)
    px_all, py_all = tile_pixels(bins["order"], bins["n_tx"])
    mean2d, conic = proj["mean2d"], proj["conic"]
    finished_t, finished_c = [], []
    for _, _, n_active, g, valid in chunks(bins, elements):
        if n_active < t.shape[0]:  # tiles whose lists have ended keep their carry
            finished_t.append(t[n_active:])
            finished_c.append(c[n_active:])
            t, c, done = t[:n_active], c[:n_active], done[:n_active]
        args = (t, c, done, mean2d[g, 0], mean2d[g, 1], conic[g, 0], conic[g, 1], conic[g, 2],
                proj["opacity"][g], proj["color"][g], valid, px_all[:n_active], py_all[:n_active])
        if torch.is_grad_enabled():
            t, c, done = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            t, c, done = _chunk(*args)
    t = torch.cat([t, *reversed(finished_t)])
    c = torch.cat([c, *reversed(finished_c)])
    inverse = torch.argsort(bins["order"])
    rgb = c[inverse] + t[inverse][..., None] * bg
    img = rgb.reshape(bins["n_ty"], bins["n_tx"], TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(bins["n_ty"] * TILE, bins["n_tx"] * TILE, 3)[:height, :width]


def render(bag: dict, view: View, bg: torch.Tensor, sh_degree: int = 3) -> torch.Tensor:
    proj = project(bag, view, sh_degree)
    return composite(proj, bin_tiles(proj, view.height, view.width), view.height, view.width, bg)
