"""Tile rasterizer with hand-written CUDA composites: the port's fast path
(counterpart of `gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py`).

  preprocess (torch)           project / cull / conic / SH, ops/projection.py
  bin_gaussians (torch)        depth-ordered per-tile pair lists, ops/binning.py
  pack_attributes (torch)      the ten per-Gaussian attributes as one (N, 12)
                               float32 table: a row is three 16-byte words
                               (pack_attributes_bf16: (N, 16) bfloat16, two)
  composite (CUDA kernels)     forward: per-tile front-to-back composite,
                               csrc/composite_fwd.cu; backward: per-tile
                               back-to-front re-walk into per-Gaussian
                               gradients, csrc/composite_bwd.cu; both take
                               the tiles in the binning's `tile_order`
  background + outputs (torch) image = rgb + T * bg

One `torch.autograd.Function` (`_Composite`) joins the two: its forward is
the forward kernel and its backward the backward kernel. For CPU tensors the
same Function runs the plain PyTorch versions `composite_fwd_plain` and
`composite_bwd_plain`, so the CPU tests go through the same autograd wiring
as the card. It never falls back from one to the other: a CUDA tensor gets
the kernel or an exception. Tiles are 16x16 pixels. `radius_mode` picks
the binning rectangles (`preprocess`): "tight" (the default, as in the JAX
package) bins the per-axis extents of each Gaussian's alpha >= 1/255
ellipse, "cuda" the reference rasterizer's 3-sigma square. The pairs only
"cuda" bins composite nothing; where the square's tile rect stops a pixel
short of a Gaussian of opacity above ~0.35, "tight" mode's +1 px bins a
tile that composites there, so the images differ at such pixels (in the
JAX package alike).

Precision (the JAX rasterizer's two options, default "f32" here):
`attr_precision="bf16"` stores the table in the JAX package's split bf16
layout (`pack_attributes_bf16`: exact hi/lo pairs for mean2d, conic and
opacity, plain bf16 colour and depth); the kernels reconstruct the float32
values that `round_attributes` returns, so the forward equals the exact
forward on those values. `grad_precision="bf16"` rounds each (Gaussian,
tile) pair's gradient to bf16 before the per-Gaussian sum; under
`attr_precision="bf16"` that rounding always happens (the JAX kernel writes
its per-pair table in bf16) and the per-Gaussian sums are rounded to bf16
too. The JAX package defaults to both ("bf16", a TPU speed choice); the port
keeps the exact mode, which its strict checks hold.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ..core.camera import Camera
from ..utils import profiling
from . import cuda_build
from .binning import Binning, bin_gaussians
from .projection import preprocess
from .rasterize_reference import ALPHA_MAX, ALPHA_MIN, T_EPS, RenderOutput

TILE = 16  # the kernels' tile edge (one block of TILE*TILE threads per tile)
N_PLANES = 5  # r, g, b, T_final, depth
GRAD_COLS = 10  # per-Gaussian gradient columns: mx, my, a, b, c, op, r, g, b, z
ROW = 12  # floats per packed row (attributes in, gradients out): GRAD_COLS + 2 of padding
BF16_ROW = 16  # bf16 per row of the split table (JAX ATTR_COLS): six hi/lo pairs + r, g, b, z
PRECISIONS = ("f32", "bf16")


def _tile_grid(height: int, width: int) -> tuple[int, int]:
    return -(-height // TILE), -(-width // TILE)


def _tile_pixels(n_tiles_x: int, n_tiles: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinates (n_tiles, TILE*TILE) float32 of each tile's threads."""
    lin = torch.arange(TILE * TILE, device=dev)
    tiles = torch.arange(n_tiles, device=dev)
    px = ((tiles % n_tiles_x)[:, None] * TILE + (lin % TILE)[None, :]).to(torch.float32)
    py = ((tiles // n_tiles_x)[:, None] * TILE + (lin // TILE)[None, :]).to(torch.float32)
    return px, py


def pack_attributes(mean2d: torch.Tensor, conic: torch.Tensor, opacity: torch.Tensor,
                    color: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """The kernels' input table (N, ROW) float32: columns mx, my, a, b, c, op,
    r, g, b, z and two of zero padding, so that a Gaussian's row is 48 bytes
    (three 16-byte words) at a 16-byte-aligned offset."""
    n = mean2d.shape[0]
    pad = torch.zeros((n, ROW - GRAD_COLS), dtype=mean2d.dtype, device=mean2d.device)
    return torch.cat([mean2d, conic, opacity[:, None], color, depth[:, None], pad], dim=1)


def pack_attributes_bf16(mean2d: torch.Tensor, conic: torch.Tensor, opacity: torch.Tensor,
                         color: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """The kernels' input table under attr_precision="bf16": (N, BF16_ROW)
    bfloat16 in the JAX rasterizer's split layout (its
    `rasterize_pallas` attr_split rows), columns mx_hi, mx_lo, my_hi, my_lo,
    a_hi, a_lo, b_hi, b_lo, c_hi, c_lo, op_hi, op_lo, r, g, b, z with hi =
    bf16(x) and lo = bf16(x - f32(hi)), both rounded to nearest even: a row
    is 32 bytes (two 16-byte words) at a 16-byte-aligned offset."""
    n = mean2d.shape[0]
    base = torch.cat([mean2d, conic, opacity[:, None]], dim=1)  # (N, 6) float32
    hi = base.to(torch.bfloat16)
    lo = (base - hi.float()).to(torch.bfloat16)
    split = torch.stack([hi, lo], dim=2).reshape(n, 12)
    plain = torch.cat([color, depth[:, None]], dim=1).to(torch.bfloat16)
    return torch.cat([split, plain], dim=1)


def round_attributes(mean2d: torch.Tensor, conic: torch.Tensor, opacity: torch.Tensor,
                     color: torch.Tensor, depth: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The float32 (mean2d, conic, opacity, color, depth) that the kernels
    read from `pack_attributes_bf16`'s table: f32(hi) + f32(lo) for mean2d,
    conic and opacity (exact in float32), f32(bf16(x)) for colour and
    depth; each contiguous."""
    table = pack_attributes_bf16(mean2d, conic, opacity, color, depth).float()
    pairs = table[:, :12].reshape(-1, 6, 2)
    values = torch.cat([pairs[..., 0] + pairs[..., 1], table[:, 12:]], dim=1)
    return tuple(c.contiguous() for c in split_columns(values))


def _check_precision(attr_precision: str, grad_precision: str) -> None:
    """Raise ValueError unless both options are "f32" or "bf16"."""
    for name, value in (("attr_precision", attr_precision), ("grad_precision", grad_precision)):
        if value not in PRECISIONS:
            raise ValueError(f"{name} must be one of {PRECISIONS}, got {value!r}")


def split_columns(table: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The (mean2d, conic, opacity, color, depth) column views of a packed
    attribute table, or of a gradient table (N, >= GRAD_COLS), which has the
    same columns."""
    return table[:, 0:2], table[:, 2:5], table[:, 5], table[:, 6:9], table[:, 9]


def gradient_buffer(n: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's zeroed output (N, ROW) float32, whose rows are
    16-byte aligned for vector atomics, and its (N, GRAD_COLS) view of the
    gradient columns (row stride ROW)."""
    buf = torch.zeros((n, ROW), dtype=torch.float32, device=dev)
    return buf, buf[:, :GRAD_COLS]


def composite_fwd_plain(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    height: int,
    width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward composite kernel, with the same
    inputs and outputs: vectorized over tiles and pixels, a Python loop over
    the k-th pair of every tile. Every product and sum is one torch
    operation, in the kernel's order.

    Returns (planes (5, H, W) float32 = r, g, b, T_final, depth;
    nc (H, W) int32 = 1-based rank of the last included pair in the tile)."""
    dev = mean2d.device
    n_ty, n_tx = _tile_grid(height, width)
    n_tiles = n_ty * n_tx
    px, py = _tile_pixels(n_tx, n_tiles, dev)

    T = torch.ones((n_tiles, TILE * TILE), device=dev)
    rgb = torch.zeros((n_tiles, TILE * TILE, 3), device=dev)
    D = torch.zeros((n_tiles, TILE * TILE), device=dev)
    nc = torch.zeros((n_tiles, TILE * TILE), dtype=torch.int32, device=dev)
    done = torch.zeros((n_tiles, TILE * TILE), dtype=torch.bool, device=dev)

    start = tile_start.long()
    count = tile_end.long() - start
    n_pairs = pair_gaussian.shape[0]
    k_max = int(count.max().item()) if n_tiles > 0 and n_pairs > 0 else 0
    for k in range(k_max):
        active = (count > k)[:, None]
        g = pair_gaussian[torch.clamp_max(start + k, n_pairs - 1)].long()
        mx, my = mean2d[g, 0][:, None], mean2d[g, 1][:, None]
        a, b, c = conic[g, 0][:, None], conic[g, 1][:, None], conic[g, 2][:, None]
        dx = mx - px
        dy = my - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(opacity[g][:, None] * torch.exp(power), ALPHA_MAX)
        contributes = active & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_T = T * (1.0 - alpha)
        terminator = contributes & (test_T < T_EPS)
        include = contributes & ~done & ~terminator
        w = torch.where(include, T * alpha, 0.0)
        rgb = rgb + w[..., None] * color[g][:, None, :]
        D = D + w * depth[g][:, None]
        T = torch.where(include, test_T, T)
        nc = torch.where(include, k + 1, nc)
        done = done | terminator

    def to_image(x):  # (..., n_tiles, TILE*TILE) -> (..., H, W)
        lead = x.shape[:-2]
        x = x.reshape(*lead, n_ty, n_tx, TILE, TILE).transpose(-3, -2)
        return x.reshape(*lead, n_ty * TILE, n_tx * TILE)[..., :height, :width]

    planes = torch.cat([rgb.permute(2, 0, 1), T[None], D[None]], dim=0)
    return to_image(planes).contiguous(), to_image(nc).contiguous()


def composite_bwd_plain(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    height: int,
    width: int,
    t_final: torch.Tensor,
    nc: torch.Tensor,
    grad_planes: torch.Tensor,
    round_pairs: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the backward composite kernel, with the same
    inputs and output: the forward's inputs, its saved T_final (H, W) and nc
    (H, W), and the cotangents of its five planes (5, H, W). Vectorized over
    tiles and pixels, a Python loop over the k-th pair of every tile from
    the back; each per-pixel term is the kernel's expression, in its order.
    With `round_pairs` each (Gaussian, tile) pair's ten sums are rounded to
    bf16 (nearest even) before they are added to the Gaussian's row.

    Returns per-Gaussian gradients (N, 10) float32, columns mx, my, a, b, c,
    op, r, g, b, z."""
    dev = mean2d.device
    n_ty, n_tx = _tile_grid(height, width)
    n_tiles = n_ty * n_tx
    px, py = _tile_pixels(n_tx, n_tiles, dev)

    def to_tiles(x, fill):  # (..., H, W) -> (..., n_tiles, TILE*TILE)
        lead = x.shape[:-2]
        pad = (0, n_tx * TILE - width, 0, n_ty * TILE - height)
        x = torch.nn.functional.pad(x, pad, value=fill)
        x = x.reshape(*lead, n_ty, TILE, n_tx, TILE).transpose(-3, -2)
        return x.reshape(*lead, n_tiles, TILE * TILE)

    T = to_tiles(t_final, 1.0)
    rank_stop = to_tiles(nc, 0)  # pixels outside the image include nothing
    gr, gg, gb, gt, gd = to_tiles(grad_planes, 0.0)
    S = T * gt

    grads = torch.zeros((mean2d.shape[0], GRAD_COLS), dtype=torch.float32, device=dev)
    start = tile_start.long()
    n_pairs = pair_gaussian.shape[0]
    if n_tiles == 0 or n_pairs == 0:
        return grads
    # each tile walks its pairs up to the largest nc among its pixels
    top = torch.minimum(tile_end.long() - start, rank_stop.amax(dim=1).long())
    for k in range(int(top.max().item()) - 1, -1, -1):
        active = top > k
        g = pair_gaussian[torch.clamp_max(start + k, n_pairs - 1)].long()
        mx, my = mean2d[g, 0][:, None], mean2d[g, 1][:, None]
        a, b, c = conic[g, 0][:, None], conic[g, 1][:, None], conic[g, 2][:, None]
        dx = mx - px
        dy = my - py
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        G = torch.exp(power)
        alpha_raw = opacity[g][:, None] * G
        alpha = torch.clamp_max(alpha_raw, ALPHA_MAX)
        inc = active[:, None] & (k < rank_stop) & (power <= 0.0) & (alpha >= ALPHA_MIN)
        one_m = 1.0 - alpha
        t_before = torch.where(inc, T / one_m, T)
        w = torch.where(inc, t_before * alpha, 0.0)
        u = (color[g, 0][:, None] * gr + color[g, 1][:, None] * gg
             + color[g, 2][:, None] * gb + depth[g][:, None] * gd)
        dalpha = t_before * u - S / one_m
        S = torch.where(inc, S + w * u, S)
        T = t_before
        unclamped = inc & (alpha_raw < ALPHA_MAX)
        dpow = torch.where(unclamped, dalpha * alpha_raw, 0.0)
        terms = torch.stack([
            -(a * dx + b * dy) * dpow,
            -(c * dy + b * dx) * dpow,
            -0.5 * dx * dx * dpow,
            -dx * dy * dpow,
            -0.5 * dy * dy * dpow,
            torch.where(unclamped, dalpha * G, 0.0),
            w * gr, w * gg, w * gb, w * gd,
        ], dim=-1).sum(dim=1)  # (n_tiles, 10): summed over the tile's pixels
        if round_pairs:
            terms = terms.to(torch.bfloat16).float()
        grads.index_add_(0, g[active], terms[active])
    return grads


# C interfaces of csrc/composite_fwd.cu and csrc/composite_bwd.cu
# fwd: pair_gaussian, tile_start, tile_end, tile_order, attrs; height, width,
#      n_tiles_x, n_tiles; out, out_nc, stream
FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
# bwd: pair_gaussian, tile_start, tile_end, tile_order, attrs, t_final, nc,
#      grad_planes; height, width, n_tiles_x, n_tiles; grads, stream
BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
# the entry points, all of one interface each: (bf16 rows,) -> fwd entry,
# (bf16 rows, pairs rounded) -> bwd entry
FWD_ENTRIES = {False: "composite_fwd", True: "composite_fwd_bf16"}
BWD_ENTRIES = {(False, False): "composite_bwd", (False, True): "composite_bwd_round_pairs",
               (True, True): "composite_bwd_bf16"}


def _bind(name: str, entries, argtypes) -> ctypes.CDLL:
    lib = cuda_build.load(name)
    for entry in entries:
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    return _bind("composite_fwd", FWD_ENTRIES.values(), FWD_ARGTYPES)


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    return _bind("composite_bwd", BWD_ENTRIES.values(), BWD_ARGTYPES)


def _check_kernel_inputs(expect: dict, dev: torch.device) -> None:
    """Every tensor on `dev` (a CUDA device), of its dtype and shape, and
    contiguous; raises ValueError otherwise."""
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _gaussian_inputs(mean2d, conic, opacity, color, depth, pair_gaussian,
                     tile_start, tile_end, n_tiles) -> dict:
    n = mean2d.shape[0]
    if n * ROW >= 2**31 or pair_gaussian.shape[0] >= 2**31:
        raise ValueError("the kernels index with 32-bit integers")
    return {
        "mean2d": (mean2d, torch.float32, (n, 2)),
        "conic": (conic, torch.float32, (n, 3)),
        "opacity": (opacity, torch.float32, (n,)),
        "color": (color, torch.float32, (n, 3)),
        "depth": (depth, torch.float32, (n,)),
        "pair_gaussian": (pair_gaussian, torch.int32, (pair_gaussian.shape[0],)),
        "tile_start": (tile_start, torch.int32, (n_tiles,)),
        "tile_end": (tile_end, torch.int32, (n_tiles,)),
    }


def _check_kernel_layout(tile_order, attrs, n, n_tiles, dev) -> bool:
    """The kernels' own two inputs, which the render path makes once and shares
    between the forward and the backward: the tile order and the packed
    attribute table, float32 (N, ROW) or bfloat16 (N, BF16_ROW). Returns
    whether the table is the bfloat16 one."""
    bf16 = attrs.dtype == torch.bfloat16
    _check_kernel_inputs({
        "tile_order": (tile_order, torch.int32, (n_tiles,)),
        "attrs": (attrs, *((torch.bfloat16, (n, BF16_ROW)) if bf16 else
                           (torch.float32, (n, ROW)))),
    }, dev)
    if attrs.data_ptr() % 16:
        raise ValueError("attrs must be 16-byte aligned (the kernels copy rows in 16-byte words)")
    return bf16


def composite_fwd_cuda(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    height: int,
    width: int,
    *,
    tile_order: torch.Tensor,
    attrs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward composite kernel (csrc/composite_fwd.cu) on
    PyTorch's current stream. Same contract as `composite_fwd_plain`, with
    the kernel's own two inputs beside: `tile_order` (`Binning.tile_order`)
    and `attrs`, `pack_attributes` of the five attribute tensors or
    `pack_attributes_bf16` (then the result is the plain version's on
    `round_attributes` of them). Counts its launches in
    `composite_fwd_cuda.launches` (float32 table) and `.launches_bf16`."""
    dev = mean2d.device
    n_ty, n_tx = _tile_grid(height, width)
    n_tiles = n_ty * n_tx
    gaussians = (mean2d, conic, opacity, color, depth)
    _check_kernel_inputs(_gaussian_inputs(*gaussians, pair_gaussian, tile_start, tile_end,
                                          n_tiles), dev)
    bf16 = _check_kernel_layout(tile_order, attrs, mean2d.shape[0], n_tiles, dev)

    planes = torch.empty((N_PLANES, height, width), dtype=torch.float32, device=dev)
    nc = torch.empty((height, width), dtype=torch.int32, device=dev)
    entry = FWD_ENTRIES[bf16]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_fwd_lib(), entry)(
            pair_gaussian.data_ptr(), tile_start.data_ptr(), tile_end.data_ptr(),
            tile_order.data_ptr(), attrs.data_ptr(),
            height, width, n_tx, n_tiles,
            planes.data_ptr(), nc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    if bf16:
        composite_fwd_cuda.launches_bf16 += 1
    else:
        composite_fwd_cuda.launches += 1
    return planes, nc


composite_fwd_cuda.launches = 0
composite_fwd_cuda.launches_bf16 = 0


def _cotangent_planes(grad_planes: torch.Tensor | None, height: int, width: int,
                      dev: torch.device) -> torch.Tensor:
    """The cotangent of the five planes as one contiguous (5, H, W) float32
    tensor: zeros where autograd passed none, a copy where it arrived strided
    (e.g. from `planes[:3].permute(1, 2, 0)`)."""
    if grad_planes is None:
        return torch.zeros((N_PLANES, height, width), dtype=torch.float32, device=dev)
    if grad_planes.dtype != torch.float32 or tuple(grad_planes.shape) != (N_PLANES, height, width):
        raise ValueError(f"the planes' cotangent must be float32 {(N_PLANES, height, width)}, "
                         f"got {grad_planes.dtype} {tuple(grad_planes.shape)}")
    return grad_planes.contiguous()


def composite_bwd_cuda(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
    pair_gaussian: torch.Tensor,
    tile_start: torch.Tensor,
    tile_end: torch.Tensor,
    height: int,
    width: int,
    t_final: torch.Tensor,
    nc: torch.Tensor,
    grad_planes: torch.Tensor | None,
    *,
    tile_order: torch.Tensor,
    attrs: torch.Tensor,
    round_pairs: bool = False,
) -> torch.Tensor:
    """Launch the backward composite kernel (csrc/composite_bwd.cu) on
    PyTorch's current stream. Same contract as `composite_bwd_plain`, but the
    (N, 10) result is a view of the kernel's (N, 12) output (row stride 12);
    `grad_planes` may also be None (zeros) or strided; `tile_order` and
    `attrs` as for `composite_fwd_cuda`. A bfloat16 table needs
    `round_pairs` (its pairs are rounded, as the JAX kernel's bf16 per-pair
    table is). Counts its launches in `composite_bwd_cuda.launches` (float32
    table), `.launches_round_pairs` (float32 table, pairs rounded) and
    `.launches_bf16`."""
    dev = mean2d.device
    n_ty, n_tx = _tile_grid(height, width)
    n_tiles = n_ty * n_tx
    gaussians = (mean2d, conic, opacity, color, depth)
    expect = _gaussian_inputs(*gaussians, pair_gaussian, tile_start, tile_end, n_tiles)
    expect["t_final"] = (t_final, torch.float32, (height, width))
    expect["nc"] = (nc, torch.int32, (height, width))
    _check_kernel_inputs(expect, dev)
    cot = _cotangent_planes(grad_planes, height, width, dev)
    _check_kernel_inputs({"grad_planes": (cot, torch.float32, (N_PLANES, height, width))}, dev)
    bf16 = _check_kernel_layout(tile_order, attrs, mean2d.shape[0], n_tiles, dev)
    if bf16 and not round_pairs:
        raise ValueError("a bfloat16 attribute table rounds its pairs' gradients: "
                         "pass round_pairs=True")

    buf, grads = gradient_buffer(mean2d.shape[0], dev)
    entry = BWD_ENTRIES[bf16, bool(round_pairs)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_bwd_lib(), entry)(
            pair_gaussian.data_ptr(), tile_start.data_ptr(), tile_end.data_ptr(),
            tile_order.data_ptr(), attrs.data_ptr(), t_final.data_ptr(), nc.data_ptr(),
            cot.data_ptr(), height, width, n_tx, n_tiles, buf.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    if bf16:
        composite_bwd_cuda.launches_bf16 += 1
    elif round_pairs:
        composite_bwd_cuda.launches_round_pairs += 1
    else:
        composite_bwd_cuda.launches += 1
    return grads


composite_bwd_cuda.launches = 0
composite_bwd_cuda.launches_round_pairs = 0
composite_bwd_cuda.launches_bf16 = 0


class _Composite(torch.autograd.Function):
    """The composite behind autograd: forward composite, then backward
    composite, as kernels for CUDA tensors and as plain versions for CPU
    tensors, in the precision modes of `rasterize_cuda`."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, depth, pair_gaussian, tile_start,
                tile_end, tile_order, height, width, attr_precision, grad_precision):
        gaussians = (mean2d, conic, opacity, color, depth)
        lists = (pair_gaussian, tile_start, tile_end)
        bf16_attrs = attr_precision == "bf16"
        with profiling.span("composite_fwd"):
            if mean2d.is_cuda:
                # packed once, read by the forward kernel and again by the backward
                pack = pack_attributes_bf16 if bf16_attrs else pack_attributes
                attrs = pack(*gaussians)
                planes, nc = composite_fwd_cuda(*gaussians, *lists, height, width,
                                                tile_order=tile_order, attrs=attrs)
                ctx.save_for_backward(*gaussians, *lists, planes, nc, tile_order, attrs)
            else:
                if bf16_attrs:  # the values the kernels read from the bf16 table
                    gaussians = round_attributes(*gaussians)
                planes, nc = composite_fwd_plain(*gaussians, *lists, height, width)
                ctx.save_for_backward(*gaussians, *lists, planes, nc)
        ctx.image_size = (height, width)
        # the JAX package: a bf16 table's per-pair gradients are a bf16 table
        # and its per-Gaussian sums are cast to bf16; grad_precision="bf16"
        # rounds the per-pair gradients alone
        ctx.round_pairs = bf16_attrs or grad_precision == "bf16"
        ctx.round_totals = bf16_attrs
        ctx.mark_non_differentiable(nc)
        return planes, nc

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_planes, _grad_nc):
        with profiling.span("composite_bwd"):
            *inputs, planes, nc = ctx.saved_tensors[:10]
            height, width = ctx.image_size
            if inputs[0].is_cuda:
                tile_order, attrs = ctx.saved_tensors[10:]
                grads = composite_bwd_cuda(*inputs, height, width, planes[3], nc, grad_planes,
                                           tile_order=tile_order, attrs=attrs,
                                           round_pairs=ctx.round_pairs)
            else:
                cot = _cotangent_planes(grad_planes, height, width, inputs[0].device)
                grads = composite_bwd_plain(*inputs, height, width, planes[3], nc, cot,
                                            round_pairs=ctx.round_pairs)
            if ctx.round_totals:
                grads = grads.to(torch.bfloat16).float()
            return (*split_columns(grads), *[None] * 8)


def composite(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    color: torch.Tensor,
    depth: torch.Tensor,
    binning: Binning,
    height: int,
    width: int,
    attr_precision: str = "f32",
    grad_precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable composite on the tensors' device: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors, in the precision modes
    of `rasterize_cuda`. Returns (planes (5,H,W), nc (H,W))."""
    if mean2d.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no composite for device {mean2d.device}")
    _check_precision(attr_precision, grad_precision)
    return _Composite.apply(
        mean2d.contiguous(), conic.contiguous(), opacity.contiguous(), color.contiguous(),
        depth.contiguous(), binning.pair_gaussian, binning.tile_start,
        binning.tile_end, binning.tile_order, height, width, attr_precision, grad_precision,
    )


def rasterize_cuda(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    *,
    bg: torch.Tensor,
    shs: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    cov3d_precomp: torch.Tensor | None = None,
    antialiasing: bool = False,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    radius_mode: str = "tight",
    grad_precision: str = "f32",
    attr_precision: str = "f32",
    pair_capacity: int | None = None,
    row_band: tuple[int, int] | None = None,
) -> RenderOutput:
    """Fast equivalent of `rasterize_reference` (same contract) at 16x16
    tiles, differentiable through the composite kernels. `radius_mode`
    ("tight" or "cuda", see `preprocess`) picks the binning rectangles; an
    unknown mode raises ValueError. `attr_precision` and `grad_precision`
    ("f32", the exact default, or "bf16": the JAX rasterizer's pair-table
    modes, see the module docstring) raise ValueError for any other value.
    `pair_capacity` bounds the pair list; pairs beyond it are dropped and
    counted in `overflow`. `row_band=(lo, hi)` renders only the tile rows
    [lo, hi): `image`, `depth` and `alpha` hold the pixel rows [lo * TILE,
    min(hi * TILE, H)), each equal to the same rows of the whole render (the
    kernels walk nothing outside the band)."""
    with profiling.span("project"):
        proj = preprocess(
            means3d, scales, rotations, opacities, cam,
            shs=shs, colors=colors, sh_degree=sh_degree,
            scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
            antialiasing=antialiasing, mean2d_offset=mean2d_offset, alive=alive,
            radius_mode=radius_mode,
        )
    h, w = cam.height, cam.width
    n_ty, n_tx = _tile_grid(h, w)
    with profiling.span("bin"):
        binning = bin_gaussians(
            proj, tile_h=TILE, tile_w=TILE, n_tiles_y=n_ty, n_tiles_x=n_tx,
            pair_capacity=pair_capacity, row_band=row_band,
        )
    planes, _nc = composite(
        proj.mean2d, proj.conic, proj.opacity, proj.color, proj.depth,
        binning, h, w, attr_precision, grad_precision,
    )
    if row_band is not None:
        planes = planes[:, row_band[0] * TILE:row_band[1] * TILE]
    t_final = planes[3]
    image = planes[:3].permute(1, 2, 0) + t_final[..., None] * bg
    return RenderOutput(
        image=image,
        radii=proj.radius.to(torch.int32),
        depth=planes[4],
        alpha=1.0 - t_final,
        mean2d=proj.mean2d,
        overflow=binning.overflow,
    )
