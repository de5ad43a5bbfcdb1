"""The frozen counts: the chunked walk count against a plain pair-by-pair
replay (the loop of `chip_smoke.py`'s `composite_op_counts`) on small
scenes, pinned on hand-built ones, the byte formulas, the step and view
operation counts; and that no count reads the program's pairs."""
import ast
import glob
import os

import pytest
import torch

from benchmark.counts import H100_BYTES_PER_S, H100_F32_FLOPS, least_seconds, ops, walk
from benchmark.reference.render import ALPHA_MAX, ALPHA_MIN, T_EPS, TILE, bin_tiles
from benchmark.tests.tiny import BENCH


def plain_counts(proj, bins, h, w):
    """Pair by pair, tile by tile, pixel by pixel: the eight counts."""
    n_tx = bins["n_tx"]
    counts = [0] * 8
    for slot in range(bins["order"].shape[0]):
        tile = int(bins["order"][slot])
        start, count = int(bins["start"][slot]), int(bins["count"][slot])
        ids = bins["gaussian"][start:start + count].tolist()
        for pix in range(TILE * TILE):
            x, y = (tile % n_tx) * TILE + pix % TILE, (tile // n_tx) * TILE + pix // TILE
            if x >= w or y >= h:
                continue
            t, done, nc, evals = 1.0, False, 0, []
            for k, g in enumerate(ids):
                dx = proj["mean2d"][g, 0] - x
                dy = proj["mean2d"][g, 1] - y
                a, b, c = proj["conic"][g]
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                raw = proj["opacity"][g] * torch.exp(power)
                alpha = torch.clamp_max(raw, ALPHA_MAX)
                near, hit = bool(power <= 0), bool(power <= 0) and bool(alpha >= ALPHA_MIN)
                evals.append((near, hit, bool(raw < ALPHA_MAX)))
                if done:
                    continue
                stop = hit and float(t * (1 - alpha)) < T_EPS
                counts[0] += 1
                counts[1] += near
                counts[2] += hit
                if hit and not stop:
                    counts[3] += 1
                    t = float(t * (1 - alpha))
                    nc = k + 1
                done = done or stop
            for near, hit, unclamped in evals[:nc]:
                counts[4] += 1
                counts[5] += near
                counts[6] += hit
                counts[7] += hit and unclamped
    return counts[:4], counts[4:]


def scene(n, seed, h=40, w=48, opacity=(0.05, 0.99)):
    g = torch.Generator().manual_seed(seed)
    mean2d = torch.rand((n, 2), generator=g) * torch.tensor([w, h])
    s = torch.rand((n, 2), generator=g) * 4 + 0.5
    conic = torch.stack([1 / s[:, 0] ** 2, torch.zeros(n), 1 / s[:, 1] ** 2], 1)
    op = opacity[0] + torch.rand(n, generator=g) * (opacity[1] - opacity[0])
    r = torch.ceil(3 * s.max(1).values) + 1
    return {"mean2d": mean2d, "conic": conic, "opacity": op, "depth": torch.rand(n, generator=g) + 1,
            "rx": r, "ry": r, "valid": torch.ones(n, dtype=torch.bool)}


@pytest.mark.parametrize("n,seed", [(1, 0), (12, 1), (60, 2)])
def test_walk_counts_match_a_plain_replay(n, seed):
    proj = scene(n, seed)
    bins = bin_tiles(proj, 40, 48)
    got = walk.walk_counts(proj, bins, 40, 48)
    want_fwd, want_bwd = plain_counts(proj, bins, 40, 48)
    assert got["evaluations"]["fwd"] == want_fwd
    assert got["evaluations"]["bwd"] == want_bwd


def test_walk_counts_are_the_same_in_any_chunking(monkeypatch):
    proj = scene(200, 3, opacity=(0.9, 0.99))  # drives pixels to termination
    bins = bin_tiles(proj, 40, 48)
    whole = walk.walk_counts(proj, bins, 40, 48)
    chunked = walk.chunks
    monkeypatch.setattr(walk, "chunks", lambda b: chunked(b, elements=1 << 11))
    assert walk.walk_counts(proj, bins, 40, 48)["evaluations"] == whole["evaluations"]


def test_one_opaque_gaussian_pinned():
    """One Gaussian of opacity 0.5 at pixel (8, 8) of a 16x16 image, sigma 2
    px: every pixel walks it, the 121 within 6.23 px (0.5 exp(-r^2 / 8) >=
    1/255) reach alpha >= 1/255 and all of those composite."""
    proj = {"mean2d": torch.tensor([[8.0, 8.0]]), "conic": torch.tensor([[0.25, 0.0, 0.25]]),
            "opacity": torch.tensor([0.5]), "depth": torch.tensor([1.0]),
            "rx": torch.tensor([8.0]), "ry": torch.tensor([8.0]), "valid": torch.tensor([True])}
    got = walk.walk_counts(proj, bin_tiles(proj, 16, 16), 16, 16)
    hit = int((0.5 * torch.exp(-0.125 * ((torch.arange(16.0)[:, None] - 8) ** 2
                                         + (torch.arange(16.0)[None, :] - 8) ** 2)) >= 1 / 255).sum())
    assert hit == 121
    assert got["evaluations"] == {"fwd": [256, 256, hit, hit], "bwd": [hit, hit, hit, hit]}
    assert got["fwd"]["flops"] == 11 * 256 + 3 * 256 + 2 * hit + 9 * hit
    assert got["bwd"]["flops"] == (11 + 3 + 29 + 18) * hit
    assert got["fwd"]["bytes"] == 4 * 1 + 8 * 1 + 40 * 1 + 24 * 256
    assert got["bwd"]["bytes"] == 4 * 1 + 8 * 1 + 40 * 1 + 28 * 256 + 40 * 1
    assert got["fwd"]["least_s"] == least_seconds(got["fwd"]["flops"], got["fwd"]["bytes"])


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(H100_F32_FLOPS, 0) == 1.0
    assert least_seconds(0, H100_BYTES_PER_S) == 1.0
    assert least_seconds(H100_F32_FLOPS, 2 * H100_BYTES_PER_S) == 2.0


def test_step_and_view_operations():
    w = {"fwd": {"flops": 1000}, "bwd": {"flops": 3000}}
    assert ops.view_flops(10, 4, 5, w) == 290 * 10 + 1000 + 4 * 3 * 20
    mesh = ops.step_flops(ops.model_flops("gs_mesh", 10, 5, 7), 10, 100, 4, 5, w)
    flame = ops.step_flops(ops.model_flops("gs_flame", 10, 5, 7), 10, 100, 4, 5, w)
    forward = 38 * 10 + 60 * 5 + 290 * 10 + 2 * 3 * 20
    assert mesh == 3 * (forward + 247 * 3 * 20) + 4000 + 12 * 100 + 12 * 10
    assert flame - mesh == 3 * (2 * 3 * 400 + 2 * 3 * 36 + 30 + 120 + 24 + 6) * 7


def test_no_count_reads_the_program():
    """counts/ and reference/ import nothing of the program, so a count is
    always made on the benchmark's own projection and pairs."""
    for path in glob.glob(os.path.join(BENCH, "counts", "**", "*.py"), recursive=True) + glob.glob(
            os.path.join(BENCH, "reference", "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("gaussian_mesh_splatting_tpu_torch", "jax",
                                                  "jaxlib", "gaussian_mesh_splatting_tpu",
                                                  "benchmark"), (path, name)


def test_trace_summary_places_the_boundaries_by_the_marker():
    """The profiled stretch's reduction: the marker (the first device
    operation) puts the first boundary on the trace's clock and is left
    out; busy time is the union of device operations inside the stretch;
    each idle gap goes to the boundary before it, split where a boundary
    falls inside it."""
    from benchmark import tracing

    def op(name, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [op("marker", 1000.0, 2.0), op("a", 1010.0, 20.0), op("b", 1020.0, 30.0),
              op("copy", 1100.0, 10.0, "gpu_memcpy"), op("late", 1300.0, 5.0),
              {"ph": "X", "cat": "cpu_op", "name": "x", "ts": 1000.0, "dur": 500.0}]
    bounds = [("between", 0.0), ("render", 5.0), ("copy", 80.0), ("between", 150.0),
              ("end", 200.0)]
    s = tracing.summarize(events, bounds, marker=True)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(50e-6)  # a and b overlap: 1010-1050; copy 1100-1110
    assert [n for n, _ in s["launches"]] == ["a", "b", "copy"]
    idle = dict(s["breakdown"]["idle_gaps"])
    # gaps 1000-1010 (between 1000-1005, render 1005-1010), 1050-1100 (render
    # 1050-1080, copy 1080-1100), 1110-1200 (copy 1110-1150, between 1150-1200)
    assert idle["render"] == pytest.approx(35e-6)
    assert idle["copy"] == pytest.approx(60e-6)
    assert idle["between"] == pytest.approx(55e-6)
    assert dict(s["breakdown"]["device_ops"])["b"] == pytest.approx(30e-6)
