"""The port's tracer (`utils/profiling`: `span`, `count`, `tracing`,
`Recording`) on the CPU, in a `gs_mesh` train step and a render: each span
once, nested and in launch order, with the step as request id; `pairs` and
`host_syncs` where the work happens; `mark` still called seven times; and
with no sink installed, the same state bit for bit, no sink called and no
CUDA event made."""
import threading

import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
from gaussian_mesh_splatting_tpu_torch.models import mesh as tmesh
from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import TILE
from gaussian_mesh_splatting_tpu_torch.renderer import render
from gaussian_mesh_splatting_tpu_torch.train import make_train_state, make_train_step
from gaussian_mesh_splatting_tpu_torch.train import optimization_config
from gaussian_mesh_splatting_tpu_torch.utils import profiling
from gaussian_mesh_splatting_tpu_torch.utils.profiling import Recording, count, span, tracing

SH = 1
SIZE = 32
STEP_SPANS = ["to_bag", "render", "render/project", "render/bin", "render/bin/bin_sync",
              "render/composite_fwd", "loss", "backward", "backward/composite_bwd", "adam",
              "stats"]
RENDER_SPANS = ["project", "bin", "bin/bin_sync", "composite_fwd"]


def _scene():
    """An octahedron turned off the axes (no depth ties), 3 splats a face,
    a camera 4 units out, a GT image and a white background."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float32) * 0.6
    a, b = 0.4, 0.3
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    verts = (verts @ (rx @ rz).T).astype(np.float32)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    rng = np.random.default_rng(3)
    state = tmesh.init_from_mesh(torch.tensor(verts), torch.tensor(faces),
                                 torch.tensor(rng.random((8, 3, 3))),
                                 torch.tensor(rng.random((24, 3))), sh_degree=SH)
    state["params"]["opacity"] = state["params"]["opacity"] + 2.0
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, SIZE, SIZE, device="cpu")
    gt = torch.tensor(rng.random((SIZE, SIZE, 3)), dtype=torch.float32)
    return state, cam, gt, torch.ones(3)


def _trainer(mark=None):
    state, cam, gt, bg = _scene()
    cfg = optimization_config("gs_mesh")
    tstate = make_train_state(state, cfg)
    tstate.active_sh_degree = SH
    return tstate, make_train_step(tmesh, cfg, SH, mark=mark), cam, gt, bg


class _Raising:
    """A sink that fails the test if anything calls it."""

    def span(self, name, request=None):
        raise AssertionError(f"span {name!r} reached a sink that is not installed")

    def count(self, name, value=1):
        raise AssertionError(f"count {name!r} reached a sink that is not installed")


def _paths(rec: Recording) -> list:
    return [rec.path(i) for i in range(len(rec.spans))]


def test_train_step_spans_nest_in_launch_order():
    stages = []
    tstate, step, cam, gt, bg = _trainer(mark=stages.append)
    step(tstate, cam, gt, bg)  # step 0 untraced
    rec = Recording("cpu")
    with tracing(rec):
        _, metrics = step(tstate, cam, gt, bg)
    assert stages == ["start", "to_bag", "render", "loss", "backward", "adam", "stats"] * 2
    assert _paths(rec) == STEP_SPANS
    assert {s.request for s in rec.spans} == {1}  # the step, from the top-level span
    assert [s.parent for s in rec.spans] == [None, None, 1, 1, 3, 1, None, None, 7, None, None]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns and s.start_event is s.end_event is None
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # binning's read, the face frames' quaternion floor (core/transforms.py)
    # and the statistics' scale copy (train/loop.py)
    assert rec.totals()["host_syncs"] == 3
    assert rec.totals()["pairs"] > 0 and metrics["overflow"] == 0
    bin_sync = _paths(rec).index("render/bin/bin_sync")
    assert ("host_syncs", 1, bin_sync) in rec.counts
    # the timeline labels each stretch by the innermost open span
    labels = [label for label, _, _ in rec.timeline()]
    assert len(labels) == 2 * len(STEP_SPANS) and labels[-1] == ""
    assert labels[:6] == ["to_bag", "", "render", "render/project", "render",
                          "render/bin"]
    assert labels[labels.index("backward/composite_bwd") + 1] == "backward"


def test_render_spans_and_counts():
    state, cam, gt, bg = _scene()
    bag = tmesh.to_bag(state)
    rec = Recording("cpu")
    with tracing(rec), torch.no_grad():
        for view in range(2):
            with span("render", request=10 + view):
                render(bag, cam, bg, sh_degree=SH)
        render(bag, cam, bg, sh_degree=SH)  # no enclosing span
    assert _paths(rec) == (["render"] + [f"render/{p}" for p in RENDER_SPANS]) * 2 + RENDER_SPANS
    # a top-level span without a request id takes the next one
    assert [s.request for s in rec.spans] == [10] * 5 + [11] * 5 + [12, 13, 13, 14]
    assert [n for n, _, _ in rec.counts] == ["host_syncs", "pairs"] * 3
    assert [rec.path(i) for _, _, i in rec.counts[:2]] == ["render/bin/bin_sync", "render/bin"]
    assert rec.totals()["host_syncs"] == 3  # one read of the pair count a render


@pytest.mark.parametrize("capacity", [None, 7])
def test_pairs_count_the_pair_list(capacity):
    state, cam, _, _ = _scene()
    bag = tmesh.to_bag(state)
    with torch.no_grad():
        proj = preprocess(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam, shs=bag.shs,
                          sh_degree=SH, alive=bag.alive)
        rec = Recording()
        with tracing(rec):
            binning = bin_gaussians(proj, tile_h=TILE, tile_w=TILE, n_tiles_y=SIZE // TILE,
                                    n_tiles_x=SIZE // TILE, pair_capacity=capacity)
    assert rec.totals() == {"host_syncs": 1, "pairs": binning.pair_gaussian.shape[0]}
    assert binning.pair_gaussian.shape[0] > 0
    assert (binning.overflow > 0) == (capacity is not None)
    assert _paths(rec) == ["bin_sync"]


def test_no_sink_changes_nothing_and_makes_nothing(monkeypatch):
    """Two equal states, one step each: traced, then with a raising sink
    installed and taken away again (and CUDA events refused): the params,
    Adam moments and metrics agree bit for bit."""
    traced, step, cam, gt, bg = _trainer()
    with tracing(Recording("cpu")):
        _, m_traced = step(traced, cam, gt, bg)
    plain, step, cam, gt, bg = _trainer()
    with tracing(_Raising()):
        pass
    assert profiling._sink is None

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    _, m_plain = step(plain, cam, gt, bg)
    for k in m_plain:
        assert torch.equal(torch.as_tensor(m_plain[k]), torch.as_tensor(m_traced[k])), k
    for k, p in plain.params.items():
        q = traced.params[k]
        assert torch.equal(p, q), k
        sp, sq = plain.optimizer.state[p], traced.optimizer.state[q]
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sp[key], sq[key]), (k, key)
    for f in ("grad_accum", "denom", "max_radii"):
        assert torch.equal(getattr(plain.stats, f), getattr(traced.stats, f)), f


def test_tracing_restores_the_sink_and_spans_cross_threads():
    """The sink is global: a span opened on another thread while the opener
    waits (as the autograd engine's device thread runs the backward) nests
    under the open span; `tracing` puts back the sink it found."""
    outer, inner = Recording(), Recording()
    with tracing(outer):
        with tracing(inner):
            count("x", 2)
        assert profiling._sink is outer
        def backward_thread():
            with span("composite_bwd"):
                pass

        with span("backward", request=5):
            t = threading.Thread(target=backward_thread)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    assert profiling._sink is None
    assert inner.counts == [("x", 2, None)] and outer.counts == []
    assert _paths(outer) == ["backward", "backward/composite_bwd"]
    assert [s.request for s in outer.spans] == [5, 5]
    assert span("anything") is span("other")  # off: one shared object, nothing made
    # each span keeps the device events of its two ends, in the timeline too
    made = iter(range(100))
    rec = Recording()
    rec._event = lambda: next(made)
    with tracing(rec), span("a"), span("b"):
        pass
    assert [(s.start_event, s.end_event) for s in rec.spans] == [(0, 3), (1, 2)]
    assert [(p, e) for p, _, e in rec.timeline()] == [("a", 0), ("a/b", 1), ("a", 2), ("", 3)]
    data = outer.to_json()
    assert [s["path"] for s in data["spans"]] == _paths(outer)
    assert data["spans"][1]["parent"] == 0 and data["totals"] == {}
