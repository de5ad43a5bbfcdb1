"""`tools_torch_span_split.py` on the CPU, at the tiny sizes of
`benchmark/tests/tiny.py`: one line a cell with the split of the render
stage and of the backward, the counters a step or view, and the profiled
stretch's idle time labelled by the stages and again by the spans under
them, whose labels under one stage sum to that stage's figure."""
import json

import pytest

import tools_torch_span_split as tool

TRAIN_SPLIT = {"project_ms", "bin_ms", "bin_sync_ms", "bwd_loss_ms", "bwd_composite_ms",
               "bwd_geometry_ms", "pairs", "host_syncs"}


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    out = tmp_path_factory.mktemp("split") / "split.jsonl"
    assert tool.main(["--device", "cpu", "--workloads", "gs_mesh.train", "gs_mesh.render",
                      "--seconds", "0.3", "--rounds", "1", "--profile_seconds", "0.6",
                      "--out", str(out)]) == 0
    return {d["workload"]: d for d in map(json.loads, out.read_text().splitlines())}


def _sums_match(profiled: dict) -> None:
    old, new = profiled["idle_gaps"], profiled["nested_idle_gaps"]
    for label, seconds in old.items():
        under = sum(v for k, v in new.items() if k.split("/")[0] == label)
        assert under == pytest.approx(seconds, rel=1e-9, abs=1e-12), label
    assert {k.split("/")[0] for k in new} == set(old)


def test_train_split(lines):
    d = lines["tiny_mesh.train"]
    split = d["split"]
    assert set(split) == TRAIN_SPLIT
    assert split["host_syncs"] == 3 and split["pairs"] > 0
    assert all(split[k] > 0 for k in TRAIN_SPLIT - {"pairs", "host_syncs"})
    assert set(d["ms_per_step"]) == {"plain", "marks", "traced"}
    assert set(d["stage_ms"]) == {"to_bag", "render", "loss", "backward", "adam", "stats"}
    nested = d["profiled"]["nested_idle_gaps"]
    for label in ("render/project", "render/bin/bin_sync", "render/composite_fwd",
                  "backward/loss", "backward/composite_bwd", "backward/geometry"):
        assert nested.get(label, 0) > 0, label
    _sums_match(d["profiled"])


def test_render_split(lines):
    d = lines["tiny_mesh.render"]
    split = d["split"]
    assert set(split) == {"project_ms", "bin_ms", "bin_sync_ms", "pairs", "host_syncs"}
    assert split["host_syncs"] == 1 and split["pairs"] > 0
    assert "stage_ms" not in d
    nested = d["profiled"]["nested_idle_gaps"]
    assert {"render/project", "render/bin", "render/composite_fwd", "copy"} <= set(nested)
    _sums_match(d["profiled"])


def test_nested_labels_on_a_synthetic_stretch():
    """Stage boundaries and span boundaries that share device times: the
    host's order decides, the backward's own time is split at B2's span,
    and idle time outside every span keeps the stage's label."""
    from gaussian_mesh_splatting_tpu_torch.utils.profiling import Recording

    rec = Recording()
    t = iter(range(1000, 100000, 1000))
    for name, parent, req in (("render", None, 0), ("bin", 0, 0), ("bin_sync", 1, 0),
                              ("backward", None, 0), ("composite_bwd", 3, 0)):
        rec.spans.append(tool_span(name, parent, req))
    # host order: render( bin( bin_sync( ) ) ) backward( composite_bwd( ) )
    order = [0, 1, 2, ~2, ~1, ~0, 3, 4, ~4, ~3]
    for b in order:
        if b < 0:
            rec.spans[~b].end_ns = next(t)
        else:
            rec.spans[b].start_ns = next(t)
    rec._boundaries = order
    first = 0.0  # host seconds of the stretch's first boundary
    stage_marks = [("between", 0.0), ("render", 0.5), ("backward", 6.5), ("between", 10.5),
                   ("end", 12.0)]
    got = tool.nested_boundaries(stage_marks, rec, first, cuda=False)
    assert got == [("between", 0.0), ("render", 0.5), ("render", 1.0), ("render/bin", 2.0),
                   ("render/bin/bin_sync", 3.0), ("render/bin", 4.0), ("render", 5.0),
                   ("render", 6.0), ("backward", 6.5), ("backward/loss", 7.0),
                   ("backward/composite_bwd", 8.0), ("backward/geometry", 9.0),
                   ("backward", 10.0), ("between", 10.5), ("end", 12.0)]


def tool_span(name, parent, request):
    from gaussian_mesh_splatting_tpu_torch.utils.profiling import Span

    return Span(name, parent, request, 0, 0)
