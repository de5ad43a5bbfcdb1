"""The multi-card scripts of the port on the CPU (`tools_torch_multicard.py`,
`tools_torch_measure_scaling.py`), and the cause of the Gaussian-sharded
step's first-step gap against the unsharded one.

* `tools_torch_measure_scaling.py --device cpu` at world 2 (gloo CPU ranks,
  a tiny scene) writes the JAX tool's keys (`tools_measure_scaling.py`:
  `step_ms`, `pixels_per_s`, `efficiency_vs_1`) for widths 1 and 2.
* Both scripts refuse to start, exit code 2, with fewer visible cards than
  asked (`torch.cuda.device_count` monkeypatched), and with none.
* The multi-card scene has the train views that camera DP at world 4 takes.
* `parallel.multihost.check_replicas`, which ends every `apps.train` run of
  several processes, names each rank's device when the states agree and
  raises on every rank when one rank's state is an ulp off.
* The gap: the sharded merge's transmittance is 1 - (1 - T), the JAX
  package's arithmetic (JAX `parallel/gaussian_sharded.py:103` on
  `ops/rasterize_pallas.py:1143`'s alpha = 1 - T), one ulp off T at some
  pixels; where the unsharded image equals the GT exactly, L1's subgradient
  is 0 and the sharded image's, one ulp away, is the full +-0.8/(3HW). Off
  such ties the two steps agree within 1e-5 x max|g| per key (reassociation
  alone), on ties they do not.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_dist_worker import flat_scene, spawn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tools_torch_measure_scaling as scaling_tool  # noqa: E402
import tools_torch_multicard as multicard  # noqa: E402

SIZE = 32
BG = np.array([0.15, 0.05, 0.25], np.float32)
SCENE = flat_scene(5, 40, log_scale=-1.4)


@pytest.fixture(scope="module")
def scaling_report(tmp_path_factory):
    root = tmp_path_factory.mktemp("scaling")
    out = root / "report.json"
    assert scaling_tool.main(["--device", "cpu", "--widths", "1", "2", "--iters", "2",
                              "--work", str(root / "work"), "--out", str(out)]) == 0
    with open(out) as f:
        return json.load(f)


def test_scaling_tool_writes_the_jax_tools_keys(scaling_report):
    assert set(scaling_report["widths"]) == {"1", "2"}
    pixels = multicard.CPU.size ** 2
    for w, row in scaling_report["widths"].items():
        assert set(row) == {"step_ms", "pixels_per_s", "efficiency_vs_1"}
        assert row["step_ms"] > 0
        assert row["pixels_per_s"] == pytest.approx(int(w) * pixels / (row["step_ms"] / 1e3))
    base = scaling_report["widths"]["1"]["step_ms"]
    assert scaling_report["widths"]["1"]["efficiency_vs_1"] == 1.0
    assert scaling_report["widths"]["2"]["efficiency_vs_1"] == pytest.approx(
        base / scaling_report["widths"]["2"]["step_ms"])
    for mode in ("rows", "gaussians"):
        assert set(scaling_report["sharded_one_camera"][mode]) == {"1", "2"}
    assert scaling_report["platform"] == "cpu" and scaling_report["ranks"] == ["cpu", "cpu"]
    assert set(scaling_report["baseline_target"]["at_or_above"]) == {"2"}


@pytest.mark.parametrize("tool,argv", [
    (multicard, []),
    (multicard, ["--worlds", "2"]),
    (scaling_tool, []),
    (scaling_tool, ["--widths", "1", "2"]),
])
@pytest.mark.parametrize("visible", [0, 1])
def test_tools_refuse_without_the_cards(monkeypatch, tmp_path, tool, argv, visible):
    """Fewer cards than the widest world: exit 2 before any work (nothing
    written); never a shared card or gloo in their place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: visible > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    work = tmp_path / "work"
    with pytest.raises(SystemExit) as exc:
        tool.main([*argv, "--work", str(work)])
    assert exc.value.code == 2
    assert not work.exists()


def test_multicard_scene_has_the_views_dp_takes_at_world_4(tmp_path):
    from gaussian_mesh_splatting_tpu_torch.scene import Scene

    root = str(tmp_path / "scene")
    os.makedirs(root)
    multicard.write_mesh_dataset(root, multicard.CPU)
    scene = Scene(root, "gs_mesh", eval=True, num_splats=1, shuffle=False, device="cpu")
    assert len(scene.train_cameras) == multicard.CARD.n_train >= 8
    assert len(scene.test_cameras) == multicard.CARD.n_test
    # rank r of 4 takes view r first, then the next ones: every view exists
    picks = {(r + i) % len(scene.train_cameras) for r in range(4) for i in range(20)}
    assert picks <= set(range(len(scene.train_cameras)))
    # the card runs the full width of tools_verify_scale.py's scene
    assert (multicard.CARD.size, multicard.CARD.num_splats) == (800, 10)
    assert len(scene.scene_info.point_cloud.faces) * multicard.CARD.num_splats == 51_200


@pytest.fixture(scope="module")
def kink(tmp_path_factory):
    """World 1: the merge and the first gaussians step for a GT that equals
    the unsharded image on a checkerboard of pixels (and is 0.1 above it
    elsewhere), and for a constant GT that no pixel equals."""
    checker = (np.indices((SIZE, SIZE)).sum(0) % 2).astype(np.float32)[..., None]
    gts = {"ties": ("image+", np.repeat(0.1 * checker, 3, axis=-1)),
           "off": ("const", np.full((SIZE, SIZE, 3), 0.5, np.float32))}
    (res,) = spawn({"k": ("merge_and_kink", dict(scene=SCENE, size=SIZE, bg=BG, gts=gts))},
                   1, tmp_path_factory.mktemp("kink"))
    return res["k"]


def test_sharded_merge_is_the_jax_transmittance_round_trip(kink):
    """World 1: image = rgb + (1 - alpha) * bg with alpha = 1 - T, bit for
    bit, which is one ulp off the unsharded rgb + T * bg at some pixels."""
    t = 1.0 - kink["alpha"]
    assert torch.equal(kink["sharded"], kink["rgb"] + t[..., None] * torch.tensor(BG))
    diff = (kink["sharded"] - kink["full"]).abs()
    assert 0 < float(diff.max()) <= float(torch.finfo(torch.float32).eps)
    assert int((diff > 0).sum()) > 0


def _rel_errors(got, ref):
    return {k: float((got[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            for k, g in ref.items() if g.numel()}


def test_gaussians_step_gap_is_the_l1_kink(kink):
    """Off ties the sharded and unsharded first steps agree per key within
    1e-5 x max|g|; where the GT equals the unsharded image at elements the
    sharded image misses by an ulp, they differ by more than the parallel
    modes' 5e-4 bound."""
    ties = kink["ties"]
    tied_off = (ties["gt"] == kink["full"]) & (kink["sharded"] != kink["full"])
    assert int(tied_off.sum()) > 0
    off = _rel_errors(kink["off"]["sharded"], kink["off"]["full"])
    assert max(off.values()) <= 1e-5, off
    on = _rel_errors(ties["sharded"], ties["full"])
    assert max(on.values()) > 5e-4, on


@pytest.mark.parametrize("drift_rank", [None, 1])
def test_check_replicas_catches_an_ulp_of_drift(tmp_path, drift_rank):
    ranks = spawn({"c": ("replica_check", dict(scene=SCENE, drift_rank=drift_rank))}, 2,
                  tmp_path)
    got = [r["c"] for r in ranks]
    if drift_rank is None:
        assert got[0] == got[1]
        assert got[0]["line"].startswith("replicas bit-identical on 2 processes")
        assert "rank 0 on cpu, rank 1 on cpu" in got[0]["line"]
    else:
        assert all("training states differ" in g.get("error", "") for g in got), got
