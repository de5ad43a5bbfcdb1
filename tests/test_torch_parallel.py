"""The port's parallel modes (`gaussian_mesh_splatting_tpu_torch/parallel/`)
on gloo CPU ranks, against the port's unsharded render and the JAX
package's unsharded train step (reference backend), on numpy-seeded scenes:
the cases of the JAX package's tests/test_parallel.py.

Ranks are spawned processes (tests/torch_dist_worker.py) joined through a
`file://` store; one spawn of 2 ranks and one of 4 run every case, and the
tests read their results.

Tolerances and why:
  * row-sharded render: bit-equal to the unsharded one (the bands bin
    global tiles, so every pixel walks the same pairs in the same order);
  * Gaussian-sharded render: 2e-4 on a scene that does not saturate
    (reassociation of the slab merge), 2e-3 where pixels saturate (the
    early-termination tail, parallel/gaussian_sharded.py), as the JAX tests;
  * gradients: 5e-4 * max|g| per param (the rasterizer's gradient bound);
    statistics: grad_accum within 1e-5, denom and max_radii exact; the
    loss 1e-4 relative;
  * replicated state: bit-identical on every rank after several steps.
"""
import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.models import flat as jflat
from gaussian_mesh_splatting_tpu.renderer import render as j_render
from gaussian_mesh_splatting_tpu.train import make_train_state as j_make_train_state
from gaussian_mesh_splatting_tpu.train import make_train_step as j_make_train_step
from gaussian_mesh_splatting_tpu.train import optimization_config as j_optimization_config
from gaussian_mesh_splatting_tpu_torch.models import flat
from gaussian_mesh_splatting_tpu_torch.parallel import make_sharded_train_step
from gaussian_mesh_splatting_tpu_torch.train import optimization_config

from torch_dist_worker import camera_fields, flat_scene, ring_pose, spawn

W, H = 40, 36  # three tile rows of 16: bands of 2 and 1 rows, the last one short
N = 27  # not a multiple of 2 or 4
BG = np.array([0.15, 0.05, 0.25], np.float32)
SCENE = flat_scene(21, N)
TEACHER = flat_scene(22, N)
SATURATING = flat_scene(42, 300, spread=0.3, log_scale=-1.3, opacity_logit=3.0)
STEPS = 3


def _jax_state(scene):
    return {"params": {k: jnp.asarray(v) for k, v in scene["params"].items()}, "consts": {},
            "alive": jnp.asarray(scene["alive"])}


@functools.lru_cache(maxsize=None)
def _jax_cams_and_gts():
    """Two ring cameras and the JAX reference render of a teacher through
    each: the GT images."""
    cams = [j_make_camera(*ring_pose(i, 2), 0.9, 0.9 * H / W, W, H) for i in range(2)]
    bag = jflat.to_bag(_jax_state(TEACHER))
    gts = [np.asarray(j_render(bag, c, jnp.asarray(BG), sh_degree=0, backend="reference").image)
           for c in cams]
    return cams, gts


@functools.lru_cache(maxsize=None)
def _jax_step(cam_index):
    """One JAX train step (reference backend) from a fresh state under
    SGD(1.0): the loss, each param's gradient (old - new params) and the
    statistics."""
    cams, gts = _jax_cams_and_gts()
    cfg = j_optimization_config("gs_flat")
    ts, _ = j_make_train_state("gs_flat", _jax_state(SCENE), cfg)
    tx = optax.sgd(1.0)
    ts = ts.replace(opt_state=tx.init(ts.params))
    step = j_make_train_step(jflat, tx, cfg, 0, backend="reference")
    new, metrics = step(ts, cams[cam_index], jnp.asarray(gts[cam_index]), jnp.asarray(BG))
    grads = {k: np.asarray(ts.params[k] - new.params[k]) for k in ts.params}
    stats = {k: np.asarray(getattr(new.stats, k)) for k in ("grad_accum", "denom", "max_radii")}
    return float(metrics["loss"]), grads, stats


def _train_case(mode, **kw):
    cams, gts = _jax_cams_and_gts()
    return ("train_steps", dict(mode=mode, scene=SCENE, cams=[camera_fields(c) for c in cams],
                                gts=gts, bg=BG, steps=STEPS, **kw))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    cams, _ = _jax_cams_and_gts()
    cam = camera_fields(cams[0])
    sat_cam = camera_fields(j_make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, 32, 32))
    cases = {
        "render_rows": ("render", dict(shard="rows", scene=SCENE, cam=cam, bg=BG)),
        "render_gaussians": ("render", dict(shard="gaussians", scene=SCENE, cam=cam, bg=BG)),
        "render_saturating": ("render", dict(shard="gaussians", scene=SATURATING, cam=sat_cam,
                                             bg=np.array([0.3, 0.2, 0.1], np.float32))),
        "grads_rows": ("render_grads", dict(shard="rows", scene=SCENE, cam=cam)),
        "grads_gaussians": ("render_grads", dict(shard="gaussians", scene=SCENE, cam=cam)),
        "step_rows": _train_case("rows"),
        "step_gaussians": _train_case("gaussians"),
        "step_data": _train_case("data"),
        "step_overflow": _train_case("rows", pair_capacity=8),
    }
    return spawn(cases, 2, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return spawn({"step_composed": _train_case("composed")}, 4,
                 tmp_path_factory.mktemp("four_ranks"))


def _assert_grads_close(got: dict, ref: dict, label: str):
    for k, g in ref.items():
        g = np.asarray(g)
        if g.size == 0:
            continue
        out = np.asarray(got[k])
        assert np.isfinite(out).all(), (label, k)
        np.testing.assert_allclose(out, g, rtol=0, atol=5e-4 * float(np.abs(g).max()) + 1e-12,
                                   err_msg=f"{label}: gradient of {k}")


def _assert_stats_close(got: dict, ref: dict):
    np.testing.assert_allclose(np.asarray(got["grad_accum"]), ref["grad_accum"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got["denom"]), ref["denom"])
    np.testing.assert_array_equal(np.asarray(got["max_radii"]), ref["max_radii"])


# ---------------------------------------------------------------- renders

def test_row_sharded_render_is_bit_equal_to_unsharded(two_ranks):
    for r in two_ranks:
        out = r["render_rows"]
        assert out["sharded"].shape == (H, W, 3)
        assert torch.equal(out["sharded"], out["full"])
        assert out["full"].std() > 0.01


def test_gaussian_sharded_render_matches_unsharded(two_ranks):
    for r in two_ranks:
        out = r["render_gaussians"]
        np.testing.assert_allclose(out["sharded"].numpy(), out["full"].numpy(), rtol=0,
                                   atol=2e-4)
    assert torch.equal(two_ranks[0]["render_gaussians"]["sharded"],
                       two_ranks[1]["render_gaussians"]["sharded"])


def test_gaussian_sharded_matches_unsharded_with_saturation(two_ranks):
    """300 near-opaque Gaussians in a dense cluster: pixels saturate, so the
    early-termination tail that the slab merge picks back up is exercised."""
    out = two_ranks[0]["render_saturating"]
    t_final = 1.0 - out["alpha"].numpy()
    assert (t_final <= 1.5e-4).any(), f"no pixel saturates (min T {t_final.min():.2e})"
    diff = np.abs(out["sharded"].numpy() - out["full"].numpy())
    assert diff.max() < 2e-3, diff.max()
    assert np.quantile(diff, 0.99) < 5e-4, np.quantile(diff, 0.99)


@pytest.mark.parametrize("shard", ["rows", "gaussians"])
def test_sharded_render_gradients_flow(two_ranks, shard):
    """Each rank's portion gradient, summed over the ranks, is the unsharded
    render's gradient."""
    for r in two_ranks:
        out = r[f"grads_{shard}"]
        assert np.abs(out["grads"]["xyz"].numpy()).max() > 0
        _assert_grads_close(out["grads"], out["ref"], shard)


# ---------------------------------------------------------------- train steps

@pytest.mark.parametrize("shard", ["rows", "gaussians"])
def test_sharded_step_gradients_match_unsharded_jax_step(two_ranks, shard):
    loss, grads, stats = _jax_step(0)
    for r in two_ranks:
        out = r[f"step_{shard}"]
        np.testing.assert_allclose(out["metrics"]["loss"], loss, rtol=1e-4)
        _assert_grads_close(out["grads"], grads, shard)
        _assert_stats_close(out["stats"], stats)
        assert out["metrics"]["overflow"] == 0 and out["step"] == STEPS


def test_dp_gradient_equals_sequential_mean(two_ranks):
    """The DP step's gradient is the mean of the two cameras' single-camera
    gradients, and its loss their mean."""
    refs = [_jax_step(c) for c in range(2)]
    mean = {k: (refs[0][1][k] + refs[1][1][k]) / 2 for k in refs[0][1]}
    for r in two_ranks:
        out = r["step_data"]
        np.testing.assert_allclose(out["metrics"]["loss"], (refs[0][0] + refs[1][0]) / 2,
                                   rtol=1e-4)
        _assert_grads_close(out["grads"], mean, "data")


def test_dp_stats_sum_over_cameras(two_ranks):
    refs = [_jax_step(c)[2] for c in range(2)]
    want = {"grad_accum": refs[0]["grad_accum"] + refs[1]["grad_accum"],
            "denom": refs[0]["denom"] + refs[1]["denom"],
            "max_radii": np.maximum(refs[0]["max_radii"], refs[1]["max_radii"])}
    for r in two_ranks:
        stats = r["step_data"]["stats"]
        _assert_stats_close(stats, want)
        assert 1.0 < float(stats["denom"].max()) <= 2.0


def test_composed_2x2_step_equals_mean_over_cameras(four_ranks):
    """(data=2, model=2): two cameras data-parallel, the Gaussians of each
    depth-sharded over two ranks."""
    refs = [_jax_step(c) for c in range(2)]
    mean = {k: (refs[0][1][k] + refs[1][1][k]) / 2 for k in refs[0][1]}
    for r in four_ranks:
        out = r["step_composed"]
        np.testing.assert_allclose(out["metrics"]["loss"], (refs[0][0] + refs[1][0]) / 2,
                                   rtol=1e-4)
        _assert_grads_close(out["grads"], mean, "composed")
        assert float(out["stats"]["denom"].max()) <= 2.0  # two cameras, not four ranks
        np.testing.assert_array_equal(out["stats"]["denom"].numpy(),
                                      refs[0][2]["denom"] + refs[1][2]["denom"])


@pytest.mark.parametrize("mode", ["rows", "gaussians", "data", "composed"])
def test_replicated_state_identical_on_every_rank(two_ranks, four_ranks, mode):
    ranks = four_ranks if mode == "composed" else two_ranks
    outs = [r[f"step_{mode}"] for r in ranks]
    for out in outs[1:]:
        assert out["losses"] == outs[0]["losses"]
        for k, p in outs[0]["params"].items():
            assert torch.equal(out["params"][k], p), (mode, k)
    assert all(np.isfinite(outs[0]["losses"]))


def test_overflow_is_summed_over_the_ranks(two_ranks):
    """A pair capacity below each band's pairs: every rank reports the same
    total, so every rank grows the capacity on the same step."""
    o0, o1 = (r["step_overflow"]["overflow"] for r in two_ranks)
    assert o0 == o1 and all(o > 0 for o in o0)


def test_unknown_shard_raises():
    with pytest.raises(ValueError, match="shard must be one of"):
        make_sharded_train_step(flat, optimization_config("gs_flat"), 0, mesh=None, shard="cols")
