"""The port's point-cloud models (`gs`, `gs_flat`, `gs_points`), their KNN
scale init, the soup face frames and `cov3d_precomp` against the JAX package
on the CPU, on the same numpy-seeded inputs.

Tolerances and why:
  * `to_bag` and the three face-frame functions: 1e-6 absolute on values of
    order 1 (float32 rounding of a dozen chained operations);
  * KNN: 5e-6 * max|p|^2 absolute on the mean squared distance (the identity
    |a|^2 + |b|^2 - 2ab leaves an error of a few ulps of |p|^2, whatever the
    distance), 1e-3 absolute on the log scale;
  * renders: 2e-5 on image and alpha, 2e-4 * max|depth| on depth, the bounds
    of the `gs_mesh` parity tests (tests/test_torch_rasterize.py);
  * `gs_points` against `gs_flat`: 2e-3 on the image, the JAX package's own
    bound for the round trip through the triangle soup (tests/test_models.py).
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.core.transforms import (
    covariance_from_scaling_rotation as j_cov3d,
)
from gaussian_mesh_splatting_tpu.models import flat as jflat
from gaussian_mesh_splatting_tpu.models import points as jpoints
from gaussian_mesh_splatting_tpu.models import vanilla as jvanilla
from gaussian_mesh_splatting_tpu.ops import knn as j_knn
from gaussian_mesh_splatting_tpu.ops.projection import preprocess as j_preprocess
from gaussian_mesh_splatting_tpu.renderer import render as j_render
from gaussian_mesh_splatting_tpu.train import make_train_state as j_make_train_state
from gaussian_mesh_splatting_tpu.train import optimization_config as j_optimization_config
from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy, state_from_numpy
from gaussian_mesh_splatting_tpu_torch.models import flat as tflat
from gaussian_mesh_splatting_tpu_torch.models import get_model
from gaussian_mesh_splatting_tpu_torch.models import points as tpoints
from gaussian_mesh_splatting_tpu_torch.ops import knn as t_knn
from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess as t_preprocess
from gaussian_mesh_splatting_tpu_torch.renderer import render as t_render
from gaussian_mesh_splatting_tpu_torch.train import make_train_state, optimization_config

# the packages' `core` export a function of the same name as the module
j_ff = importlib.import_module("gaussian_mesh_splatting_tpu.core.face_frames")
t_ff = importlib.import_module("gaussian_mesh_splatting_tpu_torch.core.face_frames")
torch.set_num_threads(2)
JMODELS = {"gs": jvanilla, "gs_flat": jflat, "gs_points": jpoints}


def _close(t, j, atol=1e-6):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def _cameras(w=64, h=48):
    jc = j_make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8 * h / w, w, h)
    tc = camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                            for f in dataclasses.fields(jc)}, device="cpu")
    return jc, tc


def _point_state(gs_type, seed=0, n=48, capacity=None, sh_degree=1):
    """A randomized state of a point-cloud model as numpy: varied disks and
    ellipsoids, some rows dead."""
    rng = np.random.default_rng(seed)
    cols = 3 if gs_type == "gs" else 2
    c = capacity or n
    alive = np.zeros(c, bool)
    alive[:n] = True
    alive[3:n:11] = False
    k = (sh_degree + 1) ** 2
    params = {
        "xyz": (rng.standard_normal((c, 3)) * 0.5).astype(np.float32),
        "f_dc": rng.random((c, 1, 3)).astype(np.float32) * 2 - 0.5,
        "f_rest": (rng.standard_normal((c, k - 1, 3)) * 0.1).astype(np.float32),
        "opacity": (rng.standard_normal((c, 1)) + 1.0).astype(np.float32),
        "scaling": (rng.standard_normal((c, cols)) * 0.3 - 2.5).astype(np.float32),
        "rotation": rng.standard_normal((c, 4)).astype(np.float32),
    }
    return {"params": params, "consts": {}, "alive": alive}


def _jax_state(state):
    return {"params": {k: jnp.asarray(v) for k, v in state["params"].items()},
            "consts": {}, "alive": jnp.asarray(state["alive"])}


def _bags(gs_type, state):
    jstate, tstate = _jax_state(state), state_from_numpy(gs_type, state, device="cpu")
    if gs_type == "gs_points":
        return (jpoints.to_bag(jstate, jpoints.pseudomesh_from_state(jstate)),
                tpoints.to_bag(tstate, tpoints.pseudomesh_from_state(tstate)))
    return JMODELS[gs_type].to_bag(jstate), get_model(gs_type).to_bag(tstate)


# ---------------------------------------------------------------- face frames

def _triangles(seed=3, f=40):
    return (np.random.default_rng(seed).standard_normal((f, 3, 3)) * 0.7).astype(np.float32)


def test_soup_frames_match_jax():
    tris = _triangles()
    got, ref = t_ff.soup_frames(torch.tensor(tris)), j_ff.soup_frames(jnp.asarray(tris))
    assert got.scales.shape == (40, 2) and got.rotation.shape == (40, 3, 3)
    _close(got.scales, ref.scales)
    _close(got.rotation, ref.rotation)


def test_soup_scaling_rotation_quat_matches_jax():
    tris = _triangles(4)
    (s, q), (js, jq) = (t_ff.soup_scaling_rotation_quat(torch.tensor(tris)),
                        j_ff.soup_scaling_rotation_quat(jnp.asarray(tris)))
    _close(s, js)
    _close(q, jq)
    assert float(s.min()) >= 0


def test_gaussians_to_pseudomesh_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.standard_normal((40, 3)).astype(np.float32)
    scaling = np.exp(rng.standard_normal((40, 3)) * 0.4 - 1.0).astype(np.float32)
    q = rng.standard_normal((40, 4)).astype(np.float32)
    got = t_ff.gaussians_to_pseudomesh(*(torch.tensor(a) for a in (xyz, scaling, q)))
    ref = j_ff.gaussians_to_pseudomesh(*(jnp.asarray(a) for a in (xyz, scaling, q)))
    assert got.shape == (40, 3, 3)
    _close(got, ref)
    # both orders of the in-plane axes occur: the larger comes first
    assert 0 < int((scaling[:, 1] > scaling[:, 2]).sum()) < 40


# ---------------------------------------------------------------- KNN

@pytest.mark.parametrize("n,chunk", [(200, 4096), (300, 64), (130, 128)])
def test_mean_knn_sq_dist_matches_jax(n, chunk):
    pts = (np.random.default_rng(n).random((n, 3)) * 2.6 - 1.3).astype(np.float32)
    got = t_knn.mean_knn_sq_dist(torch.tensor(pts), k=3, chunk=chunk).numpy()
    ref = np.asarray(j_knn.mean_knn_sq_dist(jnp.asarray(pts), k=3, chunk=chunk))
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6 * float(np.abs(pts).max()) ** 2)
    # against the distances themselves, in float64
    d2 = ((pts[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    exact = np.sort(d2, axis=1)[:, :3].mean(axis=1)
    np.testing.assert_allclose(got, exact, rtol=0, atol=5e-6 * float(np.abs(pts).max()) ** 2)


def test_knn_scale_init_matches_jax():
    pts = (np.random.default_rng(8).random((257, 3)) * 2.6 - 1.3).astype(np.float32)
    pts[1] = pts[0]  # a duplicate: distance 0 to its nearest neighbour
    got = t_knn.knn_scale_init(torch.tensor(pts)).numpy()
    ref = np.asarray(j_knn.knn_scale_init(jnp.asarray(pts)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_knn_refuses_too_few_points():
    with pytest.raises(ValueError, match="more than k=3"):
        t_knn.mean_knn_sq_dist(torch.zeros((3, 3)))


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("capacity", [None, 64])
@pytest.mark.parametrize("gs_type", ["gs", "gs_flat"])
def test_init_from_points_matches_jax(gs_type, capacity):
    rng = np.random.default_rng(6)
    pts = (rng.standard_normal((20, 3)) * 0.5).astype(np.float32)
    cols = rng.random((20, 3)).astype(np.float32)
    got = get_model(gs_type).init_from_points(torch.tensor(pts), torch.tensor(cols),
                                              sh_degree=2, capacity=capacity)
    ref = JMODELS[gs_type].init_from_points(jnp.asarray(pts), jnp.asarray(cols),
                                            sh_degree=2, capacity=capacity)
    assert set(got["params"]) == set(ref["params"])
    np.testing.assert_array_equal(got["alive"].numpy(), np.asarray(ref["alive"]))
    for k, v in ref["params"].items():
        assert got["params"][k].shape == v.shape, k
        _close(got["params"][k], v, atol=1e-3 if k == "scaling" else 1e-6)
    rows = capacity or 20
    assert got["alive"].shape == (rows,) and int(got["alive"].sum()) == 20
    assert got["params"]["scaling"].shape == (rows, 3 if gs_type == "gs" else 2)
    if capacity:  # padded rows: dead, unit-ish rotation, tiny scaling
        assert torch.equal(got["params"]["rotation"][20:, 0], torch.ones(44))
        assert torch.equal(got["params"]["scaling"][20:],
                           torch.full_like(got["params"]["scaling"][20:], -10.0))


@pytest.mark.parametrize("gs_type", ["gs", "gs_flat", "gs_points"])
def test_to_bag_matches_jax(gs_type):
    jbag, tbag = _bags(gs_type, _point_state(gs_type, seed=1, n=40, capacity=56))
    for f in dataclasses.fields(tbag):
        got, ref = getattr(tbag, f.name), np.asarray(getattr(jbag, f.name))
        assert tuple(got.shape) == ref.shape, f.name
        if f.name == "alive":
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            _close(got, ref)


@pytest.mark.parametrize("gs_type", ["gs", "gs_flat", "gs_points"])
def test_render_matches_jax(gs_type):
    jbag, tbag = _bags(gs_type, _point_state(gs_type, seed=2))
    jc, tc = _cameras()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jout = j_render(jbag, jc, jnp.asarray(bg), sh_degree=1, backend="reference",
                    tile_size=(16, 16))
    tout = t_render(tbag, tc, torch.tensor(bg), sh_degree=1, backend="auto")
    np.testing.assert_allclose(tout.image.numpy(), np.asarray(jout.image), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tout.alpha.numpy(), np.asarray(jout.alpha), atol=2e-5, rtol=0)
    d_scale = float(np.abs(np.asarray(jout.depth)).max())
    np.testing.assert_allclose(tout.depth.numpy(), np.asarray(jout.depth), atol=2e-4 * d_scale,
                               rtol=0)
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    assert float(tout.alpha.max()) > 0.1
    assert not tout.radii[~tbag.alive].any()  # dead rows are culled


def test_points_roundtrip_renders_like_flat():
    state = state_from_numpy("gs_flat", _point_state("gs_flat", seed=9), device="cpu")
    _, tc = _cameras(48, 48)
    out_flat = t_render(tflat.to_bag(state), tc, torch.zeros(3), sh_degree=1)
    tris = tpoints.pseudomesh_from_state(state)
    out_pts = t_render(tpoints.to_bag(state, tris), tc, torch.zeros(3), sh_degree=1)
    np.testing.assert_allclose(out_pts.image.numpy(), out_flat.image.numpy(), atol=2e-3)
    assert float(out_flat.alpha.max()) > 0.1
    # with no triangles given, to_bag derives the state's own pseudomesh
    assert torch.equal(tpoints.to_bag(state).scaling, tpoints.to_bag(state, tris).scaling)


def test_unported_models_raise():
    """A gs_type that is not in the registry; `gs_flame` is an instance
    built from a rig, not a registry module."""
    with pytest.raises(KeyError, match="unknown gs_type 'gs_bogus'"):
        get_model("gs_bogus")
    with pytest.raises(KeyError, match="needs a FLAME rig"):
        get_model("gs_flame")
    assert get_model("gs_multi_mesh").__name__.endswith("models.multi_mesh")


def test_register_model_adds_a_gs_type():
    """`register_model` makes a model instance, as `gs_flame`'s is, a
    registry name."""
    from gaussian_mesh_splatting_tpu_torch.models import (
        MODEL_REGISTRY,
        FlameGaussianModel,
        register_model,
    )
    from gaussian_mesh_splatting_tpu_torch.models.flame import make_random_flame_like_rig

    model = FlameGaussianModel(make_random_flame_like_rig(n_verts=16))
    register_model("gs_flame", model)
    try:
        assert get_model("gs_flame") is model
    finally:
        del MODEL_REGISTRY["gs_flame"]
    with pytest.raises(KeyError):
        get_model("gs_flame")


# ---------------------------------------------------------------- cov3d_precomp

def test_preprocess_cov3d_precomp_matches_jax():
    """`cov3d_precomp` in place of scales and rotations, at the tolerance the
    `gs_mesh` preprocess parity has: 1e-5 of each field's scale."""
    rng = np.random.default_rng(7)
    n = 64
    xyz = (rng.standard_normal((n, 3)) * 0.5).astype(np.float32)
    scales = np.exp(rng.standard_normal((n, 3)) * 0.3 - 2.5).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    op = rng.random((n, 1)).astype(np.float32)
    shs = (rng.standard_normal((n, 3, 4)) * 0.3).astype(np.float32)
    cov6 = np.asarray(j_cov3d(jnp.asarray(scales), 1.0, jnp.asarray(q)))
    jc, tc = _cameras()
    ref = j_preprocess(jnp.asarray(xyz), None, None, jnp.asarray(op), jc, shs=jnp.asarray(shs),
                       sh_degree=1, cov3d_precomp=jnp.asarray(cov6), radius_mode="tight")
    got = t_preprocess(torch.tensor(xyz), None, None, torch.tensor(op), tc,
                       shs=torch.tensor(shs), sh_degree=1, cov3d_precomp=torch.tensor(cov6),
                       radius_mode="tight")
    direct = t_preprocess(torch.tensor(xyz), torch.tensor(scales), torch.tensor(q),
                          torch.tensor(op), tc, shs=torch.tensor(shs), sh_degree=1,
                          radius_mode="tight")
    for name in got._fields:
        t, j = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        if t.dtype == bool:
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            scale = max(float(np.abs(j).max()), 1e-12)
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * scale, err_msg=name)
    # and it is the covariance that scales + rotations give
    np.testing.assert_allclose(got.conic.numpy(), direct.conic.numpy(), rtol=1e-3, atol=1e-4)


def test_rasterizers_take_cov3d_precomp():
    rng = np.random.default_rng(10)
    n = 32
    xyz = torch.tensor((rng.standard_normal((n, 3)) * 0.4).astype(np.float32))
    scales = torch.tensor(np.exp(rng.standard_normal((n, 3)) * 0.3 - 2.0).astype(np.float32))
    q = torch.tensor(rng.standard_normal((n, 4)).astype(np.float32))
    op = torch.full((n, 1), 0.7)
    colors = torch.tensor(rng.random((n, 3)).astype(np.float32))
    from gaussian_mesh_splatting_tpu_torch.core.transforms import covariance_from_scaling_rotation
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda
    from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference

    cov6 = covariance_from_scaling_rotation(scales, 1.0, q)
    _, tc = _cameras()
    for raster in (rasterize_cuda, rasterize_reference):
        a = raster(xyz, scales, q, op, tc, bg=torch.zeros(3), colors=colors)
        b = raster(xyz, None, None, op, tc, bg=torch.zeros(3), colors=colors, cov3d_precomp=cov6)
        np.testing.assert_allclose(b.image.numpy(), a.image.numpy(), atol=1e-4)
        assert float(a.alpha.max()) > 0.1


# ---------------------------------------------------------------- train state

@pytest.mark.parametrize("gs_type", ["gs", "gs_flat"])
def test_make_train_state_with_a_capacity_buffer(gs_type):
    """A padded state: statistics and `alive` span the capacity, every param
    is a leaf of its own Adam group, and the scene extent scales the `xyz`
    schedule as in the JAX package."""
    state = _point_state(gs_type, seed=4, n=10, capacity=32)
    extent = 3.7
    ts = make_train_state(state_from_numpy(gs_type, state, device="cpu"),
                          optimization_config(gs_type), extent)
    jts, _ = j_make_train_state(gs_type, _jax_state(state), j_optimization_config(gs_type),
                                extent)
    assert ts.alive.shape == (32,) and ts.stats.denom.shape == (32,)
    assert int(ts.alive.sum()) == int(jts.alive.sum())
    assert [g["name"] for g in ts.optimizer.param_groups] == list(ts.params)
    assert all(p.is_leaf and p.requires_grad and p.shape[0] == 32 for p in ts.params.values())
    (xyz_group,) = [g for g in ts.optimizer.param_groups if g["name"] == "xyz"]
    cfg = optimization_config(gs_type)
    np.testing.assert_allclose(xyz_group["lr_schedule"](0), cfg.position_lr_init * extent,
                               rtol=1e-5)
    np.testing.assert_allclose(xyz_group["lr_schedule"](cfg.position_lr_max_steps),
                               cfg.position_lr_final * extent, rtol=1e-5)
