"""Parity of the port's `gs_mesh` model and `preprocess` with the JAX package
on the CPU, at 1e-5 relative to each field's scale (float32 rounding of a
few dozen chained operations). States and cameras cross over through the
port's `interop` functions."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.models import mesh as jmesh
from gaussian_mesh_splatting_tpu.ops.projection import preprocess as j_preprocess
from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy, state_from_numpy
from gaussian_mesh_splatting_tpu_torch.models import mesh as tmesh
from gaussian_mesh_splatting_tpu_torch.models.gaussian_bag import GaussianBag
from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess as t_preprocess

torch.set_num_threads(2)
RTOL = 1e-5


def _rel_close(t, j, rtol=RTOL):
    t, j = t.detach().numpy(), np.asarray(j)
    scale = max(float(np.abs(j).max()), 1e-12) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0.0, atol=rtol * scale)


def _jax_mesh_state(seed=0, n_faces=24, splats=3, sh_degree=3):
    """A randomized JAX `gs_mesh` state (numpy inputs)."""
    rng = np.random.default_rng(seed)
    # distinct vertices per face: no degenerate triangles
    verts = rng.standard_normal((n_faces * 3, 3)).astype(np.float32) * 0.6
    faces = rng.permutation(n_faces * 3).reshape(n_faces, 3).astype(np.int32)
    alpha = rng.random((n_faces, splats, 3)).astype(np.float32)
    colors = rng.random((n_faces * splats, 3)).astype(np.float32)
    st = jmesh.init_from_mesh(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(alpha),
                              jnp.asarray(colors), sh_degree=sh_degree)
    p = dict(st["params"])
    n = n_faces * splats
    p["scale"] = jnp.asarray(rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32))
    p["f_rest"] = jnp.asarray((rng.standard_normal(p["f_rest"].shape) * 0.1).astype(np.float32))
    p["opacity"] = jnp.asarray(rng.standard_normal((n, 1)).astype(np.float32) * 2.0)
    alive = np.ones(n, bool)
    alive[::7] = False
    return {"params": p, "consts": st["consts"], "alive": jnp.asarray(alive)}


def _to_numpy(state):
    return {"params": {k: np.asarray(v) for k, v in state["params"].items()},
            "consts": {k: np.asarray(v) for k, v in state["consts"].items()},
            "alive": np.asarray(state["alive"])}


def _bag_to_torch(jbag):
    return GaussianBag(**{f.name: torch.tensor(np.asarray(getattr(jbag, f.name)))
                          for f in dataclasses.fields(GaussianBag)})


def _cameras(width=96, height=72):
    R = np.eye(3)
    T = np.array([0.1, -0.2, 3.0])
    jc = j_make_camera(R, T, 0.9, 0.7, width, height)
    fields = {f.name: np.asarray(getattr(jc, f.name)) for f in dataclasses.fields(jc)}
    return jc, camera_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("override", [False, True])
def test_mesh_to_bag_matches_jax(override):
    jstate = _jax_mesh_state()
    tstate = state_from_numpy("gs_mesh", _to_numpy(jstate), device="cpu")
    tri = None
    if override:
        tri = np.random.default_rng(3).standard_normal((24, 3, 3)).astype(np.float32)
    jbag = jmesh.to_bag(jstate, None if tri is None else jnp.asarray(tri))
    tbag = tmesh.to_bag(tstate, None if tri is None else torch.tensor(tri))
    for f in ("xyz", "scaling", "rotation", "opacity", "shs"):
        _rel_close(getattr(tbag, f), getattr(jbag, f))
    np.testing.assert_array_equal(tbag.alive.numpy(), np.asarray(jbag.alive))


@pytest.mark.parametrize("radius_mode,antialiasing",
                         [("cuda", False), ("tight", False), ("cuda", True), ("tight", True)])
def test_preprocess_matches_jax(radius_mode, antialiasing):
    # both sides get the same Gaussians (the JAX bag's values), so the
    # comparison isolates preprocess
    jbag = jmesh.to_bag(_jax_mesh_state(seed=1))
    tbag = _bag_to_torch(jbag)
    jc, tc = _cameras()
    kw = dict(sh_degree=3, scale_modifier=0.8, antialiasing=antialiasing,
              radius_mode=radius_mode)
    jp = j_preprocess(jbag.xyz, jbag.scaling, jbag.rotation, jbag.opacity, jc,
                      shs=jbag.shs, alive=jbag.alive, **kw)
    tp = t_preprocess(tbag.xyz, tbag.scaling, tbag.rotation, tbag.opacity, tc,
                      shs=tbag.shs, alive=tbag.alive, **kw)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert 0 < int(tp.valid.sum()) < tp.valid.numel()  # some culled by alive
    for f in ("mean2d", "depth", "conic", "opacity", "color", "radius", "radius_x", "radius_y"):
        _rel_close(getattr(tp, f), getattr(jp, f))


def test_preprocess_colors_passthrough_and_culling():
    jbag = jmesh.to_bag(_jax_mesh_state(seed=2))
    tbag = _bag_to_torch(jbag)
    jc, tc = _cameras()
    colors = np.random.default_rng(4).random((jbag.xyz.shape[0], 3)).astype(np.float32)
    xyz = np.asarray(jbag.xyz).copy()
    xyz[:5, 2] -= 10.0  # behind the near plane
    jp = j_preprocess(jnp.asarray(xyz), jbag.scaling, jbag.rotation, jbag.opacity, jc,
                      colors=jnp.asarray(colors), radius_mode="tight")
    tp = t_preprocess(torch.tensor(xyz), tbag.scaling, tbag.rotation, tbag.opacity, tc,
                      colors=torch.tensor(colors), radius_mode="tight")
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert not tp.valid[:5].any()
    np.testing.assert_array_equal(tp.color.numpy(), colors)
    for f in ("mean2d", "conic", "radius_x", "radius_y"):
        _rel_close(getattr(tp, f), getattr(jp, f))
