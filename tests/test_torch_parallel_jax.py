"""The port's Gaussian-sharded render (2 gloo CPU ranks,
tests/torch_dist_worker.py) against the JAX package's
`render_gaussian_sharded` on a 2-device mesh (Pallas in interpret mode, as
the JAX package's own tests run it on the CPU), on a numpy-seeded scene of
17 Gaussians (not a multiple of 2).

Tolerance 2e-4 per pixel: the JAX package's bound between its sharded and
unsharded renders on a scene that does not saturate (tests/test_parallel.py).
`render_gaussian_sharded` does not pass the rasterizer's precision options
on, and their default stores the pair attributes in bfloat16 (1.5e-3 off a
float32 render here), so the test binds the JAX package's exact path
(`attr_precision="f32"`, `grad_precision="f32"`, its tests' EXACT_RENDER)
into the module's rasterizer for the call.
This file holds the one JAX Gaussian-sharded render of the port's tests (the
interpret-mode compile costs about a minute), so that `--dist loadfile`
gives it a worker of its own.
"""
import functools

import jax.numpy as jnp
import numpy as np

import gaussian_mesh_splatting_tpu.parallel.gaussian_sharded as j_gaussian_sharded

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.models import flat as jflat
from gaussian_mesh_splatting_tpu.parallel import create_mesh as j_create_mesh
from gaussian_mesh_splatting_tpu.parallel import render_gaussian_sharded as j_render_sharded

from test_torch_parallel import _jax_state
from torch_dist_worker import camera_fields, flat_scene, spawn

SIZE = 24


def test_gaussian_sharded_render_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(j_gaussian_sharded, "rasterize_pallas", functools.partial(
        j_gaussian_sharded.rasterize_pallas, attr_precision="f32", grad_precision="f32"))
    scene = flat_scene(13, 17)
    cam = j_make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, SIZE, SIZE)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    ranks = spawn({"render": ("render", dict(shard="gaussians", scene=scene,
                                              cam=camera_fields(cam), bg=bg))}, 2, tmp_path)
    ref = np.asarray(j_render_sharded(jflat.to_bag(_jax_state(scene)), cam, jnp.asarray(bg),
                                      j_create_mesh(2), sh_degree=0, interpret=True))
    assert ref.std() > 0.01
    for r in ranks:
        np.testing.assert_allclose(r["render"]["sharded"].numpy(), ref, rtol=0, atol=2e-4)
