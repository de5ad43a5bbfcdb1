"""Gradients of the port's CPU rasterizer (preprocess + binning + the
composite Function with its plain forward and backward) and of its torch
oracle's autograd against `jax.grad` of the JAX oracle
`rasterize_reference(tile_size=(16, 16))`, w.r.t. means3d, scales,
rotations, opacities, shs and mean2d_offset, on the same numpy-seeded
Gaussians, with a loss that touches image, depth and alpha.

Tolerance: 5e-4 * max|g| + 1e-7 per parameter, the bound the JAX package
holds its exact fast path's gradients to (tests/test_raster_pallas.py)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.ops.rasterize_reference import rasterize_reference as j_raster
from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy
from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import rasterize_cuda
from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference

from test_torch_rasterize import CASES, _scene

torch.set_num_threads(2)
BG = np.array([0.1, 0.2, 0.3], np.float32)
PARAMS = ("means3d", "scales", "rotations", "opacities", "shs")


def case_inputs(case):
    """Numpy scene, JAX camera, port camera and a seeded target image."""
    spec = CASES[case]
    s = {k: v.astype(np.float32) for k, v in _scene(*spec["scene"], **spec.get("kw", {})).items()}
    w, h = spec["size"]
    jc = j_make_camera(np.eye(3), np.array([0.0, 0.0, spec.get("dist", 4.0)]), 0.8, 0.8, w, h)
    tc = camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                            for f in dataclasses.fields(jc)}, device="cpu")
    target = np.random.default_rng(7).random((h, w, 3)).astype(np.float32)
    return s, jc, tc, target


def _loss(out, target, mean, absolute):
    """Touch every output head, as tests/test_raster_pallas.py does."""
    return (mean(absolute(out.image - target)) + 0.1 * mean(out.depth)
            + 0.05 * mean(out.alpha))


@functools.lru_cache(maxsize=None)
def jax_grads(case, raster_name="reference"):
    """jax.grad of a JAX rasterizer, as numpy, per parameter + offset."""
    s, jc, _, target = case_inputs(case)
    if raster_name == "reference":
        raster = functools.partial(j_raster, tile_size=(16, 16))
    else:
        from gaussian_mesh_splatting_tpu.ops.rasterize_pallas import rasterize_pallas

        raster = functools.partial(rasterize_pallas, interpret=True, grad_precision="f32",
                                   attr_precision="f32")

    def loss_fn(p, offset):
        out = raster(p["means3d"], p["scales"], p["rotations"], p["opacities"], jc,
                     bg=jnp.asarray(BG), shs=p["shs"], sh_degree=2, mean2d_offset=offset)
        return _loss(out, jnp.asarray(target), jnp.mean, jnp.abs)

    p = {k: jnp.asarray(s[k]) for k in PARAMS}
    offset = jnp.zeros((s["means3d"].shape[0], 2))
    g, g_off = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(p, offset)
    return {**{k: np.asarray(v) for k, v in g.items()}, "mean2d_offset": np.asarray(g_off)}


def torch_grads(case, backend):
    s, _, tc, target = case_inputs(case)
    raster = rasterize_cuda if backend == "cuda_path" else rasterize_reference
    p = {k: torch.tensor(s[k], requires_grad=True) for k in PARAMS}
    offset = torch.zeros((s["means3d"].shape[0], 2), requires_grad=True)
    out = raster(p["means3d"], p["scales"], p["rotations"], p["opacities"], tc,
                 bg=torch.tensor(BG), shs=p["shs"], sh_degree=2, mean2d_offset=offset)
    _loss(out, torch.tensor(target), torch.mean, torch.abs).backward()
    return {**{k: v.grad.numpy() for k, v in p.items()}, "mean2d_offset": offset.grad.numpy()}


def assert_grads_close(got, ref):
    for name, a in ref.items():
        scale = float(np.abs(a).max())
        assert scale > 0, f"reference gradient of {name} is identically zero"
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], a, rtol=0, atol=5e-4 * scale + 1e-7,
                                   err_msg=f"gradient of {name}")


@pytest.mark.parametrize("backend", ["cuda_path", "oracle"])
@pytest.mark.parametrize("case", ["aligned", "nonaligned", "dense"])
def test_gradients_match_jax_oracle(case, backend):
    assert_grads_close(torch_grads(case, backend), jax_grads(case))


def test_gradients_finite_with_faint_and_culled_gaussians():
    """Gaussians behind the camera and Gaussians below 1/255 opacity (whose
    tight binning extent is sqrt(0), a 0/0 in torch's sqrt backward if the
    extents ever joined the loss's graph) must leave every gradient
    finite."""
    s, _, tc, target = case_inputs("aligned")
    s["means3d"][:8, 2] -= 100.0
    s["opacities"][8:16] = 1e-3
    p = {k: torch.tensor(s[k], requires_grad=True) for k in PARAMS}
    offset = torch.zeros((s["means3d"].shape[0], 2), requires_grad=True)
    out = rasterize_cuda(p["means3d"], p["scales"], p["rotations"], p["opacities"], tc,
                         bg=torch.tensor(BG), shs=p["shs"], sh_degree=2, mean2d_offset=offset)
    _loss(out, torch.tensor(target), torch.mean, torch.abs).backward()
    for name, v in [*p.items(), ("mean2d_offset", offset)]:
        assert torch.isfinite(v.grad).all(), name
