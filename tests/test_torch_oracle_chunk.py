"""The port's oracle folded in checkpointed groups (`scan_chunk`) against its
flat fold, and its `scan_chunk` / `radius_mode` keywords against the JAX
oracle's, on the same numpy-seeded Gaussians (120 at 64x48, dense enough
that pixels terminate).

Tolerances: chunked against flat, image / depth / alpha bit-equal and every
gradient within 1e-6 * max|g| (the grouping changes only where autograd
sums); against JAX, those of the existing oracle parity tests
(test_torch_rasterize.py, test_torch_raster_grads.py): 2e-5 on image and
alpha, 2e-4 * max|depth| on depth, 5e-4 * max|g| + 1e-7 per gradient."""
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
from gaussian_mesh_splatting_tpu_torch.models.gaussian_bag import GaussianBag
from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference
from gaussian_mesh_splatting_tpu_torch.renderer import render

from test_torch_rasterize import _scene

torch.set_num_threads(2)
BG = np.array([0.1, 0.2, 0.3], np.float32)
PARAMS = ("means3d", "scales", "rotations", "opacities", "shs")
N, W, H = 120, 64, 48


@functools.lru_cache(maxsize=None)
def inputs():
    s = {k: v.astype(np.float32) for k, v in
         _scene(3, N, spread=0.6, scale_log_mean=-2.0, opacity_gain=2.0).items()}
    jc = j_make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, W, H)
    tc = camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                            for f in dataclasses.fields(jc)}, device="cpu")
    target = np.random.default_rng(8).random((H, W, 3)).astype(np.float32)
    return s, jc, tc, target


def _loss(out, target, mean, absolute):
    return (mean(absolute(out.image - target)) + 0.1 * mean(out.depth)
            + 0.05 * mean(out.alpha))


@functools.lru_cache(maxsize=None)
def torch_run(**kw):
    """The port's oracle: outputs and gradients (per param + offset), numpy."""
    s, _, tc, target = inputs()
    p = {k: torch.tensor(s[k], requires_grad=True) for k in PARAMS}
    offset = torch.zeros((N, 2), requires_grad=True)
    out = rasterize_reference(p["means3d"], p["scales"], p["rotations"], p["opacities"], tc,
                              bg=torch.tensor(BG), shs=p["shs"], sh_degree=2,
                              mean2d_offset=offset, **kw)
    _loss(out, torch.tensor(target), torch.mean, torch.abs).backward()
    outs = {k: getattr(out, k).detach().numpy() for k in ("image", "depth", "alpha", "radii")}
    grads = {**{k: v.grad.numpy() for k, v in p.items()}, "mean2d_offset": offset.grad.numpy()}
    return outs, grads


def jax_run(**kw):
    s, jc, _, target = inputs()

    def loss_fn(p, offset):
        out = j_raster(p["means3d"], p["scales"], p["rotations"], p["opacities"], jc,
                       bg=jnp.asarray(BG), shs=p["shs"], sh_degree=2, mean2d_offset=offset,
                       **kw)
        return _loss(out, jnp.asarray(target), jnp.mean, jnp.abs), out

    p = {k: jnp.asarray(s[k]) for k in PARAMS}
    (_, out), (g, g_off) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        p, jnp.zeros((N, 2)))
    outs = {k: np.asarray(getattr(out, k)) for k in ("image", "depth", "alpha", "radii")}
    return outs, {**{k: np.asarray(v) for k, v in g.items()}, "mean2d_offset": np.asarray(g_off)}


def test_scene_terminates_pixels():
    outs, _ = torch_run()
    assert float(outs["alpha"].max()) > 0.999  # the `done` path is exercised


@pytest.mark.parametrize("chunk", [1, 7, 40, 500])
def test_chunked_fold_matches_flat_fold(chunk):
    flat_out, flat_g = torch_run()
    out, g = torch_run(scan_chunk=chunk)
    for k in ("image", "depth", "alpha", "radii"):
        np.testing.assert_array_equal(out[k], flat_out[k], err_msg=k)
    for k, ref in flat_g.items():
        scale = float(np.abs(ref).max())
        assert scale > 0, k
        np.testing.assert_allclose(g[k], ref, atol=1e-6 * scale, rtol=0, err_msg=k)


def test_render_forwards_the_oracle_keywords():
    s, _, tc, _ = inputs()
    bag = GaussianBag(xyz=torch.tensor(s["means3d"]), scaling=torch.tensor(s["scales"]),
                      rotation=torch.tensor(s["rotations"]), opacity=torch.tensor(s["opacities"]),
                      shs=torch.tensor(s["shs"]), alive=torch.ones(N, dtype=torch.bool))
    for kw in ({"scan_chunk": 7}, {"radius_mode": "cuda"}):
        with torch.no_grad():
            out = render(bag, tc, torch.tensor(BG), sh_degree=2, backend="reference", **kw)
        want, _ = torch_run(**kw)
        np.testing.assert_array_equal(out.image.numpy(), want["image"])
        np.testing.assert_array_equal(out.radii.numpy(), want["radii"])


@pytest.mark.parametrize("kw", [{"scan_chunk": 40}, {"radius_mode": "cuda"}],
                         ids=["scan_chunk=40", "radius_mode=cuda"])
def test_oracle_keywords_match_jax(kw):
    t_out, t_g = torch_run(**kw)
    j_out, j_g = jax_run(**kw)
    np.testing.assert_allclose(t_out["image"], j_out["image"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(t_out["alpha"], j_out["alpha"], atol=2e-5, rtol=0)
    d_scale = max(float(np.abs(j_out["depth"]).max()), 1e-6)
    np.testing.assert_allclose(t_out["depth"], j_out["depth"], atol=2e-4 * d_scale, rtol=0)
    np.testing.assert_array_equal(t_out["radii"], j_out["radii"])
    for k, ref in j_g.items():
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(t_g[k], ref, atol=5e-4 * scale + 1e-7, rtol=0, err_msg=k)


def test_radius_mode_reaches_preprocess():
    """An unknown mode is refused by `preprocess`: the keyword is not dropped."""
    s, _, tc, _ = inputs()
    with pytest.raises(ValueError, match="radius_mode"):
        rasterize_reference(*(torch.tensor(s[k]) for k in PARAMS[:4]), tc, bg=torch.tensor(BG),
                            shs=torch.tensor(s["shs"]), sh_degree=2, radius_mode="loose")
