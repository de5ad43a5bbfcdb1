"""`rasterize_cuda(radius_mode=...)` and `render(..., radius_mode=)` on the
port's CPU path (its kernels' plain versions) against the JAX package.

- On the scene of the JAX package's own mode test (tests/test_raster_pallas.py,
  `test_tight_radius_mode_bit_identical_to_cuda`: 128 Gaussians of seed 7 at
  0.3 of their opacity, 160x48, SH 2): the port's "cuda" mode against JAX
  `rasterize_pallas(radius_mode="cuda")` in its exact mode (`interpret=True`,
  `attr_precision="f32"`, `grad_precision="f32"`): image and alpha 2e-5,
  depth 2e-4 * max|depth|, radii equal, gradients 5e-4 * max|g| + 1e-7 (the
  bounds of the port's tight-mode parity tests); the port's two modes
  against each other: image and alpha 1e-6, depth 1e-5, radii equal,
  gradients 5e-4 * max|g|, and pairs("cuda") >= pairs("tight").
- At full opacity the two modes differ in both packages: where an exact
  extent reaches a tile that the 3-sigma square's tile rect stops short of
  (the rect's exclusive bound can stop a pixel short of mean + radius), a
  Gaussian of opacity above ~0.35 still has alpha >= 1/255. Each port mode
  matches the JAX oracle's same mode at 16x16 tiles (2e-5); the port's modes
  differ exactly at the pixels that `chip_smoke.reached_pixels` finds, which
  is the check the card runs (phase 10), and the pairs only "cuda" mode bins
  composite nothing.
- `row_band` and `pair_capacity` in "cuda" mode, `render` forwarding the
  mode, and a ValueError on an unknown mode."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.ops.rasterize_reference import rasterize_reference as j_oracle
from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy
from gaussian_mesh_splatting_tpu_torch.models.gaussian_bag import GaussianBag
from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
    TILE,
    composite_fwd_plain,
    rasterize_cuda,
)
from gaussian_mesh_splatting_tpu_torch.renderer import render

from helpers import activated, random_scene, test_camera
from test_torch_rasterize import _scene
from test_torch_raster_grads import assert_grads_close

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)
BG = np.array([0.1, 0.2, 0.3], np.float32)
PARAMS = ("means3d", "scales", "rotations", "opacities", "shs")
W, H = 160, 48


@functools.lru_cache(maxsize=None)
def jax_mode_scene():
    """The JAX mode test's scene, as numpy, and its camera (JAX, port)."""
    scene = activated(random_scene(jax.random.key(7), n=128))
    scene["opacities"] = scene["opacities"] * 0.3
    jc = test_camera(width=W, height=H)
    tc = camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                            for f in dataclasses.fields(jc)}, device="cpu")
    return {k: np.asarray(v, np.float32) for k, v in scene.items()}, jc, tc


def _loss(out, mean, absolute):
    """Touch every output head, as tests/test_raster_pallas.py does."""
    target = 0.5
    return mean(absolute(out.image - target)) + 0.1 * mean(out.depth) + 0.05 * mean(out.alpha)


@functools.lru_cache(maxsize=None)
def jax_pallas(radius_mode):
    """JAX rasterize_pallas's outputs and gradients, exact mode, as numpy."""
    from gaussian_mesh_splatting_tpu.ops.rasterize_pallas import rasterize_pallas

    s, jc, _ = jax_mode_scene()

    def loss_fn(p):
        out = rasterize_pallas(p["means3d"], p["scales"], p["rotations"], p["opacities"], jc,
                               bg=jnp.asarray(BG), shs=p["shs"], sh_degree=2, interpret=True,
                               attr_precision="f32", grad_precision="f32",
                               radius_mode=radius_mode)
        return _loss(out, jnp.mean, jnp.abs), out

    (_, out), g = jax.value_and_grad(loss_fn, has_aux=True)(
        {k: jnp.asarray(s[k]) for k in PARAMS})
    outs = {k: np.asarray(getattr(out, k)) for k in ("image", "alpha", "depth", "radii")}
    return outs, {k: np.asarray(v) for k, v in g.items()}


def port(radius_mode, s=None, cam=None, **kw):
    """The port's CPU render and gradients, as numpy."""
    if s is None:
        s, _, cam = jax_mode_scene()
    p = {k: torch.tensor(s[k], requires_grad=True) for k in PARAMS}
    out = rasterize_cuda(p["means3d"], p["scales"], p["rotations"], p["opacities"], cam,
                         bg=torch.tensor(BG), shs=p["shs"], sh_degree=2,
                         radius_mode=radius_mode, **kw)
    _loss(out, torch.mean, torch.abs).backward()
    outs = {k: getattr(out, k).detach().numpy() for k in ("image", "alpha", "depth", "radii")}
    return outs, {k: v.grad.numpy() for k, v in p.items()}, out


def n_pairs(s, cam, radius_mode):
    t = {k: torch.tensor(s[k]) for k in PARAMS}
    proj = preprocess(t["means3d"], t["scales"], t["rotations"], t["opacities"], cam,
                      shs=t["shs"], sh_degree=2, radius_mode=radius_mode)
    n_ty, n_tx = -(-cam.height // TILE), -(-cam.width // TILE)
    return int(bin_gaussians(proj, tile_h=TILE, tile_w=TILE, n_tiles_y=n_ty,
                             n_tiles_x=n_tx).pair_gaussian.shape[0])


def test_cuda_mode_matches_jax_pallas_cuda_mode():
    want, want_g = jax_pallas("cuda")
    got, got_g, _ = port("cuda")
    np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["alpha"], want["alpha"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=0,
                               atol=2e-4 * float(np.abs(want["depth"]).max()))
    np.testing.assert_array_equal(got["radii"], want["radii"])
    assert_grads_close(got_g, want_g)


def test_the_ports_modes_agree_on_the_jax_tests_scene():
    s, _, cam = jax_mode_scene()
    cuda, cuda_g, _ = port("cuda")
    tight, tight_g, _ = port("tight")
    np.testing.assert_allclose(cuda["image"], tight["image"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(cuda["alpha"], tight["alpha"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(cuda["depth"], tight["depth"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(cuda["radii"], tight["radii"])
    assert_grads_close(cuda_g, tight_g)
    assert n_pairs(s, cam, "cuda") >= n_pairs(s, cam, "tight")


@pytest.mark.parametrize("radius_mode", ["cuda", "tight"])
def test_full_opacity_modes_match_the_jax_oracles(radius_mode):
    s = {k: v.astype(np.float32) for k, v in _scene(7, 128, opacity_gain=3.0).items()}
    jc = test_camera(width=W, height=H)
    cam = camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                             for f in dataclasses.fields(jc)}, device="cpu")
    want = j_oracle(*(jnp.asarray(s[k]) for k in PARAMS[:4]), jc, bg=jnp.asarray(BG),
                    shs=jnp.asarray(s["shs"]), sh_degree=2, tile_size=(TILE, TILE),
                    radius_mode=radius_mode)
    got, _, _ = port(radius_mode, s, cam)
    for k in ("image", "alpha"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got["radii"], np.asarray(want.radii))


def test_full_opacity_modes_differ_only_where_an_exact_extent_reaches():
    """The check of chip_smoke.py phase 10 (a), on the plain versions."""
    s = _scene(7, 128, opacity_gain=3.0)
    bag = GaussianBag(xyz=torch.tensor(s["means3d"], dtype=torch.float32),
                      scaling=torch.tensor(s["scales"], dtype=torch.float32),
                      rotation=torch.tensor(s["rotations"], dtype=torch.float32),
                      opacity=torch.tensor(s["opacities"], dtype=torch.float32),
                      shs=torch.tensor(s["shs"], dtype=torch.float32),
                      alive=torch.ones(128, dtype=torch.bool))
    _, _, cam = jax_mode_scene()
    _, bin_t, args_t, _ = chip_smoke.composite_inputs(bag, cam, 2, radius_mode="tight")
    _, bin_c, args_c, _ = chip_smoke.composite_inputs(bag, cam, 2, radius_mode="cuda")
    tiles_t, tiles_c = chip_smoke.pair_tiles(bin_t), chip_smoke.pair_tiles(bin_c)
    key_t = tiles_t * 128 + bin_t.pair_gaussian.long()
    key_c = tiles_c * 128 + bin_c.pair_gaussian.long()
    only_t, only_c = ~torch.isin(key_t, key_c), ~torch.isin(key_c, key_t)
    boundary, reach_t = chip_smoke.reached_pixels(args_t, tiles_t[only_t],
                                                  bin_t.pair_gaussian[only_t])
    _, reach_c = chip_smoke.reached_pixels(args_c, tiles_c[only_c], bin_c.pair_gaussian[only_c])
    planes_t, _ = composite_fwd_plain(*args_t)
    planes_c, _ = composite_fwd_plain(*args_c)
    diff = (planes_c - planes_t).abs()
    assert reach_c == 0  # what only "cuda" mode bins composites nothing
    assert reach_t > 0 and float(diff.max()) > 1e-3  # the modes differ at full opacity
    assert torch.equal(diff.amax(dim=0) > 0, boundary)  # exactly at the reached pixels
    assert float(diff[:, ~boundary].max()) == 0.0


def test_row_band_and_pair_capacity_in_cuda_mode():
    s, _, cam = jax_mode_scene()
    t = {k: torch.tensor(s[k]) for k in PARAMS}
    kw = dict(bg=torch.tensor(BG), shs=t["shs"], sh_degree=2, radius_mode="cuda")
    args = (t["means3d"], t["scales"], t["rotations"], t["opacities"], cam)
    whole = rasterize_cuda(*args, **kw)
    band = rasterize_cuda(*args, row_band=(1, 2), **kw)
    for k in ("image", "depth", "alpha"):
        assert torch.equal(getattr(band, k), getattr(whole, k)[TILE:2 * TILE]), k
    total = n_pairs(s, cam, "cuda")
    assert whole.overflow == 0
    assert rasterize_cuda(*args, pair_capacity=total // 2, **kw).overflow == total - total // 2


def test_render_forwards_radius_mode():
    s, _, cam = jax_mode_scene()
    t = {k: torch.tensor(s[k]) for k in PARAMS}
    bag = GaussianBag(xyz=t["means3d"], scaling=t["scales"], rotation=t["rotations"],
                      opacity=t["opacities"], shs=t["shs"],
                      alive=torch.ones(128, dtype=torch.bool))
    tight = n_pairs(s, cam, "tight")
    assert n_pairs(s, cam, "cuda") > tight
    bg = torch.tensor(BG)
    for backend in ("auto", "reference"):
        out = render(bag, cam, bg, sh_degree=2, backend=backend, radius_mode="cuda",
                     **({"pair_capacity": tight} if backend == "auto" else {}))
        if backend == "auto":  # the "cuda" pair list outgrows the tight count
            assert out.overflow == n_pairs(s, cam, "cuda") - tight
        assert torch.isfinite(out.image).all()
    assert render(bag, cam, bg, sh_degree=2, pair_capacity=tight).overflow == 0


def test_unknown_radius_mode_raises():
    s, _, cam = jax_mode_scene()
    t = {k: torch.tensor(s[k]) for k in PARAMS}
    with pytest.raises(ValueError, match="radius_mode"):
        rasterize_cuda(t["means3d"], t["scales"], t["rotations"], t["opacities"], cam,
                       bg=torch.tensor(BG), shs=t["shs"], sh_degree=2, radius_mode="circle")
    bag = GaussianBag(xyz=t["means3d"], scaling=t["scales"], rotation=t["rotations"],
                      opacity=t["opacities"], shs=t["shs"],
                      alive=torch.ones(128, dtype=torch.bool))
    with pytest.raises(ValueError, match="radius_mode"):
        render(bag, cam, torch.tensor(BG), sh_degree=2, radius_mode="circle")
