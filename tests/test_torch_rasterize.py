"""The port's CPU render (preprocess + binning + the composite kernel's plain
version) and its sequential torch oracle against the JAX oracle
`rasterize_reference(tile_size=(16, 16))`, on the same numpy-seeded
Gaussians. Tolerances are the float32 bounds the JAX package holds its own
fast path to (tests/test_raster_pallas.py): 2e-5 on image and alpha,
2e-4 * max|depth| on depth."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.ops.rasterize_reference import rasterize_reference as j_raster
from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy
from gaussian_mesh_splatting_tpu_torch.ops.rasterize_cuda import (
    composite_fwd_cuda,
    rasterize_cuda,
)
from gaussian_mesh_splatting_tpu_torch.ops.rasterize_reference import rasterize_reference

torch.set_num_threads(2)
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _scene(seed, n, spread=1.0, scale_log_mean=-2.5, opacity_gain=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    return dict(
        means3d=rng.standard_normal((n, 3)) * spread * 0.5,
        scales=np.exp(rng.standard_normal((n, 3)) * 0.3 + scale_log_mean),
        rotations=q / np.linalg.norm(q, axis=-1, keepdims=True),
        opacities=np.clip(np.clip(rng.random((n, 1)), 0.05, 0.95) * opacity_gain, 0.0, 0.999),
        shs=np.concatenate([rng.random((n, 3, 1)) * 2.0 - 0.5,
                            rng.standard_normal((n, 3, 15)) * 0.02], axis=-1),
    )


CASES = {
    "aligned": dict(scene=(0, 64), size=(128, 64)),
    "nonaligned": dict(scene=(1, 96), size=(200, 50)),
    "dense": dict(scene=(2, 256), kw=dict(spread=0.3, scale_log_mean=-1.5, opacity_gain=3.0),
                  size=(128, 64), dist=3.0),
    "culled": dict(scene=(5, 16), size=(128, 16), behind=True),
    "colors": dict(scene=(6, 64), size=(96, 64), colors=True),
    "scale_modifier": dict(scene=(7, 64), size=(128, 64), render=dict(scale_modifier=1.7)),
}


def _render_both(case, backend):
    spec = CASES[case]
    s = {k: v.astype(np.float32) for k, v in _scene(*spec["scene"], **spec.get("kw", {})).items()}
    if spec.get("behind"):
        s["means3d"][:, 2] -= 100.0
    w, h = spec["size"]
    R, T = np.eye(3), np.array([0.0, 0.0, spec.get("dist", 4.0)])
    jc = j_make_camera(R, T, 0.8, 0.8, w, h)
    tc = camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                            for f in dataclasses.fields(jc)}, device="cpu")
    extra = dict(spec.get("render", {}), sh_degree=2)
    if spec.get("colors"):
        extra["colors"] = np.random.default_rng(9).random((s["means3d"].shape[0], 3)).astype(
            np.float32)
    else:
        extra["shs"] = s["shs"]
    order = ("means3d", "scales", "rotations", "opacities")
    jout = j_raster(*(jnp.asarray(s[k]) for k in order), jc, bg=jnp.asarray(BG),
                    tile_size=(16, 16),
                    **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                       for k, v in extra.items()})
    targs = [torch.tensor(s[k]) for k in order]
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in extra.items()}
    if backend == "reference":
        tout = rasterize_reference(*targs, tc, bg=torch.tensor(BG), tile_size=(16, 16), **tkw)
    else:
        tout = rasterize_cuda(*targs, tc, bg=torch.tensor(BG), **tkw)
    return jout, tout


@pytest.mark.parametrize("backend", ["plain_composite", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax_oracle(case, backend):
    jout, tout = _render_both(case, backend)
    np.testing.assert_allclose(tout.image.numpy(), np.asarray(jout.image), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tout.alpha.numpy(), np.asarray(jout.alpha), atol=2e-5, rtol=0)
    d_scale = max(float(np.abs(np.asarray(jout.depth)).max()), 1e-6)
    np.testing.assert_allclose(tout.depth.numpy(), np.asarray(jout.depth),
                               atol=2e-4 * d_scale, rtol=0)
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    if case == "culled":
        assert not tout.radii.any()
        np.testing.assert_allclose(tout.image.numpy(), np.broadcast_to(BG, tout.image.shape),
                                   atol=1e-6)
    elif case == "dense":
        assert float(tout.alpha.max()) > 0.999  # pixels driven to termination
    else:
        assert float(tout.alpha.max()) > 0.1


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        composite_fwd_cuda(z(4, 2), z(4, 3), z(4), z(4, 3), z(4), z(0, dtype=torch.int32),
                           z(1, dtype=torch.int32), z(1, dtype=torch.int32), 16, 16)
