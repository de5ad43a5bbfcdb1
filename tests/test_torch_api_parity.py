"""The public counterparts the port gained last, against the JAX package on
the same numpy inputs:

- `scene.cameras.load_camera(..., trans=, scale=)`: world_view, full_proj
  and the camera centre within 1e-6 (absolute; float32 of the same
  float64 matrices);
- `train.loop.make_train_step(..., to_bag_kwargs=)`: one `gs_mesh` step
  whose bag is made from a morphed mesh's triangles (a function of the
  state) from the same carried-over state: loss 1e-5 relative, every
  param's gradient 5e-4 * max|g| (the rasterizer's bound), the params after
  Adam within 3 * lr of their group (tests/test_torch_train.py's bounds);
  the triangles are constants of the step in both packages;
- `ops.projection.compute_cov3d`, `project_points`, `ewa_cov2d` at 1e-6
  relative to each output's largest value, and `models.concat_bags`
  exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.models import concat_bags as j_concat_bags
from gaussian_mesh_splatting_tpu.models import mesh as jmesh
from gaussian_mesh_splatting_tpu.models.gaussian_bag import GaussianBag as JBag
from gaussian_mesh_splatting_tpu.ops import projection as jproj
from gaussian_mesh_splatting_tpu.scene import cameras as jcameras
from gaussian_mesh_splatting_tpu.scene.dataset_readers import CameraInfo as JCameraInfo
from gaussian_mesh_splatting_tpu.train import make_train_state as j_make_train_state
from gaussian_mesh_splatting_tpu.train import make_train_step as j_make_train_step
from gaussian_mesh_splatting_tpu_torch.interop import train_state_from_numpy
from gaussian_mesh_splatting_tpu_torch.models import GaussianBag, concat_bags
from gaussian_mesh_splatting_tpu_torch.models import mesh as tmesh
from gaussian_mesh_splatting_tpu_torch.ops import projection as tproj
from gaussian_mesh_splatting_tpu_torch.scene import cameras as tcameras
from gaussian_mesh_splatting_tpu_torch.scene.dataset_readers import CameraInfo
from gaussian_mesh_splatting_tpu_torch.train import make_train_step, optimization_config

from test_torch_train import SH, _jax_setup, _to_torch_camera, _train_state_numpy

torch.set_num_threads(2)
CAMERA_FIELDS = ("world_view", "full_proj", "cam_center")


def _camera_info(cls, rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    image = rng.random((30, 40, 3)).astype(np.float32)
    return cls(uid=0, R=q, T=rng.standard_normal(3), fovy=0.7, fovx=0.9, image=image,
               image_path="x.png", image_name="x", width=40, height=30)


@pytest.mark.parametrize("trans,scale", [((0.0, 0.0, 0.0), 1.0), ((0.3, -1.2, 2.5), 1.0),
                                         ((0.3, -1.2, 2.5), 0.37), ((-2.0, 0.5, 0.1), 4.5)])
def test_load_camera_trans_and_scale_match_jax(trans, scale):
    info_kw = dict(trans=np.asarray(trans), scale=scale)
    jc, jgt = jcameras.load_camera(_camera_info(JCameraInfo, np.random.default_rng(3)),
                                   **info_kw)
    tc, tgt = tcameras.load_camera(_camera_info(CameraInfo, np.random.default_rng(3)),
                                   **info_kw, device="cpu")
    for k in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tgt, jgt)
    if scale != 1.0:  # the options reach the camera
        plain, _ = tcameras.load_camera(_camera_info(CameraInfo, np.random.default_rng(3)),
                                        device="cpu")
        assert not torch.allclose(plain.cam_center, tc.cam_center)


def _morph(vertices: np.ndarray | jnp.ndarray, faces, lib):
    """A mesh animated while training: the state's vertices, stretched and
    shifted, as (F, 3, 3) triangles."""
    v = vertices * lib.asarray([1.15, 0.9, 1.05], dtype=lib.float32) + 0.05
    return v[faces]


def test_train_step_with_to_bag_kwargs_matches_jax():
    cfg, cams, gts, bg, ts, _ = _jax_setup()
    _, j_tx = j_make_train_state("gs_mesh", {"params": ts.params, "consts": ts.consts,
                                             "alive": ts.alive}, cfg)
    j_step = j_make_train_step(
        jmesh, j_tx, cfg, SH, backend="reference",
        to_bag_kwargs=lambda s: {"triangles": _morph(s.params["vertices"],
                                                     s.consts["faces"], jnp)})
    ts2, j_metrics = j_step(ts, cams[1], gts[1], bg)

    state = train_state_from_numpy("gs_mesh", _train_state_numpy(ts),
                                   optimization_config("gs_mesh"), device="cpu")
    step = make_train_step(
        tmesh, optimization_config("gs_mesh"), SH, backend="auto",
        to_bag_kwargs=lambda s: {"triangles": _morph(s.params["vertices"],
                                                     s.consts["faces"].long(), torch)})
    state, metrics = step(state, _to_torch_camera(cams[1]), torch.tensor(np.asarray(gts[1])),
                          torch.ones(3))
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    # the morph reaches the render: the plain step renders another image
    plain = make_train_step(tmesh, optimization_config("gs_mesh"), SH, backend="auto")
    state0 = train_state_from_numpy("gs_mesh", _train_state_numpy(ts),
                                    optimization_config("gs_mesh"), device="cpu")
    _, plain_metrics = plain(state0, _to_torch_camera(cams[1]),
                             torch.tensor(np.asarray(gts[1])), torch.ones(3))
    assert abs(float(plain_metrics["loss"]) - float(metrics["loss"])) > 1e-4
    # no gradient reaches the vertices through the triangles, in either package
    assert state.params["vertices"].grad is None or not state.params["vertices"].grad.any()
    lrs = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    for k, v in ts2.params.items():
        diff = np.abs(state.params[k].detach().numpy() - np.asarray(v)).max()
        assert diff <= 3 * lrs[k], (k, diff, lrs[k])
    np.testing.assert_array_equal(state.params["vertices"].detach().numpy(),
                                  np.asarray(ts2.params["vertices"]))
    for k in ("alpha", "f_dc", "opacity", "scale"):  # the params moved, in both alike
        assert np.abs(np.asarray(ts2.params[k]) - np.asarray(ts.params[k])).max() > 0, k


def _gaussians(n=37, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return {"means3d": (rng.standard_normal((n, 3)) * 0.6).astype(np.float32),
            "scales": np.exp(rng.standard_normal((n, 3)) * 0.4 - 2.0).astype(np.float32),
            "rotations": q}


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("modifier", [1.0, 1.7])
def test_compute_cov3d_matches_jax(modifier):
    g = _gaussians()
    _close(tproj.compute_cov3d(torch.tensor(g["scales"]), torch.tensor(g["rotations"]),
                               modifier),
           jproj.compute_cov3d(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"]), modifier))


def test_project_points_and_ewa_cov2d_match_jax():
    _, cams, _, _, _, _ = _jax_setup()
    jc, tc = cams[0], _to_torch_camera(cams[0])
    g = _gaussians()
    got = tproj.project_points(torch.tensor(g["means3d"]), tc)
    want = jproj.project_points(jnp.asarray(g["means3d"]), jc)
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]
    for a, b in zip(got, want):
        _close(a, b)
    cov = jproj.compute_cov3d(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"]))
    got = tproj.ewa_cov2d(got[2], torch.tensor(np.asarray(cov)), tc)
    want = jproj.ewa_cov2d(want[2], cov, jc)
    for a, b in zip(got, want):
        _close(a, b)


def test_concat_bags_matches_jax():
    rng = np.random.default_rng(6)
    fields = [f.name for f in dataclasses.fields(GaussianBag)]
    shapes = {"xyz": (3,), "scaling": (3,), "rotation": (4,), "opacity": (1,), "shs": (3, 4)}

    def arrays(n):
        out = {k: rng.standard_normal((n, *shapes[k])).astype(np.float32) for k in shapes}
        out["alive"] = rng.random(n) > 0.3
        return out

    parts = [arrays(n) for n in (5, 0, 9)]
    got = concat_bags([GaussianBag(**{k: torch.tensor(p[k]) for k in fields}) for p in parts])
    want = j_concat_bags([JBag(**{k: jnp.asarray(p[k]) for k in fields}) for p in parts])
    for k in fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    assert got.num_gaussians == 14 and got.alive.dtype == torch.bool
