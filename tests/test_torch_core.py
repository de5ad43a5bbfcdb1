"""Parity of the port's core/ (transforms, SH, camera, face frames) with the
JAX package on the CPU. Inputs come from a numpy seed and go to both.
Tolerance: atol 1e-6 (float32 rounding of O(1) values); SH degree 4 at
1e-5 relative (its quartic terms reach ~35x the inputs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.core import camera as jcam
from gaussian_mesh_splatting_tpu.core.face_frames import face_frames as j_face_frames
from gaussian_mesh_splatting_tpu.core.face_frames import face_scaling_rotation_quat as j_face_quat
from gaussian_mesh_splatting_tpu.core import sh as jsh
from gaussian_mesh_splatting_tpu.core import transforms as jtr
from gaussian_mesh_splatting_tpu_torch.core import camera as tcam
from gaussian_mesh_splatting_tpu_torch.core.face_frames import face_frames as t_face_frames
from gaussian_mesh_splatting_tpu_torch.core.face_frames import face_scaling_rotation_quat as t_face_quat
from gaussian_mesh_splatting_tpu_torch.core import sh as tsh
from gaussian_mesh_splatting_tpu_torch.core import transforms as ttr

torch.set_num_threads(2)
ATOL = 1e-6


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", ["quat_to_rotmat", "rotmat_to_quat", "build_scaling_rotation",
                                  "covariance", "strip_unstrip", "inverse_sigmoid"])
def test_transforms_match_jax(name):
    rng = np.random.default_rng(0)
    q = _f32(rng, 64, 4)
    s = np.exp(_f32(rng, 64, 3) * 0.3 - 1.0)
    if name == "quat_to_rotmat":
        _close(ttr.quat_to_rotmat(torch.tensor(q)), jtr.quat_to_rotmat(jnp.asarray(q)))
    elif name == "rotmat_to_quat":
        rot = np.asarray(jtr.quat_to_rotmat(jnp.asarray(q)))
        _close(ttr.rotmat_to_quat(torch.tensor(rot)), jtr.rotmat_to_quat(jnp.asarray(rot)))
    elif name == "build_scaling_rotation":
        _close(ttr.build_scaling_rotation(torch.tensor(s), torch.tensor(q)),
               jtr.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q)))
    elif name == "covariance":
        _close(ttr.covariance_from_scaling_rotation(torch.tensor(s), 0.7, torch.tensor(q)),
               jtr.covariance_from_scaling_rotation(jnp.asarray(s), 0.7, jnp.asarray(q)))
    elif name == "strip_unstrip":
        six = _f32(rng, 64, 6)
        full = ttr.unstrip_symmetric(torch.tensor(six))
        _close(full, jtr.unstrip_symmetric(jnp.asarray(six)))
        _close(ttr.strip_symmetric(full), six)
    else:
        x = rng.uniform(0.01, 0.99, (64, 1)).astype(np.float32)
        _close(ttr.inverse_sigmoid(torch.tensor(x)), jtr.inverse_sigmoid(jnp.asarray(x)),
               atol=1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = _f32(rng, 128, 3, 25)
    d = _f32(rng, 128, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out_t = tsh.eval_sh(deg, torch.tensor(sh), torch.tensor(d))
    out_j = jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))
    if deg == 4:
        _close(out_t, out_j, atol=ATOL, rtol=1e-5)
    else:
        _close(out_t, out_j)


def test_rgb_sh_roundtrip_matches_jax():
    rgb = np.random.default_rng(5).random((32, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh(torch.tensor(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)), atol=1e-5)
    _close(tsh.sh_to_rgb(tsh.rgb_to_sh(torch.tensor(rgb))), rgb)
    assert tsh.C0 == jsh.C0 and tsh.C3 == jsh.C3 and tsh.C4 == jsh.C4


def test_camera_matches_jax():
    rng = np.random.default_rng(7)
    R = np.asarray(jtr.quat_to_rotmat(jnp.asarray(_f32(rng, 4))), np.float64)
    T = rng.standard_normal(3)
    trans = rng.standard_normal(3)
    args = (R, T, 0.8, 0.6, 200, 150)
    kw = dict(znear=0.05, zfar=50.0, trans=trans, scale=1.3)
    j = jcam.make_camera(*args, **kw)
    t = tcam.make_camera(*args, **kw, device="cpu")
    for f in ("world_view", "full_proj", "cam_center", "tanfovx", "tanfovy", "znear", "zfar"):
        _close(getattr(t, f), getattr(j, f), atol=1e-5)
        assert getattr(t, f).dtype == torch.float32, f
    assert (t.width, t.height) == (j.width, j.height)
    _close(t.focal_x, j.focal_x, atol=1e-3)
    _close(t.focal_y, j.focal_y, atol=1e-3)
    np.testing.assert_array_equal(tcam.world_to_view(R, T), jcam.world_to_view(R, T))
    np.testing.assert_array_equal(tcam.projection_matrix(0.01, 100.0, 0.8, 0.6),
                                  jcam.projection_matrix(0.01, 100.0, 0.8, 0.6))
    assert tcam.focal2fov(tcam.fov2focal(0.7, 300), 300) == pytest.approx(0.7)


def test_face_frames_match_jax():
    rng = np.random.default_rng(11)
    tri = _f32(rng, 96, 3, 3)
    frame_t = t_face_frames(torch.tensor(tri))
    frame_j = j_face_frames(jnp.asarray(tri))
    _close(frame_t.scales, frame_j.scales)
    _close(frame_t.rotation, frame_j.rotation, atol=1e-5)
    s_t, q_t = t_face_quat(torch.tensor(tri))
    s_j, q_j = j_face_quat(jnp.asarray(tri))
    _close(s_t, s_j)
    _close(q_t, q_j, atol=1e-5)
