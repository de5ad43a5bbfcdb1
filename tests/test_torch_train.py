"""The port's training slice against the JAX package on the CPU, on the same
numpy-seeded inputs: SSIM, the photometric loss and PSNR; the position LR
schedule; the per-group Adam against optax's `multi_transform`; one
`gs_mesh` train step from the same carried-over state (loss, every param's
gradient, the densification statistics); and three chained steps.

Tolerances and why:
  * SSIM, loss, PSNR: 1e-6, float32 rounding of the same operations;
  * expon_lr: 2.5e-7 relative, two float32 ulps: XLA's and PyTorch's
    float32 exp and log each round within about an ulp;
  * Adam: params within 1e-4 of each group's largest update plus two
    float32 ulps of the param. optax computes the bias correction
    1 - 0.999^t in float32, with 0.999 itself rounded (0.99900001), which
    puts its first updates up to 3e-5 (relative) off the exact value that
    torch's float64 bias correction gives (measured with zero params); torch
    also folds the update into the param with one addcdiv where optax adds
    it separately;
  * one step: loss 1e-5 relative; gradients 5e-4 * max|g| per param (the
    rasterizer's gradient bound, tests/test_raster_pallas.py);
  * three steps: losses 1e-4 relative; params within 3 * lr of their group,
    since Adam turns a gradient that is noise in both packages (~1e-20, of
    either sign) into a full +-lr update; vertices exactly unchanged at
    vertices_lr = 0.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.core.lr_schedule import expon_lr as j_expon_lr
from gaussian_mesh_splatting_tpu.models import mesh as jmesh
from gaussian_mesh_splatting_tpu.ops.ssim import ssim as j_ssim
from gaussian_mesh_splatting_tpu.renderer import render as j_render
from gaussian_mesh_splatting_tpu.train import loss as j_loss
from gaussian_mesh_splatting_tpu.train import make_optimizer as j_make_optimizer
from gaussian_mesh_splatting_tpu.train import make_train_state as j_make_train_state
from gaussian_mesh_splatting_tpu.train import make_train_step as j_make_train_step
from gaussian_mesh_splatting_tpu.train import optimization_config as j_optimization_config
from gaussian_mesh_splatting_tpu.train.loop import sh_degree_mask as j_sh_degree_mask
from gaussian_mesh_splatting_tpu_torch.core.lr_schedule import expon_lr
from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy, train_state_from_numpy
from gaussian_mesh_splatting_tpu_torch.models import mesh as tmesh
from gaussian_mesh_splatting_tpu_torch.ops.ssim import ssim
from gaussian_mesh_splatting_tpu_torch.train import (
    apply_lr_schedules,
    make_optimizer,
    make_train_step,
    optimization_config,
    photometric_loss,
    psnr,
)

from test_models import _icosahedron

torch.set_num_threads(2)
SH = 2
W, H = 48, 40


def _images(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.standard_normal((h, w, 3)).astype(np.float32) * 0.1, 0, 1)
    return a, b


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(size_average):
    a, b = _images(0)
    got = ssim(torch.tensor(a), torch.tensor(b), size_average=size_average).numpy()
    ref = np.asarray(j_ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_photometric_loss_and_psnr_match_jax():
    a, b = _images(1)
    total, l1 = photometric_loss(torch.tensor(a), torch.tensor(b), 0.2)
    j_total, j_l1 = j_loss.photometric_loss(jnp.asarray(a), jnp.asarray(b), 0.2)
    np.testing.assert_allclose(float(total), float(j_total), rtol=1e-6)
    np.testing.assert_allclose(float(l1), float(j_l1), rtol=1e-6)
    np.testing.assert_allclose(float(psnr(torch.tensor(a), torch.tensor(b))),
                               float(j_loss.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr_init=0.00016, lr_final=0.0000016, lr_delay_mult=0.01, max_steps=30_000),
    dict(lr_init=0.00016 * 3.7, lr_final=0.0000016 * 3.7, lr_delay_steps=500,
         lr_delay_mult=0.01, max_steps=30_000),
])
def test_expon_lr_matches_jax(kw):
    for step in [0, 1, 2, 7, 100, 499, 500, 1234, 15_000, 29_999, 30_000, 40_000]:
        ref = float(j_expon_lr(step, **kw))
        np.testing.assert_allclose(expon_lr(step, **kw), ref, rtol=2.5e-7, err_msg=str(step))
    assert expon_lr(-1, **kw) == 0.0


# ---------------------------------------------------------------- Adam

@pytest.mark.parametrize("gs_type,keys", [
    ("gs_mesh", {"vertices": (6, 3), "alpha": (4, 2, 3), "f_dc": (8, 1, 3),
                 "f_rest": (8, 8, 3), "opacity": (8, 1), "scale": (8, 1)}),
    ("gs", {"xyz": (8, 3), "f_dc": (8, 1, 3), "f_rest": (8, 8, 3), "opacity": (8, 1),
            "scaling": (8, 3), "rotation": (8, 4)}),
])
def test_adam_groups_match_optax(gs_type, keys):
    rng = np.random.default_rng(2)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in keys.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
              for k, s in keys.items()} for _ in range(3)]
    tx = j_make_optimizer(gs_type, j_optimization_config(gs_type), spatial_lr_scale=2.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_optimizer(tp, optimization_config(gs_type), spatial_lr_scale=2.5)
    for step, g in enumerate(grads):
        before = {k: np.asarray(v) for k, v in jp.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp.items():
            v.grad = torch.tensor(g[k])
        apply_lr_schedules(opt, step)
        opt.step()
        for k in keys:
            ref = np.asarray(jp[k])
            scale = float(np.abs(ref - before[k]).max())  # the group's largest update
            assert scale > 0 or k == "vertices"  # vertices_lr = 0: exactly unchanged
            np.testing.assert_allclose(tp[k].detach().numpy(), ref, rtol=2.5e-7,
                                       atol=1e-4 * scale, err_msg=f"{gs_type} {k} step {step}")


# ---------------------------------------------------------------- train steps

def _jax_camera(angle, dist=3.0):
    c = np.array([dist * np.sin(angle), 0.5, -dist * np.cos(angle)])
    fwd = -c / np.linalg.norm(c)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    rc2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return j_make_camera(rc2w, -rc2w.T @ c, 0.9, 0.9 * H / W, W, H)


def _to_torch_camera(jc):
    return camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                              for f in dataclasses.fields(jc)}, device="cpu")


def _train_state_numpy(ts):
    """A JAX TrainState -> the numpy mapping `train_state_from_numpy` takes."""
    adam = {}
    for k, masked in ts.opt_state.inner_states.items():
        st = masked.inner_state[0]  # optax ScaleByAdamState
        adam[k] = {"count": int(st.count), "mu": np.asarray(st.mu[k]), "nu": np.asarray(st.nu[k])}
    return {
        "step": int(ts.step), "active_sh_degree": int(ts.active_sh_degree),
        "params": {k: np.asarray(v) for k, v in ts.params.items()},
        "consts": {k: np.asarray(v) for k, v in ts.consts.items()},
        "alive": np.asarray(ts.alive),
        "stats": {k: np.asarray(getattr(ts.stats, k))
                  for k in ("grad_accum", "denom", "max_radii")},
        "adam": adam,
    }


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """A gs_mesh state on an icosahedron (40 Gaussians, SH 2), two cameras,
    GT rendered from a teacher, and the JAX state after one step with SH
    degree 1 active (so Adam moments and statistics are nonzero)."""
    verts, faces = _icosahedron()
    f = faces.shape[0]
    rng = np.random.default_rng(5)
    teacher = jmesh.init_from_mesh(verts, faces, jnp.asarray(rng.random((f, 2, 3))),
                                   jnp.asarray(rng.random((f * 2, 3))), sh_degree=SH)
    tp = dict(teacher["params"])
    tp["opacity"] = jnp.full_like(tp["opacity"], 1.5)
    tp["f_rest"] = jnp.asarray(rng.standard_normal(tp["f_rest"].shape).astype(np.float32) * 0.1)
    teacher = {**teacher, "params": tp}
    cams = [_jax_camera(a) for a in (0.3, 2.4)]
    bg = jnp.ones(3)
    render_gt = jax.jit(lambda cam: j_render(jmesh.to_bag(teacher), cam, bg, sh_degree=SH,
                                             backend="reference").image)
    gts = [render_gt(c) for c in cams]
    student = jmesh.init_from_mesh(verts, faces, jnp.asarray(rng.random((f, 2, 3))),
                                   jnp.full((f * 2, 3), 0.5), sh_degree=SH)
    sp = dict(student["params"])
    sp["f_rest"] = jnp.asarray(rng.standard_normal(sp["f_rest"].shape).astype(np.float32) * 0.05)
    student = {**student, "params": sp}
    cfg = j_optimization_config("gs_mesh")
    ts, tx = j_make_train_state("gs_mesh", student, cfg)
    j_step = j_make_train_step(jmesh, tx, cfg, SH, backend="reference")
    ts, _ = j_step(ts, cams[0], gts[0], bg)
    ts = ts.replace(active_sh_degree=jnp.asarray(1, jnp.int32))
    return cfg, cams, gts, bg, ts, j_step


def _torch_start():
    _, cams, gts, _, ts, _ = _jax_setup()
    cfg = optimization_config("gs_mesh")
    state = train_state_from_numpy("gs_mesh", _train_state_numpy(ts), cfg, device="cpu")
    step = make_train_step(tmesh, cfg, SH, backend="auto")
    return state, step, [_to_torch_camera(c) for c in cams], \
        [torch.tensor(np.asarray(g)) for g in gts], torch.ones(3)


def test_one_train_step_matches_jax():
    cfg, cams, gts, bg, ts, j_step = _jax_setup()

    def j_loss_fn(params, offset):
        bag = jmesh.to_bag({"params": params, "consts": ts.consts, "alive": ts.alive})
        bag = bag.replace(shs=j_sh_degree_mask(bag.shs, ts.active_sh_degree))
        out = j_render(bag, cams[1], bg, sh_degree=SH, backend="reference", mean2d_offset=offset)
        return j_loss.photometric_loss(out.image, gts[1], cfg.lambda_dssim)[0]

    j_grads = jax.jit(jax.grad(j_loss_fn))(ts.params, jnp.zeros((ts.alive.shape[0], 2)))
    ts2, j_metrics = j_step(ts, cams[1], gts[1], bg)

    state, _, tcams, tgts, tbg = _torch_start()
    stages = []  # the step's timing hook, called at each stage boundary
    step = make_train_step(tmesh, optimization_config("gs_mesh"), SH, mark=stages.append)
    state, metrics = step(state, tcams[1], tgts[1], tbg)

    assert stages == ["start", "to_bag", "render", "loss", "backward", "adam", "stats"]
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["l1"]), float(j_metrics["l1"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["psnr"]), float(j_metrics["psnr"]), rtol=1e-5)
    assert int(metrics["num_visible"]) == int(j_metrics["num_visible"]) > 0
    assert metrics["overflow"] == 0 and state.step == int(ts2.step) == 2
    for k, g in j_grads.items():
        g = np.asarray(g)
        got = state.params[k].grad.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, g, rtol=0, atol=5e-4 * float(np.abs(g).max()) + 1e-12,
                                   err_msg=f"gradient of {k}")
    assert np.abs(np.asarray(j_grads["alpha"])).max() > 0
    st, jst = state.stats, ts2.stats
    ref = np.asarray(jst.grad_accum)
    np.testing.assert_allclose(st.grad_accum.numpy(), ref, rtol=0,
                               atol=5e-4 * float(np.abs(ref).max()))
    np.testing.assert_array_equal(st.denom.numpy(), np.asarray(jst.denom))
    np.testing.assert_array_equal(st.max_radii.numpy(), np.asarray(jst.max_radii))


def test_three_chained_steps_match_jax():
    cfg, cams, gts, bg, ts, j_step = _jax_setup()
    state, step, tcams, tgts, tbg = _torch_start()
    v0 = state.params["vertices"].detach().clone()
    for i in range(3):
        c = (i + 1) % 2
        ts, j_metrics = j_step(ts, cams[c], gts[c], bg)
        state, metrics = step(state, tcams[c], tgts[c], tbg)
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-4,
                                   err_msg=f"loss of step {i}")
    lrs = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    for k, v in ts.params.items():
        diff = np.abs(state.params[k].detach().numpy() - np.asarray(v)).max()
        assert diff <= 3 * lrs[k], (k, diff, lrs[k])
    assert torch.equal(state.params["vertices"].detach(), v0)
    np.testing.assert_array_equal(state.params["vertices"].detach().numpy(),
                                  np.asarray(ts.params["vertices"]))
