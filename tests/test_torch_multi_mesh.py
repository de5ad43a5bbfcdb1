"""The port's `gs_multi_mesh` against the JAX package on the CPU, on the same
numpy-seeded inputs: `to_bag`; the gradients of a render loss w.r.t. every
per-mesh tensor; one and three train steps from the same carried-over state
(per-mesh tensors share one Adam group per key, as optax's `multi_transform`
labels them); a training checkpoint with list-valued params and moments; and
snapshots across the two packages.

Tolerances and why:
  * `to_bag`: 1e-6 absolute (float32 rounding of the same operations);
  * gradients: 5e-4 * max|g| per tensor, the rasterizer's gradient bound
    (tests/test_raster_pallas.py, tests/test_torch_train.py);
  * one step: loss 1e-5 relative, gradients as above; three steps: losses
    1e-4 relative, params within 3 * lr of their group (Adam turns a
    noise-level gradient into a full +-lr update; tests/test_torch_train.py);
  * checkpoints: bit for bit; snapshots: the sidecar's arrays bit for bit,
    the PLY's derived attributes to 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.io.snapshots import load_snapshot as j_load_snapshot
from gaussian_mesh_splatting_tpu.io.snapshots import save_snapshot as j_save_snapshot
from gaussian_mesh_splatting_tpu.models import multi_mesh as jmm
from gaussian_mesh_splatting_tpu.renderer import render as j_render
from gaussian_mesh_splatting_tpu.train import loss as j_loss
from gaussian_mesh_splatting_tpu.train import make_train_state as j_make_train_state
from gaussian_mesh_splatting_tpu.train import make_train_step as j_make_train_step
from gaussian_mesh_splatting_tpu.train import optimization_config as j_optimization_config
from gaussian_mesh_splatting_tpu.train.loop import sh_degree_mask as j_sh_degree_mask
from gaussian_mesh_splatting_tpu_torch.interop import (
    camera_from_numpy,
    state_from_numpy,
    train_state_from_numpy,
)
from gaussian_mesh_splatting_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from gaussian_mesh_splatting_tpu_torch.io.snapshots import load_snapshot, save_snapshot
from gaussian_mesh_splatting_tpu_torch.models import multi_mesh as tmm
from gaussian_mesh_splatting_tpu_torch.train import (
    make_train_state,
    make_train_step,
    optimization_config,
    photometric_loss,
)

from test_models import _icosahedron

torch.set_num_threads(2)
SH = 1
W, H = 48, 40
# vertices_lr > 0 (the config's default is 0) so that Adam moves the
# per-mesh vertices too
LR = {"vertices_lr": 1e-4}


def tree_np(tree):
    """A pytree of JAX arrays (dicts and lists) -> the same of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_np(v) for v in tree]
    return np.asarray(tree)


def train_state_numpy(ts):
    """A JAX TrainState -> the numpy mapping `train_state_from_numpy` takes
    (a list key's moments stay lists)."""
    adam = {}
    for k, masked in ts.opt_state.inner_states.items():
        st = masked.inner_state[0]  # optax ScaleByAdamState
        adam[k] = {"count": int(st.count), "mu": tree_np(st.mu[k]), "nu": tree_np(st.nu[k])}
    return {
        "step": int(ts.step), "active_sh_degree": int(ts.active_sh_degree),
        "params": tree_np(ts.params), "consts": tree_np(ts.consts),
        "alive": np.asarray(ts.alive),
        "stats": {k: np.asarray(getattr(ts.stats, k))
                  for k in ("grad_accum", "denom", "max_radii")},
        "adam": adam,
    }


def leaves(v):
    return v if isinstance(v, list) else [v]


def jax_camera(angle, dist=3.0, w=W, h=H):
    c = np.array([dist * np.sin(angle), 0.5, -dist * np.cos(angle)])
    fwd = -c / np.linalg.norm(c)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    rc2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return j_make_camera(rc2w, -rc2w.T @ c, 0.9, 0.9 * h / w, w, h)


def to_torch_camera(jc):
    return camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                              for f in dataclasses.fields(jc)}, device="cpu")


def _meshes():
    verts, faces = _icosahedron()
    verts = np.asarray(verts)
    return [verts, verts * 0.6 + np.array([0.45, -0.2, 0.1], np.float32)], \
        [np.asarray(faces)] * 2


def _jax_state(seed, splats=(2, 3), colors=None):
    """A randomized JAX multi-mesh state: two meshes of S_i splats each,
    raw alphas that the relu clips in places, varied scales and opacities."""
    rng = np.random.default_rng(seed)
    verts, faces = _meshes()
    alphas = [(rng.random((f.shape[0], s, 3)) * 1.2 - 0.1).astype(np.float32)
              for f, s in zip(faces, splats)]
    n = sum(a.shape[0] * a.shape[1] for a in alphas)
    cols = rng.random((n, 3)).astype(np.float32) if colors is None else np.full((n, 3), colors)
    st = jmm.init_from_meshes([jnp.asarray(v) for v in verts], [jnp.asarray(f) for f in faces],
                              [jnp.asarray(a) for a in alphas], jnp.asarray(cols, jnp.float32),
                              sh_degree=SH)
    p = dict(st["params"])
    p["scale"] = [jnp.asarray(rng.uniform(0.6, 1.6, s.shape).astype(np.float32))
                  for s in p["scale"]]
    p["f_rest"] = jnp.asarray((rng.standard_normal(p["f_rest"].shape) * 0.1).astype(np.float32))
    p["opacity"] = jnp.asarray((rng.standard_normal((n, 1)) + 1.0).astype(np.float32))
    return {**st, "params": p}


def _close(t, j, atol=1e-6, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol, err_msg=msg)


@pytest.mark.parametrize("override", [False, True])
def test_to_bag_matches_jax(override):
    jstate = _jax_state(0)
    tstate = state_from_numpy("gs_multi_mesh", tree_np(jstate), device="cpu")
    assert [f.dtype for f in tstate["consts"]["faces"]] == [torch.int64] * 2
    tris = None
    if override:  # the animation hook: each mesh's triangles moved a little
        rng = np.random.default_rng(3)
        tris = [(v[f] + rng.standard_normal((20, 3, 3)) * 0.02).astype(np.float32)
                for v, f in zip(*_meshes())]
    jbag = jmm.to_bag(jstate, None if tris is None else [jnp.asarray(t) for t in tris])
    tbag = tmm.to_bag(tstate, None if tris is None else [torch.tensor(t) for t in tris])
    assert tbag.xyz.shape == (20 * 2 + 20 * 3, 3)
    for name in ("xyz", "scaling", "rotation", "opacity", "shs"):
        _close(getattr(tbag, name), getattr(jbag, name), msg=name)
    assert torch.equal(tbag.alive, torch.tensor(np.asarray(jbag.alive)))


def _loss_setup():
    jstate = _jax_state(1)
    teacher = _jax_state(2)
    jc = jax_camera(0.4)
    gt = j_render(jmm.to_bag(teacher), jc, jnp.zeros(3), sh_degree=SH,
                  backend="reference").image
    return jstate, jc, gt


def test_render_loss_gradients_match_jax():
    """d(photometric loss)/d(every param), per-mesh tensors included."""
    jstate, jc, gt = _loss_setup()

    def j_loss_fn(params):
        bag = jmm.to_bag({**jstate, "params": params})
        out = j_render(bag, jc, jnp.zeros(3), sh_degree=SH, backend="reference")
        return j_loss.photometric_loss(out.image, gt, 0.2)[0]

    j_grads = jax.jit(jax.grad(j_loss_fn))(jstate["params"])
    tstate = make_train_state(state_from_numpy("gs_multi_mesh", tree_np(jstate), device="cpu"),
                              optimization_config("gs_multi_mesh"))
    from gaussian_mesh_splatting_tpu_torch.renderer import render as t_render

    out = t_render(tmm.to_bag(tstate.model_state()), to_torch_camera(jc), torch.zeros(3),
                   sh_degree=SH)
    photometric_loss(out.image, torch.tensor(np.asarray(gt)), 0.2)[0].backward()
    for k, jg in j_grads.items():
        for i, (t, g) in enumerate(zip(leaves(tstate.params[k]), leaves(jg))):
            g = np.asarray(g)
            assert np.abs(g).max() > 0, (k, i)
            _close(t.grad, g, atol=5e-4 * float(np.abs(g).max()), msg=f"{k}[{i}]")


@functools.lru_cache(maxsize=None)
def _jax_train_setup():
    """Student, two cameras, GT from a teacher, and the JAX state after one
    step with SH degree 1 active (nonzero moments and statistics)."""
    student = _jax_state(4, colors=0.5)
    teacher = _jax_state(5)
    cams = [jax_camera(a) for a in (0.3, 2.4)]
    bg = jnp.ones(3)
    render_gt = jax.jit(lambda cam: j_render(jmm.to_bag(teacher), cam, bg, sh_degree=SH,
                                             backend="reference").image)
    gts = [render_gt(c) for c in cams]
    cfg = j_optimization_config("gs_multi_mesh", **LR)
    ts, tx = j_make_train_state("gs_multi_mesh", student, cfg)
    j_step = j_make_train_step(jmm, tx, cfg, SH, backend="reference")
    ts, _ = j_step(ts, cams[0], gts[0], bg)
    ts = ts.replace(active_sh_degree=jnp.asarray(1, jnp.int32))
    return cfg, cams, gts, bg, ts, j_step


def _torch_start():
    _, cams, gts, _, ts, _ = _jax_train_setup()
    cfg = optimization_config("gs_multi_mesh", **LR)
    state = train_state_from_numpy("gs_multi_mesh", train_state_numpy(ts), cfg, device="cpu")
    return state, make_train_step(tmm, cfg, SH), [to_torch_camera(c) for c in cams], \
        [torch.tensor(np.asarray(g)) for g in gts], torch.ones(3)


def test_train_state_holds_one_adam_group_per_key():
    state, _, _, _, _ = _torch_start()
    groups = {g["name"]: g for g in state.optimizer.param_groups}
    assert list(groups) == list(state.params)
    for k in ("vertices", "alpha", "scale"):
        assert isinstance(state.params[k], list) and len(state.params[k]) == 2
        assert all(a is b for a, b in zip(groups[k]["params"], state.params[k]))
        assert all(p.is_leaf and p.requires_grad for p in state.params[k])
        assert all(float(state.optimizer.state[p]["step"]) == 1.0 for p in state.params[k])
    assert groups["vertices"]["lr"] == LR["vertices_lr"]


def test_one_train_step_matches_jax():
    cfg, cams, gts, bg, ts, j_step = _jax_train_setup()

    def j_loss_fn(params, offset):
        bag = jmm.to_bag({"params": params, "consts": ts.consts, "alive": ts.alive})
        bag = bag.replace(shs=j_sh_degree_mask(bag.shs, ts.active_sh_degree))
        out = j_render(bag, cams[1], bg, sh_degree=SH, backend="reference", mean2d_offset=offset)
        return j_loss.photometric_loss(out.image, gts[1], cfg.lambda_dssim)[0]

    j_grads = jax.jit(jax.grad(j_loss_fn))(ts.params, jnp.zeros((ts.alive.shape[0], 2)))
    ts2, j_metrics = j_step(ts, cams[1], gts[1], bg)
    state, step, tcams, tgts, tbg = _torch_start()
    state, metrics = step(state, tcams[1], tgts[1], tbg)
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    assert int(metrics["num_visible"]) == int(j_metrics["num_visible"]) > 0
    assert state.step == int(ts2.step) == 2
    for k, jg in j_grads.items():
        for i, (t, g) in enumerate(zip(leaves(state.params[k]), leaves(jg))):
            g = np.asarray(g)
            assert np.isfinite(t.grad.numpy()).all(), (k, i)
            _close(t.grad, g, atol=5e-4 * float(np.abs(g).max()) + 1e-12, msg=f"{k}[{i}]")
    np.testing.assert_array_equal(state.stats.denom.numpy(), np.asarray(ts2.stats.denom))
    np.testing.assert_array_equal(state.stats.max_radii.numpy(), np.asarray(ts2.stats.max_radii))


def test_three_chained_steps_match_jax():
    cfg, cams, gts, bg, ts, j_step = _jax_train_setup()
    state, step, tcams, tgts, tbg = _torch_start()
    a0 = [a.detach().clone() for a in state.params["alpha"]]
    for i in range(3):
        c = (i + 1) % 2
        ts, j_metrics = j_step(ts, cams[c], gts[c], bg)
        state, metrics = step(state, tcams[c], tgts[c], tbg)
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-4,
                                   err_msg=f"loss of step {i}")
    lrs = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    for k, v in ts.params.items():
        for t, j in zip(leaves(state.params[k]), leaves(v)):
            diff = np.abs(t.detach().numpy() - np.asarray(j)).max()
            assert diff <= 3 * lrs[k], (k, diff, lrs[k])
    # every per-mesh alpha moved
    assert all(not torch.equal(a, b.detach()) for a, b in zip(a0, state.params["alpha"]))


def _assert_states_equal(a, b):
    assert a.step == b.step and a.active_sh_degree == b.active_sh_degree
    assert sorted(a.params) == sorted(b.params)
    for k in a.params:
        assert type(a.params[k]) is type(b.params[k]), k
        for pa, pb in zip(leaves(a.params[k]), leaves(b.params[k])):
            assert torch.equal(pa.detach(), pb.detach()), k
            ma, mb = a.optimizer.state.get(pa, {}), b.optimizer.state.get(pb, {})
            assert set(ma) == set(mb) and all(torch.equal(ma[n], mb[n]) for n in ma), k
    for fa, fb in zip(a.consts["faces"], b.consts["faces"]):
        assert torch.equal(fa, fb)
    for k in ("grad_accum", "denom", "max_radii"):
        assert torch.equal(getattr(a.stats, k), getattr(b.stats, k)), k


def test_checkpoint_with_list_params_restores_every_tensor_and_the_next_step(tmp_path):
    state, step, tcams, tgts, tbg = _torch_start()
    step(state, tcams[1], tgts[1], tbg)
    path = str(tmp_path / "chkpnt2.pt")
    save_checkpoint(path, state)
    cfg = optimization_config("gs_multi_mesh", **LR)
    template = make_train_state(state_from_numpy("gs_multi_mesh", tree_np(_jax_state(9)),
                                                 device="cpu"), cfg)
    restored = restore_checkpoint(path, template)
    assert all(g["params"] == leaves(restored.params[g["name"]])
               for g in restored.optimizer.param_groups)
    assert len(restored.optimizer.state) == sum(len(leaves(v)) for v in restored.params.values())
    _assert_states_equal(restored, state)
    _, m_a = step(state, tcams[0], tgts[0], tbg)
    _, m_b = step(restored, tcams[0], tgts[0], tbg)
    assert float(m_a["loss"]) == float(m_b["loss"])
    _assert_states_equal(restored, state)


def test_checkpoint_refuses_another_mesh_count(tmp_path):
    state, _, _, _, _ = _torch_start()
    path = str(tmp_path / "chkpnt.pt")
    save_checkpoint(path, state)
    one = _jax_state(9)
    one = {"params": {k: v[:1] if isinstance(v, list) else v for k, v in one["params"].items()},
           "consts": {"faces": one["consts"]["faces"][:1]}, "alive": one["alive"]}
    template = make_train_state(state_from_numpy("gs_multi_mesh", tree_np(one), device="cpu"),
                                optimization_config("gs_multi_mesh"))
    with pytest.raises(ValueError, match="lists of lengths"):
        restore_checkpoint(path, template)


def test_snapshot_written_by_jax_loads_in_the_port(tmp_path):
    jstate = _jax_state(6)
    j_save_snapshot("gs_multi_mesh", jmm, jstate, str(tmp_path))
    faces = [torch.tensor(np.asarray(f), dtype=torch.int64) for f in jstate["consts"]["faces"]]
    got = load_snapshot("gs_multi_mesh", str(tmp_path), sh_degree=SH, consts={"faces": faces},
                        device="cpu")
    for k, v in jstate["params"].items():
        assert isinstance(got["params"][k], list) == isinstance(v, list), k
        for t, j in zip(leaves(got["params"][k]), leaves(v)):
            assert torch.equal(t, torch.tensor(np.asarray(j))), k
    jbag = jmm.to_bag(jstate)
    tbag = tmm.to_bag(got)
    _close(tbag.xyz, jbag.xyz)
    _close(tbag.scaling, jbag.scaling)


def test_snapshot_written_by_the_port_loads_in_jax(tmp_path):
    jstate = _jax_state(7)
    tstate = state_from_numpy("gs_multi_mesh", tree_np(jstate), device="cpu")
    save_snapshot("gs_multi_mesh", tmm, tstate, str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_params.npz", "point_cloud.ply"]
    with np.load(tmp_path / "model_params.npz") as side:
        assert sorted(side.files) == ["alpha/0", "alpha/1", "scale/0", "scale/1", "vertices/0",
                                      "vertices/1"]
    ref = j_load_snapshot("gs_multi_mesh", str(tmp_path), sh_degree=SH,
                          consts={"faces": jstate["consts"]["faces"]})
    for k, v in jstate["params"].items():
        for j, r in zip(leaves(v), leaves(ref["params"][k])):
            np.testing.assert_array_equal(np.asarray(r), np.asarray(j), err_msg=k)
    _close(tmm.to_bag(tstate).xyz, jmm.to_bag(ref).xyz)
