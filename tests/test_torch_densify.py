"""The port's density control (`train/densify.py`) against the JAX package's
on the CPU: the scenarios of tests/test_densify.py run through both packages
from the same carried-over state, with the split noise drawn by
`jax.random.normal` from the key the JAX function gets and handed to the
port as numpy.

What must agree, and how closely:
  * `alive`, every `info` count and the row assignment: exactly. Every row
    has its own colour, and `f_dc`, `f_rest`, `opacity` and `rotation` are
    only ever copied, so they are compared bit for bit over the whole
    buffer, dead rows included;
  * `xyz` and `scaling`: copied rows bit for bit; split-born rows within
    1e-6 (mean + R @ noise and log(exp(s) / 1.6) round differently in XLA and
    PyTorch);
  * Adam moments: bit for bit (gathered and zeroed, never computed);
  * the chained run (steps, an event, steps), the port carried over from the
    JAX state before every step: losses 1e-5 relative; after the first step
    (zero moments: Adam moves every element by +-lr whatever its gradient's
    size) params within 1e-4 of their group's largest update plus two float32
    ulps, the Adam bound of tests/test_torch_train.py; after a later step
    within 3 * lr of their group, that file's bound for chained steps: the
    update then follows the ratio of this gradient to the last, and an
    element whose gradient is small beside the rasterizer's bound of
    5e-4 * max|g| moves by up to a tenth of lr more in one package than in
    the other (measured: 2e-4 to 0.1 of the largest update).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.models import flat as jflat
from gaussian_mesh_splatting_tpu.models import vanilla as jvanilla
from gaussian_mesh_splatting_tpu.renderer import render as j_render
from gaussian_mesh_splatting_tpu.train import densify_and_prune as j_densify_and_prune
from gaussian_mesh_splatting_tpu.train import grow_capacity as j_grow_capacity
from gaussian_mesh_splatting_tpu.train import make_train_state as j_make_train_state
from gaussian_mesh_splatting_tpu.train import make_train_step as j_make_train_step
from gaussian_mesh_splatting_tpu.train import optimization_config as j_optimization_config
from gaussian_mesh_splatting_tpu.train import reset_opacity as j_reset_opacity
from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy, train_state_from_numpy
from gaussian_mesh_splatting_tpu_torch.models import vanilla as tvanilla
from gaussian_mesh_splatting_tpu_torch.train import (
    apply_lr_schedules,
    densify_and_prune,
    grow_capacity,
    make_train_step,
    optimization_config,
    reset_opacity,
)
from gaussian_mesh_splatting_tpu_torch.train import densify as t_densify

from test_torch_train import _train_state_numpy

torch.set_num_threads(2)
N, C = 8, 32
EVENT = dict(grad_threshold=2e-4, min_opacity=0.005, percent_dense=0.01)
MOMENTS = {"exp_avg": "mu", "exp_avg_sq": "nu"}


def _jax_state(n=N, capacity=C, gs_type="gs", seed=0, warm_steps=0):
    """A JAX TrainState on `capacity` rows, `n` alive, every row its own
    colour; `warm_steps` optax updates give it nonzero Adam moments."""
    rng = np.random.default_rng(seed)
    mod = jvanilla if gs_type == "gs" else jflat
    pts = (rng.standard_normal((n, 3)) * 0.5).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    mstate = mod.init_from_points(jnp.asarray(pts), jnp.asarray(cols), sh_degree=1,
                                  capacity=capacity)
    p = dict(mstate["params"])
    for k in ("f_dc", "f_rest", "rotation"):  # distinct in every row, dead ones too
        p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32) * 0.1)
    ts, tx = j_make_train_state(gs_type, {**mstate, "params": p}, j_optimization_config(gs_type))
    for i in range(warm_steps):
        g = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), ts.params)
        updates, opt_state = tx.update(g, ts.opt_state, ts.params)
        ts = ts.replace(params=optax.apply_updates(ts.params, updates), opt_state=opt_state)
    return ts, tx


def _with_stats(ts, hot=(), grad=1.0, radii=None):
    ga, dn, mr = (np.asarray(getattr(ts.stats, k)).copy()
                  for k in ("grad_accum", "denom", "max_radii"))
    hot = list(hot)
    ga[hot] = grad
    dn[hot] = 1.0
    if radii is not None:
        mr[hot] = radii
    return ts.replace(stats=ts.stats.replace(
        grad_accum=jnp.asarray(ga), denom=jnp.asarray(dn), max_radii=jnp.asarray(mr)))


def _to_torch(ts, gs_type="gs"):
    return train_state_from_numpy(gs_type, _train_state_numpy(ts), optimization_config(gs_type),
                                  device="cpu")


def _both_events(ts, key_seed, gs_type="gs", **kw):
    """One event in both packages from the same state and the same noise.
    Returns (JAX state before, JAX state after, JAX info, port state, port
    info)."""
    kw = {**EVENT, "scaling_cols": 3 if gs_type == "gs" else 2, **kw}
    key = jax.random.key(key_seed)
    capacity = ts.alive.shape[0]
    noise = np.array(jax.random.normal(key, (2, capacity, 3)))
    state = _to_torch(ts, gs_type)
    leaves = dict(state.params)
    ts_new, j_info = j_densify_and_prune(ts, key, **kw)
    state, info = densify_and_prune(state, noise=noise, **kw)
    # in place: the leaves and the optimizer's params are the objects they were
    assert all(state.params[k] is v for k, v in leaves.items())
    assert all(g["params"][0] is leaves[g["name"]] for g in state.optimizer.param_groups)
    return ts, ts_new, j_info, state, info


def _assert_same_event(ts_old, ts_new, j_info, state, info):
    assert set(info) == set(j_info)
    for k, v in info.items():
        assert v.ndim == 0 and int(v) == int(j_info[k]), (k, int(v), int(j_info[k]))
    np.testing.assert_array_equal(state.alive.numpy(), np.asarray(ts_new.alive))
    for k in ("f_dc", "f_rest", "opacity", "rotation"):
        np.testing.assert_array_equal(state.params[k].detach().numpy(),
                                      np.asarray(ts_new.params[k]), err_msg=k)
    old_xyz, new_xyz = np.asarray(ts_old.params["xyz"]), np.asarray(ts_new.params["xyz"])
    copied = (new_xyz[:, None, :] == old_xyz[None]).all(-1).any(-1)
    for k in ("xyz", "scaling"):
        got, ref = state.params[k].detach().numpy(), np.asarray(ts_new.params[k])
        np.testing.assert_array_equal(got[copied], ref[copied], err_msg=k)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=k)
    j_adam = _train_state_numpy(ts_new)["adam"]
    for group in state.optimizer.param_groups:
        moments = state.optimizer.state[group["params"][0]]
        assert float(moments["step"]) == j_adam[group["name"]]["count"]
        for t_name, j_name in MOMENTS.items():
            np.testing.assert_array_equal(moments[t_name].numpy(), j_adam[group["name"]][j_name],
                                          err_msg=f"{group['name']} {t_name}")
    for k in ("grad_accum", "denom", "max_radii"):
        assert not getattr(state.stats, k).any()
    return copied


# ---------------------------------------------------------------- the scenarios

@pytest.mark.parametrize("gs_type", ["gs", "gs_flat"])
def test_clone_small_high_grad_gaussians(gs_type):
    ts, _ = _jax_state(gs_type=gs_type, warm_steps=2)
    ts = _with_stats(ts, hot=range(4), grad=[0.3, 0.9, 0.5, 0.7])
    out = _both_events(ts, 1, gs_type, extent=1e6, size_threshold=0.0)  # all "small"
    copied = _assert_same_event(*out)
    info, state = out[4], out[3]
    assert (int(info["n_clone"]), int(info["n_split_rows"]), int(info["n_alive"])) == (4, 0, 12)
    assert copied.all()
    # clones fill the free rows in row order, by falling gradient: rows 1, 3, 2, 0
    np.testing.assert_array_equal(state.params["xyz"][8:12].detach().numpy(),
                                  np.asarray(ts.params["xyz"])[[1, 3, 2, 0]])


@pytest.mark.parametrize("gs_type", ["gs", "gs_flat"])
def test_split_large_high_grad_gaussians(gs_type):
    ts, _ = _jax_state(gs_type=gs_type, warm_steps=2)
    ts = _with_stats(ts, hot=range(2), grad=[0.4, 0.8])
    out = _both_events(ts, 2, gs_type, extent=1e-6, size_threshold=0.0)  # all "large"
    copied = _assert_same_event(*out)
    info, state = out[4], out[3]
    assert (int(info["n_split_rows"]), int(info["n_alive"])) == (4, 10)
    # the children take the originals' rows 0, 1, then fresh rows 8, 9; both
    # samples of the hotter row 1 come first; each has its source's scale / 1.6
    assert not copied[[0, 1, 8, 9]].any() and copied[2:8].all()
    old = np.exp(np.asarray(ts.params["scaling"]))
    new = np.exp(state.params["scaling"].detach().numpy())
    np.testing.assert_allclose(new[[0, 1]], old[[1, 1]] / 1.6, rtol=1e-5)
    np.testing.assert_allclose(new[[8, 9]], old[[0, 0]] / 1.6, rtol=1e-5)
    if gs_type == "gs_flat":
        assert state.params["scaling"].shape == (C, 2)


def test_prune_low_opacity():
    ts, _ = _jax_state(warm_steps=1)
    op = np.asarray(ts.params["opacity"]).copy()
    op[:3] = np.log(0.001 / 0.999)
    ts = ts.replace(params=dict(ts.params, opacity=jnp.asarray(op)))
    out = _both_events(ts, 3, extent=1.0, size_threshold=0.0)
    _assert_same_event(*out)
    info, state = out[4], out[3]
    assert int(info["n_alive"]) == 5 and int(info["n_pruned_opacity"]) == 3
    assert not state.alive[:3].any()
    # a dead row keeps its params and its moments
    np.testing.assert_array_equal(state.params["xyz"][:3].detach().numpy(),
                                  np.asarray(ts.params["xyz"])[:3])


def test_optimizer_moments_follow_rows():
    ts, _ = _jax_state(warm_steps=2)
    ts = _with_stats(ts, hot=[0])
    out = _both_events(ts, 4, extent=1e6, size_threshold=0.0)
    _assert_same_event(*out)
    state = out[3]
    assert int(out[4]["n_clone"]) == 1 and bool(state.alive[8])
    j_adam = _train_state_numpy(ts)["adam"]
    for group in state.optimizer.param_groups:
        moments = state.optimizer.state[group["params"][0]]
        for t_name, j_name in MOMENTS.items():
            old = j_adam[group["name"]][j_name]
            assert np.abs(old[:8]).min() > 0
            np.testing.assert_array_equal(moments[t_name][:8].numpy(), old[:8])  # survivors keep
            assert not moments[t_name][8].any()  # the clone starts at zero
        assert float(moments["step"]) == 2.0


def test_capacity_overflow_drops_candidates():
    ts, _ = _jax_state(n=30, warm_steps=1)
    grads = np.random.default_rng(1).random(30) + 0.1
    ts = _with_stats(ts, hot=range(30), grad=grads)
    out = _both_events(ts, 5, extent=1e6, size_threshold=0.0)
    _assert_same_event(*out)
    info, state = out[4], out[3]
    assert int(info["n_alive"]) == C and int(info["overflow"]) == 28
    assert int(info["n_clone"]) == 2
    # the two free rows go to the two hottest rows
    best = np.argsort(-grads)[:2]
    np.testing.assert_array_equal(state.params["xyz"][30:].detach().numpy(),
                                  np.asarray(ts.params["xyz"])[best])


def test_screen_size_pruned_rows_still_densify():
    ts, _ = _jax_state(warm_steps=1)
    ts = _with_stats(ts, hot=range(N), grad=np.linspace(1.0, 2.0, N), radii=50.0)
    out = _both_events(ts, 3, extent=1e6, percent_dense=0.0, size_threshold=20.0)
    _assert_same_event(*out)
    info = out[4]
    assert int(info["n_pruned"]) == N and int(info["n_pruned_screen"]) == N
    assert int(info["n_pruned_world"]) == 0
    assert int(info["n_alive"]) == 2 * N  # each left two split children


def test_opacity_pruned_rows_do_not_densify():
    ts, _ = _jax_state(warm_steps=1)
    ts = ts.replace(params=dict(ts.params, opacity=jnp.full_like(ts.params["opacity"], -10.0)))
    ts = _with_stats(ts, hot=range(N))
    out = _both_events(ts, 4, extent=1e6, percent_dense=0.0, size_threshold=20.0)
    _assert_same_event(*out)
    assert int(out[4]["n_alive"]) == 0 and int(out[4]["n_pruned_opacity"]) == N


def test_mixed_event_clones_splits_and_prunes_with_overflow():
    """Clones, splits, opacity and world-size prunes in one event, with more
    candidates than free rows: clones are placed before split samples."""
    ts, _ = _jax_state(n=24, warm_steps=2, seed=3)
    sc = np.asarray(ts.params["scaling"]).copy()
    sc[:6] = 0.5  # large: rows 0-5 split (and are over 0.1 * extent)
    sc[6:24] = -3.0  # small: the hot ones among them clone
    op = np.asarray(ts.params["opacity"]).copy()
    op[20:24] = -9.0
    ts = ts.replace(params=dict(ts.params, scaling=jnp.asarray(sc), opacity=jnp.asarray(op)))
    ts = _with_stats(ts, hot=range(14), grad=np.linspace(2.0, 1.0, 14))
    # percent_dense * extent = 0.1: exp(0.5) splits, exp(-3) clones
    out = _both_events(ts, 6, extent=10.0, size_threshold=20.0)
    _assert_same_event(*out)
    info = {k: int(v) for k, v in out[4].items()}
    assert info["n_clone"] == 8 and info["n_pruned_opacity"] == 4 and info["n_pruned_world"] == 6
    assert info["n_pruned"] == 10  # 4 by opacity, 6 split (which are also the world-size ones)
    # 18 free rows: the 8 clones first, then 10 of the 12 split samples
    assert info["n_split_rows"] == 10 and info["overflow"] == 2 and info["n_alive"] == 32


def test_tied_gradients_need_a_stable_sort(monkeypatch):
    """Every hot row has the same gradient: the order among ties is the row
    order (a stable sort), and it decides which Gaussian lands in which row.
    With a sort that breaks ties the other way the port disagrees with the
    JAX package, so this test does tell the two apart."""
    ts, _ = _jax_state(n=12, warm_steps=1)
    ts = _with_stats(ts, hot=range(12), grad=1.0)
    out = _both_events(ts, 7, extent=1e6, size_threshold=0.0)
    _assert_same_event(*out)
    np.testing.assert_array_equal(out[3].params["xyz"][12:24].detach().numpy(),
                                  np.asarray(ts.params["xyz"])[:12])

    real_argsort = torch.argsort

    def ties_reversed(x, **kw):
        return x.shape[0] - 1 - real_argsort(x.flip(0), stable=True)

    monkeypatch.setattr(t_densify.torch, "argsort", ties_reversed)
    with pytest.raises(AssertionError):
        _assert_same_event(*_both_events(ts, 7, extent=1e6, size_threshold=0.0))


def test_densify_draws_its_noise_from_the_generator():
    ts, _ = _jax_state()
    ts = _with_stats(ts, hot=range(2))
    kw = dict(**EVENT, extent=1e-6, size_threshold=0.0, scaling_cols=3)

    def run(seed):
        state, _ = densify_and_prune(_to_torch(ts), generator=torch.Generator().manual_seed(seed),
                                     **kw)
        return state.params["xyz"].detach().clone()

    assert torch.equal(run(5), run(5)) and not torch.equal(run(5), run(6))
    with pytest.raises(ValueError, match="noise must be"):
        densify_and_prune(_to_torch(ts), noise=np.zeros((2, C + 1, 3), np.float32), **kw)


def test_densify_before_the_first_optimizer_step():
    """A state that has taken no step has no Adam moments to gather."""
    ts, _ = _jax_state()
    state = _to_torch(_with_stats(ts, hot=range(4)))
    state.optimizer.state.clear()
    state, info = densify_and_prune(state, noise=np.zeros((2, C, 3), np.float32), **EVENT,
                                    extent=1e6, size_threshold=0.0, scaling_cols=3)
    assert int(info["n_clone"]) == 4 and not state.optimizer.state


# ---------------------------------------------------------------- reset, grow

@pytest.mark.parametrize("stepped", [False, True])
def test_opacity_reset(stepped):
    ts, _ = _jax_state(warm_steps=2 if stepped else 0)
    op = np.asarray(ts.params["opacity"]).copy()
    op[:4] = -7.0  # already below 0.01: unchanged
    ts = ts.replace(params=dict(ts.params, opacity=jnp.asarray(op)))
    state = _to_torch(ts)
    if not stepped:
        state.optimizer.state.clear()  # torch's Adam before its first step
    ts_new = j_reset_opacity(ts)
    state = reset_opacity(state)
    np.testing.assert_allclose(state.params["opacity"].detach().numpy(),
                               np.asarray(ts_new.params["opacity"]), rtol=1e-6)
    act = torch.sigmoid(state.params["opacity"].detach())
    np.testing.assert_allclose(act[4:N].numpy(), 0.01, atol=1e-6)
    assert float(act[:4].max()) < 0.001
    if stepped:
        j_adam = _train_state_numpy(ts_new)["adam"]
        for group in state.optimizer.param_groups:
            moments = state.optimizer.state[group["params"][0]]
            for t_name, j_name in MOMENTS.items():
                np.testing.assert_array_equal(moments[t_name].numpy(),
                                              j_adam[group["name"]][j_name])
            assert float(moments["step"]) == 2.0  # the opacity group's too
            assert bool(moments["exp_avg"].any()) == (group["name"] != "opacity")
    else:
        assert not state.optimizer.state


def test_grow_capacity_preserves_rows():
    ts, tx = _jax_state(n=8, capacity=16, warm_steps=2)
    ts = _with_stats(ts, hot=range(3), radii=7.0)
    state = _to_torch(ts)
    lrs = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    ts_new = j_grow_capacity(ts, tx, 64)
    state = grow_capacity(state, 64)
    assert state.alive.shape == (64,) and int(state.alive.sum()) == 8
    np.testing.assert_array_equal(state.alive.numpy(), np.asarray(ts_new.alive))
    j_adam = _train_state_numpy(ts_new)["adam"]
    for group in state.optimizer.param_groups:
        k = group["name"]
        (p,) = group["params"]
        assert p is state.params[k] and p.is_leaf and p.requires_grad and group["lr"] == lrs[k]
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(ts_new.params[k]), err_msg=k)
        moments = state.optimizer.state[p]
        assert float(moments["step"]) == 2.0
        for t_name, j_name in MOMENTS.items():
            np.testing.assert_array_equal(moments[t_name].numpy(), j_adam[k][j_name])
    for k in ("grad_accum", "denom", "max_radii"):
        np.testing.assert_array_equal(getattr(state.stats, k).numpy(),
                                      np.asarray(getattr(ts_new.stats, k)))
    assert torch.equal(state.params["rotation"][16:, 0], torch.ones(48))
    assert torch.equal(state.params["scaling"][16:], torch.full((48, 3), -10.0))
    # the grown state still steps, and the xyz schedule came along
    for p in state.params.values():
        p.grad = torch.ones_like(p)
    apply_lr_schedules(state.optimizer, 2)
    state.optimizer.step()
    assert all(float(state.optimizer.state[p]["step"]) == 3.0 for p in state.params.values())
    with pytest.raises(ValueError, match="must exceed"):
        grow_capacity(state, 64)


# ---------------------------------------------------------------- the chained run

def test_train_steps_with_an_event_match_jax():
    """Two `gs` train steps, one densify event, two more steps, in both
    packages (the JAX side with backend="reference")."""
    w, h, sh = 48, 40, 1
    rng = np.random.default_rng(11)
    jc = j_make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.9, 0.9 * h / w, w, h)
    tc = camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                            for f in dataclasses.fields(jc)}, device="cpu")
    pts = (rng.standard_normal((24, 3)) * 0.4).astype(np.float32)
    teacher = jvanilla.init_from_points(jnp.asarray(pts), jnp.asarray(rng.random((24, 3))),
                                        sh_degree=sh)
    tp = dict(teacher["params"])
    tp["opacity"] = jnp.full_like(tp["opacity"], 2.0)
    tp["scaling"] = tp["scaling"] + 0.5
    bg = jnp.ones(3)
    gt = j_render(jvanilla.to_bag({**teacher, "params": tp}), jc, bg, sh_degree=sh,
                  backend="reference").image
    student = jvanilla.init_from_points(
        jnp.asarray(pts + rng.standard_normal(pts.shape).astype(np.float32) * 0.05),
        jnp.full((24, 3), 0.5), sh_degree=sh, capacity=64)
    sp = dict(student["params"])
    sp["scaling"] = sp["scaling"].at[:12].add(0.5).at[12:24].add(-1.0)  # large and small
    cfg = j_optimization_config("gs")
    extent = 2.0
    ts, tx = j_make_train_state("gs", {**student, "params": sp}, cfg, extent)
    j_step = j_make_train_step(jvanilla, tx, cfg, sh, backend="reference")
    state = train_state_from_numpy("gs", _train_state_numpy(ts), optimization_config("gs"),
                                   extent, device="cpu")
    step = make_train_step(tvanilla, optimization_config("gs"), sh, backend="auto")
    tgt, tbg = torch.tensor(np.asarray(gt)), torch.ones(3)
    event = dict(grad_threshold=1e-7, min_opacity=0.005, extent=extent, percent_dense=0.1,
                 size_threshold=0.0, scaling_cols=3)

    def compare(stage, before, fresh_moments):
        for group in state.optimizer.param_groups:
            k = group["name"]
            ref = np.asarray(ts.params[k])
            if fresh_moments:  # the update is +-lr whatever the gradient's size
                atol = 1e-4 * float(np.abs(ref - before[k]).max())
            else:  # it follows the gradients' ratio: the chained-steps bound
                atol = 3 * group["lr"]
            np.testing.assert_allclose(state.params[k].detach().numpy(), ref, rtol=2.5e-7,
                                       atol=atol, err_msg=f"{k} after {stage}")

    def carry_over():
        # the port goes on from the JAX state, so that every step and the
        # event are compared on equal inputs
        return train_state_from_numpy("gs", _train_state_numpy(ts), optimization_config("gs"),
                                      extent, device="cpu")

    for i in range(2):
        before = {k: np.asarray(v) for k, v in ts.params.items()}
        ts, j_metrics = j_step(ts, jc, gt, bg)
        state, metrics = step(state, tc, tgt, tbg)
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
        compare(f"step {i}", before, fresh_moments=i == 0)
        # the statistics drive the event: both packages must see the same rows
        np.testing.assert_array_equal(state.stats.denom.numpy(), np.asarray(ts.stats.denom))
        ref = np.asarray(ts.stats.grad_accum)
        np.testing.assert_allclose(state.stats.grad_accum.numpy(), ref, rtol=0,
                                   atol=5e-4 * float(ref.max()))
        state = carry_over()
    key = jax.random.key(3)
    noise = np.array(jax.random.normal(key, (2, 64, 3)))
    ts_old = ts
    ts, j_info = j_densify_and_prune(ts, key, **event)
    state, info = densify_and_prune(state, noise=noise, **event)
    _assert_same_event(ts_old, ts, j_info, state, info)
    assert int(info["n_clone"]) > 0 and int(info["n_split_rows"]) > 0
    assert int(info["n_alive"]) > 24
    for i in range(2, 4):
        before = {k: np.asarray(v) for k, v in ts.params.items()}
        ts, j_metrics = j_step(ts, jc, gt, bg)
        state, metrics = step(state, tc, tgt, tbg)
        np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
        assert int(metrics["num_visible"]) == int(j_metrics["num_visible"]) > 24
        compare(f"step {i}", before, fresh_moments=False)
        state = carry_over()
