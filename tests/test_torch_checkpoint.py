"""The port's training checkpoints, and model snapshots of the point-cloud
models and of `gs_flame` across the two packages, on the CPU (the
`gs_multi_mesh` cases, with list-valued params, are in
tests/test_torch_multi_mesh.py).

A checkpoint gives back every tensor bit for bit, and the next train step
from the restored state equals the next step from the original exactly (the
same operations on the same values, on one thread count). A snapshot written
by either package loads in the other with the alive rows' raw params equal
bit for bit (float32 through a binary PLY).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.io.snapshots import load_snapshot as j_load_snapshot
from gaussian_mesh_splatting_tpu.io.snapshots import save_snapshot as j_save_snapshot
from gaussian_mesh_splatting_tpu.models import MODEL_REGISTRY as J_MODELS
from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
from gaussian_mesh_splatting_tpu_torch.interop import state_from_numpy
from gaussian_mesh_splatting_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from gaussian_mesh_splatting_tpu_torch.io.snapshots import load_snapshot, save_snapshot
from gaussian_mesh_splatting_tpu_torch.models import get_model
from gaussian_mesh_splatting_tpu_torch.train import (
    densify_and_prune,
    make_train_state,
    make_train_step,
    one_up_sh_degree,
    optimization_config,
)

from test_torch_models import _jax_state, _point_state

torch.set_num_threads(2)
SH = 1
W, H = 40, 32


def _camera():
    return make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8 * H / W, W, H, device="cpu")


def _trained_state(gs_type, capacity=48, steps=2):
    """A `gs` / `gs_flat` TrainState after `steps` train steps and one
    densify event: nonzero moments, statistics, dead rows, SH degree 1."""
    model = get_model(gs_type)
    cfg = optimization_config(gs_type)
    state = make_train_state(
        state_from_numpy(gs_type, _point_state(gs_type, seed=3, n=24, capacity=capacity),
                         device="cpu"), cfg, 2.5)
    one_up_sh_degree(state, SH)
    step = make_train_step(model, cfg, SH)
    gt = torch.tensor(np.random.default_rng(0).random((H, W, 3)).astype(np.float32))
    for _ in range(steps):
        step(state, _camera(), gt, torch.ones(3))
    densify_and_prune(state, grad_threshold=1e-9, min_opacity=0.005, extent=2.5,
                      percent_dense=0.01, size_threshold=0.0,
                      scaling_cols=3 if gs_type == "gs" else 2,
                      generator=torch.Generator().manual_seed(1))
    step(state, _camera(), gt, torch.ones(3))
    return state, step, gt


def _assert_states_equal(a, b, scheduled_lr=True):
    assert a.step == b.step and a.active_sh_degree == b.active_sh_degree
    assert list(a.params) == list(b.params)
    assert torch.equal(a.alive, b.alive)
    for k in a.params:
        assert torch.equal(a.params[k].detach(), b.params[k].detach()), k
        ma, mb = a.optimizer.state.get(a.params[k], {}), b.optimizer.state.get(b.params[k], {})
        assert set(ma) == set(mb), k
        for name in ma:
            assert torch.equal(ma[name], mb[name]), (k, name)
    for k in ("grad_accum", "denom", "max_radii"):
        assert torch.equal(getattr(a.stats, k), getattr(b.stats, k)), k
    for ga, gb in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        assert ga["name"] == gb["name"] and ("lr_schedule" in ga) == ("lr_schedule" in gb)
        # a scheduled lr is set anew before every step: a restored state has
        # the schedule, and the step's lr once it has taken a step
        assert ga["lr"] == gb["lr"] or ("lr_schedule" in ga and not scheduled_lr)


@pytest.mark.parametrize("gs_type", ["gs", "gs_flat"])
def test_checkpoint_restores_every_tensor_and_the_next_step(gs_type, tmp_path):
    state, step, gt = _trained_state(gs_type)
    path = str(tmp_path / "model" / "chkpnt3.pt")
    save_checkpoint(path, state)
    # the template: a fresh state of another capacity
    cfg = optimization_config(gs_type)
    template = make_train_state(
        state_from_numpy(gs_type, _point_state(gs_type, seed=8, n=10, capacity=16), device="cpu"),
        cfg, 2.5)
    restored = restore_checkpoint(path, template)
    assert restored.alive.shape == (48,) and restored.step == 3 and restored.active_sh_degree == 1
    assert 0 < int(restored.alive.sum()) < 48
    assert all(p.is_leaf and p.requires_grad for p in restored.params.values())
    assert all(g["params"][0] is restored.params[g["name"]]
               for g in restored.optimizer.param_groups)
    _assert_states_equal(restored, state, scheduled_lr=False)
    # the same next step, bit for bit, schedule included
    _, m_a = step(state, _camera(), gt, torch.ones(3))
    _, m_b = step(restored, _camera(), gt, torch.ones(3))
    assert float(m_a["loss"]) == float(m_b["loss"])
    _assert_states_equal(restored, state)
    assert float(state.optimizer.state[state.params["xyz"]]["step"]) == 4.0


def test_checkpoint_before_the_first_step(tmp_path):
    cfg = optimization_config("gs")
    state = make_train_state(
        state_from_numpy("gs", _point_state("gs", seed=3, n=24, capacity=32), device="cpu"),
        cfg, 1.0)
    path = str(tmp_path / "chkpnt0.pt")
    save_checkpoint(path, state)
    restored = restore_checkpoint(path, state)
    assert restored.step == 0 and not restored.optimizer.state
    _assert_states_equal(restored, state)
    assert all(restored.params[k] is not state.params[k] for k in state.params)


def test_checkpoint_of_a_mesh_model_keeps_its_faces(tmp_path):
    from test_torch_mesh_projection import _jax_mesh_state, _to_numpy

    cfg = optimization_config("gs_mesh")
    mstate = state_from_numpy("gs_mesh", _to_numpy(_jax_mesh_state(n_faces=6, sh_degree=SH)),
                              device="cpu")
    state = make_train_state(mstate, cfg)
    path = str(tmp_path / "chkpnt0.pt")
    save_checkpoint(path, state)
    restored = restore_checkpoint(path, make_train_state(mstate, cfg))
    assert torch.equal(restored.consts["faces"], state.consts["faces"])
    assert restored.consts["faces"].dtype == torch.int64
    _assert_states_equal(restored, state)


def test_checkpoint_refuses_another_model(tmp_path):
    state, _, _ = _trained_state("gs", steps=1)
    path = str(tmp_path / "chkpnt.pt")
    save_checkpoint(path, state)
    from test_torch_mesh_projection import _jax_mesh_state, _to_numpy

    mesh_state = make_train_state(
        state_from_numpy("gs_mesh", _to_numpy(_jax_mesh_state(n_faces=6, sh_degree=SH)),
                         device="cpu"), optimization_config("gs_mesh"))
    with pytest.raises(ValueError, match="holds params"):
        restore_checkpoint(path, mesh_state)


# ---------------------------------------------------------------- snapshots

def _save_type(gs_type):
    # a gs_points model is a trained gs_flat model: that is what writes its PLY
    return "gs_flat" if gs_type == "gs_points" else gs_type


@pytest.mark.parametrize("gs_type", ["gs", "gs_flat", "gs_points"])
def test_snapshot_written_by_jax_loads_in_the_port(gs_type, tmp_path):
    state = _point_state(_save_type(gs_type), seed=5, n=30, capacity=40, sh_degree=2)
    alive = state["alive"]
    j_save_snapshot(_save_type(gs_type), J_MODELS[_save_type(gs_type)], _jax_state(state),
                    str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["point_cloud.ply"]  # no sidecar
    got = load_snapshot(gs_type, str(tmp_path), sh_degree=2, device="cpu")
    assert got["alive"].all() and got["alive"].shape == (int(alive.sum()),)
    assert got["consts"] == {}
    for k, v in state["params"].items():
        assert torch.equal(got["params"][k], torch.tensor(v[alive])), k
    assert got["params"]["scaling"].shape[1] == (3 if gs_type == "gs" else 2)
    assert got["params"]["scaling"].is_contiguous()


@pytest.mark.parametrize("gs_type", ["gs", "gs_flat", "gs_points"])
def test_snapshot_written_by_the_port_loads_in_jax(gs_type, tmp_path):
    state = _point_state(_save_type(gs_type), seed=6, n=30, capacity=40, sh_degree=2)
    alive = state["alive"]
    tstate = state_from_numpy(_save_type(gs_type), state, device="cpu")
    save_snapshot(_save_type(gs_type), get_model(_save_type(gs_type)), tstate, str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["point_cloud.ply"]
    ref = j_load_snapshot(gs_type, str(tmp_path), sh_degree=2)
    back = load_snapshot(gs_type, str(tmp_path), sh_degree=2, device="cpu")
    for k, v in state["params"].items():
        np.testing.assert_array_equal(np.asarray(ref["params"][k]), v[alive], err_msg=k)
        assert torch.equal(back["params"][k], torch.tensor(v[alive])), k
    # and the loaded state renders through its model
    bag = get_model(gs_type).to_bag(back)
    assert bag.scaling.shape == (int(alive.sum()), 3) and torch.isfinite(bag.scaling).all()
    jbag = J_MODELS[_save_type(gs_type)].to_bag(
        {"params": {k: jnp.asarray(v) for k, v in ref["params"].items()}, "consts": {},
         "alive": ref["alive"]})
    np.testing.assert_allclose(bag.xyz.numpy(), np.asarray(jbag.xyz), atol=1e-6)


def test_snapshots_of_unported_models_raise(tmp_path):
    """A gs_type the package does not have, and a mesh model's snapshot
    without its sidecar."""
    with pytest.raises(ValueError, match="unknown gs_type 'gs_bogus'"):
        load_snapshot("gs_bogus", str(tmp_path), device="cpu")
    state = _point_state("gs_flat", seed=5, n=30, capacity=40, sh_degree=2)
    j_save_snapshot("gs_flat", J_MODELS["gs_flat"], _jax_state(state), str(tmp_path))
    with pytest.raises(FileNotFoundError, match="sidecar"):
        load_snapshot("gs_multi_mesh", str(tmp_path), sh_degree=2, device="cpu")


# ---------------------------------------------------------------- gs_flame

def _flame_train_state():
    from test_torch_flame import _flame_states

    _, tmodel, _, tstate = _flame_states()
    cfg = optimization_config("gs_flame")
    state = make_train_state(tstate, cfg)
    step = make_train_step(tmodel, cfg, SH)
    gt = torch.tensor(np.random.default_rng(0).random((H, W, 3)).astype(np.float32))
    for _ in range(2):
        step(state, _camera(), gt, torch.ones(3))
    return tmodel, state, step, gt


def test_checkpoint_of_gs_flame_restores_every_tensor_and_the_next_step(tmp_path):
    tmodel, state, step, gt = _flame_train_state()
    path = str(tmp_path / "chkpnt2.pt")
    save_checkpoint(path, state)
    fresh = make_train_state(tmodel.init_from_flame(torch.rand((80, 2, 3)), torch.rand((160, 3)),
                                                    sh_degree=SH), optimization_config("gs_flame"))
    restored = restore_checkpoint(path, fresh)
    assert torch.equal(restored.consts["faces"], state.consts["faces"])
    _assert_states_equal(restored, state)
    _, m_a = step(state, _camera(), gt, torch.ones(3))
    _, m_b = step(restored, _camera(), gt, torch.ones(3))
    assert float(m_a["loss"]) == float(m_b["loss"])
    _assert_states_equal(restored, state)


def test_gs_flame_snapshots_load_across_packages(tmp_path):
    from test_torch_flame import _flame_states

    jmodel, tmodel, jstate, tstate = _flame_states()
    faces = tstate["consts"]["faces"]
    j_save_snapshot("gs_flame", jmodel, jstate, str(tmp_path / "jax"))
    got = load_snapshot("gs_flame", str(tmp_path / "jax"), sh_degree=SH,
                        consts={"faces": faces}, device="cpu")
    for k, v in jstate["params"].items():
        assert torch.equal(got["params"][k], torch.tensor(np.asarray(v))), k
    save_snapshot("gs_flame", tmodel, tstate, str(tmp_path / "port"))
    ref = j_load_snapshot("gs_flame", str(tmp_path / "port"), sh_degree=SH,
                          consts=jstate["consts"])
    for k, v in jstate["params"].items():
        np.testing.assert_array_equal(np.asarray(ref["params"][k]), np.asarray(v), err_msg=k)
    # both PLYs carry the same derived Gaussians
    a = j_load_snapshot("gs", str(tmp_path / "jax"), sh_degree=SH)["params"]
    b = j_load_snapshot("gs", str(tmp_path / "port"), sh_degree=SH)["params"]
    for k in ("xyz", "scaling", "rotation"):
        scale = float(np.abs(np.asarray(a[k])).max())
        np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
