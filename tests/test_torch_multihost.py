"""The port's multi-process layer (`parallel/multihost.py`,
`parallel/mesh_setup.py`) on 4 gloo CPU ranks (tests/torch_dist_worker.py),
and its camera-DP step against the JAX package's `make_dp_train_step`
(reference backend, a 4-device mesh): the cases of the JAX package's
tests/test_multihost.py.

Tolerances: gradients 5e-4 * max|g| per param, statistics as in
tests/test_torch_parallel.py (grad_accum 1e-5, denom and max_radii exact),
the loss 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from gaussian_mesh_splatting_tpu.core import stack_cameras
from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.models import flat as jflat
from gaussian_mesh_splatting_tpu.parallel import create_mesh as j_create_mesh
from gaussian_mesh_splatting_tpu.parallel import make_dp_train_step as j_make_dp_train_step
from gaussian_mesh_splatting_tpu.train import make_train_state as j_make_train_state
from gaussian_mesh_splatting_tpu.train import optimization_config as j_optimization_config
from gaussian_mesh_splatting_tpu_torch.parallel import multihost

from test_torch_parallel import BG, SCENE, _assert_grads_close, _assert_stats_close, _jax_state
from torch_dist_worker import camera_fields, ring_pose, spawn

WORLD = 4
SIZE = 24
LAUNCH_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK", "SLURM_NTASKS",
              "SLURM_PROCID", "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_LOCAL_RANK")


def _cams_and_gts():
    cams = [j_make_camera(*ring_pose(i, WORLD), 0.9, 0.9, SIZE, SIZE) for i in range(WORLD)]
    rng = np.random.default_rng(7)
    return cams, [rng.random((SIZE, SIZE, 3)).astype(np.float32) for _ in cams]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cams, gts = _cams_and_gts()
    cases = {
        "meshes": ("meshes", dict(batch=8)),
        "scaling": ("scaling", dict(iters=2)),
        "dp": ("train_steps", dict(mode="data", scene=SCENE, cams=[camera_fields(c) for c in cams],
                                   gts=gts, bg=BG)),
    }
    return spawn(cases, WORLD, tmp_path_factory.mktemp("multihost"))


@pytest.fixture
def no_launcher(monkeypatch):
    """A plain process: no launcher's variables; `init_process_group`
    recorded instead of called."""
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    return calls


def test_initialize_is_a_noop_on_a_plain_process(no_launcher):
    assert not multihost.is_initialized()
    assert multihost.initialize() is False
    assert not multihost.is_initialized() and no_launcher == []


@pytest.mark.parametrize("env,joins,world,rank", [
    ({"WORLD_SIZE": "1", "RANK": "0", "MASTER_ADDR": "localhost"}, True, -1, -1),  # torchrun
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0"}, True, 4, 2),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1"}, True, 2, 1),
    ({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}, False, None, None),  # one task
])
def test_initialize_reads_the_launch_environment(no_launcher, monkeypatch, env, joins, world,
                                                 rank):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.initialize() is joins
    if not joins:
        assert no_launcher == []
        return
    (args, kw), = no_launcher
    assert args == ("nccl" if torch.cuda.is_available() else "gloo",)
    assert kw == {"init_method": "env://", "world_size": world, "rank": rank}


def test_spawned_ranks_join_with_explicit_args(ranks):
    assert all(r["initialized"] and r["again"] for r in ranks)
    assert [r["meshes"]["global"] for r in ranks] == [WORLD] * WORLD


def test_mesh2d_model_axis_is_fast(ranks):
    for rank, r in enumerate(ranks):
        assert r["meshes"]["model"] == [rank // 2 * 2, rank // 2 * 2 + 1]
        assert r["meshes"]["data"] == [rank % 2, rank % 2 + 2]


def test_local_batch_slices_tile_the_batch(ranks):
    slices = [tuple(r["meshes"]["slice"]) for r in ranks]
    assert slices == [(0, 2), (2, 2), (4, 2), (6, 2)]
    # a mesh of the first two ranks: they split the batch, the others hold none
    assert [tuple(r["meshes"]["sub_slice"]) for r in ranks] == [(0, 4), (4, 4), (0, 0), (0, 0)]


def test_measure_scaling_returns_the_jax_keys(ranks):
    res = ranks[0]["scaling"]
    assert sorted(res) == [1, 2, 4]
    for w, v in res.items():
        assert set(v) == {"ms", "efficiency"} and v["ms"] > 0, (w, v)
    assert res[1]["efficiency"] == 1.0
    assert all(r["scaling"] == res for r in ranks)  # the slowest rank's times, everywhere


def test_dp_step_matches_the_jax_dp_step(ranks):
    """One camera a rank against JAX's `make_dp_train_step` over a 4-device
    mesh (SGD(1.0): the update is the averaged gradient)."""
    cams, gts = _cams_and_gts()
    cfg = j_optimization_config("gs_flat")
    ts, _ = j_make_train_state("gs_flat", _jax_state(SCENE), cfg)
    tx = optax.sgd(1.0)
    ts = ts.replace(opt_state=tx.init(ts.params))
    step = j_make_dp_train_step(jflat, tx, cfg, 0, j_create_mesh(WORLD), backend="reference")
    new, metrics = step(ts, stack_cameras(cams), jnp.stack([jnp.asarray(g) for g in gts]),
                        jnp.asarray(BG))
    grads = {k: np.asarray(ts.params[k] - new.params[k]) for k in ts.params}
    stats = {k: np.asarray(getattr(new.stats, k)) for k in ("grad_accum", "denom", "max_radii")}
    assert jax.device_count() >= WORLD
    for r in ranks:
        out = r["dp"]
        np.testing.assert_allclose(out["metrics"]["loss"], float(metrics["loss"]), rtol=1e-4)
        np.testing.assert_allclose(out["metrics"]["psnr"], float(metrics["psnr"]), rtol=1e-4)
        _assert_grads_close(out["grads"], grads, "dp")
        _assert_stats_close(out["stats"], stats)
    assert ranks[0]["dp"]["losses"] == ranks[-1]["dp"]["losses"]
