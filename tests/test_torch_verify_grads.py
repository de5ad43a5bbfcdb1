"""`tools_torch_verify_grads.py` on the CPU, where the render's composite is
the kernels' plain versions.

1. Its loss and gradients against the JAX tool's (`tools_verify_grads.
   loss_fn_factory(cam, target, n, "reference")`, the JAX oracle) on the same
   numpy parameters: 300 Gaussians at 64x64. Losses within 1e-6 relative,
   each key within 5e-4 * max|g|.
2. `oracle_grad_check` and `fd_checks` end to end, meeting their bounds:
   the oracle check at 300 Gaussians, 64x64, `scan_chunk` 50; the
   finite differences at 100 Gaussians, 64x64, `scales_log` mean -2.5 (fewer,
   larger Gaussians than the tool's scene, so that along every direction
   the loss moves by at least 1,000 ulps at eps 2e-3).
"""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tools_torch_verify_grads as vg  # noqa: E402
import tools_verify_grads as jax_tool  # noqa: E402
from gaussian_mesh_splatting_tpu.core import make_camera as j_make_camera  # noqa: E402

torch.set_num_threads(2)
N, SIZE = 300, 64


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads():
    arrays = vg.scene_arrays(N)
    cam = j_make_camera(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.8, SIZE, SIZE)
    loss_fn = jax_tool.loss_fn_factory(cam, jnp.zeros((SIZE, SIZE, 3)), N, "reference")
    loss, g = jax.value_and_grad(loss_fn)({k: jnp.asarray(v) for k, v in arrays.items()})
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_tool_loss_and_gradients_match_the_jax_tool(backend):
    params, cam, target = vg.make_scene(N, SIZE, SIZE, device="cpu")
    loss, g = vg.value_and_grad(vg.loss_fn_factory(cam, target, N, backend), params)
    j_loss, j_g = jax_loss_and_grads()
    assert abs(float(loss) - j_loss) <= 1e-6 * abs(j_loss)
    assert set(g) == set(j_g) == set(vg.KEYS)
    for k in vg.KEYS:
        scale = float(np.abs(j_g[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(g[k].numpy(), j_g[k], atol=5e-4 * scale, rtol=0, err_msg=k)


def test_oracle_grad_check_small():
    r = vg.oracle_grad_check(N, SIZE, SIZE, scan_chunk=50, device="cpu")
    assert r["ok"], r
    assert r["n_pairs"] > N
    assert r["loss_rel_err"] <= vg.LOSS_RTOL
    assert set(r["per_param"]) == set(vg.KEYS)


def test_fd_checks_small():
    r = vg.fd_checks(100, SIZE, SIZE, scale_mean=-2.5, device="cpu")
    assert r["ok"], r
    assert [d["dir"] for d in r["directions"]] == ["grad", *(f"grad/{k}" for k in vg.KEYS)]
    for d in r["directions"]:
        assert d["delta_ulps"] >= 1000, d
        assert d["rel_err@0.002"] <= vg.FD_TOL, d
        assert all(np.isfinite(d[f"fd@{e:g}"]) for e in vg.FD_EPS), d


def test_tool_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert vg.main(["--out", str(tmp_path / "r.json")]) == 2
    assert not (tmp_path / "r.json").exists()


def test_scene_draws_match_the_jax_tool_distributions():
    a = vg.scene_arrays(20_000, seed=3)
    assert {k: v.shape for k, v in a.items()} == {
        "xyz": (20_000, 3), "scales_log": (20_000, 3), "q": (20_000, 4),
        "opacity_raw": (20_000, 1), "shs": (20_000, 3, 16)}
    assert abs(a["xyz"].std() - 0.5) < 0.01 and abs(a["scales_log"].mean() + 3.5) < 0.01
    dc = a["shs"][..., 0]
    assert dc.min() >= -0.5 and dc.max() <= 1.5 and abs(a["shs"][..., 1:].std() - 0.01) < 1e-3
    assert dataclasses.is_dataclass(vg.bag_of({k: torch.tensor(v) for k, v in a.items()},
                                              20_000))
