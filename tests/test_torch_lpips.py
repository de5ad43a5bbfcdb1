"""The port's LPIPS (`ops/lpips.py`) against the JAX package's
`ops.lpips.lpips` and against the numpy re-derivation of `tests/test_lpips.py`,
with weights drawn once in numpy and handed to both packages (the JAX
`synthetic_params` draws from `jax.random`), on a tiny plan and on the full
VGG16 plan; plus the metric's own properties and the weights file."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.ops import lpips as j_lpips
from gaussian_mesh_splatting_tpu_torch.ops import lpips as t_lpips
from test_lpips import TINY_PLAN, np_lpips

torch.set_num_threads(2)
RTOL = 1e-5


def _jax_params(arrays, plan):
    n_conv = sum(1 for it in plan if it != "M")
    n_lin = sum(1 for it in plan if it != "M" and it[0] == "C*")
    return j_lpips.LPIPSParams(
        tuple(jnp.asarray(arrays[f"conv{i}_w"]) for i in range(n_conv)),
        tuple(jnp.asarray(arrays[f"conv{i}_b"]) for i in range(n_conv)),
        tuple(jnp.asarray(arrays[f"lin{j}_w"]) for j in range(n_lin)),
        plan)


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32))


@pytest.mark.parametrize("plan,shape", [(TINY_PLAN, (12, 16, 3)), (j_lpips.VGG16_PLAN, (32, 32, 3)),
                                        (j_lpips.VGG16_PLAN, (2, 48, 40, 3))],
                         ids=["tiny", "vgg16_32x32", "vgg16_batch_48x40"])
def test_matches_jax(plan, shape):
    arrays = t_lpips.synthetic_arrays(np.random.default_rng(0), plan)
    a, b = _images(1, shape)
    got = t_lpips.lpips(torch.as_tensor(a), torch.as_tensor(b),
                        t_lpips.params_from_arrays(arrays, plan, device="cpu")).numpy()
    want = np.asarray(j_lpips.lpips(jnp.asarray(a), jnp.asarray(b), _jax_params(arrays, plan)))
    assert got.shape == want.shape == shape[:-3]
    assert (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_matches_numpy_rederivation():
    arrays = t_lpips.synthetic_arrays(np.random.default_rng(2), TINY_PLAN)
    a, b = _images(3, (12, 16, 3))
    got = float(t_lpips.lpips(torch.as_tensor(a), torch.as_tensor(b),
                              t_lpips.params_from_arrays(arrays, TINY_PLAN, device="cpu")))
    ref = types.SimpleNamespace(
        plan=TINY_PLAN, conv_w=[arrays[f"conv{i}_w"] for i in range(4)],
        conv_b=[arrays[f"conv{i}_b"] for i in range(4)], lin_w=[arrays["lin0_w"], arrays["lin1_w"]])
    want = np_lpips(a.astype(np.float64), b.astype(np.float64), ref)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_identical_zero_symmetric_and_batched():
    params = t_lpips.synthetic_params(torch.Generator().manual_seed(0), TINY_PLAN, device="cpu")
    a, b = (torch.as_tensor(x) for x in _images(4, (3, 16, 16, 3)))
    assert float(t_lpips.lpips(a[0], a[0], params)) == 0.0
    s_ab, s_ba = t_lpips.lpips(a, b, params), t_lpips.lpips(b, a, params)
    assert s_ab.shape == (3,)
    torch.testing.assert_close(s_ab, s_ba, rtol=1e-6, atol=0)
    singles = torch.stack([t_lpips.lpips(a[i], b[i], params) for i in range(3)])
    torch.testing.assert_close(s_ab, singles, rtol=1e-6, atol=0)


def test_synthetic_params_shapes_and_seed():
    p = t_lpips.synthetic_params(torch.Generator().manual_seed(5), device="cpu")
    q = t_lpips.synthetic_params(torch.Generator().manual_seed(5), device="cpu")
    c_in = 3
    convs = [it[1] for it in t_lpips.VGG16_PLAN if it != "M"]
    for w, b, c_out in zip(p.conv_w, p.conv_b, convs):
        assert w.shape == (c_out, c_in, 3, 3) and b.shape == (c_out,)
        c_in = c_out
    assert [w.shape[0] for w in p.lin_w] == [64, 128, 256, 512, 512]
    assert all(bool((w >= 0).all()) for w in p.lin_w)
    assert all(torch.equal(x, y) for x, y in zip(p.conv_w, q.conv_w))


def test_scorer_turns_tf32_off_and_restores_it():
    params = t_lpips.synthetic_params(torch.Generator().manual_seed(1), TINY_PLAN, device="cpu")
    a, b = (torch.as_tensor(x) for x in _images(6, (8, 8, 3)))
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        seen = []
        conv2d = t_lpips.F.conv2d

        def spy(*args, **kw):
            seen.append(torch.backends.cudnn.allow_tf32)
            return conv2d(*args, **kw)

        t_lpips.F.conv2d = spy
        try:
            t_lpips.lpips(a, b, params)
        finally:
            t_lpips.F.conv2d = conv2d
        assert seen and not any(seen)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_weights_file(tmp_path, monkeypatch):
    """load_params: None for an absent file; the documented .npz loads in
    both packages (also through $GMS_LPIPS_WEIGHTS) and scores alike."""
    assert t_lpips.load_params(str(tmp_path / "nope.npz"), device="cpu") is None
    arrays = t_lpips.synthetic_arrays(np.random.default_rng(7))
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **arrays)
    monkeypatch.setenv("GMS_LPIPS_WEIGHTS", path)
    assert t_lpips.default_weights_path() == path
    got_p, want_p = t_lpips.load_params(device="cpu"), j_lpips.load_params()
    assert got_p is not None and want_p is not None
    np.testing.assert_array_equal(got_p.conv_w[3].numpy(),
                                  np.asarray(want_p.conv_w[3]).transpose(3, 2, 0, 1))
    a, b = _images(8, (32, 32, 3))
    got = float(t_lpips.lpips(torch.as_tensor(a), torch.as_tensor(b), got_p))
    want = float(j_lpips.lpips(jnp.asarray(a), jnp.asarray(b), want_p))
    np.testing.assert_allclose(got, want, rtol=RTOL)
