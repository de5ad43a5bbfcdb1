"""The loss kernels' CPU side (csrc/loss.cu runs only on a card):
`photometric_vjp_plain`, the VJP kernel's plain version, against autograd
of the chain (`train/loss.photometric_loss` on CPU tensors); the dispatch
of `photometric_loss` between the kernels and the chain; the autograd
Function's wiring, with its two launchers stood in by the chain and the
plain VJP; the wrappers' refusals.

The VJP is held at 1e-10 x max|g| in float64 (the derivation) and 1e-5 x
max|g| in float32 (autograd sums the same terms in another order), on
whole tiles, ragged ones and an image smaller than the window, at lambda
0, 0.2 and 1, with and without a cotangent on l1. Pixels where pred == gt
exactly take sgn(0) = 0, as torch's abs backward does."""
import collections

import pytest
import torch

from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
from gaussian_mesh_splatting_tpu_torch.ops import ssim as S
from gaussian_mesh_splatting_tpu_torch.train.loss import l1_loss, photometric_loss
from gaussian_mesh_splatting_tpu_torch.utils.profiling import Recording, tracing

torch.set_num_threads(2)
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
SHAPES = [(64, 96), (37, 53), (7, 9)]  # whole tiles; ragged tiles; under the 11x11 window
LAMBDAS = [0.0, 0.2, 1.0]


def _images(shape, dtype, seed, ties=0.0):
    """A seeded (H, W, 3) pair in [0, 1]; a share `ties` of the entries of
    `gt` set equal to `pred`'s."""
    g = torch.Generator().manual_seed(seed)
    pred = torch.rand(*shape, 3, generator=g, dtype=torch.float64)
    gt = torch.rand(*shape, 3, generator=g, dtype=torch.float64)
    tie = torch.rand(*shape, 3, generator=g, dtype=torch.float64) < ties
    gt[tie] = pred[tie]
    return pred.to(dtype), gt.to(dtype)


def _autograd(pred, gt, lam, g_total, g_l1):
    leaf = pred.detach().clone().requires_grad_()
    total, l1 = photometric_loss(leaf, gt, lam)
    outs, cots = zip(*[(o, c) for o, c in ((total, g_total), (l1, g_l1)) if c is not None])
    return torch.autograd.grad(outs, leaf, cots)[0]


def _cotangents(dtype, with_l1: bool):
    return torch.tensor(1.3, dtype=dtype), (torch.tensor(-0.7, dtype=dtype) if with_l1 else None)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_l1", [True, False])
@pytest.mark.parametrize("lam", LAMBDAS)
@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_plain_matches_autograd_of_the_chain(shape, lam, with_l1, dtype):
    pred, gt = _images(shape, dtype, seed=shape[0] * 131 + shape[1])
    g_total, g_l1 = _cotangents(dtype, with_l1)
    got = S.photometric_vjp_plain(pred, gt, lam, g_total, g_l1)
    want = _autograd(pred, gt, lam, g_total, g_l1)
    assert got.dtype == dtype and got.shape == pred.shape
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lam", LAMBDAS)
def test_vjp_plain_takes_sgn_0_where_pred_equals_gt(lam, dtype):
    pred, gt = _images((37, 53), dtype, seed=5, ties=0.3)
    tie = pred == gt
    assert 0.2 < float(tie.double().mean()) < 0.4
    g_total, g_l1 = _cotangents(dtype, True)
    got = S.photometric_vjp_plain(pred, gt, lam, g_total, g_l1)
    want = _autograd(pred, gt, lam, g_total, g_l1)
    assert _rel(got, want) <= TOL[dtype]
    # sgn(x - y) as +-1 at the ties would move them by (1 - lambda + g_l1) / N
    assert float((got - want)[tie].abs().max()) < 1e-3 / pred.numel()
    if lam == 0.0:  # the L1 term alone: no gradient where pred == gt
        assert float(got[tie].abs().max()) == 0.0


@pytest.mark.parametrize("which", ["total", "l1"])
def test_vjp_plain_with_one_cotangent(which):
    pred, gt = _images((37, 53), torch.float64, seed=9)
    g_total, g_l1 = _cotangents(torch.float64, True)
    cots = (g_total, None) if which == "total" else (None, g_l1)
    got = S.photometric_vjp_plain(pred, gt, 0.2, *cots)
    assert _rel(got, _autograd(pred, gt, 0.2, *cots)) <= TOL[torch.float64]


@pytest.mark.parametrize("shape", SHAPES)
def test_ssim_map_is_ssims_map(shape):
    pred, gt = _images(shape, torch.float32, seed=3)
    smap = S.ssim_map(pred, gt)
    assert torch.equal(S.ssim(pred, gt), torch.mean(smap))
    assert torch.equal(S.ssim(pred, gt, size_average=False), torch.mean(smap, dim=(0, 1)))


def test_cpu_tensors_take_the_chain():
    pred, gt = _images((37, 53), torch.float32, seed=11)
    launches = (cuda_build.launches["loss_fwd"], cuda_build.launches["loss_bwd"])
    rec = Recording("cpu")
    leaf = pred.clone().requires_grad_()
    with tracing(rec):
        total, l1 = photometric_loss(leaf, gt, 0.2)
    total.backward()
    assert rec.counts == [("loss_kernel", 0, None)]
    assert (cuda_build.launches["loss_fwd"], cuda_build.launches["loss_bwd"]) == launches
    want_l1 = l1_loss(pred, gt)
    assert torch.equal(l1, want_l1)
    assert torch.equal(total, 0.8 * want_l1 + 0.2 * (1.0 - S.ssim(pred, gt)))


def test_cuda_wrappers_refuse_cpu_tensors():
    pred, gt = _images((7, 9), torch.float32, seed=1)
    maps = torch.zeros(3, 7, 9, 3)
    for call in (lambda: S.photometric_loss_cuda(pred, gt),
                 lambda: S.photometric_fwd_cuda(pred, gt, 0.2),
                 lambda: S.photometric_bwd_cuda(pred, gt, maps, 0.2, torch.tensor(1.0))):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def _plain_launchers(monkeypatch):
    """Stand the two launchers in by the chain (forward, with the derivative
    maps of the plain VJP) and the plain VJP (backward), counting as they
    do; the input check by one that lets CPU tensors through."""
    calls = {"bwd_maps": []}

    def fwd(pred, gt, lam, *, with_map=False):
        with torch.no_grad():
            total, l1 = photometric_loss(pred, gt, lam)
        cuda_build.launches["loss_fwd"] += 1
        return total, l1, torch.zeros(3, *pred.shape), None

    def bwd(pred, gt, maps, lam, g_total, g_l1=None):
        calls["bwd_maps"].append(maps)
        cuda_build.launches["loss_bwd"] += 1
        return S.photometric_vjp_plain(pred, gt, lam, g_total, g_l1)

    monkeypatch.setattr(S, "photometric_fwd_cuda", fwd)
    monkeypatch.setattr(S, "photometric_bwd_cuda", bwd)
    monkeypatch.setattr(S, "_check_loss_inputs", lambda pred, gt: None)
    monkeypatch.setattr(cuda_build, "launches", collections.Counter())
    return calls


@pytest.mark.parametrize("uses", ["total", "l1", "both", "none"])
def test_function_wiring(monkeypatch, uses):
    calls = _plain_launchers(monkeypatch)
    pred, gt = _images((37, 53), torch.float32, seed=13)
    # a transposed view: the wrapper makes it contiguous
    leaf = pred.transpose(0, 1).contiguous().requires_grad_()
    total, l1 = S.photometric_loss_cuda(leaf.transpose(0, 1), gt, 0.2)
    want_total, want_l1 = photometric_loss(pred, gt, 0.2)
    assert torch.equal(total, want_total) and torch.equal(l1, want_l1)
    outs = {"total": [total], "l1": [l1], "both": [total, l1 * 0.5], "none": []}[uses]
    if outs:
        sum(outs).backward()
        g_total = torch.tensor(1.0) if uses != "l1" else None
        g_l1 = torch.tensor(1.0 if uses == "l1" else 0.5) if uses != "total" else None
        want = S.photometric_vjp_plain(pred, gt, 0.2, g_total, g_l1)
        assert torch.equal(leaf.grad.transpose(0, 1), want)
        assert calls["bwd_maps"][0].shape == (3, 37, 53, 3)
    assert cuda_build.launches["loss_fwd"] == 1
    assert cuda_build.launches["loss_bwd"] == (1 if outs else 0)

