"""The backward composite on the CPU: `composite_bwd_plain` (the plain version
of the CUDA kernel csrc/composite_bwd.cu) against torch.autograd of
`composite_fwd_plain`, on the render tests' scenes, with seeded cotangents;
the autograd Function that joins the two composites, with cotangents that
arrive strided or not at all; and the kernel wrapper's refusals.

Tolerance: 5e-4 * max|g| + 1e-7 per gradient column, the bound the JAX
package holds its exact fast path's gradients to
(tests/test_raster_pallas.py): the kernel's division form T_before =
T_after / (1 - alpha) and its back-to-front suffix sums round differently
from autograd's forward-order products."""
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
from gaussian_mesh_splatting_tpu_torch.ops import rasterize_cuda as rc
from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess

from test_torch_rasterize import CASES, _scene

torch.set_num_threads(2)
TOL = 5e-4
FIELDS = ("mean2d", "conic", "opacity", "color", "depth")


def _composite_inputs(case):
    """Projected attributes (detached leaves) and the binning of a case."""
    spec = CASES[case]
    s = {k: torch.tensor(v.astype(np.float32))
         for k, v in _scene(*spec["scene"], **spec.get("kw", {})).items()}
    if spec.get("behind"):
        s["means3d"][:, 2] -= 100.0
    w, h = spec["size"]
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, spec.get("dist", 4.0)]), 0.8, 0.8, w, h,
                      device="cpu")
    proj = preprocess(s["means3d"], s["scales"], s["rotations"], s["opacities"], cam,
                      shs=s["shs"], sh_degree=2, radius_mode="tight")
    n_ty, n_tx = rc._tile_grid(h, w)
    binning = bin_gaussians(proj, tile_h=rc.TILE, tile_w=rc.TILE, n_tiles_y=n_ty,
                            n_tiles_x=n_tx)
    leaves = [getattr(proj, f).detach().clone().requires_grad_(True) for f in FIELDS]
    return leaves, binning, h, w


def _as_columns(grads, n):
    """Per-field gradients (None = unused) -> (N, 10) in the kernel's order."""
    cols = []
    for g, width in zip(grads, (2, 3, 1, 3, 1)):
        g = torch.zeros((n, width)) if g is None else g.reshape(n, width)
        cols.append(g)
    return torch.cat(cols, dim=1)


def _assert_close_per_column(got, ref):
    for j in range(ref.shape[1]):
        scale = float(ref[:, j].abs().max())
        np.testing.assert_allclose(got[:, j].numpy(), ref[:, j].numpy(), rtol=0,
                                   atol=TOL * scale + 1e-7, err_msg=f"gradient column {j}")


@pytest.mark.parametrize("case", ["aligned", "nonaligned", "dense", "culled"])
def test_bwd_plain_matches_autograd_of_fwd_plain(case):
    leaves, b, h, w = _composite_inputs(case)
    args = (*leaves, b.pair_gaussian, b.tile_start, b.tile_end, h, w)
    planes, nc = rc.composite_fwd_plain(*args)
    cot = torch.tensor(np.random.default_rng(3).standard_normal((5, h, w)).astype(np.float32))
    grads = rc.composite_bwd_plain(*(x.detach() for x in leaves), b.pair_gaussian,
                                   b.tile_start, b.tile_end, h, w, planes[3].detach(), nc, cot)
    n = leaves[0].shape[0]
    assert grads.shape == (n, rc.GRAD_COLS) and torch.isfinite(grads).all()
    if case == "culled":
        assert b.pair_gaussian.numel() == 0 and not grads.any()
        return
    ref = torch.autograd.grad((planes * cot).sum(), leaves, allow_unused=True)
    ref = _as_columns(ref, n)
    assert (ref.abs().amax(dim=0) > 0).all()  # every column is exercised
    _assert_close_per_column(grads, ref)
    if case == "dense":
        assert float(planes[3].detach().min()) < 1e-3  # pixels driven to termination


@pytest.mark.parametrize("heads", ["image", "depth_alpha", "image_depth_alpha"])
def test_function_matches_autograd_with_strided_or_missing_cotangents(heads):
    """The Function's backward (the plain version on the CPU) gets the
    cotangent of `planes[:3].permute(1, 2, 0)` (strided) and none for the
    planes a loss leaves unused; it must agree with autograd through the
    plain forward under the same loss."""
    leaves, b, h, w = _composite_inputs("nonaligned")
    bg = torch.tensor([0.1, 0.2, 0.3])
    weights = torch.tensor(np.random.default_rng(4).random((h, w, 3)).astype(np.float32))

    def loss_of(planes):
        total = 0.0
        if "image" in heads:
            image = planes[:3].permute(1, 2, 0) + planes[3][..., None] * bg
            total = total + (image * weights).sum()
        if "depth" in heads:
            total = total + 0.1 * planes[4].mean() + 0.05 * (1.0 - planes[3]).mean()
        return total

    planes, _ = rc.composite(*leaves, b, h, w)
    got = torch.autograd.grad(loss_of(planes), leaves, allow_unused=True)
    planes_p, _ = rc.composite_fwd_plain(*leaves, b.pair_gaussian, b.tile_start,
                                         b.tile_end, h, w)
    ref = torch.autograd.grad(loss_of(planes_p), leaves, allow_unused=True)
    n = leaves[0].shape[0]
    _assert_close_per_column(_as_columns(got, n), _as_columns(ref, n))


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        rc.composite_bwd_cuda(z(4, 2), z(4, 3), z(4), z(4, 3), z(4), z(0, dtype=torch.int32),
                              z(1, dtype=torch.int32), z(1, dtype=torch.int32), 16, 16,
                              z(16, 16), z(16, 16, dtype=torch.int32), z(5, 16, 16),
                              tile_order=z(1, dtype=torch.int32), attrs=z(4, 12))


def test_cotangent_planes_are_materialized_and_checked():
    assert not rc._cotangent_planes(None, 4, 3, torch.device("cpu")).any()
    strided = torch.arange(60, dtype=torch.float32).reshape(4, 3, 5).permute(2, 0, 1)
    got = rc._cotangent_planes(strided, 4, 3, torch.device("cpu"))
    assert got.is_contiguous() and torch.equal(got, strided)
    with pytest.raises(ValueError, match="cotangent"):
        rc._cotangent_planes(torch.zeros(3, 4, 3), 4, 3, torch.device("cpu"))
