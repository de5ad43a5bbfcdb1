"""The torch-side layout that the composite kernels read and write, on the
CPU: the packed (N, 12) attribute table, the tile launch order of the
binning, the padded (N, 12) gradient buffer and its (N, 10) view, and that
the composite Function with these in place still matches the JAX oracle
`rasterize_reference(tile_size=(16, 16))` on its image and its gradients.

Tolerances: the layout pieces are exact (copies and integer sorts). Against
the JAX oracle: 2e-5 on image and alpha, 2e-4 * max|depth| on depth, and
5e-4 * max|g| + 1e-7 per gradient, the bounds the JAX package holds its
exact fast path to (tests/test_raster_pallas.py)."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.core.camera import make_camera as j_make_camera
from gaussian_mesh_splatting_tpu.ops.rasterize_reference import rasterize_reference as j_raster
from gaussian_mesh_splatting_tpu_torch.interop import camera_from_numpy
from gaussian_mesh_splatting_tpu_torch.ops import rasterize_cuda as rc
from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians, tile_launch_order
from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess

from test_torch_binning import _projected
from test_torch_rasterize import _scene

torch.set_num_threads(2)
BG = np.array([0.1, 0.2, 0.3], np.float32)
PARAMS = ("means3d", "scales", "rotations", "opacities", "shs")


def _attributes(n, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32))

    return t(n, 2), t(n, 3), t(n), t(n, 3), t(n)


# ---- the packed attribute table ---------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 37])
def test_pack_attributes_round_trip(n):
    fields = _attributes(n)
    table = rc.pack_attributes(*fields)
    assert table.shape == (n, rc.ROW) and table.dtype == torch.float32
    assert table.is_contiguous() and table.stride() == (rc.ROW, 1)
    assert rc.ROW * table.element_size() == 48  # three 16-byte words per row
    for got, want in zip(rc.split_columns(table), fields):
        assert got.shape == want.shape
        assert torch.equal(got, want)


def test_pack_attributes_padding_is_zero_and_columns_are_in_kernel_order():
    mean2d, conic, opacity, color, depth = _attributes(5, seed=1)
    table = rc.pack_attributes(mean2d, conic, opacity, color, depth)
    assert not table[:, rc.GRAD_COLS:].any()
    want = torch.cat([mean2d, conic, opacity[:, None], color, depth[:, None]], dim=1)
    assert torch.equal(table[:, :rc.GRAD_COLS], want)  # mx my a b c op r g b z


def test_pack_attributes_carries_no_graph():
    """The table feeds the kernels only: the Function packs inside its
    forward, where autograd does not record, so the gradients come back
    through the backward kernel's own columns and not through the table."""
    packed = []

    class Packs(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *fields):
            packed.append(rc.pack_attributes(*fields))
            return packed[0].sum()

        @staticmethod
        def backward(ctx, grad):
            return (None,) * 5

    fields = [f.requires_grad_(True) for f in _attributes(3, seed=2)]
    assert rc.pack_attributes(*fields).requires_grad  # outside a Function it would record
    Packs.apply(*fields)
    assert not packed[0].requires_grad and packed[0].grad_fn is None


# ---- the tile launch order ---------------------------------------------------


def _assert_launch_order(order, start, end):
    counts = (end - start).numpy()
    order = order.numpy()
    assert order.dtype == np.int32 and order.shape == counts.shape
    np.testing.assert_array_equal(np.sort(order), np.arange(counts.shape[0]))  # a permutation
    walked = counts[order]
    assert (walked[:-1] >= walked[1:]).all()  # falling pair count
    ties = walked[:-1] == walked[1:]
    assert (order[:-1][ties] < order[1:][ties]).all()  # ties in tile order


@pytest.mark.parametrize("size", [(200, 120), (64, 64), (803, 611)])
def test_binning_tile_order(size):
    w, h = size
    _, tp = _projected(4, 400, w, h)
    nty, ntx = -(-h // 16), -(-w // 16)
    b = bin_gaussians(tp, tile_h=16, tile_w=16, n_tiles_y=nty, n_tiles_x=ntx)
    assert b.tile_order.shape == (nty * ntx,)
    _assert_launch_order(b.tile_order, b.tile_start, b.tile_end)
    assert len(set((b.tile_end - b.tile_start).tolist())) < nty * ntx  # the scene has ties
    assert torch.equal(b.tile_order, tile_launch_order(b.tile_start, b.tile_end))


def test_tile_order_by_hand_and_under_capacity():
    start = torch.tensor([0, 3, 3, 8, 10, 10], dtype=torch.int32)
    end = torch.tensor([3, 3, 8, 10, 10, 13], dtype=torch.int32)  # counts 3 0 5 2 0 3
    order = tile_launch_order(start, end)
    assert order.tolist() == [2, 0, 5, 3, 1, 4]
    _assert_launch_order(order, start, end)
    # a capped pair list orders the tiles by the pairs that were kept
    _, tp = _projected(2, 400, 200, 120)
    b = bin_gaussians(tp, tile_h=16, tile_w=16, n_tiles_y=8, n_tiles_x=13, pair_capacity=200)
    assert b.overflow > 0
    _assert_launch_order(b.tile_order, b.tile_start, b.tile_end)


def test_tile_order_of_an_empty_scene():
    _, tp = _projected(3, 16, 64, 64)
    tp = tp._replace(valid=torch.zeros(16, dtype=torch.bool))
    b = bin_gaussians(tp, tile_h=16, tile_w=16, n_tiles_y=4, n_tiles_x=4)
    assert b.pair_gaussian.numel() == 0
    assert b.tile_order.dtype == torch.int32
    assert b.tile_order.tolist() == list(range(16))  # all tied at 0: tile order


# ---- the padded gradient buffer ----------------------------------------------


def test_gradient_buffer_view_and_strides():
    buf, grads = rc.gradient_buffer(7, torch.device("cpu"))
    assert buf.shape == (7, rc.ROW) and buf.dtype == torch.float32 and buf.is_contiguous()
    assert not buf.any()
    assert grads.shape == (7, rc.GRAD_COLS) and grads.stride() == (rc.ROW, 1)
    assert grads.data_ptr() == buf.data_ptr()  # a view: the kernel's writes show through
    buf.copy_(torch.arange(7 * rc.ROW, dtype=torch.float32).reshape(7, rc.ROW))
    assert torch.equal(grads, buf[:, :rc.GRAD_COLS])
    # the columns as `_Composite.backward` hands them to autograd
    cols = rc.split_columns(grads)
    assert [tuple(c.shape) for c in cols] == [(7, 2), (7, 3), (7,), (7, 3), (7,)]
    assert [c.stride() for c in cols] == [(rc.ROW, 1), (rc.ROW, 1), (rc.ROW,), (rc.ROW, 1),
                                          (rc.ROW,)]
    for c, (lo, hi) in zip(cols, [(0, 2), (2, 5), (5, 6), (6, 9), (9, 10)]):
        assert torch.equal(c.reshape(7, -1), buf[:, lo:hi])


def test_gradient_buffer_of_no_gaussians():
    buf, grads = rc.gradient_buffer(0, torch.device("cpu"))
    assert buf.shape == (0, rc.ROW) and grads.shape == (0, rc.GRAD_COLS)


def test_kernel_layout_refuses_a_wrong_table_or_order():
    """The wrappers take the tile order and the packed table from the caller
    (they make neither), and refuse CPU tensors for the device before any
    build or launch: the plain versions serve those."""
    fields = _attributes(4)
    zeros = torch.zeros(1, dtype=torch.int32)
    lists = (torch.zeros(0, dtype=torch.int32), zeros, zeros)
    with pytest.raises(TypeError, match="tile_order"):
        rc.composite_fwd_cuda(*fields, *lists, 16, 16)
    layout = {"tile_order": zeros, "attrs": rc.pack_attributes(*fields)}
    with pytest.raises(ValueError, match="CUDA"):
        rc.composite_fwd_cuda(*fields, *lists, 16, 16, **layout)
    with pytest.raises(ValueError, match="CUDA"):
        rc.composite_bwd_cuda(*fields, *lists, 16, 16, torch.ones(16, 16),
                              torch.zeros(16, 16, dtype=torch.int32), None, **layout)
    with pytest.raises(ValueError, match="CUDA"):
        rc._check_kernel_layout(zeros, layout["attrs"], 4, 1, torch.device("cpu"))


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """A kernel library is cached under a hash of what it was built from:
    the source and the headers it includes, so an edit of either rebuilds."""
    from gaussian_mesh_splatting_tpu_torch.ops import cuda_build

    assert os.path.exists(os.path.join(cuda_build.CSRC_DIR, "composite_common.cuh"))
    for name in ("composite_fwd.cu", "composite_bwd.cu", "composite_common.cuh"):
        shutil.copy(os.path.join(cuda_build.CSRC_DIR, name), tmp_path / name)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    keys = {k: cuda_build.source_digest(k) for k in ("composite_fwd", "composite_bwd")}
    assert keys["composite_fwd"] != keys["composite_bwd"]
    assert keys == {k: cuda_build.source_digest(k) for k in keys}
    with open(tmp_path / "composite_common.cuh", "a") as f:
        f.write("// edited\n")
    for k, before in keys.items():
        assert cuda_build.source_digest(k) != before


# ---- the composite with the layout in place, against the JAX oracle ----------


def _oracle_case():
    """96 Gaussians at 72x40 (a ragged right and bottom tile edge)."""
    s = {k: v.astype(np.float32) for k, v in _scene(8, 96, spread=0.6).items()}
    w, h = 72, 40
    jc = j_make_camera(np.eye(3), np.array([0.0, 0.0, 3.5]), 0.8, 0.8, w, h)
    tc = camera_from_numpy({f.name: np.asarray(getattr(jc, f.name))
                            for f in dataclasses.fields(jc)}, device="cpu")
    target = np.random.default_rng(9).random((h, w, 3)).astype(np.float32)
    return s, jc, tc, target


def _loss(out, target, mean, absolute):
    return mean(absolute(out.image - target)) + 0.1 * mean(out.depth) + 0.05 * mean(out.alpha)


def test_function_on_cpu_matches_jax_oracle_image_and_gradients():
    s, jc, tc, target = _oracle_case()

    def j_loss(p):
        out = j_raster(p["means3d"], p["scales"], p["rotations"], p["opacities"], jc,
                       bg=jnp.asarray(BG), shs=p["shs"], sh_degree=2, tile_size=(16, 16))
        return _loss(out, jnp.asarray(target), jnp.mean, jnp.abs), out

    (_, jout), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        {k: jnp.asarray(s[k]) for k in PARAMS})

    p = {k: torch.tensor(s[k], requires_grad=True) for k in PARAMS}
    tout = rc.rasterize_cuda(p["means3d"], p["scales"], p["rotations"], p["opacities"], tc,
                             bg=torch.tensor(BG), shs=p["shs"], sh_degree=2)
    _loss(tout, torch.tensor(target), torch.mean, torch.abs).backward()

    np.testing.assert_allclose(tout.image.detach().numpy(), np.asarray(jout.image), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(tout.alpha.detach().numpy(), np.asarray(jout.alpha), atol=2e-5,
                               rtol=0)
    d_scale = max(float(np.abs(np.asarray(jout.depth)).max()), 1e-6)
    np.testing.assert_allclose(tout.depth.detach().numpy(), np.asarray(jout.depth),
                               atol=2e-4 * d_scale, rtol=0)
    assert float(tout.alpha.detach().max()) > 0.1
    for name in PARAMS:
        ref = np.asarray(jg[name])
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        np.testing.assert_allclose(p[name].grad.numpy(), ref, rtol=0, atol=5e-4 * scale + 1e-7,
                                   err_msg=f"gradient of {name}")


def test_function_on_cpu_equals_plain_versions_whatever_the_tile_order():
    """On CPU tensors the Function runs the plain versions, which take the
    tiles all at once: the launch order must not change a bit of the planes
    or of the gradients, and the Function must return exactly what the plain
    versions return."""
    s, _, tc, _ = _oracle_case()
    t = {k: torch.tensor(v) for k, v in s.items()}
    proj = preprocess(t["means3d"], t["scales"], t["rotations"], t["opacities"], tc,
                      shs=t["shs"], sh_degree=2, radius_mode="tight")
    h, w = tc.height, tc.width
    n_ty, n_tx = rc._tile_grid(h, w)
    b = bin_gaussians(proj, tile_h=rc.TILE, tile_w=rc.TILE, n_tiles_y=n_ty, n_tiles_x=n_tx)
    cot = torch.tensor(np.random.default_rng(5).standard_normal((5, h, w)).astype(np.float32))
    fields = ("mean2d", "conic", "opacity", "color", "depth")

    def run(binning):
        leaves = [getattr(proj, f).detach().clone().requires_grad_(True) for f in fields]
        planes, nc = rc.composite(*leaves, binning, h, w)
        grads = torch.autograd.grad((planes * cot).sum(), leaves)
        return planes.detach(), nc, grads

    planes, nc, grads = run(b)
    flipped = b._replace(tile_order=torch.flip(b.tile_order, dims=(0,)))
    planes_f, nc_f, grads_f = run(flipped)
    assert torch.equal(planes, planes_f) and torch.equal(nc, nc_f)
    for g, g_f in zip(grads, grads_f):
        assert torch.equal(g, g_f)

    leaves = [getattr(proj, f).detach() for f in fields]
    lists = (b.pair_gaussian, b.tile_start, b.tile_end)
    planes_p, nc_p = rc.composite_fwd_plain(*leaves, *lists, h, w)
    assert torch.equal(planes, planes_p) and torch.equal(nc, nc_p)
    g_p = rc.composite_bwd_plain(*leaves, *lists, h, w, planes_p[3], nc_p, cot)
    assert g_p.shape == (leaves[0].shape[0], rc.GRAD_COLS) and g_p.abs().sum() > 0
    for g, col in zip(grads, rc.split_columns(g_p)):
        assert torch.equal(g, col)
