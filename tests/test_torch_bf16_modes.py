"""The JAX rasterizer's bf16 pair-table modes in the port
(`rasterize_cuda(attr_precision=, grad_precision=)`), on the CPU path (the
kernels' plain versions behind the same autograd Function), against the JAX
package on the same numpy-seeded inputs: 64 Gaussians at 128x32, SH 2, the
size of tests/test_raster_pallas.py.

  * attr_precision="bf16" stores mean2d, conic and opacity as exact hi/lo
    bf16 pairs and colour and depth as plain bf16. The table and its
    reconstruction equal the JAX construction (rasterize_pallas's attr_split
    rows, `_chunk_columns`) bit for bit.
  * The forward composites the rounded attributes, as JAX's does, so the two
    agree at the exact mode's tolerances (image and alpha 2e-5, depth
    2e-4 x max|depth|), and the port is as far from the float32 oracle as
    JAX is: within JAX's own bounds (6e-3, 5e-4, 1e-2 x max|depth|) wherever
    JAX's default mode is.
  * Gradients: a JAX pair is a (Gaussian, 32x32 tile), a port pair a
    (Gaussian, 16x16 tile), so the per-pair rounding acts on different
    partial sums. The port's gradients can only match JAX's in the same mode
    within JAX's own bound against the oracle, 8e-2 x max|g| per key, never
    bit for bit. They are held to it, to the port's exact mode within the
    same bound (or JAX's own distance from its oracle, where that is larger),
    and must differ from the exact mode (the rounding happens).

Interpret-mode Pallas costs ~20 s a trace on the CPU, so the JAX calls are
three, shared through module-scoped fixtures and `jax_grads`' cache: the
default forward, the default gradient and the (f32, bf16) gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu.ops.rasterize_pallas import rasterize_pallas as j_pallas
from gaussian_mesh_splatting_tpu.ops.rasterize_reference import rasterize_reference as j_raster
from gaussian_mesh_splatting_tpu_torch.models import mesh as tmesh
from gaussian_mesh_splatting_tpu_torch.models.gaussian_bag import GaussianBag
from gaussian_mesh_splatting_tpu_torch.ops import rasterize_cuda as rc
from gaussian_mesh_splatting_tpu_torch.ops.binning import bin_gaussians
from gaussian_mesh_splatting_tpu_torch.ops.projection import preprocess
from gaussian_mesh_splatting_tpu_torch.renderer import render
from gaussian_mesh_splatting_tpu_torch.train import make_train_step, optimization_config

from test_torch_raster_grads import BG, case_inputs, jax_grads, torch_grads
from test_torch_train import SH as TRAIN_SH, _torch_start

torch.set_num_threads(2)
CASE = "pallas_small"
MODES = [("bf16", "bf16"), ("f32", "bf16"), ("bf16", "f32")]
BF16_GRAD_TOL = 8e-2  # x max|g| per key: JAX's bound on its default mode (test_raster_pallas.py)


def _attribute_arrays(seed: int, n: int = 257) -> dict:
    """Seeded float32 attributes at the render path's scales: pixel
    coordinates of an 800x800 view (some off screen), conics, opacities,
    colours, depths; every 16th row zero (a dead row)."""
    rng = np.random.default_rng(seed)
    a = {
        "mean2d": rng.uniform(-60.0, 860.0, (n, 2)),
        "conic": np.stack([rng.lognormal(-3, 2, n), rng.normal(0, 0.01, n),
                           rng.lognormal(-3, 2, n)], axis=1),
        "opacity": rng.random(n),
        "color": rng.random((n, 3)),
        "depth": rng.uniform(0.2, 40.0, n),
    }
    a = {k: v.astype(np.float32) for k, v in a.items()}
    for v in a.values():
        v[::16] = 0.0
    return a


def _jax_split_rows(a: dict):
    """rasterize_pallas's attr_split rows and its kernels' reconstruction
    (`_chunk_columns`: hi + lo for the first six columns), in jnp."""
    n = a["mean2d"].shape[0]
    base = jnp.concatenate([a["mean2d"], a["conic"], a["opacity"][:, None]], axis=1)
    hi = base.astype(jnp.bfloat16)
    lo = (base - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    split_cols = jnp.stack([hi, lo], axis=2).reshape(n, 12)
    plain = jnp.concatenate([a["color"], a["depth"][:, None]], axis=1).astype(jnp.bfloat16)
    rows = jnp.concatenate([split_cols, plain], axis=1)
    at = rows.astype(jnp.float32)
    values = jnp.concatenate([at[:, 0:12:2] + at[:, 1:12:2], at[:, 12:]], axis=1)
    return np.asarray(jax.lax.bitcast_convert_type(rows, jnp.uint16)), np.asarray(values)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_table_and_its_values_equal_jax_bit_for_bit(seed):
    a = _attribute_arrays(seed)
    want_bits, want_values = _jax_split_rows({k: jnp.asarray(v) for k, v in a.items()})
    t = {k: torch.tensor(v) for k, v in a.items()}
    table = rc.pack_attributes_bf16(t["mean2d"], t["conic"], t["opacity"], t["color"],
                                    t["depth"])
    assert table.dtype == torch.bfloat16 and table.shape == (len(a["depth"]), rc.BF16_ROW)
    assert table.is_contiguous() and table.data_ptr() % 16 == 0
    np.testing.assert_array_equal(table.view(torch.int16).numpy().view(np.uint16), want_bits)
    got = torch.cat([c.reshape(len(a["depth"]), -1) for c in rc.round_attributes(
        t["mean2d"], t["conic"], t["opacity"], t["color"], t["depth"])], dim=1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want_values.view(np.uint32))
    # dead rows stay exactly zero (hi = lo = 0), and the split pairs are exact:
    # hi + lo is the float32 value to 2^-16 relative
    assert not table[::16].view(torch.int16).any()
    np.testing.assert_allclose(got[:, :6].numpy(), np.concatenate(
        [a["mean2d"], a["conic"], a["opacity"][:, None]], axis=1), rtol=2.0**-16, atol=0)


def test_round_attributes_keeps_the_attributes_layout():
    """`round_attributes` returns float32 tensors of the inputs' shapes;
    colour and depth are bf16 values, and the table's plain columns hold
    them."""
    t = {k: torch.tensor(v) for k, v in _attribute_arrays(2).items()}
    args = (t["mean2d"], t["conic"], t["opacity"], t["color"], t["depth"])
    rounded = rc.round_attributes(*args)
    for x, r in zip(args, rounded):
        assert r.dtype == torch.float32 and r.shape == x.shape
    plain = torch.cat([rounded[3], rounded[4][:, None]], dim=1)
    assert torch.equal(plain, plain.to(torch.bfloat16).float())
    assert torch.equal(rc.pack_attributes_bf16(*args).float()[:, 12:], plain)


@pytest.fixture(scope="module")
def jax_default_forward():
    """JAX's Pallas rasterizer at its defaults (both bf16; interpret mode) and
    its float32 oracle, on CASE."""
    s, jc, _, _ = case_inputs(CASE)
    args = [jnp.asarray(s[k]) for k in ("means3d", "scales", "rotations", "opacities")]
    kw = dict(bg=jnp.asarray(BG), shs=jnp.asarray(s["shs"]), sh_degree=2)
    pallas = j_pallas(*args, jc, interpret=True, **kw)
    oracle = j_raster(*args, jc, tile_size=(16, 16), **kw)
    return ({k: np.asarray(getattr(pallas, k)) for k in ("image", "alpha", "depth")},
            {k: np.asarray(getattr(oracle, k)) for k in ("image", "alpha", "depth")})


def _port_forward(**kw):
    s, _, tc, _ = case_inputs(CASE)
    t = {k: torch.tensor(v) for k, v in s.items()}
    with torch.no_grad():
        out = rc.rasterize_cuda(t["means3d"], t["scales"], t["rotations"], t["opacities"], tc,
                                bg=torch.tensor(BG), shs=t["shs"], sh_degree=2, **kw)
    return {k: getattr(out, k).numpy() for k in ("image", "alpha", "depth")}


@pytest.mark.parametrize("grad_precision", ["f32", "bf16"])
def test_bf16_forward_matches_jax_default_mode(jax_default_forward, grad_precision):
    pallas, oracle = jax_default_forward
    got = _port_forward(attr_precision="bf16", grad_precision=grad_precision)
    d_scale = max(float(np.abs(pallas["depth"]).max()), 1e-6)
    np.testing.assert_allclose(got["image"], pallas["image"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got["alpha"], pallas["alpha"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got["depth"], pallas["depth"], atol=2e-4 * d_scale, rtol=0)
    # JAX's own bounds of its default mode against the oracle (measured on
    # its test scene): image 6e-3, alpha 5e-4, depth 1e-2 x max|depth|. On
    # this scene JAX's default mode is itself over the alpha bound at one
    # pixel, where a pair at the alpha = 1/255 cut is moved across it by the
    # rounding of its mean and conic (pinned below); the port may exceed the
    # alpha bound only where JAX does, and is as far from the oracle as JAX is
    o_scale = max(float(np.abs(oracle["depth"]).max()), 1e-6)
    bounds = {"image": 6e-3, "alpha": 5e-4, "depth": 1e-2 * o_scale}
    for k, bound in bounds.items():
        err_port, err_jax = (np.abs(x[k] - oracle[k]) for x in (got, pallas))
        assert not (err_port > bound)[err_jax <= bound].any(), k
        assert float(err_port.max()) <= float(err_jax.max()) + 2e-5, k
        if k != "alpha":
            assert float(err_jax.max()) <= bound, k
    err_alpha = np.abs(pallas["alpha"] - oracle["alpha"])
    assert int((err_alpha > 5e-4).sum()) == 1 and float(err_alpha.max()) > 2e-3
    assert float(got["alpha"].max()) > 0.1
    # the rounding happened: the exact mode's image differs
    assert not np.array_equal(got["image"], _port_forward()["image"])


def test_grad_precision_alone_leaves_the_forward_exact():
    assert all(np.array_equal(a, b) for a, b in zip(
        _port_forward(grad_precision="bf16").values(), _port_forward().values()))


def _assert_within(got: dict, ref: dict, tol: float, what: str) -> None:
    for name, a in ref.items():
        scale = float(np.abs(a).max())
        assert scale > 0, f"{what}: the gradient of {name} is identically zero"
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], a, rtol=0, atol=tol * scale + 1e-7,
                                   err_msg=f"{what}: gradient of {name}")


def _max_rel_gap(got: dict, ref: dict) -> dict:
    return {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref}


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
def test_bf16_gradients(mode):
    """Within 8e-2 x max|g| of JAX's gradient in the same mode ((bf16, f32):
    JAX's (bf16, bf16), the same computation, since a bf16 table's pairs are
    rounded whatever grad_precision says) and of the port's exact mode, and
    not equal to the exact mode. On this scene JAX's own default mode is
    more than 8e-2 x max|g| off its float32 oracle on means3d (pinned below;
    JAX measured 4e-2 on its test scene): where JAX's mode is further than
    8e-2 from its oracle, the port's may be as far from its exact mode as
    JAX's is plus 1e-2."""
    attr, grad = mode
    got = torch_grads(CASE, "cuda_path", attr_precision=attr, grad_precision=grad)
    exact = torch_grads(CASE, "cuda_path")
    jax_mode = ("bf16", "bf16") if attr == "bf16" else mode
    _assert_within(got, jax_grads(CASE, "pallas", jax_mode), BF16_GRAD_TOL, f"JAX {jax_mode}")
    jax_gap = _max_rel_gap(jax_grads(CASE, "pallas", jax_mode), jax_grads(CASE))
    if attr == "bf16":
        assert jax_gap["means3d"] > BF16_GRAD_TOL
    for k, gap in _max_rel_gap(got, exact).items():
        assert gap <= max(BF16_GRAD_TOL, jax_gap[k] + 1e-2), (k, gap, jax_gap[k])
    assert any(not np.array_equal(got[k], exact[k]) for k in got), \
        f"{mode}: the gradients equal the exact mode's: nothing was rounded"


def test_bf16_table_rounds_pairs_whatever_the_grad_precision():
    """Under attr_precision="bf16" the per-pair gradients are rounded (the
    JAX kernel writes them to a bf16 table) whatever grad_precision says, so
    the two modes are one computation."""
    a = torch_grads(CASE, "cuda_path", attr_precision="bf16", grad_precision="bf16")
    b = torch_grads(CASE, "cuda_path", attr_precision="bf16", grad_precision="f32")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _composite_case():
    """The composite's inputs on CASE (projection, binning) and a seeded
    cotangent of its five planes."""
    s, _, tc, _ = case_inputs(CASE)
    t = {k: torch.tensor(v) for k, v in s.items()}
    proj = preprocess(t["means3d"], t["scales"], t["rotations"], t["opacities"], tc,
                      shs=t["shs"], sh_degree=2, radius_mode="tight")
    n_ty, n_tx = rc._tile_grid(tc.height, tc.width)
    binning = bin_gaussians(proj, tile_h=rc.TILE, tile_w=rc.TILE, n_tiles_y=n_ty,
                            n_tiles_x=n_tx)
    cot = torch.tensor(np.random.default_rng(3).standard_normal(
        (rc.N_PLANES, tc.height, tc.width)).astype(np.float32))
    gaussians = [x.detach().contiguous() for x in
                 (proj.mean2d, proj.conic, proj.opacity, proj.color, proj.depth)]
    return gaussians, binning, tc.height, tc.width, cot


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
def test_function_returns_the_plain_versions_in_each_mode(mode):
    """Through `_Composite` on CPU tensors: the forward is the plain forward
    on `round_attributes` (attr bf16), the per-Gaussian gradients are the
    plain backward's with each pair rounded, then (attr bf16) rounded to
    bf16, so that every value is exactly a bf16; under (f32, bf16) the totals
    are float32 sums of bf16 values and not all are bf16."""
    attr, grad = mode
    gaussians, binning, h, w, cot = _composite_case()
    leaves = [g.clone().requires_grad_(True) for g in gaussians]
    planes, nc = rc.composite(*leaves, binning, h, w, attr_precision=attr, grad_precision=grad)
    planes.backward(cot)
    got = torch.cat([x.grad.reshape(x.shape[0], -1) for x in leaves], dim=1)

    inputs = rc.round_attributes(*gaussians) if attr == "bf16" else gaussians
    lists = (binning.pair_gaussian, binning.tile_start, binning.tile_end)
    want_planes, want_nc = rc.composite_fwd_plain(*inputs, *lists, h, w)
    assert torch.equal(planes.detach(), want_planes) and torch.equal(nc, want_nc)
    want = rc.composite_bwd_plain(*inputs, *lists, h, w, want_planes[3], want_nc, cot,
                                  round_pairs=True)
    if attr == "bf16":
        want = want.to(torch.bfloat16).float()
    assert torch.equal(got, want)
    representable = torch.equal(got, got.to(torch.bfloat16).float())
    assert representable == (attr == "bf16")
    assert float(got.abs().max()) > 0


def test_plain_backward_rounds_each_pair():
    """`composite_bwd_plain(round_pairs=True)` is a sum of bf16 values per
    (Gaussian, tile) pair: with one tile per Gaussian it is bf16 itself, and
    it differs from the exact backward."""
    gaussians, binning, h, w, cot = _composite_case()
    lists = (binning.pair_gaussian, binning.tile_start, binning.tile_end)
    planes, nc = rc.composite_fwd_plain(*gaussians, *lists, h, w)
    exact = rc.composite_bwd_plain(*gaussians, *lists, h, w, planes[3], nc, cot)
    rounded = rc.composite_bwd_plain(*gaussians, *lists, h, w, planes[3], nc, cot,
                                     round_pairs=True)
    pairs = torch.bincount(binning.pair_gaussian.long(), minlength=exact.shape[0])
    one = pairs == 1
    assert one.any() and (pairs > 1).any()
    assert torch.equal(rounded[one], rounded[one].to(torch.bfloat16).float())
    assert torch.equal(rounded[one], exact[one].to(torch.bfloat16).float())
    assert not torch.equal(rounded, exact)


def test_bf16_row_band_is_bit_equal_to_the_whole_render():
    s, _, tc, _ = case_inputs("aligned")  # 128x64: four tile rows
    t = {k: torch.tensor(v) for k, v in s.items()}
    kw = dict(bg=torch.tensor(BG), shs=t["shs"], sh_degree=2, attr_precision="bf16",
              grad_precision="bf16")
    args = (t["means3d"], t["scales"], t["rotations"], t["opacities"], tc)
    with torch.no_grad():
        whole = rc.rasterize_cuda(*args, **kw)
        band = rc.rasterize_cuda(*args, row_band=(1, 3), **kw)
    for k in ("image", "depth", "alpha"):
        assert torch.equal(getattr(band, k), getattr(whole, k)[16:48]), k
    assert float(band.alpha.max()) > 0.1


def _bag(case="aligned"):
    s, _, tc, _ = case_inputs(case)
    t = {k: torch.tensor(v) for k, v in s.items()}
    return GaussianBag(xyz=t["means3d"], scaling=t["scales"], rotation=t["rotations"],
                       opacity=t["opacities"], shs=t["shs"],
                       alive=torch.ones(t["means3d"].shape[0], dtype=torch.bool)), tc


@pytest.mark.parametrize("mode", MODES, ids=["-".join(m) for m in MODES])
def test_flags_arrive_through_render(mode):
    attr, grad = mode
    bag, tc = _bag()
    bg = torch.tensor(BG)
    with torch.no_grad():
        got = render(bag, tc, bg, sh_degree=2, attr_precision=attr, grad_precision=grad)
        want = rc.rasterize_cuda(bag.xyz, bag.scaling, bag.rotation, bag.opacity, tc, bg=bg,
                                 shs=bag.shs, sh_degree=2, alive=bag.alive,
                                 attr_precision=attr, grad_precision=grad)
        exact = render(bag, tc, bg, sh_degree=2)
    for k in ("image", "depth", "alpha"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert torch.equal(got.image, exact.image) == (attr == "f32")


def _one_step(render_kwargs=None, render_fn=None):
    state, _, cams, gts, bg = _torch_start()
    step = make_train_step(tmesh, optimization_config("gs_mesh"), TRAIN_SH,
                           render_kwargs=render_kwargs, render_fn=render_fn)
    params = {k: v.detach().clone() for k, v in state.params.items()}
    state, metrics = step(state, cams[1], gts[1], bg)
    return params, {k: v.grad.clone() for k, v in state.params.items()}, metrics, state


@pytest.mark.parametrize("mode", [("bf16", "bf16"), ("f32", "bf16")],
                         ids=["bf16-bf16", "f32-bf16"])
def test_flags_arrive_through_make_train_step(mode):
    """One `gs_mesh` step with the modes in `render_kwargs` equals the step
    whose render is a direct `rasterize_cuda` call in that mode (loss,
    every gradient, the densification statistics), and differs from the
    exact mode's step."""
    attr, grad = mode

    def direct(bag, cam, bg, mean2d_offset):
        return rc.rasterize_cuda(bag.xyz, bag.scaling, bag.rotation, bag.opacity, cam, bg=bg,
                                 shs=bag.shs, sh_degree=TRAIN_SH, alive=bag.alive,
                                 mean2d_offset=mean2d_offset, attr_precision=attr,
                                 grad_precision=grad)

    p0, g, m, st = _one_step(render_kwargs=dict(attr_precision=attr, grad_precision=grad))
    p0_d, g_d, m_d, st_d = _one_step(render_fn=direct)
    _, g_x, m_x, _ = _one_step()
    assert all(torch.equal(p0[k], p0_d[k]) for k in p0)
    assert float(m["loss"]) == float(m_d["loss"])
    for k in g:
        assert torch.equal(g[k], g_d[k]), k
    for k in ("grad_accum", "denom", "max_radii"):
        assert torch.equal(getattr(st.stats, k), getattr(st_d.stats, k)), k
    assert any(not torch.equal(g[k], g_x[k]) for k in g)
    assert (float(m["loss"]) == float(m_x["loss"])) == (attr == "f32")


@pytest.mark.parametrize("kw", [dict(attr_precision="fp16"), dict(grad_precision="float32"),
                                dict(attr_precision="BF16", grad_precision="bf16")],
                         ids=["attr", "grad", "case"])
def test_unknown_precision_raises(kw):
    bag, tc = _bag()
    args = (bag.xyz, bag.scaling, bag.rotation, bag.opacity, tc)
    with pytest.raises(ValueError, match="precision"):
        rc.rasterize_cuda(*args, bg=torch.tensor(BG), shs=bag.shs, sh_degree=2, **kw)
    with pytest.raises(ValueError, match="precision"):
        render(bag, tc, torch.tensor(BG), sh_degree=2, **kw)
    gaussians, binning, h, w, _ = _composite_case()
    with pytest.raises(ValueError, match="precision"):
        rc.composite(*gaussians, binning, h, w, **kw)


def test_kernel_wrappers_take_the_bf16_table_and_refuse_cpu_tensors():
    """The wrappers accept the (N, 16) bfloat16 table as the kernels' layout
    (and nothing else of that dtype), and refuse CPU tensors for the device
    before any build or launch."""
    gaussians, binning, h, w, cot = _composite_case()
    n = gaussians[0].shape[0]
    lists = (binning.pair_gaussian, binning.tile_start, binning.tile_end)
    table = rc.pack_attributes_bf16(*gaussians)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        rc._check_kernel_layout(binning.tile_order, table, n, binning.tile_order.shape[0], cpu)
    with pytest.raises(ValueError, match="CUDA"):
        rc.composite_fwd_cuda(*gaussians, *lists, h, w, tile_order=binning.tile_order,
                              attrs=table)
    with pytest.raises(ValueError, match="CUDA"):
        rc.composite_bwd_cuda(*gaussians, *lists, h, w, torch.ones(h, w),
                              torch.zeros(h, w, dtype=torch.int32), cot,
                              tile_order=binning.tile_order, attrs=table, round_pairs=True)
    assert set(rc.BWD_ENTRIES) == {(False, False), (False, True), (True, True)}
    assert rc.FWD_ENTRIES == {False: "composite_fwd", True: "composite_fwd_bf16"}
