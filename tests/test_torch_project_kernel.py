"""The projection kernels' CPU side (csrc/preprocess.cu runs only on a card):
`preprocess_bwd_plain`, the VJP kernel's plain version, against autograd of
`preprocess`; the dispatch of `rasterize_cuda` between the kernels and the
chain; the camera values the kernels read; the wrappers' refusals.

The VJP is held per leaf at 1e-10 x max|g| in float64 (the derivation) and
1e-5 x max|g| in float32 (autograd sums a leaf's terms in another order),
with the non-finite entries in the same places. Besides random rows, a
scene of exact ties: view-space x/z and y/z on both frustum limits, an SH
colour channel at exactly -0.5 (the clamp at 0), a rank-1 covariance whose
det_raw is exactly 0 (the antialiasing floor, where sqrt's gradient is
infinite in both), rank-1 covariances whose det_raw rounds to 0 or below,
and a view-space z inside the 1e-6 guard."""
import dataclasses

import numpy as np
import pytest
import torch

from gaussian_mesh_splatting_tpu_torch.core.camera import make_camera
from gaussian_mesh_splatting_tpu_torch.core.sh import C0
from gaussian_mesh_splatting_tpu_torch.ops import cuda_build
from gaussian_mesh_splatting_tpu_torch.ops import projection as P
from gaussian_mesh_splatting_tpu_torch.ops import rasterize_cuda as rc
from gaussian_mesh_splatting_tpu_torch.ops.projection import (
    FRUSTUM_CLAMP, preprocess, preprocess_bwd_plain)
from gaussian_mesh_splatting_tpu_torch.utils.profiling import Recording, tracing

torch.set_num_threads(2)
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
K = 25  # SH coefficients of the bags (degree 4)
LEAVES = ("means3d", "scales", "rotations", "opacities", "shs")
GUARD_ROW = 40  # the tie scene's row at view-space z = 4e-7, inside the |tz| < 1e-6 guard


def _camera(ties: bool):
    if ties:  # world_view = identity: view-space x, y, z are the world's, exactly
        return make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 96, 72, device="cpu")
    R, _ = np.linalg.qr(np.array([[0.96, -0.2, 0.19], [0.22, 0.97, -0.05],
                                  [-0.17, 0.09, 0.98]]))
    return make_camera(R, np.array([0.1, -0.2, 4.0]), 0.9, 0.7, 96, 72, device="cpu")


def _exact_product_root(c: float, want: float, dtype) -> float:
    """A value x of `dtype` with x * c == want exactly in `dtype` (c > 0)."""
    x = torch.tensor(want / c, dtype=dtype)
    up = torch.tensor(float("inf"), dtype=dtype)
    for _ in range(64):
        product = (torch.ones((), dtype=dtype) * c * x).item()
        if product == want:
            return x.item()
        x = torch.nextafter(x, -up if product > want else up)
    raise AssertionError("no exact root")


def _scene(dtype, ties: bool, seed: int = 0):
    """(camera, [means3d, scales, rotations, opacities (N, 1), shs (N, 3, K) as
    the bags hold them: a transpose of a contiguous (N, K, 3)], the rank-1
    rows)."""
    g = torch.Generator().manual_seed(seed)
    cam = _camera(ties)
    n = 160
    m = torch.randn(n, 3, generator=g, dtype=torch.float64) * 1.2
    s = torch.rand(n, 3, generator=g, dtype=torch.float64) * 0.3 + 0.01
    q = torch.randn(n, 4, generator=g, dtype=torch.float64)
    o = torch.rand(n, 1, generator=g, dtype=torch.float64)
    sh = torch.randn(n, K, 3, generator=g, dtype=torch.float64) * 0.5
    needles = torch.zeros(n, dtype=torch.bool)
    if ties:
        m[:, 2] = m[:, 2].abs() + 1.0  # in front of the camera at the origin
        limx = (FRUSTUM_CLAMP * cam.tanfovx).to(dtype).item()
        limy = (FRUSTUM_CLAMP * cam.tanfovy).to(dtype).item()
        # the frustum clamp's four ties (x / z or y / z on a limit, z = 2)
        m[0:4] = torch.tensor([[2 * limx, 0.1, 2.0], [-2 * limx, 0.2, 2.0],
                               [0.3, 2 * limy, 2.0], [-0.1, -2 * limy, 2.0]], dtype=torch.float64)
        # beyond the limits: the clamp holds
        m[4:6] = torch.tensor([[3 * limx, 0.0, 1.5], [0.0, -3 * limy, 1.5]], dtype=torch.float64)
        # the SH clamp's tie: red's sum is exactly -0.5 (higher coefficients 0)
        sh[6:9, :, 0] = 0.0
        sh[6:9, 0, 0] = _exact_product_root(C0, -0.5, dtype)
        # the antialiasing floor's tie: rank 1 along view-space x, on the axis
        m[9] = torch.tensor([0.0, 0.0, 3.0], dtype=torch.float64)
        q[9] = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
        s[9] = torch.tensor([0.2, 0.0, 0.0], dtype=torch.float64)
        # rank-1 rows elsewhere whose det_raw rounds to 0 or below (the floor
        # holds); those it leaves above 0 keep their scales: sqrt's gradient
        # is huge there, and no float32 sum of it is accurate to 1e-5
        full = s[10:40].clone()
        s[10:40, 1:] = 0.0
        floor = _antialias_factor(cam, m[10:40], s[10:40], q[10:40], dtype) == 0.0
        s[10:40] = torch.where(floor[:, None], s[10:40], full)
        needles[9] = True
        needles[10:40] = floor
        # inside the |tz| < 1e-6 guard (its mean2d cotangent is zeroed: 1 / w
        # is ~1e7 there)
        m[GUARD_ROW] = torch.tensor([0.1, -0.1, 4e-7], dtype=torch.float64)
    tensors = [t.to(dtype) for t in (m, s, q, o, sh)]
    tensors[4] = tensors[4].transpose(1, 2)
    return cam, tensors, needles


def _antialias_factor(cam, m, s, q, dtype):
    """sqrt(max(det_raw / det_d, 0)) of each row, as `preprocess` computes it."""
    m, s, q = (t.to(dtype) for t in (m, s, q))
    ones = torch.ones_like(m[:, :1])
    return preprocess(m, s, q, ones, cam, colors=ones.expand(-1, 3), antialiasing=True).opacity


def _row_errors(got, want):
    """Each row's largest |got - want| over the entries finite in both."""
    both = torch.isfinite(want) & torch.isfinite(got)
    err = torch.where(both, got.double() - want.double(), 0.0)
    return err.abs().reshape(got.shape[0], -1).amax(dim=1)


def _assert_close(got, want, tol, label, rows=None):
    """Non-finite entries in the same places; the finite ones of `rows` (all
    if None) within tol x the leaf's max|g|."""
    assert got.shape == want.shape, label
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)), f"{label}: non-finite entries differ"
    if not fin.any():
        return
    scale = want[fin].abs().max().item()
    err = _row_errors(got, want)
    worst = (err if rows is None else err[rows]).max().item()
    assert worst <= tol * scale + 1e-30, f"{label}: {worst:.3g} > {tol} x {scale:.3g}"


def _assert_as_accurate(plain, auto, truth, rows, label):
    """On `rows`, the plain float32 VJP no further from the float64 result
    than autograd's float32 one (twice its distance, plus 1e-5 x max|g|)."""
    scale = truth[torch.isfinite(truth)].abs().max().item()
    mine = _row_errors(plain, truth)[rows].max().item()
    theirs = _row_errors(auto, truth)[rows].max().item()
    assert mine <= 2.0 * theirs + TOL[torch.float32] * scale, \
        f"{label}: {mine:.3g} from float64 against autograd's {theirs:.3g}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("antialiasing", [False, True])
def test_plain_vjp_matches_autograd(dtype, ties, sh_degree, antialiasing):
    cam, inputs, needles = _scene(dtype, ties, seed=sh_degree)
    # the rank-1 rows in float32 are held to float64 instead: there autograd's
    # own float32 gradient is up to 1e-4 x max|g| off its float64 one (a
    # needle's quaternion gradient is nearly parallel to the quaternion, and
    # the normalisation's projection cancels)
    needles_f32 = dtype == torch.float32 and bool(needles.any())
    g = torch.Generator().manual_seed(100 + sh_degree)
    n = inputs[0].shape[0]
    offset = torch.zeros(n, 2, dtype=dtype, requires_grad=True)
    alive = torch.rand(n, generator=g) > 0.2
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    for mode, extra in (("tight", dict(mean2d_offset=offset, alive=alive)), ("cuda", {})):
        proj = preprocess(*leaves[:4], cam, shs=leaves[4], sh_degree=sh_degree,
                          antialiasing=antialiasing, radius_mode=mode, **extra)
        outs = (proj.mean2d, proj.depth, proj.conic, proj.opacity, proj.color)
        cots = tuple(torch.randn(t.shape, generator=g, dtype=torch.float64).to(dtype)
                     for t in outs)
        if ties:
            cots[0][GUARD_ROW] = 0.0
        wrt = leaves + ([offset] if extra else [])
        want = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
        got = preprocess_bwd_plain(*inputs, cam, cots, sh_degree=sh_degree,
                                   antialiasing=antialiasing)
        if needles_f32:
            up = [t.detach().double().requires_grad_() for t in inputs]
            p64 = preprocess(*up[:4], cam, shs=up[4], sh_degree=sh_degree,
                             antialiasing=antialiasing)
            truth = torch.autograd.grad(
                (p64.mean2d, p64.depth, p64.conic, p64.opacity, p64.color), up,
                tuple(c.double() for c in cots))
        for i, (name, a, b) in enumerate(zip(LEAVES, got, want)):
            label = f"{name} ({mode})"
            _assert_close(a, b, TOL[dtype], label, ~needles if needles_f32 else None)
            if needles_f32:
                _assert_as_accurate(a, b, truth[i], needles, label)
        if extra:  # the offset's gradient is the mean2d cotangent
            assert torch.equal(want[5], cots[0])
        k = (sh_degree + 1) ** 2
        assert torch.equal(got[4][:, :, k:], torch.zeros_like(got[4][:, :, k:]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tie_scene_reaches_every_tie(dtype):
    """The tie rows are where the tests say: on the frustum limits, an SH sum
    of exactly -0.5, a det_raw of exactly 0 (an antialiased opacity of 0
    whose gradient is not finite) and rank-1 rows on the floor."""
    cam, (m, s, q, o, sh), needles = _scene(dtype, ties=True)
    limx = (FRUSTUM_CLAMP * cam.tanfovx).to(dtype)
    limy = (FRUSTUM_CLAMP * cam.tanfovy).to(dtype)
    u = m[:, 0] / m[:, 2]
    v = m[:, 1] / m[:, 2]
    assert u[0] == limx and u[1] == -limx and v[2] == limy and v[3] == -limy
    assert abs(u[4]) > limx and abs(v[5]) > limy
    assert 0.0 < m[GUARD_ROW, 2] < 1e-6
    red = torch.ones((), dtype=dtype) * C0 * sh[6:9, 0, 0] + 0.5
    assert torch.equal(red, torch.zeros_like(red))
    leaves = [t.detach().clone().requires_grad_() for t in (m, s, q, o, sh)]
    proj = preprocess(*leaves[:4], cam, shs=leaves[4], sh_degree=3, antialiasing=True)
    assert proj.opacity[9] == 0.0
    floor = _antialias_factor(cam, m, s, q, dtype)[10:40] == 0.0
    assert torch.equal(floor, needles[10:40]) and floor.sum() >= 5  # of 30 candidates
    proj.opacity[9].backward()
    assert not torch.isfinite(leaves[0].grad[9]).all()


def test_dispatch_sends_other_calls_to_the_chain():
    """CPU tensors run `preprocess` in `rasterize_cuda`, whatever the options
    (`colors`, `cov3d_precomp`, SH degree 4); the `project_kernel` counter
    reads 0 there. On the card every call goes to the kernels, and `project`
    refuses what they do not take before it touches a tensor."""
    cam, (m, s, q, o, sh), _ = _scene(torch.float32, ties=False)
    n = m.shape[0]
    colors = torch.rand(n, 3)
    cov6 = torch.tensor([0.01, 0.0, 0.0, 0.01, 0.0, 0.01]).expand(n, 6)
    for extra in (dict(shs=sh, sh_degree=3), dict(shs=sh, sh_degree=4),
                  dict(shs=sh, sh_degree=0, mean2d_offset=torch.zeros(n, 2)),
                  dict(colors=colors), dict(shs=sh, sh_degree=3, cov3d_precomp=cov6)):
        rec = Recording("cpu")
        with tracing(rec), torch.no_grad():
            out = rc.rasterize_cuda(m, s, q, o, cam, bg=torch.zeros(3), **extra)
        assert rec.totals()["project_kernel"] == 0, extra.keys()
        assert torch.isfinite(out.image).all()
    for refused in (dict(shs=None, colors=colors), dict(shs=sh, colors=colors),
                    dict(shs=sh, cov3d_precomp=cov6), dict(shs=None)):
        with pytest.raises(ValueError, match="colors"):
            P.project(m, s, q, o, cam, sh_degree=3, **refused)
    with pytest.raises(ValueError, match="SH degrees 0 to 4"):
        P.project(m, s, q, o, cam, shs=sh, sh_degree=5)
    with pytest.raises(ValueError, match="scale_modifier"):
        P.project(m, s, q, o, cam, shs=sh, sh_degree=3, scale_modifier=torch.tensor(1.0))


def test_cpu_render_counts_the_chain():
    cam, (m, s, q, o, sh), _ = _scene(torch.float32, ties=False)
    rec = Recording("cpu")
    with tracing(rec), torch.no_grad():
        rc.rasterize_cuda(m, s, q, o, cam, bg=torch.zeros(3), shs=sh, sh_degree=3)
    assert rec.totals()["project_kernel"] == 0


def test_kernels_read_the_cameras_own_tensors():
    """The kernels read world_view, full_proj, cam_center and the two
    tangents from the Camera, each made contiguous (the viewer's matrices
    arrive transposed), and derive the rest as torch does: focal =
    reciprocal(2 tanfov) * size, the clamp's limit = 1.3 tanfov."""
    cam = _camera(ties=False)
    assert torch.equal(torch.reciprocal(2.0 * cam.tanfovx) * cam.width, cam.focal_x)
    assert torch.equal(torch.reciprocal(2.0 * cam.tanfovy) * cam.height, cam.focal_y)
    viewer = dataclasses.replace(cam, world_view=cam.world_view.t().contiguous().t())
    assert not viewer.world_view.is_contiguous()
    with pytest.raises(ValueError, match="camera world_view must be on cuda"):
        P._camera_tensors(viewer, torch.device("cuda"))
    got = [getattr(viewer, f).contiguous() for f, _ in P.CAMERA_FIELDS]
    assert all(t.is_contiguous() for t in got)
    assert [tuple(t.shape) for t in got] == [shape for _, shape in P.CAMERA_FIELDS]
    assert torch.equal(got[0], cam.world_view)


def test_kernel_wrappers_refuse_cpu_tensors():
    cam, (m, s, q, o, sh), _ = _scene(torch.float32, ties=False)
    with pytest.raises(ValueError, match="CUDA"):
        P.project_fwd_cuda(m, s, q, o, sh, cam, sh_degree=3)
    grads = (torch.zeros(m.shape[0], 2), None, None, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        P.project_bwd_cuda(m, s, q, o, sh, cam, grads, sh_degree=3)
    assert cuda_build.launches["project_fwd"] == 0 and cuda_build.launches["project_bwd"] == 0


def test_cotangent_rows_read_the_composites_table_in_place():
    """The composite's backward hands its (N, 12) gradient table's columns:
    they are read at its row stride, not copied; a transposed layout is."""
    n = 7
    grads = torch.randn(n, 12)
    dev = torch.device("cpu")
    view, stride = P._cotangent_rows(grads[:, 2:5], n, 3, "conic", dev)
    assert view.data_ptr() == grads[:, 2:5].data_ptr() and stride == 12
    col, stride = P._cotangent_rows(grads[:, 9], n, 1, "depth", dev)
    assert col.data_ptr() == grads[:, 9].data_ptr() and stride == 12
    odd = torch.randn(2, n).t()
    copied, stride = P._cotangent_rows(odd, n, 2, "mean2d", dev)
    assert stride == 2 and torch.equal(copied, odd)
    assert P._cotangent_rows(None, n, 3, "color", dev) == (None, 0)
    with pytest.raises(ValueError, match="conic"):
        P._cotangent_rows(torch.zeros(n, 2), n, 3, "conic", dev)
