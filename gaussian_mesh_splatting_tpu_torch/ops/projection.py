"""Per-Gaussian screen-space preprocessing, shared by the oracle and the
CUDA rasterizer.

Port of `preprocess` / `sh_colors` from
`gaussian_mesh_splatting_tpu/ops/projection.py`, as plain torch:
  * frustum cull at view-space depth <= 0.2;
  * project means with the full projective transform, w-divide with a 1e-7
    guard, NDC -> pixel with ``pix = ((ndc + 1) * size - 1) / 2``;
  * 3D covariance from quaternion + scale (Sigma = R S S^T R^T);
  * EWA 2D covariance with the view-space x/y clamped to 1.3x the frustum
    tangents, +0.3 px^2 dilation, optional antialiasing opacity factor;
  * conic (inverse 2D covariance), radius = ceil(3 sqrt(max eigenvalue)),
    and the per-axis binning half-extents of the chosen `radius_mode`.
The arithmetic is written per coordinate, in the JAX package's order, so
that the two agree to float32 rounding.

On CUDA tensors `project` (which `ops/rasterize_cuda` calls) runs the same
function as one kernel and its VJP as another (csrc/preprocess.cu, P1 and
P2, behind one autograd Function, launched through `ops/cuda_build`).
`preprocess_bwd_plain` is that VJP in plain torch, line for line as the
kernel computes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..core.camera import Camera
from ..core.sh import C0, C1, C2, C3, C4
from ..core.transforms import quat_to_rotmat
from . import cuda_build

NEAR_CULL_Z = 0.2  # the CUDA in_frustum near clip
DILATION = 0.3  # px^2 added to the 2D covariance diagonal
FRUSTUM_CLAMP = 1.3  # view-space x/z and y/z clamped to this many frustum tangents


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussian attributes, one row per input Gaussian."""

    mean2d: torch.Tensor  # (N, 2) pixel coordinates
    depth: torch.Tensor  # (N,) view-space z
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # (N,) opacity, incl. antialiasing compensation
    color: torch.Tensor  # (N, 3) RGB from SH (or passthrough colors)
    radius: torch.Tensor  # (N,) float conservative pixel radius (0 if culled)
    valid: torch.Tensor  # (N,) bool: survives culling and has positive det
    radius_x: torch.Tensor  # (N,) binning rect x half-extent
    radius_y: torch.Tensor  # (N,) binning rect y half-extent


def compute_cov3d(scaling: torch.Tensor, rotation_q: torch.Tensor, modifier=1.0) -> torch.Tensor:
    """(N, 3) activated scales + (N, 4) quaternions -> (N, 3, 3) covariance
    R S S^T R^T."""
    L = quat_to_rotmat(rotation_q) * (modifier * scaling)[..., None, :]
    return L @ L.transpose(-1, -2)


def ndc_to_pixel(ndc: torch.Tensor, size) -> torch.Tensor:
    """CUDA ndc2Pix: ((v + 1) * size - 1) * 0.5 (pixel centres at integers)."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def project_points(means3d: torch.Tensor, cam: Camera
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project (N, 3) world points. Returns (mean2d pixels (N, 2), view z
    (N,), view-space points (N, 3))."""
    hom = torch.cat([means3d, means3d.new_ones((*means3d.shape[:-1], 1))], dim=-1)
    p_view = hom @ cam.world_view.T  # (N, 4)
    clip = hom @ cam.full_proj.T  # (N, 4)
    ndc = clip[..., :3] / (clip[..., 3:4] + 1e-7)
    px = ndc_to_pixel(ndc[..., 0], cam.width)
    py = ndc_to_pixel(ndc[..., 1], cam.height)
    return torch.stack([px, py], dim=-1), p_view[..., 2], p_view[..., :3]


def ewa_cov2d(p_view: torch.Tensor, cov3d: torch.Tensor, cam: Camera
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """EWA 2D covariance, row-major: view-space positions (N, 3) and world
    covariances (N, 3, 3) -> (cov2d (N, 3) = [a, b, c] with the dilation,
    det_ratio (N,) = det(raw) / det(dilated), the antialiasing factor's
    square)."""
    c6 = (cov3d[..., 0, 0], cov3d[..., 0, 1], cov3d[..., 0, 2],
          cov3d[..., 1, 1], cov3d[..., 1, 2], cov3d[..., 2, 2])
    a, b, c, det_ratio = _ewa_cov2d_cols(p_view.unbind(-1), c6, cam)
    return torch.stack([a, b, c], dim=-1), det_ratio


def _quad(u, v, cov6):
    """u^T Sigma v with the symmetric Sigma in 6-entry form."""
    c00, c01, c02, c11, c12, c22 = cov6
    return (
        u[0] * v[0] * c00
        + (u[0] * v[1] + u[1] * v[0]) * c01
        + (u[0] * v[2] + u[2] * v[0]) * c02
        + u[1] * v[1] * c11
        + (u[1] * v[2] + u[2] * v[1]) * c12
        + u[2] * v[2] * c22
    )


def _ewa_cov2d_cols(pv, cov6, cam: Camera):
    """Columnar EWA: pv = (tx, ty, tz) (N,) each; cov6 = the 6 unique 3D
    covariance entries (c00, c01, c02, c11, c12, c22). Returns
    (a_dilated, b, c_dilated, det_ratio)."""
    fx, fy = cam.focal_x, cam.focal_y
    tx, ty, tz = pv
    tz = torch.where(torch.abs(tz) < 1e-6, 1e-6, tz)
    limx = FRUSTUM_CLAMP * cam.tanfovx
    limy = FRUSTUM_CLAMP * cam.tanfovy
    tx = torch.minimum(torch.maximum(tx / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(ty / tz, -limy), limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    Wv = cam.world_view[:3, :3]
    # T = J @ Wv, one row per pixel axis
    t0 = [j00 * Wv[0, k] + j02 * Wv[2, k] for k in range(3)]
    t1 = [j11 * Wv[1, k] + j12 * Wv[2, k] for k in range(3)]

    a = _quad(t0, t0, cov6)
    b = _quad(t0, t1, cov6)
    c = _quad(t1, t1, cov6)
    det_raw = a * c - b * b
    a_d = a + DILATION
    c_d = c + DILATION
    det_d = a_d * c_d - b * b
    det_ratio = det_raw / torch.where(det_d == 0, 1.0, det_d)
    return a_d, b, c_d, det_ratio


def _sh_basis(deg: int, x, y, z) -> list:
    """The SH basis functions (degree <= 4) at unit directions x/y/z (N,)
    each: a list of (deg + 1)^2 (N,) values. Same basis and constants as
    `core.sh.eval_sh`."""
    basis = [torch.ones_like(x) * C0]
    if deg > 0:
        basis += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [
                C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy),
            ]
            if deg > 2:
                basis += [
                    C3[0] * y * (3 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
                if deg > 3:
                    basis += [
                        C4[0] * xy * (xx - yy),
                        C4[1] * yz * (3 * xx - yy),
                        C4[2] * xy * (7 * zz - 1),
                        C4[3] * yz * (7 * zz - 3),
                        C4[4] * (zz * (35 * zz - 30) + 3),
                        C4[5] * xz * (7 * zz - 3),
                        C4[6] * (xx - yy) * (7 * zz - 1),
                        C4[7] * xz * (xx - 3 * yy),
                        C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
                    ]
    return basis


def _eval_sh_cols(deg: int, sh_t: torch.Tensor, x, y, z):
    """Columnar SH evaluation: sh_t (K, C, N) transposed coefficients,
    x/y/z (N,) unit direction components. Returns a C-list of (N,) values."""
    basis = _sh_basis(deg, x, y, z)
    out = []
    for ch in range(sh_t.shape[1]):
        acc = basis[0] * sh_t[0, ch]
        for k in range(1, len(basis)):
            acc = acc + basis[k] * sh_t[k, ch]
        out.append(acc)
    return out


def sh_colors(
    sh_deg: int, shs: torch.Tensor, means3d: torch.Tensor, campos: torch.Tensor
) -> torch.Tensor:
    """Per-Gaussian RGB from SH and viewing direction, +0.5 and clamped at 0
    (the CUDA computeColorFromSH)."""
    dx = means3d[..., 0] - campos[0]
    dy = means3d[..., 1] - campos[1]
    dz = means3d[..., 2] - campos[2]
    inv_n = 1.0 / (torch.sqrt(dx * dx + dy * dy + dz * dz) + 1e-12)
    coeff = (sh_deg + 1) ** 2
    sh_t = shs[..., :coeff].permute(2, 1, 0)  # (K, C, N)
    rgb = _eval_sh_cols(sh_deg, sh_t, dx * inv_n, dy * inv_n, dz * inv_n)
    # torch.maximum, not clamp_min: at a tie it splits the gradient in half,
    # as jnp.maximum does (clamp_min passes all of it)
    rgb = torch.stack(rgb, dim=-1) + 0.5
    return torch.maximum(rgb, rgb.new_zeros(()))


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    *,
    shs: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
    sh_degree: int = 0,
    scale_modifier=1.0,
    cov3d_precomp: torch.Tensor | None = None,
    antialiasing: bool = False,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    radius_mode: str = "cuda",
) -> ProjectedGaussians:
    """Full screen-space preprocessing for a batch of Gaussians.

    `cov3d_precomp` (N, 6) = the 3D covariance's unique entries (c00, c01,
    c02, c11, c12, c22) takes the place of `scales` and `rotations` (which
    may then be None; `scale_modifier` does not apply to it).

    `mean2d_offset` is an all-zeros (N, 2) tensor the caller threads in to
    obtain screen-space positional gradients: gradients w.r.t. it equal
    gradients w.r.t. the projected pixel positions.

    radius_mode selects the binning rectangle (the reported `radius` is
    always the CUDA ceil(3 sigma_max) visibility radius):
      * "cuda": rx = ry = ceil(3 sigma_max), the CUDA getRect square.
      * "tight": per-axis ceil(min(3 sigma_max, sqrt(2 ln(255 op) cov_aa)))
        + 1 px, the axis extents of the {alpha >= 1/255} ellipse clipped to
        the CUDA circle. Pairs it drops have alpha < 1/255 at every pixel
        of their tile, so the composite is the same.
    """
    mx3, my3, mz3 = means3d.unbind(-1)

    def apply_row(M, i):
        return M[i, 0] * mx3 + M[i, 1] * my3 + M[i, 2] * mz3 + M[i, 3]

    Wv = cam.world_view
    FP = cam.full_proj
    tx_v = apply_row(Wv, 0)
    ty_v = apply_row(Wv, 1)
    depth = apply_row(Wv, 2)
    inv_w = 1.0 / (apply_row(FP, 3) + 1e-7)
    px = ndc_to_pixel(apply_row(FP, 0) * inv_w, cam.width)
    py = ndc_to_pixel(apply_row(FP, 1) * inv_w, cam.height)
    if mean2d_offset is not None:
        px = px + mean2d_offset[:, 0]
        py = py + mean2d_offset[:, 1]

    # 3D covariance (6 unique entries)
    if cov3d_precomp is not None:
        cov6 = cov3d_precomp.unbind(-1)
    else:
        qr, qx, qy, qz = rotations.unbind(-1)
        inv_qn = 1.0 / torch.sqrt(qr * qr + qx * qx + qy * qy + qz * qz)
        qr, qx, qy, qz = qr * inv_qn, qx * inv_qn, qy * inv_qn, qz * inv_qn
        r00 = 1 - 2 * (qy * qy + qz * qz)
        r01 = 2 * (qx * qy - qr * qz)
        r02 = 2 * (qx * qz + qr * qy)
        r10 = 2 * (qx * qy + qr * qz)
        r11 = 1 - 2 * (qx * qx + qz * qz)
        r12 = 2 * (qy * qz - qr * qx)
        r20 = 2 * (qx * qz - qr * qy)
        r21 = 2 * (qy * qz + qr * qx)
        r22 = 1 - 2 * (qx * qx + qy * qy)
        s0, s1, s2 = (s * scale_modifier for s in scales.unbind(-1))
        s0q, s1q, s2q = s0 * s0, s1 * s1, s2 * s2

        def sig(ra, rb):
            return ra[0] * rb[0] * s0q + ra[1] * rb[1] * s1q + ra[2] * rb[2] * s2q

        R0 = (r00, r01, r02)
        R1 = (r10, r11, r12)
        R2 = (r20, r21, r22)
        cov6 = (sig(R0, R0), sig(R0, R1), sig(R0, R2),
                sig(R1, R1), sig(R1, R2), sig(R2, R2))

    a, b, c, det_ratio = _ewa_cov2d_cols((tx_v, ty_v, depth), cov6, cam)

    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    conic_a = c * inv_det
    conic_b = -b * inv_det
    conic_c = a * inv_det

    opac = opacities.reshape(-1)
    if antialiasing:
        opac = opac * torch.sqrt(torch.maximum(det_ratio, det_ratio.new_zeros(())))

    # conservative screen radius from the major eigenvalue (CUDA heuristic)
    mid = 0.5 * (a + c)
    disc = torch.clamp_min(mid * mid - det, 0.1)
    sigma_max = torch.sqrt(torch.clamp_min(mid + torch.sqrt(disc), 0.0))
    radius = torch.ceil(3.0 * sigma_max)

    if radius_mode == "cuda":
        rx = ry = radius
    elif radius_mode == "tight":
        # +1 px guard: tile_rect's exclusive bound floor((m + r + t - 1)/t)
        # can stop one pixel short of m + r when m + r lands in the first
        # (1/t)-th of a tile; the 3-sigma radius has slack for that, an
        # exact radius does not.
        lim = 2.0 * torch.log(torch.clamp_min(255.0 * opac, 1e-12))
        lim = torch.clamp_min(lim, 0.0)
        rx = torch.ceil(torch.minimum(torch.sqrt(lim * torch.clamp_min(a, 0.0)), 3.0 * sigma_max)) + 1.0
        ry = torch.ceil(torch.minimum(torch.sqrt(lim * torch.clamp_min(c, 0.0)), 3.0 * sigma_max)) + 1.0
        visible = opac * 255.0 > 1.0
        rx = torch.where(visible, rx, 0.0)
        ry = torch.where(visible, ry, 0.0)
    else:
        raise ValueError(f"unknown radius_mode {radius_mode!r}")

    if colors is None:
        if shs is None:
            raise ValueError("preprocess needs shs or colors")
        color = sh_colors(sh_degree, shs, means3d, cam.cam_center)
    else:
        color = colors

    valid = (depth > NEAR_CULL_Z) & det_ok
    if alive is not None:
        valid = valid & alive
    radius = torch.where(valid, radius, 0.0)
    rx = torch.where(valid, rx, 0.0)
    ry = torch.where(valid, ry, 0.0)
    return ProjectedGaussians(
        mean2d=torch.stack([px, py], dim=-1),
        depth=depth,
        conic=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        opacity=opac,
        color=color,
        radius=radius,
        valid=valid,
        radius_x=rx,
        radius_y=ry,
    )


def _max_grad(g, a, b):
    """torch.maximum(a, b)'s gradient to `a`: g where a > b, half at a tie."""
    return torch.where(a < b, 0.0, torch.where(a == b, g * 0.5, g))


def _min_grad(g, a, b):
    """torch.minimum(a, b)'s gradient to `a`: g where a < b, half at a tie."""
    return torch.where(a > b, 0.0, torch.where(a == b, g * 0.5, g))


def _sh_slopes(deg: int, x, y, z) -> list:
    """The partial derivatives (d/dx, d/dy, d/dz) of each SH basis function
    of `_sh_basis` (degree <= 4) at unit directions x/y/z."""
    zero = 0.0
    slopes = [(zero, zero, zero)]
    if deg > 0:
        slopes += [(zero, -C1, zero), (zero, zero, C1), (-C1, zero, zero)]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            slopes += [
                (C2[0] * y, C2[0] * x, zero),
                (zero, C2[1] * z, C2[1] * y),
                (-2.0 * C2[2] * x, -2.0 * C2[2] * y, 4.0 * C2[2] * z),
                (C2[3] * z, zero, C2[3] * x),
                (2.0 * C2[4] * x, -2.0 * C2[4] * y, zero),
            ]
            if deg > 2:
                slopes += [
                    (C3[0] * 6.0 * xy, C3[0] * (3.0 * xx - 3.0 * yy), zero),
                    (C3[1] * yz, C3[1] * xz, C3[1] * xy),
                    (C3[2] * -2.0 * xy, C3[2] * (4.0 * zz - xx - 3.0 * yy), C3[2] * 8.0 * yz),
                    (C3[3] * -6.0 * xz, C3[3] * -6.0 * yz,
                     C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
                    (C3[4] * (4.0 * zz - 3.0 * xx - yy), C3[4] * -2.0 * xy, C3[4] * 8.0 * xz),
                    (C3[5] * 2.0 * xz, C3[5] * -2.0 * yz, C3[5] * (xx - yy)),
                    (C3[6] * (3.0 * xx - 3.0 * yy), C3[6] * -6.0 * xy, zero),
                ]
                if deg > 3:
                    slopes += [
                        (C4[0] * y * (3.0 * xx - yy), C4[0] * x * (xx - 3.0 * yy), zero),
                        (C4[1] * 6.0 * xy * z, C4[1] * 3.0 * z * (xx - yy),
                         C4[1] * y * (3.0 * xx - yy)),
                        (C4[2] * y * (7.0 * zz - 1.0), C4[2] * x * (7.0 * zz - 1.0),
                         C4[2] * 14.0 * xy * z),
                        (zero, C4[3] * z * (7.0 * zz - 3.0), C4[3] * y * (21.0 * zz - 3.0)),
                        (zero, zero, C4[4] * z * (140.0 * zz - 60.0)),
                        (C4[5] * z * (7.0 * zz - 3.0), zero, C4[5] * x * (21.0 * zz - 3.0)),
                        (C4[6] * 2.0 * x * (7.0 * zz - 1.0), C4[6] * -2.0 * y * (7.0 * zz - 1.0),
                         C4[6] * 14.0 * z * (xx - yy)),
                        (C4[7] * 3.0 * z * (xx - yy), C4[7] * -6.0 * xy * z,
                         C4[7] * x * (xx - 3.0 * yy)),
                        (C4[8] * 4.0 * x * (xx - 3.0 * yy), C4[8] * 4.0 * y * (yy - 3.0 * xx),
                         zero),
                    ]
    return slopes


def preprocess_bwd_plain(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    cam: Camera,
    grads: tuple,
    *,
    sh_degree: int,
    scale_modifier=1.0,
    antialiasing: bool = False,
) -> tuple[torch.Tensor, ...]:
    """The VJP of `preprocess` with `shs` (degree <= 4), neither `colors` nor
    `cov3d_precomp`: plain torch, line for line as the backward kernel
    (csrc/preprocess.cu, `project_bwd_kernel`) computes it. It recomputes
    the forward's intermediates from the inputs and takes the cotangents
    `grads` = (mean2d (N, 2), depth (N,), conic (N, 3), opacity (N,),
    color (N, 3)) of the differentiable outputs. The gradient of
    `mean2d_offset` is the mean2d cotangent itself; `alive` and
    `radius_mode` move no gradient (the radii pass through ceil).

    Ties follow autograd: torch.maximum / torch.minimum split the gradient
    in half, torch.where passes none to the branch it did not take.
    Returns the gradients of (means3d, scales, rotations, opacities, shs),
    each shaped as its input; shs's coefficients above the degree get 0."""
    g_mean2d, g_depth, g_conic, g_opacity, g_color = grads
    mx, my, mz = means3d.unbind(-1)
    Wv, FP = cam.world_view, cam.full_proj
    fx, fy = cam.focal_x, cam.focal_y
    limx, limy = FRUSTUM_CLAMP * cam.tanfovx, FRUSTUM_CLAMP * cam.tanfovy

    def apply_row(M, i):
        return M[i, 0] * mx + M[i, 1] * my + M[i, 2] * mz + M[i, 3]

    # ---- the forward's intermediates --------------------------------------
    tx_v, ty_v, tz = apply_row(Wv, 0), apply_row(Wv, 1), apply_row(Wv, 2)
    nx, ny = apply_row(FP, 0), apply_row(FP, 1)
    inv_w = 1.0 / (apply_row(FP, 3) + 1e-7)

    q = rotations.unbind(-1)
    qnorm = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    inv_qn = 1.0 / qnorm
    qr, qx, qy, qz = (c * inv_qn for c in q)
    R = ((1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qr * qz), 2 * (qx * qz + qr * qy)),
         (2 * (qx * qy + qr * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qr * qx)),
         (2 * (qx * qz - qr * qy), 2 * (qy * qz + qr * qx), 1 - 2 * (qx * qx + qy * qy)))
    s = [c * scale_modifier for c in scales.unbind(-1)]
    sq = [c * c for c in s]
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))  # cov6's entries
    cov6 = [R[i][0] * R[j][0] * sq[0] + R[i][1] * R[j][1] * sq[1] + R[i][2] * R[j][2] * sq[2]
            for i, j in pairs]

    tz_small = torch.abs(tz) < 1e-6
    tzs = torch.where(tz_small, 1e-6, tz)
    ux, uy = tx_v / tzs, ty_v / tzs
    vx, vy = torch.maximum(ux, -limx), torch.maximum(uy, -limy)
    uxc, uyc = torch.minimum(vx, limx), torch.minimum(vy, limy)
    txc, tyc = uxc * tzs, uyc * tzs
    inv_z = 1.0 / tzs
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * txc * inv_z2
    j11, j12 = fy * inv_z, -fy * tyc * inv_z2
    t0 = [j00 * Wv[0, k] + j02 * Wv[2, k] for k in range(3)]
    t1 = [j11 * Wv[1, k] + j12 * Wv[2, k] for k in range(3)]
    S = [[None] * 3 for _ in range(3)]  # the symmetric 3D covariance
    for (i, j), c in zip(pairs, cov6):
        S[i][j] = S[j][i] = c
    St0 = [S[i][0] * t0[0] + S[i][1] * t0[1] + S[i][2] * t0[2] for i in range(3)]
    St1 = [S[i][0] * t1[0] + S[i][1] * t1[1] + S[i][2] * t1[2] for i in range(3)]
    # the forms in the forward's order: the tests at det and its ties see its values
    a, b, c = _quad(t0, t0, cov6), _quad(t0, t1, cov6), _quad(t1, t1, cov6)
    a_d, c_d = a + DILATION, c + DILATION
    det = a_d * c_d - b * b  # det_d of the EWA and det of preprocess alike
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)

    # ---- conic and opacity -------------------------------------------------
    g_ca, g_cb, g_cc = g_conic.unbind(-1)
    g_a_d = g_cc * inv_det
    g_c_d = g_ca * inv_det
    g_b = -(g_cb * inv_det)
    g_inv_det = g_ca * c_d + g_cb * -b + g_cc * a_d
    g_det = torch.where(det_ok, -g_inv_det * (inv_det * inv_det), 0.0)
    g_a_d = g_a_d + g_det * c_d
    g_c_d = g_c_d + g_det * a_d
    g_b = g_b - 2.0 * b * g_det
    opac = opacities.reshape(-1)
    g_a, g_c = g_a_d, g_c_d
    if antialiasing:
        # opac * sqrt(max(det_raw / det_d, 0)), det_d == 0 read as 1
        det_raw = a * c - b * b
        det_dd = torch.where(det == 0, 1.0, det)
        ratio = det_raw / det_dd
        root = torch.sqrt(torch.maximum(ratio, ratio.new_zeros(())))
        g_op = g_opacity * root
        g_root = g_opacity * opac
        g_ratio = _max_grad(g_root / (2.0 * root), ratio, 0.0)
        g_raw = g_ratio / det_dd
        g_det_d = torch.where(det == 0, 0.0, -g_ratio * ((det_raw / det_dd) / det_dd))
        g_a = g_a + g_raw * c + g_det_d * c_d
        g_c = g_c + g_raw * a + g_det_d * a_d
        g_b = g_b - 2.0 * b * g_raw - 2.0 * b * g_det_d
    else:
        g_op = g_opacity

    # ---- the EWA quadratic forms: a = t0 S t0, b = t0 S t1, c = t1 S t1 -----
    g_t0 = [2.0 * g_a * St0[k] + g_b * St1[k] for k in range(3)]
    g_t1 = [g_b * St0[k] + 2.0 * g_c * St1[k] for k in range(3)]
    g_cov6 = []
    for i, j in pairs:
        f = 1.0 if i == j else 2.0  # an off-diagonal entry stands for two
        cross = t0[i] * t1[j] if i == j else t0[i] * t1[j] + t0[j] * t1[i]
        g_cov6.append(f * g_a * t0[i] * t0[j] + g_b * cross + f * g_c * t1[i] * t1[j])
    # ---- the Jacobian and the frustum clamp ---------------------------------
    g_j00 = g_t0[0] * Wv[0, 0] + g_t0[1] * Wv[0, 1] + g_t0[2] * Wv[0, 2]
    g_j02 = g_t0[0] * Wv[2, 0] + g_t0[1] * Wv[2, 1] + g_t0[2] * Wv[2, 2]
    g_j11 = g_t1[0] * Wv[1, 0] + g_t1[1] * Wv[1, 1] + g_t1[2] * Wv[1, 2]
    g_j12 = g_t1[0] * Wv[2, 0] + g_t1[1] * Wv[2, 1] + g_t1[2] * Wv[2, 2]
    g_inv_z2 = g_j02 * (-fx * txc) + g_j12 * (-fy * tyc)
    g_inv_z = g_j00 * fx + g_j11 * fy + 2.0 * inv_z * g_inv_z2
    g_txc = g_j02 * -fx * inv_z2
    g_tyc = g_j12 * -fy * inv_z2
    g_tzs = -g_inv_z * (inv_z * inv_z) + g_txc * uxc + g_tyc * uyc
    g_ux = _max_grad(_min_grad(g_txc * tzs, vx, limx), ux, -limx)
    g_uy = _max_grad(_min_grad(g_tyc * tzs, vy, limy), uy, -limy)
    g_tx_v = g_ux / tzs
    g_ty_v = g_uy / tzs
    g_tzs = g_tzs - g_ux * (ux / tzs) - g_uy * (uy / tzs)
    g_tz = g_depth + torch.where(tz_small, 0.0, g_tzs)

    # ---- the 3D covariance: cov6[i, j] = sum_k R_ik R_jk sq_k ----------------
    G = [[None] * 3 for _ in range(3)]  # symmetric: 2 g on the diagonal, g off it
    for (i, j), g in zip(pairs, g_cov6):
        if i == j:
            G[i][i] = 2.0 * g
        else:
            G[i][j] = G[j][i] = g
    g_R = [[(G[i][0] * R[0][k] + G[i][1] * R[1][k] + G[i][2] * R[2][k]) * sq[k]
            for k in range(3)] for i in range(3)]
    g_sq = [sum(g * R[i][k] * R[j][k] for (i, j), g in zip(pairs, g_cov6)) for k in range(3)]
    g_scales = torch.stack([2.0 * s[k] * g_sq[k] * scale_modifier for k in range(3)], dim=-1)
    (g00, g01, g02), (g10, g11, g12), (g20, g21, g22) = g_R
    g_qn = (
        2.0 * (-g01 * qz + g02 * qy + g10 * qz - g12 * qx - g20 * qy + g21 * qx),
        2.0 * (g01 * qy + g02 * qz + g10 * qy - g12 * qr + g20 * qz + g21 * qr)
        - 4.0 * qx * (g11 + g22),
        2.0 * (g01 * qx + g02 * qr + g10 * qx + g12 * qz - g20 * qr + g21 * qz)
        - 4.0 * qy * (g00 + g22),
        2.0 * (-g01 * qr + g02 * qx + g10 * qr + g12 * qy + g20 * qx + g21 * qy)
        - 4.0 * qz * (g00 + g11),
    )
    g_inv_qn = g_qn[0] * q[0] + g_qn[1] * q[1] + g_qn[2] * q[2] + g_qn[3] * q[3]
    g_sumsq = (-g_inv_qn * (inv_qn * inv_qn)) / (2.0 * qnorm)
    g_rotations = torch.stack([g_qn[k] * inv_qn + 2.0 * q[k] * g_sumsq for k in range(4)],
                              dim=-1)

    # ---- colour from SH -----------------------------------------------------
    cc = cam.cam_center
    d = (mx - cc[0], my - cc[1], mz - cc[2])
    dnorm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    inv_n = 1.0 / (dnorm + 1e-12)
    direction = (d[0] * inv_n, d[1] * inv_n, d[2] * inv_n)
    basis, slopes = _sh_basis(sh_degree, *direction), _sh_slopes(sh_degree, *direction)
    coeff = len(basis)
    g_shs = torch.zeros_like(shs)
    g_rgb = []
    for ch in range(3):
        acc = basis[0] * shs[:, ch, 0]
        for k in range(1, coeff):
            acc = acc + basis[k] * shs[:, ch, k]
        g = _max_grad(g_color[:, ch], acc + 0.5, 0.0)
        g_rgb.append(g)
        for k in range(coeff):
            g_shs[:, ch, k] = g * basis[k]
    g_dir = [0.0, 0.0, 0.0]
    for k in range(1, coeff):
        g_bk = g_rgb[0] * shs[:, 0, k] + g_rgb[1] * shs[:, 1, k] + g_rgb[2] * shs[:, 2, k]
        g_dir = [g_dir[i] + g_bk * slopes[k][i] for i in range(3)]
    g_inv_n = g_dir[0] * d[0] + g_dir[1] * d[1] + g_dir[2] * d[2]
    g_dsq = (-g_inv_n * (inv_n * inv_n)) / (2.0 * dnorm)
    g_d = [g_dir[i] * inv_n + 2.0 * d[i] * g_dsq for i in range(3)]

    # ---- the projection: mean2d = ndc_to_pixel(FP[:2] m / (FP[3] m + 1e-7)) --
    g_nx = g_mean2d[:, 0] * 0.5 * cam.width
    g_ny = g_mean2d[:, 1] * 0.5 * cam.height
    g_w = -(g_nx * nx + g_ny * ny) * (inv_w * inv_w)
    g_nx, g_ny = g_nx * inv_w, g_ny * inv_w
    g_means3d = torch.stack([
        g_tx_v * Wv[0, k] + g_ty_v * Wv[1, k] + g_tz * Wv[2, k]
        + g_nx * FP[0, k] + g_ny * FP[1, k] + g_w * FP[3, k] + g_d[k]
        for k in range(3)], dim=-1)
    return (g_means3d, g_scales, g_rotations, g_op.reshape(opacities.shape), g_shs)


# ---- the projection kernels (csrc/preprocess.cu) ---------------------------

PROJECT_MAX_SH_DEGREE = 4  # the kernels' SH basis
CAMERA_FIELDS = (("world_view", (4, 4)), ("full_proj", (4, 4)), ("cam_center", (3,)),
                 ("tanfovx", ()), ("tanfovy", ()))  # the camera's tensors the kernels read
RADIUS_MODES = ("cuda", "tight")


def _check_projection_inputs(means3d, scales, rotations, opacities, shs, cam: Camera,
                             sh_degree: int, scale_modifier) -> torch.device:
    """The projection kernels' own inputs: float32 on one CUDA device,
    contiguous but for `shs` (N, 3, K >= (sh_degree + 1)^2, any strides),
    SH degree <= 4 and a Python number as `scale_modifier`; raises
    ValueError otherwise. Returns the device."""
    dev = means3d.device
    n = means3d.shape[0]
    if n * 4 >= 2**31:
        raise ValueError("the projection kernels index with 32-bit integers")
    if not 0 <= sh_degree <= PROJECT_MAX_SH_DEGREE:
        raise ValueError(f"the projection kernels take SH degrees 0 to {PROJECT_MAX_SH_DEGREE}, "
                         f"got {sh_degree}")
    if isinstance(scale_modifier, torch.Tensor):
        raise ValueError("the projection kernels take scale_modifier as a Python number")
    cuda_build.check_inputs({
        "means3d": (means3d, torch.float32, (n, 3)),
        "scales": (scales, torch.float32, (n, 3)),
        "rotations": (rotations, torch.float32, (n, 4)),
        "opacities": (opacities.reshape(-1), torch.float32, (n,)),
    }, dev)
    if not opacities.is_contiguous():
        raise ValueError("opacities must be contiguous")
    if shs.device != dev or shs.dtype != torch.float32:
        raise ValueError(f"shs must be float32 on {dev}, got {shs.dtype} on {shs.device}")
    if shs.dim() != 3 or shs.shape[:2] != (n, 3) or shs.shape[2] < (sh_degree + 1) ** 2:
        raise ValueError(f"shs must be ({n}, 3, K >= {(sh_degree + 1) ** 2}), "
                         f"got {tuple(shs.shape)}")
    return dev


def _camera_tensors(cam: Camera, dev: torch.device) -> list[torch.Tensor]:
    """The camera's tensors the kernels read (CAMERA_FIELDS), float32 on
    `dev`, made contiguous (the viewer's matrices arrive transposed)."""
    tensors = [getattr(cam, f).contiguous() for f, _ in CAMERA_FIELDS]
    cuda_build.check_inputs({f"camera {f}": (t, torch.float32, shape)
                             for (f, shape), t in zip(CAMERA_FIELDS, tensors)}, dev)
    return tensors


def project_fwd_cuda(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    cam: Camera,
    *,
    sh_degree: int,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    radius_mode: str = "tight",
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Launch the projection kernel (csrc/preprocess.cu `project_fwd`) on
    PyTorch's current stream: `preprocess` of these inputs with `shs` (read
    at its own strides) through `cam` (its tensors read on the device),
    every output bit-equal. Counted in `cuda_build.launches["project_fwd"]`."""
    dev = _check_projection_inputs(means3d, scales, rotations, opacities, shs, cam, sh_degree,
                                   scale_modifier)
    n = means3d.shape[0]
    extra = {}
    if mean2d_offset is not None:
        extra["mean2d_offset"] = (mean2d_offset, torch.float32, (n, 2))
    if alive is not None:
        extra["alive"] = (alive, torch.bool, (n,))
    cuda_build.check_inputs(extra, dev)
    if radius_mode not in RADIUS_MODES:
        raise ValueError(f"unknown radius_mode {radius_mode!r}")
    camera = _camera_tensors(cam, dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = ProjectedGaussians(
        mean2d=empty(n, 2), depth=empty(n), conic=empty(n, 3), opacity=empty(n),
        color=empty(n, 3), radius=empty(n), valid=empty(n, dtype=torch.bool),
        radius_x=empty(n), radius_y=empty(n))
    cuda_build.launch(
        "project_fwd", dev,
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(), opacities.data_ptr(),
        shs.data_ptr(), *shs.stride(),
        None if mean2d_offset is None else mean2d_offset.data_ptr(),
        None if alive is None else alive.data_ptr(),
        *(t.data_ptr() for t in camera), n, sh_degree, float(scale_modifier),
        int(antialiasing), int(radius_mode == "tight"), cam.width, cam.height,
        *(t.data_ptr() for t in out))
    return out


def _cotangent_rows(g: torch.Tensor | None, n: int, cols: int, name: str,
                    dev: torch.device) -> tuple[torch.Tensor | None, int]:
    """(a cotangent whose columns are adjacent, its row stride): None stays
    None (the kernel reads zeros); a view of a wider table (the composite's
    gradient rows) is read in place; other layouts are copied."""
    if g is None:
        return None, 0
    shape = (n, cols) if cols > 1 else (n,)
    if g.device != dev or g.dtype != torch.float32 or tuple(g.shape) != shape:
        raise ValueError(f"the {name} cotangent must be float32 {shape} on {dev}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    if cols > 1 and g.stride(1) != 1:
        g = g.contiguous()
    return g, g.stride(0)


def project_bwd_cuda(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    cam: Camera,
    grads: tuple,
    *,
    sh_degree: int,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Launch the projection's VJP kernel (csrc/preprocess.cu `project_bwd`)
    on PyTorch's current stream. Same contract as `preprocess_bwd_plain`; a
    cotangent may be None (zeros) or a strided view. The shs gradient has
    the layout of `shs`. Counted in `cuda_build.launches["project_bwd"]`."""
    dev = _check_projection_inputs(means3d, scales, rotations, opacities, shs, cam, sh_degree,
                                   scale_modifier)
    n = means3d.shape[0]
    cots = [_cotangent_rows(g, n, cols, name, dev) for g, cols, name in
            zip(grads, (2, 1, 3, 1, 3), ("mean2d", "depth", "conic", "opacity", "color"))]
    camera = _camera_tensors(cam, dev)
    out = (torch.empty_like(means3d), torch.empty_like(scales), torch.empty_like(rotations),
           torch.empty_like(opacities), torch.empty_like(shs))
    cuda_build.launch(
        "project_bwd", dev,
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(), opacities.data_ptr(),
        shs.data_ptr(), *shs.stride(), *(t.data_ptr() for t in camera), n, sh_degree,
        float(scale_modifier), int(antialiasing), cam.width, cam.height,
        *(v for g, stride in cots for v in (None if g is None else g.data_ptr(), stride)),
        *(t.data_ptr() for t in out), *out[4].stride(), shs.shape[2])
    return out


class _Project(torch.autograd.Function):
    """Projection with SH behind autograd (CUDA tensors): the forward kernel,
    then the VJP kernel. The radii and `valid` are not differentiable; the
    gradient of `mean2d_offset` is the mean2d cotangent."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, shs, mean2d_offset, alive, cam,
                sh_degree, scale_modifier, antialiasing, radius_mode):
        settings = dict(sh_degree=sh_degree, scale_modifier=scale_modifier,
                        antialiasing=antialiasing)
        proj = project_fwd_cuda(means3d, scales, rotations, opacities, shs, cam,
                                radius_mode=radius_mode, mean2d_offset=mean2d_offset,
                                alive=alive, **settings)
        ctx.save_for_backward(means3d, scales, rotations, opacities, shs)
        ctx.cam = cam
        ctx.settings = settings
        ctx.has_offset = mean2d_offset is not None
        ctx.mark_non_differentiable(proj.radius, proj.valid, proj.radius_x, proj.radius_y)
        ctx.set_materialize_grads(False)  # a missing cotangent reads as zeros in the kernel
        return tuple(proj)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mean2d, g_depth, g_conic, g_opacity, g_color, *_non_differentiable):
        grads = project_bwd_cuda(*ctx.saved_tensors, ctx.cam,
                                 (g_mean2d, g_depth, g_conic, g_opacity, g_color), **ctx.settings)
        g_offset = g_mean2d if ctx.has_offset else None
        return (*grads, g_offset, *[None] * 6)


def project(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    cam: Camera,
    *,
    shs: torch.Tensor | None,
    colors: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    mean2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    radius_mode: str = "tight",
) -> ProjectedGaussians:
    """`preprocess` of CUDA float32 tensors through the projection kernels,
    differentiable: the same outputs, bit-equal. They take `shs` of SH
    degree <= 4 and a Python number as `scale_modifier`; any other call
    (`colors`, `cov3d_precomp`, another dtype) raises ValueError."""
    if shs is None or colors is not None or cov3d_precomp is not None:
        raise ValueError("the projection kernels take `shs`, not `colors` or `cov3d_precomp` "
                         "(those run through `preprocess` on CPU tensors)")
    return ProjectedGaussians(*_Project.apply(
        means3d.contiguous(), scales.contiguous(), rotations.contiguous(),
        opacities.contiguous(), shs, mean2d_offset, alive, cam, sh_degree, scale_modifier,
        antialiasing, radius_mode))
