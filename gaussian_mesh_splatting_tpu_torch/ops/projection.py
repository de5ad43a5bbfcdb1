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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.camera import Camera
from ..core.sh import C0, C1, C2, C3, C4
from ..core.transforms import quat_to_rotmat

NEAR_CULL_Z = 0.2  # the CUDA in_frustum near clip
DILATION = 0.3  # px^2 added to the 2D covariance diagonal


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


def _ewa_cov2d_cols(pv, cov6, cam: Camera):
    """Columnar EWA: pv = (tx, ty, tz) (N,) each; cov6 = the 6 unique 3D
    covariance entries (c00, c01, c02, c11, c12, c22). Returns
    (a_dilated, b, c_dilated, det_ratio)."""
    fx, fy = cam.focal_x, cam.focal_y
    tx, ty, tz = pv
    tz = torch.where(torch.abs(tz) < 1e-6, 1e-6, tz)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
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

    c00, c01, c02, c11, c12, c22 = cov6

    def quad(u, v):
        # u^T Sigma v with symmetric Sigma in 6-entry form
        return (
            u[0] * v[0] * c00
            + (u[0] * v[1] + u[1] * v[0]) * c01
            + (u[0] * v[2] + u[2] * v[0]) * c02
            + u[1] * v[1] * c11
            + (u[1] * v[2] + u[2] * v[1]) * c12
            + u[2] * v[2] * c22
        )

    a = quad(t0, t0)
    b = quad(t0, t1)
    c = quad(t1, t1)
    det_raw = a * c - b * b
    a_d = a + DILATION
    c_d = c + DILATION
    det_d = a_d * c_d - b * b
    det_ratio = det_raw / torch.where(det_d == 0, 1.0, det_d)
    return a_d, b, c_d, det_ratio


def _eval_sh_cols(deg: int, sh_t: torch.Tensor, x, y, z):
    """Columnar SH evaluation: sh_t (K, C, N) transposed coefficients,
    x/y/z (N,) unit direction components. Returns a C-list of (N,) values.
    Same basis and constants as `core.sh.eval_sh`."""
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
