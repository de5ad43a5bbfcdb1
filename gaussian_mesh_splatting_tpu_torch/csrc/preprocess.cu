// Projection with SH colour, and its VJP, for Hopper (sm_90a): one thread
// per Gaussian in each direction.
//
// Replaces no TPU kernel: the JAX package leaves `preprocess`
// (gaussian_mesh_splatting_tpu/ops/projection.py) to XLA, which fuses it.
// The port ran it as a chain of ~500 small PyTorch launches forward and
// ~950 backward (ops/projection.py `preprocess` under autograd), whose host
// time set the pace of a render and of a training step.
//
// project_fwd_kernel computes everything `preprocess` returns for the call
// with `shs` (degree <= 4) and neither `colors` nor `cov3d_precomp`: the
// world -> view and projective transforms, the w-divide with its 1e-7 guard
// and ndc_to_pixel (+ mean2d_offset); the quaternion's normalisation,
// R S S^T R^T and the EWA covariance with the 1.3x frustum clamp and the
// 0.3 px^2 dilation; the conic, det > 0 and the 3-sigma radius; both radius
// modes; the antialiasing factor; the near cull at 0.2 and `alive`; the SH
// colour with its +0.5 and clamp at 0. Every value comes from the same
// float32 operations in the same order as the chain's, each rounded on its
// own (built with -fmad=false, no fast math; max / min / clamp_min as
// torch's, NaN passed on), so the outputs are bit-equal to the chain's on
// the same CUDA tensors.
//
// project_bwd_kernel recomputes the forward's intermediates from the inputs
// (nothing per Gaussian is saved but the inputs, as in the reference
// rasterizer's BACKWARD::preprocess) and writes each Gaussian's gradients
// of means3d, scales, rotations, opacities and shs in its own rows: no
// atomics. Its plain version is ops/projection.py `preprocess_bwd_plain`,
// line for line. Ties follow autograd: torch.maximum / torch.minimum split
// the gradient in half (the SH clamp, the antialiasing floor, the frustum
// clamp), torch.where passes none to the branch it did not take (the
// |tz| < 1e-6 guard, det > 0, det_d == 0), ceil passes none (the radii).
//
// What bounds them: a few hundred float operations against ~300 bytes a
// Gaussian forward (inputs 245, outputs 53 at SH degree 3) and ~520
// backward (the inputs, five cotangent rows, five gradient rows): device
// memory. A thread reads its SH row (48 floats at degree 3) in place, at the
// strides it arrives with (the bag's (N, 3, K) is a transpose of a contiguous
// (N, K, 3)), and writes the SH gradient at its own strides. The camera is
// read from the Camera's own tensors: world_view, full_proj, cam_center,
// tanfovx and tanfovy, with focal_x / focal_y and the frustum clamp's limits
// computed from them as the chain's torch ops do.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCoeffs = 25;  // SH degree 4

// Python's float constants as torch rounds them to float32
constexpr float kWGuard = static_cast<float>(1e-7);
constexpr float kFrustumClamp = static_cast<float>(1.3);
constexpr float kTzGuard = static_cast<float>(1e-6);
constexpr float kDilation = static_cast<float>(0.3);
constexpr float kNearCull = static_cast<float>(0.2);
constexpr float kDiscFloor = static_cast<float>(0.1);
constexpr float kLogFloor = static_cast<float>(1e-12);
constexpr float kDirGuard = static_cast<float>(1e-12);
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kMinusC1 = static_cast<float>(-0.4886025119029199);
constexpr float kC20 = static_cast<float>(1.0925484305920792);
constexpr float kC21 = static_cast<float>(-1.0925484305920792);
constexpr float kC22 = static_cast<float>(0.31539156525252005);
constexpr float kC23 = static_cast<float>(-1.0925484305920792);
constexpr float kC24 = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);
constexpr float kC40 = static_cast<float>(2.5033429417967046);
constexpr float kC41 = static_cast<float>(-1.7701307697799304);
constexpr float kC42 = static_cast<float>(0.9461746957575601);
constexpr float kC43 = static_cast<float>(-0.6690465435572892);
constexpr float kC44 = static_cast<float>(0.10578554691520431);
constexpr float kC45 = static_cast<float>(-0.6690465435572892);
constexpr float kC46 = static_cast<float>(0.47308734787878004);
constexpr float kC47 = static_cast<float>(-1.7701307697799304);
constexpr float kC48 = static_cast<float>(0.6258357354491761);

// torch.maximum / torch.minimum / clamp_min on CUDA: NaN passed on
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
// their gradients to `a` (autograd's rules: half at a tie)
__device__ __forceinline__ float max_grad(float g, float a, float b) {
  return a < b ? 0.0f : (a == b ? g * 0.5f : g);
}
__device__ __forceinline__ float min_grad(float g, float a, float b) {
  return a > b ? 0.0f : (a == b ? g * 0.5f : g);
}

struct Cam {
  float wv[16], fp[16], campos[3], fx, fy, limx, limy;
};

// the Camera's tensors
struct CamPtrs {
  const float *wv, *fp, *campos, *tanfovx, *tanfovy;  // (4, 4), (4, 4), (3,), (), ()
};

// focal = width / (2 tanfov), as torch evaluates it: reciprocal(2 tanfov) *
// width; the clamp's limit = FRUSTUM_CLAMP * tanfov
__device__ __forceinline__ void load_cam(const CamPtrs& p, int width, int height, Cam& c) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    c.wv[i] = __ldg(p.wv + i);
    c.fp[i] = __ldg(p.fp + i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) c.campos[i] = __ldg(p.campos + i);
  const float tx = __ldg(p.tanfovx), ty = __ldg(p.tanfovy);
  c.fx = (1.0f / (2.0f * tx)) * static_cast<float>(width);
  c.fy = (1.0f / (2.0f * ty)) * static_cast<float>(height);
  c.limx = kFrustumClamp * tx;
  c.limy = kFrustumClamp * ty;
}

// M[r, 0] x + M[r, 1] y + M[r, 2] z + M[r, 3], the chain's apply_row
__device__ __forceinline__ float apply_row(const float* M, int r, float x, float y, float z) {
  return ((M[4 * r] * x + M[4 * r + 1] * y) + M[4 * r + 2] * z) + M[4 * r + 3];
}

// u^T Sigma v, Sigma in 6-entry form (c00, c01, c02, c11, c12, c22)
__device__ __forceinline__ float quad(const float* u, const float* v, const float* c6) {
  return ((((u[0] * v[0] * c6[0] + (u[0] * v[1] + u[1] * v[0]) * c6[1]) +
            (u[0] * v[2] + u[2] * v[0]) * c6[2]) +
           u[1] * v[1] * c6[3]) +
          (u[1] * v[2] + u[2] * v[1]) * c6[4]) +
         u[2] * v[2] * c6[5];
}

// The geometry of one Gaussian, as the forward computes it: what the
// outputs need and what the backward reads again.
struct Geometry {
  float tx_v, ty_v, tz;     // view-space position (tz = depth)
  float nx, ny, inv_w;      // projective x, y and 1 / (w + 1e-7)
  float q[4], qnorm, inv_qn, qn[4];
  float R[3][3], s[3], sq[3], c6[6];
  bool tz_small;
  float tzs, ux, uy, vx, vy, uxc, uyc, txc, tyc;
  float inv_z, inv_z2, j00, j02, j11, j12;
  float t0[3], t1[3];
  float a, b, c, a_d, c_d, det;  // det = a_d c_d - b^2 (the EWA's det_d too)
  bool det_ok;
  float inv_det;
};

__device__ __forceinline__ void geometry(const Cam& cam, const float* m, const float* q4,
                                         const float* s3, float scale_modifier, Geometry& g) {
  const float mx = m[0], my = m[1], mz = m[2];
  g.tx_v = apply_row(cam.wv, 0, mx, my, mz);
  g.ty_v = apply_row(cam.wv, 1, mx, my, mz);
  g.tz = apply_row(cam.wv, 2, mx, my, mz);
  g.nx = apply_row(cam.fp, 0, mx, my, mz);
  g.ny = apply_row(cam.fp, 1, mx, my, mz);
  g.inv_w = 1.0f / (apply_row(cam.fp, 3, mx, my, mz) + kWGuard);

  // 3D covariance from the normalised quaternion and the scales
#pragma unroll
  for (int i = 0; i < 4; ++i) g.q[i] = q4[i];
  g.qnorm = sqrtf(((g.q[0] * g.q[0] + g.q[1] * g.q[1]) + g.q[2] * g.q[2]) + g.q[3] * g.q[3]);
  g.inv_qn = 1.0f / g.qnorm;
#pragma unroll
  for (int i = 0; i < 4; ++i) g.qn[i] = g.q[i] * g.inv_qn;
  const float qr = g.qn[0], qx = g.qn[1], qy = g.qn[2], qz = g.qn[3];
  g.R[0][0] = 1.0f - (qy * qy + qz * qz) * 2.0f;
  g.R[0][1] = (qx * qy - qr * qz) * 2.0f;
  g.R[0][2] = (qx * qz + qr * qy) * 2.0f;
  g.R[1][0] = (qx * qy + qr * qz) * 2.0f;
  g.R[1][1] = 1.0f - (qx * qx + qz * qz) * 2.0f;
  g.R[1][2] = (qy * qz - qr * qx) * 2.0f;
  g.R[2][0] = (qx * qz - qr * qy) * 2.0f;
  g.R[2][1] = (qy * qz + qr * qx) * 2.0f;
  g.R[2][2] = 1.0f - (qx * qx + qy * qy) * 2.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.s[k] = s3[k] * scale_modifier;
    g.sq[k] = g.s[k] * g.s[k];
  }
  const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const float* ra = g.R[pi[e]];
    const float* rb = g.R[pj[e]];
    g.c6[e] = (ra[0] * rb[0] * g.sq[0] + ra[1] * rb[1] * g.sq[1]) + ra[2] * rb[2] * g.sq[2];
  }

  // EWA: the Jacobian at the clamped view-space position
  g.tz_small = fabsf(g.tz) < kTzGuard;
  g.tzs = g.tz_small ? kTzGuard : g.tz;
  g.ux = g.tx_v / g.tzs;
  g.uy = g.ty_v / g.tzs;
  g.vx = tmax(g.ux, -cam.limx);
  g.vy = tmax(g.uy, -cam.limy);
  g.uxc = tmin(g.vx, cam.limx);
  g.uyc = tmin(g.vy, cam.limy);
  g.txc = g.uxc * g.tzs;
  g.tyc = g.uyc * g.tzs;
  g.inv_z = 1.0f / g.tzs;
  g.inv_z2 = g.inv_z * g.inv_z;
  g.j00 = cam.fx * g.inv_z;
  g.j02 = (-cam.fx * g.txc) * g.inv_z2;
  g.j11 = cam.fy * g.inv_z;
  g.j12 = (-cam.fy * g.tyc) * g.inv_z2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.t0[k] = g.j00 * cam.wv[k] + g.j02 * cam.wv[8 + k];
    g.t1[k] = g.j11 * cam.wv[4 + k] + g.j12 * cam.wv[8 + k];
  }
  g.a = quad(g.t0, g.t0, g.c6);
  g.b = quad(g.t0, g.t1, g.c6);
  g.c = quad(g.t1, g.t1, g.c6);
  g.a_d = g.a + kDilation;
  g.c_d = g.c + kDilation;
  g.det = g.a_d * g.c_d - g.b * g.b;
  g.det_ok = g.det > 0.0f;
  g.inv_det = 1.0f / (g.det_ok ? g.det : 1.0f);
}

// The SH basis at a unit direction, as `_eval_sh_cols` computes it; with
// `slopes`, each function's partial derivatives too. Returns the count.
template <bool kSlopes>
__device__ __forceinline__ int sh_basis(int deg, float x, float y, float z, float* b,
                                        float (*d)[3]) {
  b[0] = 1.0f * kC0;
  if (deg < 1) return 1;
  b[1] = kMinusC1 * y;
  b[2] = kC1 * z;
  b[3] = kMinusC1 * x;
  if (kSlopes) {
    d[1][0] = 0.0f, d[1][1] = kMinusC1, d[1][2] = 0.0f;
    d[2][0] = 0.0f, d[2][1] = 0.0f, d[2][2] = kC1;
    d[3][0] = kMinusC1, d[3][1] = 0.0f, d[3][2] = 0.0f;
  }
  if (deg < 2) return 4;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  b[4] = kC20 * xy;
  b[5] = kC21 * yz;
  b[6] = kC22 * ((2.0f * zz - xx) - yy);
  b[7] = kC23 * xz;
  b[8] = kC24 * (xx - yy);
  if (kSlopes) {
    d[4][0] = kC20 * y, d[4][1] = kC20 * x, d[4][2] = 0.0f;
    d[5][0] = 0.0f, d[5][1] = kC21 * z, d[5][2] = kC21 * y;
    d[6][0] = -2.0f * kC22 * x, d[6][1] = -2.0f * kC22 * y, d[6][2] = 4.0f * kC22 * z;
    d[7][0] = kC23 * z, d[7][1] = 0.0f, d[7][2] = kC23 * x;
    d[8][0] = 2.0f * kC24 * x, d[8][1] = -2.0f * kC24 * y, d[8][2] = 0.0f;
  }
  if (deg < 3) return 9;
  b[9] = (kC30 * y) * (3.0f * xx - yy);
  b[10] = (kC31 * xy) * z;
  b[11] = (kC32 * y) * ((4.0f * zz - xx) - yy);
  b[12] = (kC33 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
  b[13] = (kC34 * x) * ((4.0f * zz - xx) - yy);
  b[14] = (kC35 * z) * (xx - yy);
  b[15] = (kC36 * x) * (xx - 3.0f * yy);
  if (kSlopes) {
    d[9][0] = kC30 * 6.0f * xy, d[9][1] = kC30 * (3.0f * xx - 3.0f * yy), d[9][2] = 0.0f;
    d[10][0] = kC31 * yz, d[10][1] = kC31 * xz, d[10][2] = kC31 * xy;
    d[11][0] = kC32 * -2.0f * xy, d[11][1] = kC32 * ((4.0f * zz - xx) - 3.0f * yy),
    d[11][2] = kC32 * 8.0f * yz;
    d[12][0] = kC33 * -6.0f * xz, d[12][1] = kC33 * -6.0f * yz,
    d[12][2] = kC33 * ((6.0f * zz - 3.0f * xx) - 3.0f * yy);
    d[13][0] = kC34 * ((4.0f * zz - 3.0f * xx) - yy), d[13][1] = kC34 * -2.0f * xy,
    d[13][2] = kC34 * 8.0f * xz;
    d[14][0] = kC35 * 2.0f * xz, d[14][1] = kC35 * -2.0f * yz, d[14][2] = kC35 * (xx - yy);
    d[15][0] = kC36 * (3.0f * xx - 3.0f * yy), d[15][1] = kC36 * -6.0f * xy, d[15][2] = 0.0f;
  }
  if (deg < 4) return 16;
  b[16] = (kC40 * xy) * (xx - yy);
  b[17] = (kC41 * yz) * (3.0f * xx - yy);
  b[18] = (kC42 * xy) * (7.0f * zz - 1.0f);
  b[19] = (kC43 * yz) * (7.0f * zz - 3.0f);
  b[20] = kC44 * (zz * (35.0f * zz - 30.0f) + 3.0f);
  b[21] = (kC45 * xz) * (7.0f * zz - 3.0f);
  b[22] = (kC46 * (xx - yy)) * (7.0f * zz - 1.0f);
  b[23] = (kC47 * xz) * (xx - 3.0f * yy);
  b[24] = kC48 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
  if (kSlopes) {
    d[16][0] = kC40 * y * (3.0f * xx - yy), d[16][1] = kC40 * x * (xx - 3.0f * yy),
    d[16][2] = 0.0f;
    d[17][0] = kC41 * 6.0f * xy * z, d[17][1] = kC41 * 3.0f * z * (xx - yy),
    d[17][2] = kC41 * y * (3.0f * xx - yy);
    d[18][0] = kC42 * y * (7.0f * zz - 1.0f), d[18][1] = kC42 * x * (7.0f * zz - 1.0f),
    d[18][2] = kC42 * 14.0f * xy * z;
    d[19][0] = 0.0f, d[19][1] = kC43 * z * (7.0f * zz - 3.0f),
    d[19][2] = kC43 * y * (21.0f * zz - 3.0f);
    d[20][0] = 0.0f, d[20][1] = 0.0f, d[20][2] = kC44 * z * (140.0f * zz - 60.0f);
    d[21][0] = kC45 * z * (7.0f * zz - 3.0f), d[21][1] = 0.0f,
    d[21][2] = kC45 * x * (21.0f * zz - 3.0f);
    d[22][0] = kC46 * 2.0f * x * (7.0f * zz - 1.0f),
    d[22][1] = kC46 * -2.0f * y * (7.0f * zz - 1.0f),
    d[22][2] = kC46 * 14.0f * z * (xx - yy);
    d[23][0] = kC47 * 3.0f * z * (xx - yy), d[23][1] = kC47 * -6.0f * xy * z,
    d[23][2] = kC47 * x * (xx - 3.0f * yy);
    d[24][0] = kC48 * 4.0f * x * (xx - 3.0f * yy), d[24][1] = kC48 * 4.0f * y * (yy - 3.0f * xx),
    d[24][2] = 0.0f;
  }
  return 25;
}

// SH rows as they arrive: element (i, channel, coefficient) at these strides
struct ShRows {
  const float* p;
  long long sn, sc, sk;
  __device__ __forceinline__ float at(int i, int ch, int k) const {
    return __ldg(p + i * sn + ch * sc + k * sk);
  }
};

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ means3d, const float* __restrict__ scales,
                   const float* __restrict__ rotations, const float* __restrict__ opacities,
                   ShRows shs, const float* __restrict__ offset,
                   const unsigned char* __restrict__ alive, CamPtrs cam_ptrs, int n, int sh_degree, float scale_modifier, int antialiasing, int tight,
                   int width, int height, float* __restrict__ mean2d,
                   float* __restrict__ depth, float* __restrict__ conic,
                   float* __restrict__ opacity, float* __restrict__ color,
                   float* __restrict__ radius, bool* __restrict__ valid,
                   float* __restrict__ radius_x, float* __restrict__ radius_y) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Cam cam;
  load_cam(cam_ptrs, width, height, cam);
  float m[3], q[4], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m[k] = __ldg(means3d + 3 * i + k);
    s[k] = __ldg(scales + 3 * i + k);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __ldg(rotations + 4 * i + k);
  Geometry g;
  geometry(cam, m, q, s, scale_modifier, g);

  float px = ((g.nx * g.inv_w + 1.0f) * static_cast<float>(width) - 1.0f) * 0.5f;
  float py = ((g.ny * g.inv_w + 1.0f) * static_cast<float>(height) - 1.0f) * 0.5f;
  if (offset != nullptr) {
    px = px + __ldg(offset + 2 * i);
    py = py + __ldg(offset + 2 * i + 1);
  }
  float op = __ldg(opacities + i);
  if (antialiasing) {
    const float det_raw = g.a * g.c - g.b * g.b;
    const float ratio = det_raw / (g.det == 0.0f ? 1.0f : g.det);
    op = op * sqrtf(tmax(ratio, 0.0f));
  }

  // the CUDA heuristic's 3-sigma radius, and the binning half-extents
  const float mid = 0.5f * (g.a_d + g.c_d);
  const float disc = clamp_min(mid * mid - g.det, kDiscFloor);
  const float sigma_max = sqrtf(clamp_min(mid + sqrtf(disc), 0.0f));
  float r = ceilf(3.0f * sigma_max);
  float rx = r, ry = r;
  if (tight) {
    float lim = 2.0f * logf(clamp_min(255.0f * op, kLogFloor));
    lim = clamp_min(lim, 0.0f);
    rx = ceilf(tmin(sqrtf(lim * clamp_min(g.a_d, 0.0f)), 3.0f * sigma_max)) + 1.0f;
    ry = ceilf(tmin(sqrtf(lim * clamp_min(g.c_d, 0.0f)), 3.0f * sigma_max)) + 1.0f;
    const bool visible = op * 255.0f > 1.0f;
    rx = visible ? rx : 0.0f;
    ry = visible ? ry : 0.0f;
  }

  // colour from SH along the camera-to-Gaussian direction
  const float dx = m[0] - cam.campos[0], dy = m[1] - cam.campos[1], dz = m[2] - cam.campos[2];
  const float inv_n = 1.0f / (sqrtf((dx * dx + dy * dy) + dz * dz) + kDirGuard);
  float basis[kMaxCoeffs];
  const int coeff = sh_basis<false>(sh_degree, dx * inv_n, dy * inv_n, dz * inv_n, basis,
                                    nullptr);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = basis[0] * shs.at(i, ch, 0);
    for (int k = 1; k < coeff; ++k) acc = acc + basis[k] * shs.at(i, ch, k);
    color[3 * i + ch] = tmax(acc + 0.5f, 0.0f);
  }

  bool ok = g.tz > kNearCull && g.det_ok;
  if (alive != nullptr) ok = ok && alive[i] != 0;
  mean2d[2 * i] = px;
  mean2d[2 * i + 1] = py;
  depth[i] = g.tz;
  conic[3 * i] = g.c_d * g.inv_det;
  conic[3 * i + 1] = -g.b * g.inv_det;
  conic[3 * i + 2] = g.a_d * g.inv_det;
  opacity[i] = op;
  radius[i] = ok ? r : 0.0f;
  valid[i] = ok;
  radius_x[i] = ok ? rx : 0.0f;
  radius_y[i] = ok ? ry : 0.0f;
}

// a cotangent column: element i at i * stride; none (nullptr) reads 0
struct Cot {
  const float* p;
  long long stride;
  __device__ __forceinline__ float at(int i, int col) const {
    return p == nullptr ? 0.0f : __ldg(p + i * stride + col);
  }
};

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ means3d, const float* __restrict__ scales,
                   const float* __restrict__ rotations, const float* __restrict__ opacities,
                   ShRows shs, CamPtrs cam_ptrs, int n, int sh_degree,
                   float scale_modifier, int antialiasing, int width, int height,
                   Cot g_mean2d, Cot g_depth, Cot g_conic, Cot g_opacity, Cot g_color,
                   float* __restrict__ d_means3d, float* __restrict__ d_scales,
                   float* __restrict__ d_rotations, float* __restrict__ d_opacities,
                   float* __restrict__ d_shs, long long dsn, long long dsc, long long dsk,
                   int n_coeffs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Cam cam;
  load_cam(cam_ptrs, width, height, cam);
  float m[3], q[4], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m[k] = __ldg(means3d + 3 * i + k);
    s[k] = __ldg(scales + 3 * i + k);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __ldg(rotations + 4 * i + k);
  Geometry g;
  geometry(cam, m, q, s, scale_modifier, g);
  float S[3][3];  // the symmetric 3D covariance
  {
    const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) S[pi[e]][pj[e]] = S[pj[e]][pi[e]] = g.c6[e];
  }
  float St0[3], St1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    St0[k] = S[k][0] * g.t0[0] + S[k][1] * g.t0[1] + S[k][2] * g.t0[2];
    St1[k] = S[k][0] * g.t1[0] + S[k][1] * g.t1[1] + S[k][2] * g.t1[2];
  }

  // ---- conic and opacity
  const float g_ca = g_conic.at(i, 0), g_cb = g_conic.at(i, 1), g_cc = g_conic.at(i, 2);
  const float g_opacity_i = g_opacity.at(i, 0);
  float g_a_d = g_cc * g.inv_det;
  float g_c_d = g_ca * g.inv_det;
  float g_b = -(g_cb * g.inv_det);
  const float g_inv_det = (g_ca * g.c_d + g_cb * -g.b) + g_cc * g.a_d;
  const float g_det = g.det_ok ? -g_inv_det * (g.inv_det * g.inv_det) : 0.0f;
  g_a_d = g_a_d + g_det * g.c_d;
  g_c_d = g_c_d + g_det * g.a_d;
  g_b = g_b - 2.0f * g.b * g_det;
  const float opac = __ldg(opacities + i);
  float g_a = g_a_d, g_c = g_c_d, g_op;
  if (antialiasing) {
    const float det_raw = g.a * g.c - g.b * g.b;
    const float det_dd = g.det == 0.0f ? 1.0f : g.det;
    const float ratio = det_raw / det_dd;
    const float root = sqrtf(tmax(ratio, 0.0f));
    g_op = g_opacity_i * root;
    const float g_root = g_opacity_i * opac;
    const float g_ratio = max_grad(g_root / (2.0f * root), ratio, 0.0f);
    const float g_raw = g_ratio / det_dd;
    const float g_det_d = g.det == 0.0f ? 0.0f : -g_ratio * ((det_raw / det_dd) / det_dd);
    g_a = (g_a + g_raw * g.c) + g_det_d * g.c_d;
    g_c = (g_c + g_raw * g.a) + g_det_d * g.a_d;
    g_b = (g_b - 2.0f * g.b * g_raw) - 2.0f * g.b * g_det_d;
  } else {
    g_op = g_opacity_i;
  }

  // ---- the EWA quadratic forms: a = t0 S t0, b = t0 S t1, c = t1 S t1
  float g_t0[3], g_t1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_t0[k] = 2.0f * g_a * St0[k] + g_b * St1[k];
    g_t1[k] = g_b * St0[k] + 2.0f * g_c * St1[k];
  }
  float g_c6[6];
  {
    const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int a = pi[e], b = pj[e];
      const float f = a == b ? 1.0f : 2.0f;  // an off-diagonal entry stands for two
      const float cross =
          a == b ? g.t0[a] * g.t1[b] : g.t0[a] * g.t1[b] + g.t0[b] * g.t1[a];
      g_c6[e] = (f * g_a * g.t0[a] * g.t0[b] + g_b * cross) + f * g_c * g.t1[a] * g.t1[b];
    }
  }
  // ---- the Jacobian and the frustum clamp
  const float* W = cam.wv;
  const float g_j00 = (g_t0[0] * W[0] + g_t0[1] * W[1]) + g_t0[2] * W[2];
  const float g_j02 = (g_t0[0] * W[8] + g_t0[1] * W[9]) + g_t0[2] * W[10];
  const float g_j11 = (g_t1[0] * W[4] + g_t1[1] * W[5]) + g_t1[2] * W[6];
  const float g_j12 = (g_t1[0] * W[8] + g_t1[1] * W[9]) + g_t1[2] * W[10];
  const float g_inv_z2 = g_j02 * (-cam.fx * g.txc) + g_j12 * (-cam.fy * g.tyc);
  const float g_inv_z = (g_j00 * cam.fx + g_j11 * cam.fy) + 2.0f * g.inv_z * g_inv_z2;
  const float g_txc = g_j02 * -cam.fx * g.inv_z2;
  const float g_tyc = g_j12 * -cam.fy * g.inv_z2;
  float g_tzs = (-g_inv_z * (g.inv_z * g.inv_z) + g_txc * g.uxc) + g_tyc * g.uyc;
  const float g_ux = max_grad(min_grad(g_txc * g.tzs, g.vx, cam.limx), g.ux, -cam.limx);
  const float g_uy = max_grad(min_grad(g_tyc * g.tzs, g.vy, cam.limy), g.uy, -cam.limy);
  const float g_tx_v = g_ux / g.tzs;
  const float g_ty_v = g_uy / g.tzs;
  g_tzs = (g_tzs - g_ux * (g.ux / g.tzs)) - g_uy * (g.uy / g.tzs);
  const float g_tz = g_depth.at(i, 0) + (g.tz_small ? 0.0f : g_tzs);

  // ---- the 3D covariance: c6[i, j] = sum_k R_ik R_jk sq_k
  float G[3][3];  // symmetric: 2 g on the diagonal, g off it
  G[0][0] = 2.0f * g_c6[0];
  G[1][1] = 2.0f * g_c6[3];
  G[2][2] = 2.0f * g_c6[5];
  G[0][1] = G[1][0] = g_c6[1];
  G[0][2] = G[2][0] = g_c6[2];
  G[1][2] = G[2][1] = g_c6[4];
  float gR[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gR[a][k] = ((G[a][0] * g.R[0][k] + G[a][1] * g.R[1][k]) + G[a][2] * g.R[2][k]) * g.sq[k];
  {
    const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float g_sq = 0.0f;
#pragma unroll
      for (int e = 0; e < 6; ++e) g_sq = g_sq + g_c6[e] * g.R[pi[e]][k] * g.R[pj[e]][k];
      d_scales[3 * i + k] = 2.0f * g.s[k] * g_sq * scale_modifier;
    }
  }
  const float qr = g.qn[0], qx = g.qn[1], qy = g.qn[2], qz = g.qn[3];
  float g_qn[4];
  g_qn[0] = 2.0f * (((((-gR[0][1] * qz + gR[0][2] * qy) + gR[1][0] * qz) - gR[1][2] * qx) -
                     gR[2][0] * qy) + gR[2][1] * qx);
  g_qn[1] = 2.0f * (((((gR[0][1] * qy + gR[0][2] * qz) + gR[1][0] * qy) - gR[1][2] * qr) +
                     gR[2][0] * qz) + gR[2][1] * qr) -
            4.0f * qx * (gR[1][1] + gR[2][2]);
  g_qn[2] = 2.0f * (((((gR[0][1] * qx + gR[0][2] * qr) + gR[1][0] * qx) + gR[1][2] * qz) -
                     gR[2][0] * qr) + gR[2][1] * qz) -
            4.0f * qy * (gR[0][0] + gR[2][2]);
  g_qn[3] = 2.0f * (((((-gR[0][1] * qr + gR[0][2] * qx) + gR[1][0] * qr) + gR[1][2] * qy) +
                     gR[2][0] * qx) + gR[2][1] * qy) -
            4.0f * qz * (gR[0][0] + gR[1][1]);
  const float g_inv_qn =
      ((g_qn[0] * g.q[0] + g_qn[1] * g.q[1]) + g_qn[2] * g.q[2]) + g_qn[3] * g.q[3];
  const float g_qsum = (-g_inv_qn * (g.inv_qn * g.inv_qn)) / (2.0f * g.qnorm);
#pragma unroll
  for (int k = 0; k < 4; ++k) d_rotations[4 * i + k] = g_qn[k] * g.inv_qn + 2.0f * g.q[k] * g_qsum;
  d_opacities[i] = g_op;

  // ---- colour from SH
  const float d[3] = {m[0] - cam.campos[0], m[1] - cam.campos[1], m[2] - cam.campos[2]};
  const float dnorm = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  const float inv_n = 1.0f / (dnorm + kDirGuard);
  float basis[kMaxCoeffs], slopes[kMaxCoeffs][3];
  const int coeff = sh_basis<true>(sh_degree, d[0] * inv_n, d[1] * inv_n, d[2] * inv_n, basis,
                                   slopes);
  float g_rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = basis[0] * shs.at(i, ch, 0);
    for (int k = 1; k < coeff; ++k) acc = acc + basis[k] * shs.at(i, ch, k);
    g_rgb[ch] = max_grad(g_color.at(i, ch), acc + 0.5f, 0.0f);
    float* out = d_shs + i * dsn + ch * dsc;
    for (int k = 0; k < n_coeffs; ++k) out[k * dsk] = k < coeff ? g_rgb[ch] * basis[k] : 0.0f;
  }
  float g_dir[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 1; k < coeff; ++k) {
    const float g_bk = (g_rgb[0] * shs.at(i, 0, k) + g_rgb[1] * shs.at(i, 1, k)) +
                       g_rgb[2] * shs.at(i, 2, k);
#pragma unroll
    for (int c = 0; c < 3; ++c) g_dir[c] = g_dir[c] + g_bk * slopes[k][c];
  }
  const float g_inv_n = (g_dir[0] * d[0] + g_dir[1] * d[1]) + g_dir[2] * d[2];
  const float g_dsq = (-g_inv_n * (inv_n * inv_n)) / (2.0f * dnorm);

  // ---- the projection: mean2d = ndc_to_pixel(FP[:2] m / (FP[3] m + 1e-7))
  const float g_ndcx = g_mean2d.at(i, 0) * 0.5f * static_cast<float>(width);
  const float g_ndcy = g_mean2d.at(i, 1) * 0.5f * static_cast<float>(height);
  const float g_w = -(g_ndcx * g.nx + g_ndcy * g.ny) * (g.inv_w * g.inv_w);
  const float g_nx = g_ndcx * g.inv_w, g_ny = g_ndcy * g.inv_w;
  const float* F = cam.fp;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d_means3d[3 * i + k] = (((((g_tx_v * W[k] + g_ty_v * W[4 + k]) + g_tz * W[8 + k]) +
                              g_nx * F[k]) + g_ny * F[4 + k]) + g_w * F[12 + k]) +
                           (g_dir[k] * inv_n + 2.0f * d[k] * g_dsq);
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// the forward: every output (N rows) of `preprocess`; offset and alive may
// be null; sh strides in elements; the camera as the Camera's five tensors
extern "C" int project_fwd(const float* means3d, const float* scales, const float* rotations,
                           const float* opacities, const float* shs, long long sh_sn,
                           long long sh_sc, long long sh_sk, const float* offset,
                           const unsigned char* alive, const float* cam_wv,
                           const float* cam_fp, const float* cam_center,
                           const float* cam_tanfovx, const float* cam_tanfovy, int n,
                           int sh_degree, float scale_modifier, int antialiasing, int tight,
                           int width, int height, float* mean2d, float* depth, float* conic,
                           float* opacity, float* color, float* radius, bool* valid,
                           float* radius_x, float* radius_y, void* stream) {
  if (n > 0) {
    project_fwd_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        means3d, scales, rotations, opacities, ShRows{shs, sh_sn, sh_sc, sh_sk}, offset, alive,
        CamPtrs{cam_wv, cam_fp, cam_center, cam_tanfovx, cam_tanfovy}, n, sh_degree, scale_modifier, antialiasing, tight, width, height, mean2d,
        depth, conic, opacity, color, radius, valid, radius_x, radius_y);
  }
  return static_cast<int>(cudaGetLastError());
}

// the backward: cotangents as (pointer or null, row stride in elements); the
// gradients of means3d (N, 3), scales (N, 3), rotations (N, 4), opacities
// (N) contiguous, of shs at its own strides (all n_coeffs coefficients)
extern "C" int project_bwd(const float* means3d, const float* scales, const float* rotations,
                           const float* opacities, const float* shs, long long sh_sn,
                           long long sh_sc, long long sh_sk, const float* cam_wv,
                           const float* cam_fp, const float* cam_center,
                           const float* cam_tanfovx, const float* cam_tanfovy, int n,
                           int sh_degree, float scale_modifier, int antialiasing, int width,
                           int height, const float* g_mean2d, long long s_mean2d,
                           const float* g_depth, long long s_depth, const float* g_conic,
                           long long s_conic, const float* g_opacity, long long s_opacity,
                           const float* g_color, long long s_color, float* d_means3d,
                           float* d_scales, float* d_rotations, float* d_opacities,
                           float* d_shs, long long dsn, long long dsc, long long dsk,
                           int n_coeffs, void* stream) {
  if (n > 0) {
    project_bwd_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        means3d, scales, rotations, opacities, ShRows{shs, sh_sn, sh_sc, sh_sk},
        CamPtrs{cam_wv, cam_fp, cam_center, cam_tanfovx, cam_tanfovy}, n,
        sh_degree, scale_modifier, antialiasing, width, height, Cot{g_mean2d, s_mean2d},
        Cot{g_depth, s_depth}, Cot{g_conic, s_conic}, Cot{g_opacity, s_opacity},
        Cot{g_color, s_color}, d_means3d, d_scales, d_rotations, d_opacities, d_shs, dsn, dsc,
        dsk, n_coeffs);
  }
  return static_cast<int>(cudaGetLastError());
}
