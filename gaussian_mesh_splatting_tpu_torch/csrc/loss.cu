// The training loss (1 - lambda) * L1 + lambda * (1 - SSIM) over an (H, W, 3)
// float32 image pair, and its VJP, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves SSIM (ops/ssim.py) to XLA,
// which fuses it. The port ran it as a chain of ~360 small PyTorch launches
// forward and ~240 backward (ops/ssim.py `ssim` under autograd: five
// separable blurs of 2 pads and 22 shifted multiply-adds each), whose host
// time was the largest of a training step's stages.
//
// loss_fwd_kernel (L1): one block per tile of kRows image rows by kCols
// floats of a row (32 pixels x 3 channels; the row is the image's 3W floats,
// so a channel's horizontal neighbours lie 3 floats apart). It stages the
// tile of `pred` and `gt` with a 5-row and 16-float halo in shared memory
// (float4 loads where the row length and the pointers allow), forms x, y,
// x*x, y*y and x*y, blurs them along H, then along W, as ops/ssim.py `_blur`
// does: taps k = 0..10 summed in order, each product rounded before its add,
// zero padding. The SSIM map then follows `ssim_map`'s expression in its
// operation order, with C1 and C2 as float32 and IEEE division; built with
// -fmad=false and no fast math, each map element is bit-equal to the chain's.
// In the same pass it writes the three partial derivatives of the map that
// the VJP needs (with mu1, sigma1^2 = E[x^2] - mu1^2 and sigma12 = E[xy] -
// mu1 mu2, A1 = 2 mu1 mu2 + C1, A2 = 2 sigma12 + C2, B1 = mu1^2 + mu2^2 + C1,
// B2 = sigma1^2 + sigma2^2 + C2, D = B1 B2, m = A1 A2 / D):
//   dm/dmu1   = 2 (mu2 (A2 - A1) + mu1 m (B1 - B2)) / D
//   dm/dE[x2] = -m / B2
//   dm/dE[xy] = 2 A1 / D
// and each block's sums of the map and of |x - y|, in double, to a buffer.
// loss_reduce_kernel sums the blocks' partials in a fixed order into `total`
// and `l1`: no atomics, so two runs give the same bits.
//
// loss_bwd_kernel (L2): dL/dx = g_total ((1 - lambda)/N sgn(x - y) - lambda/N
// (B'(dm/dmu1) + 2x B'(dm/dE[x2]) + y B'(dm/dE[xy]))) + g_l1/N sgn(x - y),
// N = 3HW, sgn(0) = 0 (torch's abs backward). The window is symmetric and
// the padding zero, so the transposed blur B' is the same separable blur,
// along W first, then H; the tiles and halo are L1's. Its plain version is
// ops/ssim.py `photometric_vjp_plain`, operation for operation.
//
// What bounds them: bytes. At 800x800 L1 reads the two images (15.4 MB) and
// writes the three derivative maps (23 MB); L2 reads them and the images
// (38 MB) and writes the gradient (7.7 MB): ~11 and ~14 us at 3.35 TB/s,
// against ~0.47 GFLOP a pass (~7 us at 67 TFLOP/s). The halo's re-reads
// (26/16 rows, 128/96 floats) come from L2, not device memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTaps = 11;
constexpr int kHalf = kTaps / 2;
constexpr int kChannels = 3;
constexpr int kThreads = 256;
constexpr int kRows = 16;                         // a tile's image rows
constexpr int kCols = 96;                         // a tile's floats of a row: 32 pixels
constexpr int kHaloCols = 16;                     // 5 pixels (15 floats), to a float4
constexpr int kLoadRows = kRows + 2 * kHalf;      // 26
constexpr int kLoadCols = kCols + 2 * kHaloCols;  // 128
constexpr int kTile = kLoadRows * kLoadCols;      // one staged array, floats
constexpr int kRowsPerThread = kRows * kLoadCols / kThreads;  // L1's vertical pass: 8
constexpr int kReduceThreads = 256;

static_assert(kThreads % kLoadCols == 0, "L1's vertical pass: whole columns a thread");
static_assert(kCols % 32 == 0, "a warp's outputs lie in one row");

// dynamic shared memory: L1 stages x and y, then keeps the five vertical
// blurs of kRows rows; L2 stages the three derivative maps, then keeps their
// horizontal blurs of every staged row
constexpr int kFwdSmem = (2 * kTile + 5 * kRows * kLoadCols) * 4;  // 67,584 bytes
constexpr int kBwdSmem = (3 * kTile + 3 * kLoadRows * kCols) * 4;  // 69,888 bytes

struct Window {
  float w[kTaps];
};

// rows r0 - 5 .. r0 + kRows + 4 and floats f0 - 16 .. f0 + kCols + 15 of an
// (h, f) row-major array into tile[kLoadRows][kLoadCols], zeros outside it.
// `vec`: f % 4 == 0 and `src` 16-byte aligned, so a float4 lies wholly in
// or wholly out of a row
__device__ void load_tile(const float* __restrict__ src, float* tile, int r0, int f0, int h,
                          int f, bool vec) {
  if (vec) {
    constexpr int kVecs = kLoadCols / 4;
    for (int i = threadIdx.x; i < kLoadRows * kVecs; i += kThreads) {
      const int r = i / kVecs, v = i % kVecs;
      const int gr = r0 - kHalf + r, gc = f0 - kHaloCols + 4 * v;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr >= 0 && gr < h && gc >= 0 && gc < f) {
        val = *reinterpret_cast<const float4*>(src + gr * f + gc);
      }
      *reinterpret_cast<float4*>(tile + r * kLoadCols + 4 * v) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int r = i / kLoadCols, c = i % kLoadCols;
      const int gr = r0 - kHalf + r, gc = f0 - kHaloCols + c;
      tile[i] = (gr >= 0 && gr < h && gc >= 0 && gc < f) ? src[gr * f + gc] : 0.f;
    }
  }
}

// taps k = 0..10 at p[k * stride], in order: p[0] w0, then + p[k] wk
__device__ __forceinline__ float blur_taps(const float* p, int stride, const Window& win) {
  float acc = p[0] * win.w[0];
#pragma unroll
  for (int k = 1; k < kTaps; ++k) acc = acc + p[k * stride] * win.w[k];
  return acc;
}

// the block's sums of a and b, in a fixed order, by thread 0
__device__ void block_sums(double a, double b, double* out) {
  __shared__ double red[2 * kThreads];
  red[threadIdx.x] = a;
  red[kThreads + threadIdx.x] = b;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[threadIdx.x] += red[threadIdx.x + s];
      red[kThreads + threadIdx.x] += red[kThreads + threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = red[0];
    out[1] = red[kThreads];
  }
}

__global__ void __launch_bounds__(kThreads)
    loss_fwd_kernel(const float* __restrict__ pred, const float* __restrict__ gt, int h, int f,
                    int vec, Window win, float c1, float c2, float* __restrict__ ssim_map,
                    float* __restrict__ d_mu, float* __restrict__ d_xx,
                    float* __restrict__ d_xy, double* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ys = xs + kTile;
  float* vb = ys + kTile;  // [5][kRows][kLoadCols]: x, y, xx, yy, xy blurred along H
  const int r0 = blockIdx.y * kRows, f0 = blockIdx.x * kCols;
  load_tile(pred, xs, r0, f0, h, f, vec);
  load_tile(gt, ys, r0, f0, h, f, vec);
  __syncthreads();

  {  // along H: a thread takes one staged column and kRowsPerThread rows
    const int c = threadIdx.x % kLoadCols;
    const int i0 = (threadIdx.x / kLoadCols) * kRowsPerThread;
    float x[kRowsPerThread + 2 * kHalf], y[kRowsPerThread + 2 * kHalf];
#pragma unroll
    for (int k = 0; k < kRowsPerThread + 2 * kHalf; ++k) {
      x[k] = xs[(i0 + k) * kLoadCols + c];
      y[k] = ys[(i0 + k) * kLoadCols + c];
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float a0 = x[i] * win.w[0], a1 = y[i] * win.w[0], a2 = (x[i] * x[i]) * win.w[0],
            a3 = (y[i] * y[i]) * win.w[0], a4 = (x[i] * y[i]) * win.w[0];
#pragma unroll
      for (int k = 1; k < kTaps; ++k) {
        const float xk = x[i + k], yk = y[i + k], wk = win.w[k];
        a0 = a0 + xk * wk;
        a1 = a1 + yk * wk;
        a2 = a2 + (xk * xk) * wk;
        a3 = a3 + (yk * yk) * wk;
        a4 = a4 + (xk * yk) * wk;
      }
      const int o = (i0 + i) * kLoadCols + c;
      vb[o] = a0;
      vb[kRows * kLoadCols + o] = a1;
      vb[2 * kRows * kLoadCols + o] = a2;
      vb[3 * kRows * kLoadCols + o] = a3;
      vb[4 * kRows * kLoadCols + o] = a4;
    }
  }
  __syncthreads();

  // along W, the map, its derivatives, the block's sums
  double sum_map = 0.0, sum_abs = 0.0;
  for (int o = threadIdx.x; o < kRows * kCols; o += kThreads) {
    const int i = o / kCols, j = o % kCols;
    const int gr = r0 + i, gc = f0 + j;
    if (gr >= h || gc >= f) continue;
    // tap k of output float j reads staged float j + 3k + 1 (the halo is 16)
    const float* row = vb + i * kLoadCols + j + 1;
    const float mu1 = blur_taps(row, kChannels, win);
    const float mu2 = blur_taps(row + kRows * kLoadCols, kChannels, win);
    const float exx = blur_taps(row + 2 * kRows * kLoadCols, kChannels, win);
    const float eyy = blur_taps(row + 3 * kRows * kLoadCols, kChannels, win);
    const float exy = blur_taps(row + 4 * kRows * kLoadCols, kChannels, win);
    // ops/ssim.py `_ssim_parts` and `ssim_map`, in their order
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
    const float sigma1_sq = exx - mu1_sq, sigma2_sq = eyy - mu2_sq, sigma12 = exy - mu1_mu2;
    const float a1 = 2.f * mu1_mu2 + c1;
    const float a2 = 2.f * sigma12 + c2;
    const float b1 = (mu1_sq + mu2_sq) + c1;
    const float b2 = (sigma1_sq + sigma2_sq) + c2;
    const float den = b1 * b2;
    const float m = (a1 * a2) / den;
    const int idx = gr * f + gc;
    if (ssim_map != nullptr) ssim_map[idx] = m;
    d_mu[idx] = (2.f * (mu2 * (a2 - a1) + (mu1 * m) * (b1 - b2))) / den;
    d_xx[idx] = -m / b2;
    d_xy[idx] = (2.f * a1) / den;
    const int s = (i + kHalf) * kLoadCols + j + kHaloCols;
    sum_map += static_cast<double>(m);
    sum_abs += static_cast<double>(fabsf(xs[s] - ys[s]));
  }
  block_sums(sum_map, sum_abs, partials + 2 * (blockIdx.y * gridDim.x + blockIdx.x));
}

__global__ void __launch_bounds__(kReduceThreads)
    loss_reduce_kernel(const double* __restrict__ partials, int n_blocks, double n,
                       float one_minus_lambda, float lambda, float* __restrict__ total,
                       float* __restrict__ l1) {
  __shared__ double red[2 * kReduceThreads];
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < n_blocks; i += kReduceThreads) {
    a += partials[2 * i];
    b += partials[2 * i + 1];
  }
  red[threadIdx.x] = a;
  red[kReduceThreads + threadIdx.x] = b;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[threadIdx.x] += red[threadIdx.x + s];
      red[kReduceThreads + threadIdx.x] += red[kReduceThreads + threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float ssim_mean = static_cast<float>(red[0] / n);
    const float l1_mean = static_cast<float>(red[kReduceThreads] / n);
    *l1 = l1_mean;
    // train/loss.py: (1 - lambda) * l1 + lambda * (1 - ssim), in float32
    *total = one_minus_lambda * l1_mean + lambda * (1.f - ssim_mean);
  }
}

__global__ void __launch_bounds__(kThreads)
    loss_bwd_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                    const float* __restrict__ d_mu, const float* __restrict__ d_xx,
                    const float* __restrict__ d_xy, int h, int f, int vec, Window win,
                    const float* __restrict__ g_total, const float* __restrict__ g_l1,
                    float coef_l1, float coef_ssim, float coef_g_l1,
                    float* __restrict__ grad) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);  // [3][kLoadRows][kLoadCols]
  float* hb = gs + 3 * kTile;                     // [3][kLoadRows][kCols]: blurred along W
  const int r0 = blockIdx.y * kRows, f0 = blockIdx.x * kCols;
  load_tile(d_mu, gs, r0, f0, h, f, vec);
  load_tile(d_xx, gs + kTile, r0, f0, h, f, vec);
  load_tile(d_xy, gs + 2 * kTile, r0, f0, h, f, vec);
  __syncthreads();

  // along W, every staged row
  for (int o = threadIdx.x; o < kLoadRows * kCols; o += kThreads) {
    const int r = o / kCols, j = o % kCols;
    const float* row = gs + r * kLoadCols + j + 1;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      hb[q * kLoadRows * kCols + o] = blur_taps(row + q * kTile, kChannels, win);
    }
  }
  __syncthreads();

  // along H, then the gradient
  const float gt_total = g_total != nullptr ? *g_total : 0.f;
  const float gt_l1 = g_l1 != nullptr ? *g_l1 : 0.f;
  for (int o = threadIdx.x; o < kRows * kCols; o += kThreads) {
    const int i = o / kCols, j = o % kCols;
    const int gr = r0 + i, gc = f0 + j;
    if (gr >= h || gc >= f) continue;
    const float* col = hb + i * kCols + j;
    const float bt_mu = blur_taps(col, kCols, win);
    const float bt_xx = blur_taps(col + kLoadRows * kCols, kCols, win);
    const float bt_xy = blur_taps(col + 2 * kLoadRows * kCols, kCols, win);
    const int idx = gr * f + gc;
    const float x = pred[idx], y = gt[idx];
    const float d = x - y;
    const float sgn = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
    float v = 0.f;
    if (g_total != nullptr) {
      const float part = (bt_mu + (2.f * x) * bt_xx) + y * bt_xy;
      v = gt_total * (coef_l1 * sgn + coef_ssim * part);
    }
    if (g_l1 != nullptr) v = v + (gt_l1 * coef_g_l1) * sgn;
    grad[idx] = v;
  }
}

dim3 tiles(int h, int w) {
  return dim3((kChannels * w + kCols - 1) / kCols, (h + kRows - 1) / kRows);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// the blocks of a loss_fwd launch over an (h, w, 3) image: the partial
// sums' buffer holds two doubles for each
extern "C" int loss_blocks(int h, int w) {
  const dim3 g = tiles(h, w);
  return static_cast<int>(g.x * g.y);
}

// L1 and the reduction. `window`: the 11 float32 weights (host memory);
// `ssim_map` may be null (not written);
// `partials`: 2 x loss_blocks(h, w) doubles of scratch; `total`, `l1`: one
// float each
extern "C" int loss_fwd(const float* pred, const float* gt, int h, int w, const float* window,
                        float c1, float c2, float one_minus_lambda, float lambda,
                        float* ssim_map, float* d_mu, float* d_xx, float* d_xy,
                        double* partials, float* total, float* l1, void* stream) {
  Window win;
  for (int k = 0; k < kTaps; ++k) win.w[k] = window[k];
  const int f = kChannels * w;
  const dim3 grid = tiles(h, w);
  const int vec = f % 4 == 0 && aligned16(pred) && aligned16(gt);
  cudaError_t err =
      cudaFuncSetAttribute(loss_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  loss_fwd_kernel<<<grid, kThreads, kFwdSmem, s>>>(pred, gt, h, f, vec, win, c1, c2, ssim_map,
                                                   d_mu, d_xx, d_xy, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_reduce_kernel<<<1, kReduceThreads, 0, s>>>(partials, static_cast<int>(grid.x * grid.y),
                                                  static_cast<double>(f) * h, one_minus_lambda,
                                                  lambda, total, l1);
  return static_cast<int>(cudaGetLastError());
}

// L2. `g_total`, `g_l1`: device scalars, either may be null (no gradient);
// coef_l1 = (1 - lambda) / N, coef_ssim = -lambda / N, coef_g_l1 = 1 / N
extern "C" int loss_bwd(const float* pred, const float* gt, const float* d_mu,
                        const float* d_xx, const float* d_xy, int h, int w,
                        const float* window, const float* g_total, const float* g_l1,
                        float coef_l1, float coef_ssim, float coef_g_l1, float* grad,
                        void* stream) {
  Window win;
  for (int k = 0; k < kTaps; ++k) win.w[k] = window[k];
  const int f = kChannels * w;
  const int vec = f % 4 == 0 && aligned16(d_mu) && aligned16(d_xx) && aligned16(d_xy);
  cudaError_t err =
      cudaFuncSetAttribute(loss_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_bwd_kernel<<<tiles(h, w), kThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      pred, gt, d_mu, d_xx, d_xy, h, f, vec, win, g_total, g_l1, coef_l1, coef_ssim, coef_g_l1,
      grad);
  return static_cast<int>(cudaGetLastError());
}
