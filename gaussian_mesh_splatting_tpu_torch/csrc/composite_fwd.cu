// Forward composite of the tile rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py (launched by
// `_composite_fwd`). For every 16x16 pixel tile it walks the tile's
// depth-ordered [start, end) range of the sorted pair list front to back:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,   alpha = min(0.99, op e^power)
//   a pair is skipped if power > 0 or alpha < 1/255;
//   a pair that would take T below 1e-4 stops the pixel and is NOT
//   composited; otherwise C += T alpha c, D += T alpha z, T *= 1 - alpha.
// Outputs per pixel: r, g, b (no background), final T, expected depth and
// nc, the 1-based rank (within the tile's range) of the last included pair.
//
// What bounds it: per evaluated (pixel, pair) it does ~20 float operations
// including one expf, against 40 bytes of Gaussian attributes per pair that
// are read once per tile; with 256 pixels sharing every pair it is bound by
// arithmetic (the f32 pipe and the SFU's exp), not by device memory.
// Design: one block of 256 threads per tile, one pixel per thread. The
// tile's pairs are staged through shared memory in batches of 256, one pair
// loaded per thread (the Gaussian id from the pair list, then that
// Gaussian's attributes gathered by id), so every attribute is fetched from
// device memory once per tile and then broadcast from shared memory to all
// 256 pixels. The block leaves the walk as soon as every pixel is done
// (__syncthreads_count). Pixels outside the image take part in the loads
// and barriers but start done and store nothing.
//
// Precision: exact float32, built WITHOUT fast math and with -fmad=false,
// so every product and sum rounds as the plain PyTorch version's separate
// operations do. A contracted a*b+c can move alpha across the 1/255 cut or
// T across 1e-4 for a pair that sits on the boundary, which changes the
// included pairs (nc) and the image by a whole pair's weight.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const int* __restrict__ pair_gaussian,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end,
                     const float* __restrict__ mean2d,   // (N, 2)
                     const float* __restrict__ conic,    // (N, 3)
                     const float* __restrict__ opacity,  // (N,)
                     const float* __restrict__ color,    // (N, 3)
                     const float* __restrict__ depth,    // (N,)
                     int height, int width, int n_tiles_x,
                     float* __restrict__ out,            // (5, H, W): r, g, b, T, D
                     int* __restrict__ out_nc) {         // (H, W)
  __shared__ float s_mx[kThreads], s_my[kThreads];
  __shared__ float s_ca[kThreads], s_cb[kThreads], s_cc[kThreads];
  __shared__ float s_op[kThreads];
  __shared__ float s_r[kThreads], s_g[kThreads], s_b[kThreads], s_z[kThreads];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = (tile % n_tiles_x) * kTile + (tid % kTile);
  const int py = (tile / n_tiles_x) * kTile + (tid / kTile);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  const int start = tile_start[tile];
  const int end = tile_end[tile];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int nc = 0;
  bool done = !inside;

  for (int base = start; base < end; base += kThreads) {
    // also the barrier that keeps the previous batch readable until all
    // threads are through it
    if (__syncthreads_count(done) == kThreads) break;
    const int idx = base + tid;
    if (idx < end) {
      const int g = pair_gaussian[idx];
      s_mx[tid] = mean2d[2 * g];
      s_my[tid] = mean2d[2 * g + 1];
      s_ca[tid] = conic[3 * g];
      s_cb[tid] = conic[3 * g + 1];
      s_cc[tid] = conic[3 * g + 2];
      s_op[tid] = opacity[g];
      s_r[tid] = color[3 * g];
      s_g[tid] = color[3 * g + 1];
      s_b[tid] = color[3 * g + 2];
      s_z[tid] = depth[g];
    }
    __syncthreads();
    const int n = min(kThreads, end - base);
    for (int j = 0; !done && j < n; ++j) {
      const float dx = s_mx[j] - fx;
      const float dy = s_my[j] - fy;
      const float power =
          -0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) - s_cb[j] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(kAlphaMax, s_op[j] * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < kTEps) {
        done = true;
        break;
      }
      const float w = T * alpha;
      cr = cr + w * s_r[j];
      cg = cg + w * s_g[j];
      cb = cb + w * s_b[j];
      cd = cd + w * s_z[j];
      T = test_T;
      nc = base - start + j + 1;
    }
  }

  if (inside) {
    const int plane = height * width;
    const int p = py * width + px;
    out[p] = cr;
    out[plane + p] = cg;
    out[2 * plane + p] = cb;
    out[3 * plane + p] = T;
    out[4 * plane + p] = cd;
    out_nc[p] = nc;
  }
}

}  // namespace

extern "C" int composite_fwd(const int* pair_gaussian, const int* tile_start,
                             const int* tile_end, const float* mean2d,
                             const float* conic, const float* opacity,
                             const float* color, const float* depth,
                             int height, int width, int n_tiles_x, int n_tiles,
                             float* out, int* out_nc, void* stream) {
  if (n_tiles > 0) {
    composite_fwd_kernel<<<n_tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pair_gaussian, tile_start, tile_end, mean2d, conic, opacity, color,
        depth, height, width, n_tiles_x, out, out_nc);
  }
  return static_cast<int>(cudaGetLastError());
}
