// Backward composite of the tile rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of
// gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py (launched by
// `_composite_bwd`) together with the per-pair table and the sort-plus-cumsum
// segment sum that `_get_expand_pairs` runs after it: this kernel writes
// per-GAUSSIAN gradients directly, with atomics.
//
// For every 16x16 pixel tile it re-walks the tile's depth-ordered pair range
// BACK to front, from the block-wide max of nc (the forward kernel's 1-based
// rank of each pixel's last included pair). A pair of rank r < nc with
// power <= 0 and alpha >= 1/255 is exactly a pair the forward included
// (T only falls, so no pair is skipped for termination before nc). Per pixel,
// starting from T = T_final and S = T_final * dL/dT:
//   T_before = T / (1 - alpha)                (alpha <= 0.99: no blow-up)
//   w        = T_before * alpha
//   u        = r dL/dr + g dL/dg + b dL/db + z dL/dD
//   dalpha   = T_before * u - S / (1 - alpha)  S = T_final dL/dT + sum of w u
//                                               over the pairs behind this one
//   S += w u;  T = T_before
// and, while alpha_raw = op * exp(power) < 0.99 (the clamp has zero slope),
//   dpower = dalpha * alpha_raw,  dop = dalpha * exp(power).
// With dx = mx - px, dy = my - py and power = -0.5 (a dx^2 + c dy^2) - b dx dy:
//   dmx = -(a dx + b dy) dpower   dmy = -(c dy + b dx) dpower
//   da = -0.5 dx^2 dpower   db = -dx dy dpower   dc = -0.5 dy^2 dpower
//   dcolor = w dL/dC,  dz = w dL/dD.
// Output: grads (N, 10) float32 in the column order
// mx, my, a, b, c, op, r, g, b, z; the caller zeroes it before the launch.
//
// What bounds it: per evaluated (pixel, pair) ~60 float operations with one
// expf and a 10-term sum over the tile, against 40 bytes of attributes per
// pair read once per tile and 32 bytes of per-pixel state read once; like the
// forward it is bound by arithmetic, not by device memory.
// Design: one block of 256 threads per tile, one pixel per thread (the
// forward's layout). Pairs are staged back to front through shared memory in
// batches of 256, gathered by Gaussian id. Each pair's 10 gradient terms are
// summed over the block (warp shuffles, skipped for a warp whose pixels all
// miss the pair, then 8 warp partials in shared memory) and added with ONE
// atomicAdd per term into the Gaussian's row: 256 times fewer global atomics
// than per-pixel adds. The partials are double-buffered, so each pair costs
// one barrier, which also reports (__syncthreads_or) whether any pixel of the
// tile included the pair; if none did, it adds nothing.
//
// Precision: float32, built WITHOUT fast math and with -fmad=false, so the
// inclusion tests (power <= 0, alpha >= 1/255) round exactly as the forward
// kernel's did. Sums over pixels and the atomics run in an order that changes
// from run to run, so the result matches the plain version to a tolerance,
// not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 10;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const int* __restrict__ pair_gaussian,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end,
                     const float* __restrict__ mean2d,   // (N, 2)
                     const float* __restrict__ conic,    // (N, 3)
                     const float* __restrict__ opacity,  // (N,)
                     const float* __restrict__ color,    // (N, 3)
                     const float* __restrict__ depth,    // (N,)
                     const float* __restrict__ t_final,  // (H, W)
                     const int* __restrict__ nc_in,      // (H, W)
                     const float* __restrict__ grad_planes,  // (5, H, W): r, g, b, T, D
                     int height, int width, int n_tiles_x,
                     float* __restrict__ grads) {        // (N, 10)
  __shared__ int s_id[kThreads];
  __shared__ float s_mx[kThreads], s_my[kThreads];
  __shared__ float s_ca[kThreads], s_cb[kThreads], s_cc[kThreads];
  __shared__ float s_op[kThreads];
  __shared__ float s_r[kThreads], s_g[kThreads], s_b[kThreads], s_z[kThreads];
  __shared__ float s_part[2][kWarps][kCols];
  __shared__ int s_max_nc;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px = (tile % n_tiles_x) * kTile + (tid % kTile);
  const int py = (tile / n_tiles_x) * kTile + (tid / kTile);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  const int start = tile_start[tile];
  const int end = tile_end[tile];

  float T = 1.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f, gt = 0.0f, gd = 0.0f;
  int nc = 0;
  if (inside) {
    const int plane = height * width;
    const int p = py * width + px;
    T = t_final[p];
    nc = nc_in[p];
    gr = grad_planes[p];
    gg = grad_planes[plane + p];
    gb = grad_planes[2 * plane + p];
    gt = grad_planes[3 * plane + p];
    gd = grad_planes[4 * plane + p];
  }
  float S = T * gt;

  if (tid == 0) s_max_nc = 0;
  __syncthreads();
  if (nc > 0) atomicMax(&s_max_nc, nc);
  __syncthreads();
  const int stop = min(end, start + s_max_nc);

  int buf = 0;
  for (int hi = stop; hi > start; hi -= kThreads) {
    const int lo = max(start, hi - kThreads);
    // the previous batch (and its last pair's atomics) is done with smem
    __syncthreads();
    const int idx = lo + tid;
    if (idx < hi) {
      const int g = pair_gaussian[idx];
      s_id[tid] = g;
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
    for (int j = hi - lo - 1; j >= 0; --j) {
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = 0.0f;
      bool included = false;
      if (lo - start + j < nc) {
        const float a = s_ca[j], b = s_cb[j], c = s_cc[j];
        const float dx = s_mx[j] - fx;
        const float dy = s_my[j] - fy;
        const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha_raw = s_op[j] * G;
          const float alpha = fminf(kAlphaMax, alpha_raw);
          if (alpha >= kAlphaMin) {
            included = true;
            const float one_m = 1.0f - alpha;
            const float t_before = T / one_m;
            const float w = t_before * alpha;
            const float u = s_r[j] * gr + s_g[j] * gg + s_b[j] * gb + s_z[j] * gd;
            const float dalpha = t_before * u - S / one_m;
            S = S + w * u;
            T = t_before;
            if (alpha_raw < kAlphaMax) {
              const float dpow = dalpha * alpha_raw;
              v[0] = -(a * dx + b * dy) * dpow;
              v[1] = -(c * dy + b * dx) * dpow;
              v[2] = -0.5f * dx * dx * dpow;
              v[3] = -dx * dy * dpow;
              v[4] = -0.5f * dy * dy * dpow;
              v[5] = dalpha * G;
            }
            v[6] = w * gr;
            v[7] = w * gg;
            v[8] = w * gb;
            v[9] = w * gd;
          }
        }
      }
      if (__any_sync(0xffffffffu, included)) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[c] = warp_sum(v[c]);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) s_part[buf][warp][c] = v[c];
      }
      // one barrier per pair: the partials are double-buffered, so the
      // next pair's writes cannot overtake this pair's reads
      if (__syncthreads_or(included) && tid < kCols) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += s_part[buf][w][tid];
        atomicAdd(&grads[kCols * s_id[j] + tid], sum);
      }
      buf ^= 1;
    }
  }
}

}  // namespace

extern "C" int composite_bwd(const int* pair_gaussian, const int* tile_start,
                             const int* tile_end, const float* mean2d,
                             const float* conic, const float* opacity,
                             const float* color, const float* depth,
                             const float* t_final, const int* nc,
                             const float* grad_planes, int height, int width,
                             int n_tiles_x, int n_tiles, float* grads,
                             void* stream) {
  if (n_tiles > 0) {
    composite_bwd_kernel<<<n_tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pair_gaussian, tile_start, tile_end, mean2d, conic, opacity, color,
        depth, t_final, nc, grad_planes, height, width, n_tiles_x, grads);
  }
  return static_cast<int>(cudaGetLastError());
}
