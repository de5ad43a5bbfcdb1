// Forward composite of the tile rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py (launched by
// `_composite_fwd`). For every 16x16 pixel tile it walks the tile's
// depth-ordered [start, end) range of the sorted pair list front to back:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,   alpha = min(0.99, op e^power)
//   a pair is skipped unless power <= 0 and alpha >= 1/255;
//   a pair that would take T below 1e-4 stops the pixel and is NOT
//   composited; otherwise C += T alpha c, D += T alpha z, T *= 1 - alpha.
// Outputs per pixel: r, g, b (no background), final T, expected depth and
// nc, the 1-based rank (within the tile's range) of the last included pair.
// Input: one packed row per Gaussian, in one of two formats
// (composite_common.cuh): 12 floats (mx, my, a, b, c, op, r, g, b, z, 0, 0),
// three 16-byte words (entry point composite_fwd), or 16 bf16 in the JAX
// rasterizer's attr_precision="bf16" split layout, two 16-byte words
// (composite_fwd_bf16). The staging copy turns a bf16 row into the float32
// row of its reconstructed values, so on the bf16 table the kernel's result
// is bit-equal to its result on the float32 table of those values.
//
// What bounds it: per evaluated (pixel, pair) it does ~20 float operations
// including one expf, against 48 bytes (bf16 rows: 32) of Gaussian
// attributes per pair that are read once per tile; with 256 pixels sharing
// every pair it is bound by arithmetic (the f32 pipe and the SFU's exp), not
// by device memory. What
// kept it far from that bound was not the arithmetic but its order: a tile's
// walk is serial in T and cannot be spread over SMs, so the kernel lasts as
// long as its longest tile, whose every step waited for the previous one
// (shared-memory read, power, expf, alpha, T) and whose every batch waited
// for a synchronous gather.
// Design: one block of 256 threads per tile, one pixel per thread, a warp on
// an 8x4 pixel patch (composite_common.cuh).
//  - Tile order: block i takes tile `tile_order[i]`, the tiles by falling pair
//    count, so the longest walks start first and short tiles fill in behind.
//  - Double-buffered staging: pairs go through shared memory in batches of
//    256. Before batch k is walked, each thread copies one row of batch k+1
//    from device memory into the other buffer (three 16-byte words per pair,
//    gathered by Gaussian id; the ids are fetched one batch further ahead into
//    a register), so the copy of one warp overlaps the walk of the others.
//    One barrier per batch, which also ends the block when every pixel is done
//    (__syncthreads_count). cp.async for the copy measured no faster on the
//    H100 and is not used.
//  - Warp cull: the thread that staged a pair marks which of the tile's eight
//    warp patches its alpha >= 1/255 ellipse can reach; each warp compacts the
//    batch to the pairs that can reach its own patch and walks only those
//    (about four in ten on the gs_mesh scene). The test is conservative, so
//    no included pair is dropped (composite_common.cuh).
//  - Instruction-level parallelism: dx, dy, power, expf and alpha of kIlp
//    listed pairs do not depend on T and are evaluated together; only the
//    short chain (skip, terminate, accumulate, T) then runs over them in
//    order, as selects without branches. Each value comes from the same
//    operations in the same order as in a one-by-one walk, so the result is
//    bit-equal; evaluations past a pixel's termination are wasted, never
//    stored. A warp leaves a batch when all its pixels are done.
// No tensor core (wgmma) is used: the kernel has no matrix product, and its
// inclusion tests allow no operand rounded to fewer bits than float32.
//
// Precision: exact float32, built WITHOUT fast math and with -fmad=false,
// so every product and sum rounds as the plain PyTorch version's separate
// operations do. A contracted a*b+c can move alpha across the 1/255 cut or
// T across 1e-4 for a pair that sits on the boundary, which changes the
// included pairs (nc) and the image by a whole pair's weight.
#include "composite_common.cuh"

namespace {

using namespace gms;

constexpr int kBatch = kThreads;  // pairs staged per batch, one per thread
constexpr int kIlp = 4;            // pairs evaluated together
constexpr float kTEps = 1e-4f;

template <bool kBf16Rows>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const int* __restrict__ pair_gaussian,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end,
                     const int* __restrict__ tile_order,
                     const void* __restrict__ attrs,     // (N, 12) floats or (N, 16) bf16
                     int height, int width, int n_tiles_x,
                     float* __restrict__ out,            // (5, H, W): r, g, b, T, D
                     int* __restrict__ out_nc) {         // (H, W)
  __shared__ float4 s_attr[2][kBatch * kRow4];
  __shared__ unsigned char s_mask[2][kBatch];       // per staged pair: the warps it can reach
  __shared__ unsigned char s_list[kWarps][kBatch];  // per warp: the pairs it walks

  const int tile = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_x = (tile % n_tiles_x) * kTile;
  const int tile_y = (tile / n_tiles_x) * kTile;
  const int px = tile_x + (warp % kWarpsX) * kWarpW + lane % kWarpW;
  const int py = tile_y + (warp / kWarpsX) * kWarpH + lane / kWarpW;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  const int start = tile_start[tile];
  const int count = tile_end[tile] - start;
  const int n_batches = (count + kBatch - 1) / kBatch;

  // this thread's pair of a batch: its Gaussian id, or -1 past the range
  auto pair_id = [&](int batch) {
    const int rank = batch * kBatch + tid;
    return rank < count ? pair_gaussian[start + rank] : -1;
  };
  int g_next = pair_id(0);
  // copy this thread's row of `batch` (whose id is in g_next) into the batch's
  // buffer, then fetch the id of the batch after it
  auto stage = [&](int batch) {
    if (g_next >= 0) stage_row<kBf16Rows>(&s_attr[batch & 1][kRow4 * tid], attrs, g_next);
    g_next = pair_id(batch + 1);
  };

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int nc = 0;
  bool done = !inside;

  if (n_batches > 0) stage(0);
  for (int k = 0; k < n_batches; ++k) {
    // of the row this thread staged: which warps its pair can reach
    if (k * kBatch + tid < count) {
      s_mask[k & 1][tid] = static_cast<unsigned char>(pair_patch_mask(
          s_attr[k & 1][kRow4 * tid], s_attr[k & 1][kRow4 * tid + 1],
          static_cast<float>(tile_x), static_cast<float>(tile_y)));
    }
    // the one barrier per batch: batch k is in shared memory, and every
    // thread is through batch k-1, whose buffers the next copy overwrites
    if (__syncthreads_count(done) == kThreads) break;
    if (k + 1 < n_batches) stage(k + 1);

    if (__all_sync(kFull, done)) continue;  // this warp's pixels are done
    const float4* s = s_attr[k & 1];
    const unsigned char* list = s_list[warp];
    const int n_listed = warp_pair_list<kBatch>(
        s_mask[k & 1], min(kBatch, count - k * kBatch), warp, lane, s_list[warp]);
    for (int i0 = 0; i0 < n_listed; i0 += kIlp) {
      if (__all_sync(kFull, done)) break;
      float alpha[kIlp], one_m[kIlp], r[kIlp], g[kIlp], b[kIlp], z[kIlp];
      int rank[kIlp];
      bool hit[kIlp];
      // independent of T: all kIlp evaluations are in flight together (past
      // the list's end its last pair is evaluated again and discarded)
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const int j = list[min(i0 + i, n_listed - 1)];
        const float4 q0 = s[kRow4 * j];      // mx, my, a, b
        const float4 q1 = s[kRow4 * j + 1];  // c, op, r, g
        const float4 q2 = s[kRow4 * j + 2];  // b, z, 0, 0
        const float dx = q0.x - fx;
        const float dy = q0.y - fy;
        const float power =
            -0.5f * (q0.z * dx * dx + q1.x * dy * dy) - q0.w * dx * dy;
        alpha[i] = fminf(kAlphaMax, q1.y * expf(power));
        one_m[i] = 1.0f - alpha[i];
        hit[i] = i0 + i < n_listed && power <= 0.0f && alpha[i] >= kAlphaMin;
        rank[i] = k * kBatch + j + 1;
        r[i] = q1.z;
        g[i] = q1.w;
        b[i] = q2.x;
        z[i] = q2.y;
      }
      // the chain through T, in order
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        // without branches: every lane computes the step and keeps it or not
        const bool live = hit[i] && !done;
        const float test_T = T * one_m[i];
        const bool take = live && !(test_T < kTEps);
        const float w = T * alpha[i];
        const float nr = cr + w * r[i], ng = cg + w * g[i];
        const float nb = cb + w * b[i], nd = cd + w * z[i];
        cr = take ? nr : cr;
        cg = take ? ng : cg;
        cb = take ? nb : cb;
        cd = take ? nd : cd;
        T = take ? test_T : T;
        nc = take ? rank[i] : nc;
        done = done || (live && !take);
      }
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

template <bool kBf16Rows>
int launch(const int* pair_gaussian, const int* tile_start, const int* tile_end,
           const int* tile_order, const void* attrs, int height, int width, int n_tiles_x,
           int n_tiles, float* out, int* out_nc, void* stream) {
  if (n_tiles > 0) {
    composite_fwd_kernel<kBf16Rows><<<n_tiles, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        pair_gaussian, tile_start, tile_end, tile_order, attrs, height, width, n_tiles_x,
        out, out_nc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// attrs: (N, 12) float32 rows
extern "C" int composite_fwd(const int* pair_gaussian, const int* tile_start,
                             const int* tile_end, const int* tile_order,
                             const void* attrs, int height, int width,
                             int n_tiles_x, int n_tiles, float* out, int* out_nc,
                             void* stream) {
  return launch<false>(pair_gaussian, tile_start, tile_end, tile_order, attrs, height, width,
                       n_tiles_x, n_tiles, out, out_nc, stream);
}

// attrs: (N, 16) bfloat16 rows (the split layout)
extern "C" int composite_fwd_bf16(const int* pair_gaussian, const int* tile_start,
                                  const int* tile_end, const int* tile_order,
                                  const void* attrs, int height, int width,
                                  int n_tiles_x, int n_tiles, float* out, int* out_nc,
                                  void* stream) {
  return launch<true>(pair_gaussian, tile_start, tile_end, tile_order, attrs, height, width,
                      n_tiles_x, n_tiles, out, out_nc, stream);
}
