// Backward composite of the tile rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of
// gaussian_mesh_splatting_tpu/ops/rasterize_pallas.py (launched by
// `_composite_bwd`) together with the per-pair table and the sort-plus-cumsum
// segment sum that `_get_expand_pairs` runs after it: this kernel writes
// per-GAUSSIAN gradients directly, with atomics.
//
// For every 16x16 pixel tile it re-walks the tile's depth-ordered pair range
// BACK to front, from the largest nc among its pixels (the forward kernel's
// 1-based rank of each pixel's last included pair). A pair of rank r < nc with
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
// Input: one packed row of 12 floats per Gaussian (mx, my, a, b, c, op, r, g,
// b, z, 0, 0). Output: grads (N, 12) float32, columns mx, my, a, b, c, op, r,
// g, b, z and two that stay zero (a 16-byte-aligned row for vector atomics);
// the caller zeroes it before the launch.
//
// What bounds it: per evaluated (pixel, pair) ~60 float operations with one
// expf and a 10-term sum over the tile, against 48 bytes of attributes per
// pair read once per tile and 32 bytes of per-pixel state read once; like the
// forward it is bound by arithmetic, not by device memory. What kept it far
// from that bound: a tile's walk is serial and cannot be spread over SMs, and
// every pair of every tile cost, in sequence, fifty warp shuffles, a block
// barrier and up to ten global atomics, whether or not a warp's own pixels
// reached the pair.
// Design: one block of 256 threads per tile, one pixel per thread, a warp on
// an 8x4 pixel patch (the forward's layout, composite_common.cuh).
//  - Tile order: block i takes tile `tile_order[i]`, the tiles by falling
//    pair count, so the longest walks start first.
//  - Double-buffered staging: pairs go back to front through shared memory in
//    batches of 256; before one batch is walked, each thread copies one row of
//    the next into the other buffer (three 16-byte words per pair, gathered by
//    Gaussian id; the ids are fetched one batch further ahead), so the copy of
//    one warp overlaps the walk of the others. cp.async for the copy measured
//    no faster on the H100 and is not used.
//  - Warp-local walk: between the batch's two barriers the eight warps run
//    free of each other. Each warp walks only the pairs of rank below the
//    largest nc of ITS pixels (__reduce_max_sync) that can reach its patch:
//    the thread that staged a pair marks which of the tile's eight patches its
//    alpha >= 1/255 ellipse can reach, and each warp compacts the batch to its
//    own list (the warp cull of composite_common.cuh; conservative, so no
//    included pair is dropped).
//  - Instruction-level parallelism: the listed pairs are taken kIlp at a time.
//    dx, dy, power, expf and alpha of the group do not depend on T and S and
//    are evaluated together; the chain through T and S then runs over the
//    group without branches (a pixel that did not include a pair computes the
//    step and keeps nothing of it).
//  - Shared-memory accumulation: the group's kIlp * 10 terms are summed over
//    the warp by ONE butterfly that halves the number of live values at each
//    of its five levels (kIlp = 2: 21 shuffles, where one reduction per term
//    takes 100) and leaves every total in one lane; that lane adds it to the
//    pair's row of a table in shared memory (atomicAdd on shared memory: at
//    most eight warps meet on a row). No block barrier and no global atomic
//    per pair. (One table per warp with plain adds measured slower: its 80 KB
//    leave one or two blocks an SM.)
//  - Flush once per batch: after the walk one barrier, then thread t adds pair
//    t's row into its Gaussian's row of the output with three 16-byte vector
//    atomics (atomicAdd on float4, compute capability 9.x), and only if some
//    pixel included the pair.
// No tensor core (wgmma) is used: the kernel has no matrix product, and its
// inclusion tests allow no operand rounded to fewer bits than float32.
//
// Precision: float32, built WITHOUT fast math and with -fmad=false, so the
// inclusion tests (power <= 0, alpha >= 1/255) round exactly as the forward
// kernel's did. The sums over pixels are taken in the butterfly's order, then
// by shared-memory and device-memory atomics in an order that changes from
// run to run, so the result matches the plain version to a tolerance, not bit
// for bit.
#include "composite_common.cuh"

namespace {

using namespace gms;

constexpr int kBatch = kThreads;  // pairs staged per batch, one per thread
constexpr int kIlp = 2;           // pairs evaluated together (4 needs 99 registers)
constexpr int kCols = 10;

// The block's shared memory. It is passed as dynamic shared memory although
// its size is fixed: with static arrays ptxas (CUDA 12.9) spills a register of
// this kernel, with a dynamic block it does not.
struct Shared {
  float4 attr[2][kBatch * kRow4];        // two staging buffers of packed rows
  float4 acc[kBatch * kRow4];            // per staged pair: its ten sums
  int id[2][kBatch];                     // per staged pair: its Gaussian
  int warp_nc[kWarps];
  unsigned char mask[2][kBatch];         // per staged pair: the warps it can reach
  unsigned char list[kWarps][kBatch];    // per warp: the pairs it walks
};
static_assert(sizeof(Shared) <= 48 * 1024, "fits without an opt-in to more shared memory");

// One level of the butterfly that sums N values per lane over the warp: the
// lanes whose bit D is clear keep the lower half of their values and hand the
// upper half to the partner lane (lane ^ D), the others the reverse, and each
// adds what it gets to what it keeps. `first` is the index (among the values
// the butterfly began with) of the lane's value 0, `n_real` how many of its
// values are such values and not padding.
template <int N, int D>
__device__ __forceinline__ void halve_and_add(const float (&v)[N], float (&out)[(N + 1) / 2],
                                              int lane, int& first, int& n_real) {
  constexpr int kHalf = (N + 1) / 2;
  const bool upper = lane & D;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float lo = v[i];
    const float hi = i + kHalf < N ? v[min(i + kHalf, N - 1)] : 0.0f;
    const float keep = upper ? hi : lo;
    const float send = upper ? lo : hi;
    out[i] = keep + __shfl_xor_sync(kFull, send, D);
  }
  first += upper ? kHalf : 0;
  n_real = upper ? n_real - kHalf : min(n_real, kHalf);
}

__host__ __device__ constexpr int halved(int n, int times) { return times == 0 ? n : halved((n + 1) / 2, times - 1); }

// Sums each of v[0..N-1] over the warp's 32 lanes with a butterfly that halves
// the number of live values at each of its five levels (N = 20: 10 + 5 + 3 + 2
// + 1 = 21 shuffles, where 20 separate reductions take 100). On return the
// lane holds the totals of the values first, first + 1, ..., first + n_real - 1
// in out[0..n_real-1] (n_real may be 0 or less: nothing); every value's total
// is in exactly one lane.
template <int N>
__device__ __forceinline__ void warp_sum_values(const float (&v)[N], float (&out)[halved(N, 5)],
                                                int lane, int& first, int& n_real) {
  float u1[halved(N, 1)], u2[halved(N, 2)], u3[halved(N, 3)], u4[halved(N, 4)];
  first = 0;
  n_real = N;
  halve_and_add<N, 16>(v, u1, lane, first, n_real);
  halve_and_add<halved(N, 1), 8>(u1, u2, lane, first, n_real);
  halve_and_add<halved(N, 2), 4>(u2, u3, lane, first, n_real);
  halve_and_add<halved(N, 3), 2>(u3, u4, lane, first, n_real);
  halve_and_add<halved(N, 4), 1>(u4, out, lane, first, n_real);
}

__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const int* __restrict__ pair_gaussian,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_end,
                     const int* __restrict__ tile_order,
                     const float4* __restrict__ attrs,   // (N, 12) floats
                     const float* __restrict__ t_final,  // (H, W)
                     const int* __restrict__ nc_in,      // (H, W)
                     const float* __restrict__ grad_planes,  // (5, H, W): r, g, b, T, D
                     int height, int width, int n_tiles_x,
                     float4* __restrict__ grads) {       // (N, 12) floats
  extern __shared__ float4 s_mem[];
  Shared& sh = *reinterpret_cast<Shared*>(s_mem);

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

  // the walk starts at the largest nc: of the warp's pixels for the warp, of
  // the tile's for the staging
  const int warp_nc = __reduce_max_sync(kFull, nc);
  if (lane == 0) sh.warp_nc[warp] = warp_nc;
  for (int i = tid; i < kBatch * kRow4; i += kThreads) {
    sh.acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  int tile_nc = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tile_nc = max(tile_nc, sh.warp_nc[w]);
  const int count = min(tile_end[tile] - start, tile_nc);
  const int n_batches = (count + kBatch - 1) / kBatch;

  // this thread's pair of a batch: its Gaussian id, or -1 outside the walk
  auto pair_id = [&](int batch) {
    const int rank = batch * kBatch + tid;
    return batch >= 0 && rank < count ? pair_gaussian[start + rank] : -1;
  };
  int g_next = pair_id(n_batches - 1);
  // copy this thread's row of `batch` (whose id is in g_next) into buffer
  // `buf`, then fetch the id of the batch in front of it
  auto stage = [&](int batch, int buf) {
    if (g_next >= 0) {
      stage_row(&sh.attr[buf][kRow4 * tid], attrs, g_next);
      sh.id[buf][tid] = g_next;
    }
    g_next = pair_id(batch - 1);
  };

  if (n_batches > 0) stage(n_batches - 1, 0);
  for (int step = 0; step < n_batches; ++step) {
    const int batch = n_batches - 1 - step;
    const int buf = step & 1;
    // of the row this thread staged: which warps its pair can reach
    if (batch * kBatch + tid < count) {
      sh.mask[buf][tid] = static_cast<unsigned char>(pair_patch_mask(
          sh.attr[buf][kRow4 * tid], sh.attr[buf][kRow4 * tid + 1],
          static_cast<float>(tile_x), static_cast<float>(tile_y)));
    }
    // this batch is in shared memory; every thread is through the previous
    // batch's flush, which read the buffer the next copy overwrites and
    // zeroed the accumulators
    __syncthreads();
    if (batch > 0) stage(batch - 1, buf ^ 1);

    const float4* s = sh.attr[buf];
    const unsigned char* list = sh.list[warp];
    const int rank0 = batch * kBatch;
    const int n = min(kBatch, count - rank0);
    float* const acc = reinterpret_cast<float*>(sh.acc);
    // of this batch the warp walks the pairs of rank below the largest nc of
    // its pixels, and of those the ones that may reach its patch
    const int n_listed = warp_pair_list<kBatch>(
        sh.mask[buf], min(n, warp_nc - rank0), warp, lane, sh.list[warp]);
    for (int i0 = n_listed - 1; i0 >= 0; i0 -= kIlp) {
      float G[kIlp], alpha_raw[kIlp], alpha[kIlp];
      int index[kIlp];
      bool included[kIlp];
      // independent of T and S: the kIlp evaluations are in flight together
      // (before the list's start its first pair is evaluated again and discarded)
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const int j = list[max(i0 - i, 0)];
        const float4 q0 = s[kRow4 * j];      // mx, my, a, b
        const float4 q1 = s[kRow4 * j + 1];  // c, op, r, g
        const float dx = q0.x - fx;
        const float dy = q0.y - fy;
        const float power = -0.5f * (q0.z * dx * dx + q1.x * dy * dy) - q0.w * dx * dy;
        G[i] = expf(power);
        alpha_raw[i] = q1.y * G[i];
        alpha[i] = fminf(kAlphaMax, alpha_raw[i]);
        index[i] = j;
        included[i] = i0 - i >= 0 && rank0 + j < nc && power <= 0.0f && alpha[i] >= kAlphaMin;
      }
      // the chain through T and S, back to front, without branches: every lane
      // computes every pair's step and terms and keeps them or not
      float v[kIlp * kCols];
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const int j = index[i];
        const float4 q0 = s[kRow4 * j];
        const float4 q1 = s[kRow4 * j + 1];
        const float4 q2 = s[kRow4 * j + 2];  // b, z, 0, 0
        const float a = q0.z, b = q0.w, c = q1.x;
        const float dx = q0.x - fx;
        const float dy = q0.y - fy;
        const bool inc = included[i];
        const bool unclamped = inc && alpha_raw[i] < kAlphaMax;
        // two divisions, as the plain version rounds them (one reciprocal
        // and two products would round once more)
        const float one_m = 1.0f - alpha[i];
        const float t_before = T / one_m;
        const float s_before = S / one_m;
        const float u = q1.z * gr + q1.w * gg + q2.x * gb + q2.y * gd;
        const float dalpha = t_before * u - s_before;
        // zero where the pair is not included (w) or its alpha is clamped
        // (dpow, dop), so that the terms below vanish there
        const float w = inc ? t_before * alpha[i] : 0.0f;
        const float dpow = unclamped ? dalpha * alpha_raw[i] : 0.0f;
        const float dop = unclamped ? dalpha * G[i] : 0.0f;
        S = S + w * u;
        T = inc ? t_before : T;
        float* const vi = v + i * kCols;
        vi[0] = -(a * dx + b * dy) * dpow;
        vi[1] = -(c * dy + b * dx) * dpow;
        vi[2] = -0.5f * dx * dx * dpow;
        vi[3] = -dx * dy * dpow;
        vi[4] = -0.5f * dy * dy * dpow;
        vi[5] = dop;
        vi[6] = w * gr;
        vi[7] = w * gg;
        vi[8] = w * gb;
        vi[9] = w * gd;
      }
      // the group's kIlp * 10 terms summed over the warp together; each total
      // lands in one lane, which adds it to the pair's row
      float total[halved(kIlp * kCols, 5)];
      int first, n_real;
      warp_sum_values(v, total, lane, first, n_real);
#pragma unroll
      for (int t = 0; t < halved(kIlp * kCols, 5); ++t) {
        const int value = first + t;  // pair value / kCols of the group, its column value % kCols
        if (t < n_real && total[t] != 0.0f) {
          const int j = list[max(i0 - value / kCols, 0)];
          atomicAdd(&acc[kRow * j + value % kCols], total[t]);
        }
      }
    }

    __syncthreads();
    // flush: thread t adds pair t's sums into its Gaussian's row
    if (tid < n) {
      float4* const mine = sh.acc + kRow4 * tid;
      const float4 r0 = mine[0], r1 = mine[1], r2 = mine[2];
      // nonzero only if some pixel included the pair
      if (r0.x != 0.0f || r0.y != 0.0f || r0.z != 0.0f || r0.w != 0.0f || r1.x != 0.0f ||
          r1.y != 0.0f || r1.z != 0.0f || r1.w != 0.0f || r2.x != 0.0f || r2.y != 0.0f) {
        float4* const dst = grads + kRow4 * sh.id[buf][tid];
        atomicAdd(dst, r0);
        atomicAdd(dst + 1, r1);
        atomicAdd(dst + 2, r2);
      }
      mine[0] = mine[1] = mine[2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // for the next batch
    }
  }
}

}  // namespace

extern "C" int composite_bwd(const int* pair_gaussian, const int* tile_start,
                             const int* tile_end, const int* tile_order,
                             const float* attrs, const float* t_final,
                             const int* nc, const float* grad_planes, int height,
                             int width, int n_tiles_x, int n_tiles, float* grads,
                             void* stream) {
  if (n_tiles > 0) {
    composite_bwd_kernel<<<n_tiles, kThreads, sizeof(Shared),
                           static_cast<cudaStream_t>(stream)>>>(
        pair_gaussian, tile_start, tile_end, tile_order,
        reinterpret_cast<const float4*>(attrs), t_final, nc, grad_planes, height,
        width, n_tiles_x, reinterpret_cast<float4*>(grads));
  }
  return static_cast<int>(cudaGetLastError());
}
