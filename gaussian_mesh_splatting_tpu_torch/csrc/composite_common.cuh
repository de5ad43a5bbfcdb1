// What csrc/composite_fwd.cu and csrc/composite_bwd.cu share: the block's
// shape, the staging copy of a pair's row, and the cull that gives each warp
// the list of the pairs it has to walk.
//
// Block shape: one block of 256 threads per 16x16 pixel tile, one pixel per
// thread, a warp on a kWarpW x kWarpH pixel patch (8x4: a compact patch is
// missed by a Gaussian, and finishes, together more often than a 16x2 strip).
//
// Warp cull: a tile's pair list holds every Gaussian whose bounding rectangle
// touches the tile, but a Gaussian reaches only the pixels inside its
// alpha >= 1/255 ellipse: on the 51,200-Gaussian gs_mesh scene at 800x800 some
// pixel of a warp's patch is inside it for only about four warp-pairs in ten
// (counted on the host from the kernels' own inclusion test). The thread that
// staged a pair tests it against the tile's eight patches (`pair_patch_mask`,
// one byte per pair in shared memory); before a warp walks a staged batch its
// lanes compact the indices of the pairs with the warp's bit, in order, into
// the warp's list in shared memory, and the walk takes only those. The test
// is conservative: it never drops a pair that the walk's own test (power <= 0,
// alpha >= 1/255, both as rounded by the walk) would include for some pixel of
// the patch, so the kernels' results do not change by a bit.
#pragma once
#include <cuda_runtime.h>

namespace gms {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 12;  // floats per packed row (attributes in, gradients out)
constexpr int kRow4 = kRow / 4;  // 16-byte words per row
constexpr int kWarpW = 8;  // a warp's pixel patch is kWarpW x kWarpH
constexpr int kWarpH = 32 / kWarpW;
constexpr int kWarpsX = kTile / kWarpW;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

// Copies Gaussian `g`'s packed row (three 16-byte words) from the attribute
// table into a staging buffer's row in shared memory. The three loads are in
// flight together; the double buffer lets them overlap the other warps' walk
// of the batch before. (cp.async in their place measured no faster on the
// H100: the gather's latency is already hidden behind the walk.)
__device__ __forceinline__ void stage_row(float4* dst_shared, const float4* attrs, int g) {
  const float4* src = attrs + kRow4 * g;
  const float4 q0 = src[0], q1 = src[1], q2 = src[2];
  dst_shared[0] = q0;
  dst_shared[1] = q1;
  dst_shared[2] = q2;
}

// Which of the tile's eight warp patches the Gaussian q0 = (mx, my, a, b),
// q1 = (c, op, ...) can reach: bit w is set unless no pixel of warp w's patch
// can pass the walk's inclusion test. (tile_x, tile_y) is the tile's first
// pixel. A pixel passes with power <= 0 and op exp(power) >= 1/255, i.e.
// q(dx, dy) = 0.5 (a dx^2 + c dy^2) + b dx dy <= tau = log(255 op). The least
// value of the convex q over a patch's box of (dx, dy) is 0 if the centre lies
// in the box and else the least of its minima along the four edges. tau is
// widened by 1 % + 0.01 (expf, logf) and by 1e-5 of the largest terms that the
// walk's float32 `power` sums anywhere on the tile (its rounding, and this
// function's), so a pass of the walk's test is never missed; where the conic
// is not positive definite or a number is not finite every bit is set.
__device__ __forceinline__ unsigned pair_patch_mask(const float4 q0, const float4 q1,
                                                    float tile_x, float tile_y) {
  const float a = q0.z, b = q0.w, c = q1.x, op = q1.y;
  if (op < 0.999f * kAlphaMin) return 0u;  // alpha <= op exp(power) with power <= 0
  // dx = mx - px runs over [cx - 15, cx] on the tile, dy likewise
  const float cx = q0.x - tile_x, cy = q0.y - tile_y;
  const float far_x = fmaxf(fabsf(cx), fabsf(cx - static_cast<float>(kTile - 1)));
  const float far_y = fmaxf(fabsf(cy), fabsf(cy - static_cast<float>(kTile - 1)));
  const float terms = a * far_x * far_x + c * far_y * far_y;
  if (!(a > 0.0f && c > 0.0f && a * c - b * b > 0.0f && op <= 1e30f && terms <= 1e30f)) {
    return 0xffu;
  }
  const float tau = 1.01f * logf(255.0f * op) + 0.01f + 1e-5f * terms;
  const float inv_a = 1.0f / a, inv_c = 1.0f / c;
  // least q along the edge where one coordinate is `fixed` (its conic term p)
  // and the other (conic term s, 1/s given) runs over [lo, hi]
  auto edge_min = [b](float p, float s, float inv_s, float fixed, float lo, float hi) {
    const float t = fminf(fmaxf(-b * fixed * inv_s, lo), hi);
    return 0.5f * (p * fixed * fixed + s * t * t) + b * fixed * t;
  };
  unsigned mask = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // the patch's pixel columns [x, x + kWarpW - 1] as dx, its rows as dy
    const float dx1 = cx - static_cast<float>((w % kWarpsX) * kWarpW);
    const float dx0 = dx1 - static_cast<float>(kWarpW - 1);
    const float dy1 = cy - static_cast<float>((w / kWarpsX) * kWarpH);
    const float dy0 = dy1 - static_cast<float>(kWarpH - 1);
    const bool centre_inside = dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f;
    const float q_min = fminf(
        fminf(edge_min(a, c, inv_c, dx0, dy0, dy1), edge_min(a, c, inv_c, dx1, dy0, dy1)),
        fminf(edge_min(c, a, inv_a, dy0, dx0, dx1), edge_min(c, a, inv_a, dy1, dx0, dx1)));
    mask |= (centre_inside || q_min <= tau) ? 1u << w : 0u;
  }
  return mask;
}

// The pairs of a staged batch that warp `warp` has to walk: those of index
// below `limit` whose patch mask (`masks`, one per staged pair) has the warp's
// bit, in ascending order, one byte each, in `list` (the warp's own kBatch
// bytes of shared memory). Returns their number. All 32 lanes call it; the
// list is ready for all of them on return.
template <int kBatch>
__device__ __forceinline__ int warp_pair_list(const unsigned char* masks, int limit, int warp,
                                              int lane, unsigned char* list) {
  static_assert(kBatch <= 256 && kBatch % 32 == 0, "indices are bytes, lanes take rounds");
  int n_listed = 0;
#pragma unroll
  for (int round = 0; round < kBatch / 32; ++round) {
    const int j = round * 32 + lane;
    const bool keep = j < limit && ((masks[j] >> warp) & 1u);
    const unsigned kept = __ballot_sync(kFull, keep);
    if (keep) {
      list[n_listed + __popc(kept & ((1u << lane) - 1u))] = static_cast<unsigned char>(j);
    }
    n_listed += __popc(kept);
  }
  __syncwarp();
  return n_listed;
}

}  // namespace gms
