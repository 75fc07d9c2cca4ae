// What the 3-D pair's kernels share (csrc/cond_pair.cu: the forward;
// csrc/cond_pair_bwd.cu: the backward): the tile geometry, the offsets of
// the 27 taps in the x window, the m16n8k8 TF32 products of the f32
// tensor-core instances as 3xTF32, and the kink rule with its f32
// tap-order sum, so that the forward and the backward take PReLU's branch
// from one computation.
//
// Geometry: a block computes an 8 x 32 (H x W) tile of z over a chunk of
// depths from an x window with a 2-voxel halo, (kTH + 4) x (kTW + 4) a
// depth; y (the pre-activations) over the tile and its 1-voxel halo,
// (kTH + 2) x (kTW + 2) = 340 positions a depth, walked in 16-position
// tiles by the warps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tower_wg.cuh"                 // split_tf32

namespace cpair {

using tower::split_tf32;

constexpr int kTW = 32;                 // output tile width (W)
constexpr int kTH = 8;                  // output tile height (H)
constexpr int kThreads = kTW * kTH;     // one thread per output (h, w)
constexpr int kYW = kTW + 2, kYH = kTH + 2;
constexpr int kXW = kTW + 4, kXH = kTH + 4;
constexpr int kYCols = kYW * kYH;
constexpr int kXCols = kXW * kXH;
constexpr int kK = 32;                  // the tensor-core instances' K
constexpr int kYTiles = (kYCols + 15) / 16;     // 22 tiles of 16 positions
constexpr int kYRows = kYTiles * 16;            // 352: a plane's rows, padded
constexpr int kPStride = 356;           // floats per contribution plane:
                                        // >= kYRows and 4 (mod 32), so a
                                        // warp's stores hit 32 banks

// offset in the x window of tap t = 9 dh + 3 dw + dd (-1: a tap that pads
// 27 to 32)
__device__ __forceinline__ int tap_off(int t) {
  return t < 27 ? (t % 3) * kXCols + (t / 9) * kXW + (t / 3) % 3 : -1;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n] += a b[n] as 3xTF32 (lo * lo dropped) for four B fragments, b[n] =
// (hi of b0, b1, lo of b0, b1): each of the three products taken over the
// four sums in turn, so that no product waits on the one before it (each
// sum still adds lo hi, hi lo, hi hi in that order)
__device__ __forceinline__ void mma_3x4(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                        const uint4 (&b)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(c[n], al, b[n].x, b[n].y);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(c[n], ah, b[n].z, b[n].w);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(c[n], ah, b[n].x, b[n].y);
}

// A pre-activation this close to 0 is summed again: where pre is within
// rounding of 0, the side of 0 it lands on depends on the order of its f32
// sums, and the other side takes PReLU's other slope (in the backward, a
// jump of dpre that dx carries to 27 neighbours).  The tensor cores' sums
// truncate; near the kink pre is summed as the CUDA-core instances sum it,
// so that every instance, forward and backward, takes the same side.
constexpr uint32_t kKinkBits = 0x37800000u;     // |pre| < 2^-16, as f32 bits

__device__ __forceinline__ bool near_kink(float v) {
  return (__float_as_uint(v) & 0x7fffffffu) < kKinkBits;
}

// pre + b_a of channel ch at x-window position base, as the f32 CUDA-core
// instances sum it: the 27 products in tap order with fused multiply-adds,
// then the bias.
static __device__ __noinline__ float f32_pre_f(const float* xs, int base, const float* gwa, int ch,
                                               float bias) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 27; ++t) s = fmaf(gwa[ch * 27 + t], xs[base + tap_off(t)], s);
  return s + bias;
}

}  // namespace cpair
