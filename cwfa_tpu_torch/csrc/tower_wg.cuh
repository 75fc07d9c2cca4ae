// What the 64-wide tower kernels on Hopper's warpgroup tensor cores share
// (csrc/btower_wg.cu: bf16 and f32 as 3xTF32; csrc/qtower_wg.cu: int8;
// csrc/btower_bwd_wg.cu: the backward): the tile geometry, the
// shared-memory and cp.async helpers, the 3xTF32 split and products
// (csrc/cond_pair_bwd.cu takes the split), and the block's coordinates
// with its ring of weight slices.
//
// Geometry: a block computes a TH x 16 output tile from a canvas of
// (TH + 8) x 24 positions (the 4-pixel halo of the four 3x3 convs), kept as
// [16-byte channel chunk][position][16 bytes], so 8 consecutive positions of
// one chunk are one 128-byte wgmma core matrix.  The layers run on shrinking
// levels (halo 4 -> 3 -> 2 -> 1 -> 0) of that one geometry; an M tile is 64
// consecutive positions of a level's span, and a 3x3 tap is the same tile
// with its start shifted by (dy * 24 + dx) positions.
//
// The kernel's Params must hold: H, W, nslices, wp (const char*, the weight
// pack) and slice[] (int2: byte offset in the pack, bytes; in order of use).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace tower {

constexpr int kC = 64;               // tower width
constexpr int kTW = 16;              // output tile width
constexpr int kHalo = 4;
constexpr int kSW = kTW + 2 * kHalo; // canvas width, 24
constexpr int kThreads = 384;        // three warpgroups
constexpr int kRing = 4;
constexpr int kMaxSlices = 192;
constexpr int kSmemMax = 232448;

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
// Four 8 x 8 bf16 matrices from the sum fragments (a register holds row g,
// columns 2 q, 2 q + 1 of its matrix), each stored transposed: lane l gives
// the address of the 16-byte memory row l % 8 (a column of the fragment) of
// matrix l / 8.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t row_addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          row_addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// An rs product reads its A registers, and every product writes its sums,
// until wgmma's wait: these keep the compiler from treating the registers as
// free or final before that (no instruction is emitted).
__device__ __forceinline__ void keep(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- f32 as 3xTF32 (csrc/btower_wg.cu, csrc/btower_bwd_wg.cu)

// f32 -> (hi, lo): hi = v rounded to TF32 (10 mantissa bits, ties away),
// lo = v - hi, exact in f32 (the tensor cores read its top 10 mantissa bits)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// One slice (nks k-steps of 8 channels, hi parts then lo parts `lo_off`
// bytes on) times the A fragments (hi, lo) of those k-steps, added to d.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float* d, uint32_t (*hi)[4],
                                           uint32_t (*lo)[4], int nks,
                                           uint64_t dw, uint32_t slot,
                                           uint32_t lo_off) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    if (ks < nks) {
      const uint64_t bh = wg::desc_at(dw, slot + 2 * ks * N * 16);
      const uint64_t bl = wg::desc_at(dw, slot + lo_off + 2 * ks * N * 16);
      wg::wgmma_rs_tf32<N>(d, lo[ks], bh);
      wg::wgmma_rs_tf32<N>(d, hi[ks], bl);
      wg::wgmma_rs_tf32<N>(d, hi[ks], bh);
    }
}

// The A fragments of one slice from the canvas: rows pos_lo, pos_hi
// (canvas positions, already shifted by the tap) and the channel quads
// quad0 .. quad0 + 2 nks - 1, split into hi and lo.
__device__ __forceinline__ void load_frags(uint32_t (*hi)[4], uint32_t (*lo)[4],
                                           uint32_t canvas, int plane,
                                           int pos_lo, int pos_hi, int quad0,
                                           int nks, int q) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    if (ks < nks) {
      const uint32_t a = canvas + (quad0 + 2 * ks) * plane + q * 4;
      split_tf32(__uint_as_float(lds32(a + pos_lo * 16)), hi[ks][0], lo[ks][0]);
      split_tf32(__uint_as_float(lds32(a + pos_hi * 16)), hi[ks][1], lo[ks][1]);
      split_tf32(__uint_as_float(lds32(a + plane + pos_lo * 16)), hi[ks][2], lo[ks][2]);
      split_tf32(__uint_as_float(lds32(a + plane + pos_hi * 16)), hi[ks][3], lo[ks][3]);
    }
}

// Ends a slice's committed products: wait, and the operands are free again.
template <int N>
__device__ __forceinline__ void finish_3xtf32(float (&d)[N], uint32_t (*hi)[4],
                                              uint32_t (*lo)[4]) {
  wg::wait<0>();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    keep(hi[ks]);
    keep(lo[ks]);
  }
  keep(d);
}

// What every instance shares: thread coordinates, the ring of weight slices
// and the geometry of a level.
template <typename Params, int SH, int SLOT>
struct Block {
  static constexpr int P = SH * kSW;         // canvas positions
  const Params& p;
  const int tid, wgi, r_lo, q;               // r_lo: the thread's first row of an M tile
  const int r0, c0;                          // image coordinates of canvas (0, 0)
  const uint32_t ring;
  int owed = -1;                             // the slice prefetch() is to copy

  __device__ Block(const Params& p_, int th, uint32_t ring_)
      : p(p_), tid(threadIdx.x),
        // the same in every lane, and the compiler can see that: a branch on
        // it is not divergent, so wgmma inside it stays asynchronous
        wgi(__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0)),
        r_lo(((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2)),
        q(threadIdx.x & 3), r0(blockIdx.y * th - kHalo),
        c0(blockIdx.x * kTW - kHalo), ring(ring_) {}

  __device__ __forceinline__ bool inside(int pos) const {
    return (unsigned)(r0 + pos / kSW) < (unsigned)p.H &&
           (unsigned)(c0 + pos % kSW) < (unsigned)p.W;
  }
  // level L keeps rows and columns [L, S - L): positions 25 L .. P - 1 - 25 L
  static __device__ __forceinline__ int tiles(int L) {
    return (P - 50 * L + 63) >> 6;
  }
  static __device__ __forceinline__ bool valid(int L, int pos) {
    return pos <= P - 1 - 25 * L &&
           (unsigned)(pos % kSW - L) < (unsigned)(kSW - 2 * L);
  }

  __device__ __forceinline__ void load_slice(int i) const {
    if (i < p.nslices) {
      const int2 e = p.slice[i];
      const uint32_t dst = ring + (i % kRing) * SLOT;
      for (int c = tid * 16; c < e.y; c += kThreads * 16)
        cp_async16(dst + c, p.wp + e.x + c);
    }
    cp_async_commit();
  }
  // Starts the copy that the last acquire() made room for (slice i + 2 into
  // the slot that slice i - 2 has left).  Call it after issuing the slice's
  // products, so the tensor cores start first; acquire() does it otherwise.
  __device__ __forceinline__ void prefetch() {
    if (owed >= 0) load_slice(owed);
    owed = -1;
  }
  // Slice i, in its slot: waits for this thread's copies and for its wgmma
  // groups before the newest, and publishes both with the block barrier
  // (which also publishes the canvas writes made before it).
  __device__ __forceinline__ uint32_t acquire(int i) {
    prefetch();
    cp_async_wait<kRing - 3>();
    wg::wait<1>();
    wg::fence_proxy_async();
    __syncthreads();
    owed = i + kRing - 2;
    return ring + (i % kRing) * SLOT;
  }
};

}  // namespace tower
