// Ceiling probes for Hopper (sm_90a): a tiled GEMM, a chained on-chip GEMM
// and an FMA-rate probe.  They are the yardsticks the tower and cond-pair
// kernels are read against: what a kernel of that shape reaches on this
// card, next to the data-sheet peak.
//
// Replace the Pallas TPU kernels of the two probe scripts:
//
//   gemm_kernel   scripts/bench_int8_micro.py:182 (_pallas_gemm) and, with the
//                 int8 requant epilogue, :305 (gemm_out8): C = A (M, K) x
//                 B (K, N); int8 x int8 -> int32 sums -> int32, or
//                 clip(sum >> 7, -127, 127) -> int8; bf16 x bf16 -> f32 sums
//                 -> bf16.
//   chain_kernel  scripts/bench_int8_micro.py:255 (_chained): `depth` chained
//                 128 x 128 products on a row tile that never leaves the
//                 chip; between products int8: clip(sum >> 7, -127, 127) ->
//                 int8, bf16: max(sum, 0) -> bf16.
//   fma_kernel    scripts/probe_vpu_rate.py:24 (fma_kernel): u independent
//                 accumulators a_k = y * (0.5 + 0.01 k) per element, t times
//                 a <- fma(a, x, y) | a <- a * x | a <- roll(a, 1, axis 1) + y,
//                 output sum_k a_k, on (rows, 128) f32.
//
// Bounds.  The GEMM at the probe's shapes (M 2^20, K 1152, N 128..512) does
// 2 M K N operations on M K + K N + M N elements: 200-800 operations per
// byte, so N = 128 sits near the card's ridge (~590 int8 operations, ~295
// bf16 FLOP per byte: A alone, 2.4 GB in bf16, takes 0.72 ms to read) and
// N >= 256 is bound by the tensor cores.  The chain does 8 products per row
// tile that it reads and writes once (2048 operations per int8 byte): bound
// by the tensor cores.  The FMA probe keeps its accumulators in registers
// and touches 3 x 4 bytes per element for 2 t u FLOP: bound by the CUDA
// cores' FMA rate.
//
// Design:
//   - The older instances run on mma.sync (m16n8k32 s8, m16n8k16 bf16).
//     In bytes the two have the same fragment layout: a k-step is 32 bytes
//     of K, lane l = 4 g + q holds the 4-byte words at byte 4 q and
//     4 q + 16 of rows g and g + 8 (A) or of column g (B).  So one kernel
//     body serves both types, with K counted in bytes.  B is given
//     TRANSPOSED, (N, K) row-major (the wrapper transposes the small B
//     once), so that a B fragment is one 32-bit shared-memory load like an A
//     fragment.
//   - gemm_kernel (int8 -> int32, and the requant GEMM where gemm_s8_kernel
//     does not take the call): 128 x 128 output tile per block, 8 warps of
//     32 x 64, a 4-stage cp.async ring of 64-byte K slices of A and B^T;
//     rows are padded to 80 bytes (20 words: the 8 rows x 4 words of a
//     fragment load hit 32 distinct banks).  Rows beyond M or N are
//     zero-filled by cp.async's source size; the epilogue masks them.  K
//     bytes must be a multiple of 16 (the wrapper zero-pads K otherwise).
//     Blocks that share a row tile of A are neighbours in the grid, so A is
//     read from device memory once.
//   - gemm_wgmma_kernel (bf16): mma.sync feeds every fragment through the
//     registers and tops out near 230 TFLOP/s here; wgmma (csrc/wgmma.cuh)
//     reads both operands from shared memory.  A 128 x BN tile per block (BN
//     256, or 128 for N <= 128), two warpgroups of 64 rows x BN columns
//     (m64nBNk16, f32 sums in registers).  A slice is 128 bytes of K: one
//     row of the 128-byte swizzle, which every thread applies to the
//     16-byte chunks it copies with cp.async (chunk c of row r goes to chunk
//     c ^ (r % 8)), so neither the copies nor the tensor cores' reads
//     conflict.  A ring of 4 (BN 256) or 6 (BN 128) stages, the copies two
//     slices ahead; one block barrier per slice, before which a thread waits
//     for its own copies and for its products but the newest (wgmma's
//     wait_group 1), so the tensor cores stay busy across the barrier.  The
//     same edges as the int8 kernel.  Neither TMA nor a producer warp: every
//     thread copies, which costs instruction slots; the remaining distance to
//     cuBLAS at N >= 256 is there and in the epilogue's 4-byte stores.
//   - chain_kernel (the older instance of both types, kept for the shapes
//     the wgmma ones do not take and to time them against): 16 warps, each
//     carries its own 16 rows through all the products, so only the
//     weights need block-wide barriers.  The weights of one stage (128 x
//     128, 16 KB int8, 32 KB bf16) stream from L2 into a double buffer with
//     cp.async while the previous stage computes.  bf16: the sum fragment of
//     one stage is, packed to bf16 pairs, the A fragment of the next, and
//     never leaves the registers.  int8: the m16n8k32 A fragment needs four
//     consecutive columns that two lanes hold, so the requantized tile
//     passes through the warp's own shared-memory tile.  Every warp re-reads
//     the whole stage from shared memory, one 32-bit pair per mma:
//     shared-memory bandwidth caps it (int8 near 17% of its peak, bf16 23%
//     of its bound).
//   - chain_s8_kernel and gemm_s8_kernel (int8 on s8 wgmma, csrc/tma.cuh):
//     persistent blocks (one per SM) of consumer warpgroups, 64 rows and
//     128 columns each (m64n128k32), and one producer warp whose one thread
//     keeps TMA loads of 128-byte-wide row tiles (the 128-byte swizzle wgmma
//     reads) in flight through a ring behind full / empty mbarriers.
//     chain_s8_kernel holds all `depth` stages' weights in shared memory
//     (16 KB each, loaded once per block); x tiles of 192 rows stream
//     through the ring to three warpgroups.  Stage 0 reads x from shared
//     memory; the requantized sums of stage i, as they sit in the thread,
//     are the A registers of stage i + 1: the wrapper permutes the input
//     channels of every stage after the first (slot 4 q + e of every 16 is
//     channel 8 (e / 2) + 2 q + e % 2, as for the int8 tower), so nothing
//     crosses threads and no stage needs a barrier.  Within a warpgroup the
//     products and the requant run in series; the three warpgroups drift
//     out of step, so one's requant runs while another's products are on
//     the tensor cores, and cvt.pack.sat halves the requant's instructions
//     (forcing the warpgroups to take turns measured slower: PERF.md
//     section 6).  chain_bf16_kernel (the bf16 chain, bf16 wgmma
//     m64n128k16) has the same blocks, but eight bf16 stages (256 KB) do not
//     fit beside anything: every tile's stages stream through a ring of four
//     32 KB slots behind the x ring's two 48 KB slots, the producer loading
//     each tile's x, then its stages, in the order the consumers take them.
//     A stage loaded once serves the tile's 192 rows (all three
//     warpgroups), so ~1.4 GB of weights come from L2 at M = 2^20, depth 8,
//     against 0.54 GB of x and out from device memory.  No permutation: the
//     f32 sums of a 16-bit m64nNk16 product, packed in pairs, are the next
//     product's A registers as they sit.  The x slot, free once stage 0 has
//     read it, is the warpgroup's staging tile for its stores.
//     gemm_s8_kernel (the requant GEMM, two
//     warpgroups on 128-row tiles) keeps B^T's 128-column slice resident
//     (128 x K bytes, K <= 1408) and streams 128-byte K slices of A; a
//     block keeps its column slice and walks row tiles, so the ring already
//     holds the next tile's slices while the epilogue runs.  Both write
//     their int8 tile through a swizzled staging tile in shared memory, 16
//     bytes a store; TMA zero-fills rows >= M and K beyond the matrix, the
//     stores skip them.
//   - fma_kernel: one warp per row, a lane holds 4 consecutive columns of
//     each accumulator in registers; roll by one along the 128 columns is
//     one shuffle (the lane's last column from its left neighbour, lane 0
//     from lane 31) and a register rename.  fmaf / __fmul_rn / __fadd_rn
//     keep the compiler from contracting or reordering what is measured.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, returns cudaGetLastError().  The plain PyTorch versions are
// in cwfa_tpu_torch/ops/probes.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ void mma(int* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The int8 requant epilogue of the probes: an arithmetic shift, then a clip.
__device__ __forceinline__ int requant(int acc) {
  return max(-127, min(127, acc >> 7));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// tiled GEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128;     // output tile
constexpr int kBKB = 64;                // bytes of K per pipeline stage
constexpr int kStr = kBKB + 16;         // padded row of a stage, bytes
constexpr int kStages = 4;
constexpr int kGemmThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kStr;
constexpr int kGemmSmem = kStages * kStageBytes;

enum { kOutInt32 = 0, kOutInt8 = 1, kOutBf16 = 2 };

template <int EPI>
__device__ __forceinline__ void store_pair(void* out, size_t idx, int n_left,
                                           bool pair_ok, int v0, int v1) {
  if constexpr (EPI == kOutInt32) {
    int* o = static_cast<int*>(out) + idx;
    if (pair_ok && n_left > 1) {
      *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
    } else {
      o[0] = v0;
      if (n_left > 1) o[1] = v1;
    }
  } else {
    int8_t* o = static_cast<int8_t*>(out) + idx;
    const int8_t q0 = (int8_t)requant(v0), q1 = (int8_t)requant(v1);
    if (pair_ok && n_left > 1) {
      *reinterpret_cast<char2*>(o) = make_char2(q0, q1);
    } else {
      o[0] = q0;
      if (n_left > 1) o[1] = q1;
    }
  }
}

template <int EPI>
__device__ __forceinline__ void store_pair(void* out, size_t idx, int n_left,
                                           bool pair_ok, float v0, float v1) {
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + idx;
  if (pair_ok && n_left > 1) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    o[0] = __float2bfloat16_rn(v0);
    if (n_left > 1) o[1] = __float2bfloat16_rn(v1);
  }
}

// a: (M, kb) bytes, bt: (N, kb) bytes (B transposed), kb % 16 == 0.
template <typename Acc, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
                void* __restrict__ out, int64_t M, int N, int kb, int ntn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int64_t m0 = (int64_t)(blockIdx.x / ntn) * kBM;
  const int n0 = (blockIdx.x % ntn) * kBN;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int nk = (kb + kBKB - 1) / kBKB;

  auto load = [&](int stage, int kt) {
    unsigned char* as = smem + stage * kStageBytes;
    unsigned char* bs = as + kBM * kStr;
    const int kb0 = kt * kBKB;
#pragma unroll
    for (int i = 0; i < (kBM * kBKB / 16) / kGemmThreads; ++i) {
      const int c = tid + i * kGemmThreads;
      const int row = c >> 2, col = (c & 3) * 16;
      const bool k_ok = kb0 + col < kb;
      const bool a_ok = k_ok && m0 + row < M;
      const bool b_ok = k_ok && n0 + row < N;
      cp_async16(as + row * kStr + col,
                 a_ok ? a + (size_t)(m0 + row) * kb + kb0 + col : a,
                 a_ok ? 16 : 0);
      cp_async16(bs + row * kStr + col,
                 b_ok ? bt + (size_t)(n0 + row) * kb + kb0 + col : bt,
                 b_ok ? 16 : 0);
    }
  };

  Acc acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // slice kt has landed
    __syncthreads();                // ... for every thread; slice kt-1 is free
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const unsigned char* as = smem + (kt % kStages) * kStageBytes;
    const unsigned char* bs = as + kBM * kStr;
#pragma unroll
    for (int ks = 0; ks < kBKB / 32; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned char* p = as + (wm + mt * 16 + g) * kStr + ks * 32 + q * 4;
        af[mt][0] = lds32(p);
        af[mt][1] = lds32(p + 8 * kStr);
        af[mt][2] = lds32(p + 16);
        af[mt][3] = lds32(p + 8 * kStr + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const unsigned char* p = bs + (wn + nt * 8 + g) * kStr + ks * 32 + q * 4;
        const uint32_t b0 = lds32(p), b1 = lds32(p + 16);
        mma(acc[0][nt], af[0], b0, b1);
        mma(acc[1][nt], af[1], b0, b1);
      }
    }
  }

  const bool pair_ok = (N & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + mt * 16 + g + h * 8;
        const int col = n0 + wn + nt * 8 + q * 2;
        if (row < M && col < N)
          store_pair<EPI>(out, (size_t)row * N + col, N - col, pair_ok,
                          acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

template <typename Acc, int EPI>
int launch_gemm(const void* a, const void* bt, void* out, int64_t m, int n,
                int kb, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<Acc, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  const int ntn = (n + kBN - 1) / kBN;
  const int64_t blocks = (m + kBM - 1) / kBM * ntn;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gemm_kernel<Acc, EPI><<<(unsigned)blocks, kGemmThreads, kGemmSmem, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt), out, m,
      n, kb, ntn);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tiled GEMM, bf16, on wgmma
// ---------------------------------------------------------------------------

constexpr int kWRow = 128;              // bytes of K per slice: one swizzled row
constexpr int kWSmemMax = 232448 - 1024;   // the tile base is aligned up

constexpr int kWBM = 128;               // two warpgroups of 64 rows
constexpr int kWThreads = 256;
constexpr int kWPass = kWThreads / 8;   // rows a pass of copies covers

template <int BN>
struct WGemm {
  static constexpr int kStage = (kWBM + BN) * kWRow;
  static constexpr int kFit = kWSmemMax / kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kSmem = kStages * kStage + 1024;
};

// a: (M, kb) bytes, bt: (N, kb) bytes (B transposed), bf16, kb % 16 == 0.
// A 128 x BN tile per block; warpgroup w owns rows 64 w .. 64 w + 63 and all
// BN columns (BN / 2 sums per thread).
template <int BN>
__global__ void __launch_bounds__(kWThreads, 1)
    gemm_wgmma_kernel(const uint8_t* __restrict__ a,
                      const uint8_t* __restrict__ bt, void* __restrict__ out,
                      int64_t M, int N, int kb, int ntn) {
  using G = WGemm<BN>;
  constexpr int S = G::kStages, BM = kWBM, PASS = kWPass;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sbase =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int64_t m0 = (int64_t)(blockIdx.x / ntn) * BM;
  const int n0 = (blockIdx.x % ntn) * BN;
  const int nk = (kb + kWRow - 1) / kWRow;

  // a thread copies chunk `ch` (16 bytes) of rows r0 + PASS i of A and B^T
  const int ch = tid & 7, r0 = tid >> 3;
  const uint32_t sw = (uint32_t)((ch ^ (r0 & 7)) << 4);   // PASS % 8 == 0
  auto load = [&](int stage, int kt) {
    const uint32_t as = sbase + stage * G::kStage;
    const uint32_t bs = as + BM * kWRow;
    const int koff = kt * kWRow + ch * 16;
    const bool k_ok = koff < kb;
#pragma unroll
    for (int i = 0; i < BM / PASS; ++i) {
      const int row = r0 + PASS * i;
      const bool ok = k_ok && m0 + row < M;
      const uint8_t* src = ok ? a + (size_t)(m0 + row) * kb + koff : a;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       as + row * kWRow + sw),
                   "l"(src), "r"(ok ? 16 : 0)
                   : "memory");
    }
#pragma unroll
    for (int i = 0; i < BN / PASS; ++i) {
      const int row = r0 + PASS * i;
      const bool ok = k_ok && n0 + row < N;
      const uint8_t* src = ok ? bt + (size_t)(n0 + row) * kb + koff : bt;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       bs + row * kWRow + sw),
                   "l"(src), "r"(ok ? 16 : 0)
                   : "memory");
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // Slice kt + S - 2 is copied while slices kt - 1 (its products may still
  // run) and kt are in use: it goes to the stage of slice kt - 2.
  for (int s = 0; s < S - 2; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  const uint64_t dbase = wg::desc_base(0, 1024, wg::kSwizzle128);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 3>();         // this thread's part of slice kt is in
    wg::wait<1>();                  // its products on slice kt - 2 are done
    wg::fence_proxy_async();
    __syncthreads();
    if (kt + S - 2 < nk) load((kt + S - 2) % S, kt + S - 2);
    cp_async_commit();
    const uint32_t as = sbase + (kt % S) * G::kStage + wgi * 64 * kWRow;
    const uint32_t bs = sbase + (kt % S) * G::kStage + BM * kWRow;
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kWRow / 32; ++ks)
      wg::wgmma_ss_bf16<BN>(acc, wg::desc_at(dbase, as + ks * 32),
                            wg::desc_at(dbase, bs + ks * 32));
    wg::commit();
  }
  wg::wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool pair_ok = (N & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + wgi * 64 + warp * 16 + g + h * 8;
      const int col = n0 + nt * 8 + q * 2;
      if (row < M && col < N)
        store_pair<kOutBf16>(out, (size_t)row * N + col, N - col, pair_ok,
                             acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
    }
}

template <int BN>
int launch_gemm_wgmma(const void* a, const void* bt, void* out, int64_t m,
                      int n, int kb, cudaStream_t s) {
  using G = WGemm<BN>;
  constexpr int BM = kWBM;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int ntn = (n + BN - 1) / BN;
  const int64_t blocks = (m + BM - 1) / BM * ntn;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gemm_wgmma_kernel<BN><<<(unsigned)blocks, kWThreads, G::kSmem, s>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt), out, m,
      n, kb, ntn);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// chained GEMM
// ---------------------------------------------------------------------------

constexpr int kC = 128;                 // width of every product
constexpr int kChainWarps = 16;
constexpr int kChainThreads = kChainWarps * 32;
constexpr int kChainBM = kChainWarps * 16;

template <bool BF16>
struct Chain {
  using Acc = typename std::conditional<BF16, float, int>::type;
  static constexpr int kRowB = kC * (BF16 ? 2 : 1);   // bytes of one row
  static constexpr int kTStr = kRowB + 16;            // padded, 4 (mod 32) words
  static constexpr int kKS = kRowB / 32;              // k-steps per product
  static constexpr int kSmem = (2 * kC + kChainWarps * 16) * kTStr;
};

// x, out: (M, 128); wt: (depth, 128, 128), each stage TRANSPOSED (N, K).
template <bool BF16>
__global__ void __launch_bounds__(kChainThreads, 1)
    chain_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ wt,
                 uint8_t* __restrict__ out, int64_t M, int depth) {
  using T = Chain<BF16>;
  using Acc = typename T::Acc;
  constexpr int RowB = T::kRowB, TStr = T::kTStr, KS = T::kKS;
  constexpr int RowChunks = RowB / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  unsigned char* wbuf = smem;
  unsigned char* ytile = smem + 2 * kC * TStr + warp * 16 * TStr;
  const int64_t row0 = (int64_t)blockIdx.x * kChainBM + warp * 16;

  auto load_w = [&](int buf, int stage) {
    const uint8_t* src = wt + (size_t)stage * kC * RowB;
    unsigned char* dst = wbuf + buf * kC * TStr;
    for (int c = tid; c < kC * RowChunks; c += kChainThreads) {
      const int r = c / RowChunks, col = (c % RowChunks) * 16;
      cp_async16(dst + r * TStr + col, src + r * RowB + col, 16);
    }
  };
  load_w(0, 0);
  cp_async_commit();

  // the warp's 16 rows of x into its own tile (zeros beyond M)
  for (int c = lane; c < 16 * RowChunks; c += 32) {
    const int r = c / RowChunks, col = (c % RowChunks) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (row0 + r < M)
      v = __ldg(reinterpret_cast<const int4*>(x + (size_t)(row0 + r) * RowB + col));
    *reinterpret_cast<int4*>(ytile + r * TStr + col) = v;
  }
  __syncwarp();

  auto load_a = [&](uint32_t* af, int ks) {
    const unsigned char* p = ytile + g * TStr + ks * 32 + q * 4;
    af[0] = lds32(p);
    af[1] = lds32(p + 8 * TStr);
    af[2] = lds32(p + 16);
    af[3] = lds32(p + 8 * TStr + 16);
  };

  uint32_t afrag[KS][4];   // bf16: y as A fragments, carried across stages
  if constexpr (BF16) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_a(afrag[ks], ks);
  }

  for (int i = 0; i < depth; ++i) {
    if (i + 1 < depth) {
      load_w((i + 1) & 1, i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                 // stage i's weights are in for everyone
    const unsigned char* ws = wbuf + (i & 1) * kC * TStr;
    Acc acc[kC / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[4];
      if constexpr (BF16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = afrag[ks][e];
      } else {
        load_a(af, ks);
      }
#pragma unroll
      for (int nt = 0; nt < kC / 8; ++nt) {
        const unsigned char* p = ws + (nt * 8 + g) * TStr + ks * 32 + q * 4;
        mma(acc[nt], af, lds32(p), lds32(p + 16));
      }
    }
    if constexpr (BF16) {
      // sum fragments of n-tiles 2s, 2s+1 -> A fragment of k-step s
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        afrag[s][0] = pack_bf16(fmaxf(acc[2 * s][0], 0.f), fmaxf(acc[2 * s][1], 0.f));
        afrag[s][1] = pack_bf16(fmaxf(acc[2 * s][2], 0.f), fmaxf(acc[2 * s][3], 0.f));
        afrag[s][2] = pack_bf16(fmaxf(acc[2 * s + 1][0], 0.f), fmaxf(acc[2 * s + 1][1], 0.f));
        afrag[s][3] = pack_bf16(fmaxf(acc[2 * s + 1][2], 0.f), fmaxf(acc[2 * s + 1][3], 0.f));
      }
    } else {
      __syncwarp();                  // every lane has read this stage's y
#pragma unroll
      for (int nt = 0; nt < kC / 8; ++nt) {
        unsigned char* p = ytile + g * TStr + nt * 8 + q * 2;
        *reinterpret_cast<char2*>(p) =
            make_char2((signed char)requant(acc[nt][0]), (signed char)requant(acc[nt][1]));
        *reinterpret_cast<char2*>(p + 8 * TStr) =
            make_char2((signed char)requant(acc[nt][2]), (signed char)requant(acc[nt][3]));
      }
      __syncwarp();
    }
    __syncthreads();                 // buffer i & 1 is free for stage i + 2
  }

  if constexpr (BF16) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned char* p = ytile + g * TStr + ks * 32 + q * 4;
      *reinterpret_cast<uint32_t*>(p) = afrag[ks][0];
      *reinterpret_cast<uint32_t*>(p + 8 * TStr) = afrag[ks][1];
      *reinterpret_cast<uint32_t*>(p + 16) = afrag[ks][2];
      *reinterpret_cast<uint32_t*>(p + 8 * TStr + 16) = afrag[ks][3];
    }
    __syncwarp();
  }
  for (int c = lane; c < 16 * RowChunks; c += 32) {
    const int r = c / RowChunks, col = (c % RowChunks) * 16;
    if (row0 + r < M)
      *reinterpret_cast<int4*>(out + (size_t)(row0 + r) * RowB + col) =
          *reinterpret_cast<const int4*>(ytile + r * TStr + col);
  }
}

template <bool BF16>
int launch_chain(const void* x, const void* wt, void* out, int64_t m, int depth,
                 cudaStream_t s) {
  constexpr int smem = Chain<BF16>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (m + kChainBM - 1) / kChainBM;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  chain_kernel<BF16><<<(unsigned)blocks, kChainThreads, smem, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(wt),
      static_cast<uint8_t*>(out), m, depth);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 on s8 wgmma, fed by TMA: the requant GEMM and the chain
// ---------------------------------------------------------------------------

constexpr int kTile = 128 * 128;        // a 128-row x 128-byte tile, swizzled
constexpr int kHalf = 64 * 128;         // a consumer warpgroup's 64 rows of it

// Threads of a block with NC consumer warpgroups and the producer warp;
// its thread 128 NC issues every TMA load.
constexpr int tma_threads(int nc) { return 128 * nc + 32; }

// Shared memory: [nres resident tiles][ring slots of `slot` bytes][a
// 64-row staging tile per consumer warpgroup][barriers: full[ring],
// empty[ring], resident], every tile 1024-byte aligned.  The ring and the
// grid come from the caller's plan (ops/probes.py gemm_plan, chain_plan, which
// lays shared memory out the same way); the launch only checks them.
constexpr int tma_smem(int nres, int ring, int slot, int nc) {
  return 1024 + nres * kTile + ring * slot + nc * kHalf + 8 * (2 * ring + 1);
}

// cudaSuccess when `smem` bytes fit a block of this device, a grid of
// `grid` blocks is positive and a ring has at least two slots.
int check_tma_launch(int device, int smem, int64_t grid, int ring) {
  int most = 0;
  const int err = (int)cudaDeviceGetAttribute(
      &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != 0) return err;
  return smem <= most && grid >= 1 && grid <= 2147483647LL && ring >= 2
             ? (int)cudaSuccess
             : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"((uint16_t)v)
               : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
// wgmma writes the sums, and an rs product reads its A registers, until
// wgmma's wait: these keep the compiler from taking them as final or free
// before it (no instruction is emitted).
__device__ __forceinline__ void keep(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

// The requant epilogue packed: (c << 16) | q(hi) << 8 | q(lo), q(v) =
// clip(v >> 7, -127, 127).  The lower clip goes before the shift (v >> 7 >=
// -127 exactly when v >= -16256), the upper is the saturation of the pack
// (cvt.pack.sat clips to -128..127): two instructions a value and one per
// pair where requant() and a byte permute take four.
__device__ __forceinline__ uint32_t requant2(int hi, int lo, uint32_t c) {
  uint32_t d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(max(hi, -16256) >> 7), "r"(max(lo, -16256) >> 7), "r"(c));
  return d;
}
// four requantized values, the first in the lowest byte
__device__ __forceinline__ uint32_t requant4(int a, int b, int c, int d) {
  return requant2(b, a, requant2(d, c, 0u));
}

// The barriers and the thread's place, which both kernels share.
template <int NC>
struct TmaBlock {
  uint32_t full0, empty0, res;          // mbarrier addresses
  int ring, tid, wgi;

  __device__ TmaBlock(uint32_t bars, int ring_) : ring(ring_) {
    full0 = bars;
    empty0 = bars + 8 * ring;
    res = bars + 16 * ring;
    tid = threadIdx.x;
    // the same in every lane, and the compiler can see that: a branch on it
    // is not divergent, so wgmma inside it stays asynchronous
    wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
    if (tid == 0) {
      for (int s = 0; s < ring; ++s) {
        tma::mbar_init(full0 + 8 * s, 1);
        tma::mbar_init(empty0 + 8 * s, 4 * NC);   // lane 0 of each consumer warp
      }
      tma::mbar_init(res, 1);
      tma::fence_barrier_init();
    }
    __syncthreads();
  }
  __device__ __forceinline__ bool producer() const { return wgi == NC; }
  __device__ __forceinline__ bool issues() const { return tid == 128 * NC; }
  __device__ __forceinline__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return empty0 + 8 * s; }
  // the ring slot of the it-th tile a thread takes, and its phase's parity
  __device__ __forceinline__ int slot(int it) const { return it % ring; }
  __device__ __forceinline__ uint32_t parity(int it) const {
    return (uint32_t)(it / ring) & 1u;
  }
};

// The requantized sums of a warpgroup's 64 x 128 tile (t: the thread's
// index in it) to rows row0.. and columns col0.. of the (M, N) int8 out:
// into the warpgroup's staging tile (128-byte rows, chunk c of row r at
// c ^ (r % 8): the 2-byte writes of a warp hit 32 banks), then 16 bytes a
// store (vec: N % 16 == 0 and out 16-byte aligned), each row of the tile
// 8 neighbouring threads.
__device__ __forceinline__ void store_tile(const int32_t (&acc)[64],
                                           uint32_t stg, int8_t* out,
                                           int64_t row0, int64_t M, int col0,
                                           int N, bool vec, int t, int bar) {
  const int w = t >> 5, g = (t & 31) >> 2, q = t & 3;
  tma::bar_sync<128>(bar);              // the last tile's reads are done
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + g + 8 * h, c = 8 * j + 2 * q;
      sts16(stg + r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15),
            requant2(acc[4 * j + 2 * h + 1], acc[4 * j + 2 * h], 0u));
    }
  tma::bar_sync<128>(bar);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = t + 128 * i, r = idx >> 3, ch = idx & 7;
    const int64_t row = row0 + r;
    const int col = col0 + 16 * ch;
    if (row >= M || col >= N) continue;
    const uint4 v = lds128(stg + r * 128 + ((ch ^ (r & 7)) << 4));
    int8_t* o = out + row * N + col;
    if (vec) {
      *reinterpret_cast<uint4*>(o) = v;
    } else {
      const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (col + b < N) o[b] = (int8_t)(wv[b >> 2] >> (8 * (b & 3)));
    }
  }
}

struct GemmS8 {
  int64_t M;
  int N, nk, ring, ntn;    // K slices (resident), ring tiles, column slices
  int vec;
};

// clip((A B) >> 7, -127, 127): A (M, kb) int8 through map ma, B^T (N, kb)
// through mb, out (M, N) int8.  Block b keeps column slice b % ntn of B^T
// resident and takes row tiles b / ntn, b / ntn + gridDim.x / ntn, ...
// Two consumer warpgroups, 64 rows of a 128-row tile each.
__global__ void __launch_bounds__(tma_threads(2), 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb,
                   int8_t* __restrict__ out, const GemmS8 p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t bres =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = bres + p.nk * kTile, stg = ring + p.ring * kTile;
  const TmaBlock<2> B(stg + 2 * kHalf, p.ring);
  const int n0 = (blockIdx.x % p.ntn) * 128;
  const int64_t mtiles = (p.M + 127) / 128;
  const int64_t mt0 = blockIdx.x / p.ntn, mstep = gridDim.x / p.ntn;

  if (B.producer()) {
    if (B.issues()) {
      tma::mbar_expect(B.res, p.nk * kTile);
      for (int s = 0; s < p.nk; ++s)
        tma::load_2d(bres + s * kTile, &mb, 128 * s, n0, B.res);
      int it = 0;
      for (int64_t mt = mt0; mt < mtiles; mt += mstep)
        for (int s = 0; s < p.nk; ++s, ++it) {
          const int sl = B.slot(it);
          tma::mbar_wait(B.empty(sl), B.parity(it) ^ 1u);
          tma::mbar_expect(B.full(sl), kTile);
          tma::load_2d(ring + sl * kTile, &ma, 128 * s, (int)(mt * 128),
                       B.full(sl));
        }
    }
    return;
  }

  const uint64_t dsw = wg::desc_base(0, 1024, wg::kSwizzle128);
  const int lane = B.tid & 31;
  int32_t acc[64];
  tma::mbar_wait(B.res, 0);
  int it = 0;
  for (int64_t mt = mt0; mt < mtiles; mt += mstep) {
    for (int s = 0; s < p.nk; ++s, ++it) {
      const int sl = B.slot(it);
      tma::mbar_wait(B.full(sl), B.parity(it));
      const uint32_t a = ring + sl * kTile + B.wgi * kHalf;
      const uint32_t b = bres + s * kTile;
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wg::wgmma_ss_s8<128>(acc, wg::desc_at(dsw, a + 32 * ks),
                             wg::desc_at(dsw, b + 32 * ks), s > 0 || ks > 0);
      wg::commit();
      wg::wait<0>();
      keep(acc);
      if (lane == 0) tma::mbar_arrive(B.empty(sl));
    }
    store_tile(acc, stg + B.wgi * kHalf, out, mt * 128 + B.wgi * 64, p.M, n0,
               p.N, p.vec, B.tid & 127, 1 + B.wgi);
  }
}

// The chain: x (M, 128) int8 through map mx (boxes of 192 rows), the depth
// stages' weights through mw (depth * 128 rows of 128 bytes: stage i's
// B^T, its input channels permuted for i >= 1), out (M, 128) int8.  Three
// consumer warpgroups, 64 rows of a 192-row tile each; they drift out of
// step, so one's epilogue runs while another's products are on the tensor
// cores.
constexpr int kChainWGs = 3;
constexpr int kChainRows = 64 * kChainWGs, kChainSlot = kChainWGs * kHalf;

__global__ void __launch_bounds__(tma_threads(kChainWGs), 1)
    chain_s8_kernel(const __grid_constant__ CUtensorMap mx,
                    const __grid_constant__ CUtensorMap mw,
                    int8_t* __restrict__ out, const int64_t M,
                    const int depth, const int nring) {
  constexpr int NC = kChainWGs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t wres =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = wres + depth * kTile, stg = ring + nring * kChainSlot;
  const TmaBlock<NC> B(stg + NC * kHalf, nring);
  const int64_t ntiles = (M + kChainRows - 1) / kChainRows;

  if (B.producer()) {
    if (B.issues()) {
      tma::mbar_expect(B.res, depth * kTile);
      for (int i = 0; i < depth; ++i)
        tma::load_2d(wres + i * kTile, &mw, 0, 128 * i, B.res);
      int it = 0;
      for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
        const int sl = B.slot(it);
        tma::mbar_wait(B.empty(sl), B.parity(it) ^ 1u);
        tma::mbar_expect(B.full(sl), kChainSlot);
        tma::load_2d(ring + sl * kChainSlot, &mx, 0, (int)(t * kChainRows),
                     B.full(sl));
      }
    }
    return;
  }

  const uint64_t dsw = wg::desc_base(0, 1024, wg::kSwizzle128);
  const int lane = B.tid & 31;
  int32_t acc[64];
  uint32_t af[4][4];
  tma::mbar_wait(B.res, 0);
  int it = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int sl = B.slot(it);
    tma::mbar_wait(B.full(sl), B.parity(it));
    const uint32_t xa = ring + sl * kChainSlot + B.wgi * kHalf;
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wg::wgmma_ss_s8<128>(acc, wg::desc_at(dsw, xa + 32 * ks),
                           wg::desc_at(dsw, wres + 32 * ks), ks > 0);
    wg::commit();
    wg::wait<0>();
    keep(acc);
    if (lane == 0) tma::mbar_arrive(B.empty(sl));   // x is in the sums now
#pragma unroll 1
    for (int i = 1; i < depth; ++i) {
      // requantize: register 2 r + h of k-step ks holds, for row g + 8 h,
      // slots 16 r + 4 q .. + 3 of its 32, the columns of n-tiles
      // jn = 4 ks + 2 r and jn + 1 that this thread's sums hold
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int32_t* a = acc + 4 * (4 * ks + 2 * r);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            af[ks][2 * r + h] = requant4(a[2 * h], a[2 * h + 1], a[4 + 2 * h],
                                         a[5 + 2 * h]);
        }
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wg::wgmma_rs_s8<128>(acc, af[ks],
                             wg::desc_at(dsw, wres + i * kTile + 32 * ks),
                             ks > 0);
      wg::commit();
      wg::wait<0>();
      keep(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) keep(af[ks]);
    }
    store_tile(acc, stg + B.wgi * kHalf, out, t * kChainRows + B.wgi * 64, M,
               0, 128, true, B.tid & 127, 1 + B.wgi);
  }
}

// ---------------------------------------------------------------------------
// the bf16 chain on bf16 wgmma, fed by TMA
// ---------------------------------------------------------------------------

// A tile of 64 kChainWGs rows of bf16 x: two K halves (128 bytes of each
// row), each kChainWGs 64-row parts of 8 KB; a stage's weights: two K halves
// of 128 rows of B^T.  The x ring's slots are also the warpgroups' staging
// tiles for the stores.
constexpr int kBXSlot = 2 * kChainSlot, kBWSlot = 2 * kTile;
constexpr int kBXRing = 2;

// Shared memory: [x ring][weight ring][barriers: x full, x empty, weight
// full, weight empty], the tiles 1024-byte aligned (ops/probes.py
// chain_plan lays it out the same way).
constexpr int bf16_chain_smem(int wring) {
  return 1024 + kBXRing * kBXSlot + wring * kBWSlot + 16 * (kBXRing + wring);
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void keep(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The chain in bf16: x (M, 128) through map mx (boxes of 192 rows x 128
// bytes), the depth stages' B^T through mw (depth * 128 rows of 256 bytes,
// unpermuted), out (M, 128), all bf16.  Three consumer warpgroups, 64 rows
// of a 192-row tile each, and the producer warp, which streams every
// tile's x and then its depth stages' weights through two rings in the
// order the consumers take them.
__global__ void __launch_bounds__(tma_threads(kChainWGs), 1)
    chain_bf16_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mw,
                      uint8_t* __restrict__ out, const int64_t M,
                      const int depth, const int wring) {
  constexpr int NC = kChainWGs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t xring =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t wr = xring + kBXRing * kBXSlot;
  const uint32_t xfull = wr + wring * kBWSlot, xempty = xfull + 8 * kBXRing;
  const uint32_t wfull = xempty + 8 * kBXRing, wempty = wfull + 8 * wring;
  const int tid = threadIdx.x;
  // the same in every lane, so that wgmma is not in a divergent branch
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (tid == 0) {
    for (int s = 0; s < kBXRing; ++s) {
      tma::mbar_init(xfull + 8 * s, 1);
      tma::mbar_init(xempty + 8 * s, 4 * NC);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < wring; ++s) {
      tma::mbar_init(wfull + 8 * s, 1);
      tma::mbar_init(wempty + 8 * s, 4 * NC);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();
  const int64_t ntiles = (M + kChainRows - 1) / kChainRows;

  if (wgi == NC) {
    if (tid == 128 * NC) {
      int wi = 0;
      int xi = 0;
      for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++xi) {
        const int xs = xi % kBXRing;
        const uint32_t xd = xring + xs * kBXSlot;
        tma::mbar_wait(xempty + 8 * xs, ((uint32_t)(xi / kBXRing) & 1u) ^ 1u);
        tma::mbar_expect(xfull + 8 * xs, kBXSlot);
        tma::load_2d(xd, &mx, 0, (int)(t * kChainRows), xfull + 8 * xs);
        tma::load_2d(xd + kChainSlot, &mx, 128, (int)(t * kChainRows), xfull + 8 * xs);
        for (int i = 0; i < depth; ++i, ++wi) {
          const int ws = wi % wring;
          const uint32_t wd = wr + ws * kBWSlot;
          tma::mbar_wait(wempty + 8 * ws, ((uint32_t)(wi / wring) & 1u) ^ 1u);
          tma::mbar_expect(wfull + 8 * ws, kBWSlot);
          tma::load_2d(wd, &mw, 0, 128 * i, wfull + 8 * ws);
          tma::load_2d(wd + kTile, &mw, 128, 128 * i, wfull + 8 * ws);
        }
      }
    }
    return;
  }

  const uint64_t dsw = wg::desc_base(0, 1024, wg::kSwizzle128);
  const int t128 = tid & 127, lane = tid & 31;
  const int warp = t128 >> 5, g = lane >> 2, q = lane & 3;
  float acc[64];
  uint32_t af[8][4];
  int wi = 0;
  int xi = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++xi) {
    const int xs = xi % kBXRing;
    // this warpgroup's 64 rows: K half 0 at xa, K half 1 at xa + kChainSlot
    const uint32_t xa = xring + xs * kBXSlot + wgi * kHalf;
    tma::mbar_wait(xfull + 8 * xs, (uint32_t)(xi / kBXRing) & 1u);
#pragma unroll 1
    for (int i = 0; i < depth; ++i, ++wi) {
      if (i > 0) {
        // relu, bf16: the sums of n-tiles 2 ks, 2 ks + 1, packed in pairs,
        // are the A registers of k-step ks (rows g, g + 8; k = 16 ks + 2 q,
        // + 1 and + 8, + 9), as they sit in the thread
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* a = acc + 4 * (2 * ks + (r >> 1)) + 2 * (r & 1);
            af[ks][r] = pack_bf16(fmaxf(a[0], 0.f), fmaxf(a[1], 0.f));
          }
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      const int ws = wi % wring;
      const uint32_t wb = wr + ws * kBWSlot;
      tma::mbar_wait(wfull + 8 * ws, (uint32_t)(wi / wring) & 1u);
      wg::fence();
      if (i == 0) {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          wg::wgmma_ss_bf16<128>(
              acc, wg::desc_at(dsw, xa + (ks >> 2) * kChainSlot + 32 * (ks & 3)),
              wg::desc_at(dsw, wb + (ks >> 2) * kTile + 32 * (ks & 3)));
      } else {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          wg::wgmma_rs_bf16<128>(
              acc, af[ks], wg::desc_at(dsw, wb + (ks >> 2) * kTile + 32 * (ks & 3)));
      }
      wg::commit();
      wg::wait<0>();
      keep(acc);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) keep(af[ks]);
      if (lane == 0) tma::mbar_arrive(wempty + 8 * ws);
    }
    // relu, bf16 into the warpgroup's part of its x slot (x was read by
    // stage 0): 128-byte rows of each K half, chunk c of row r at c ^ (r %
    // 8), then 16 bytes a store, rows >= M skipped
    tma::bar_sync<128>(1 + wgi);        // every warp is past stage 0
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        sts32(xa + (j >> 3) * kChainSlot + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * q,
              pack_bf16(fmaxf(acc[4 * j + 2 * h], 0.f), fmaxf(acc[4 * j + 2 * h + 1], 0.f)));
      }
    tma::bar_sync<128>(1 + wgi);
    const int64_t row0 = t * kChainRows + wgi * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = t128 + 128 * i, r = idx >> 4, ch = idx & 15;
      if (row0 + r >= M) continue;
      const uint4 v = lds128(xa + (ch >> 3) * kChainSlot + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(out + (row0 + r) * 256 + 16 * ch) = v;
    }
    // the slot's generic reads and writes before TMA writes it again
    wg::fence_proxy_async();
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(xempty + 8 * xs);
  }
}

int launch_gemm_s8(const void* a, const void* bt, void* out, int64_t m, int n,
                   int kb, int ring, int grid, int device, cudaStream_t s) {
  GemmS8 p;
  p.M = m;
  p.N = n;
  p.nk = (kb + 127) / 128;
  p.ring = ring;
  p.ntn = (n + 127) / 128;
  p.vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int smem = tma_smem(p.nk, p.ring, kTile, 2);
  int err = check_tma_launch(device, smem, grid, ring);
  if (err == 0 && (grid % p.ntn || reinterpret_cast<uintptr_t>(a) % 16 ||
                   reinterpret_cast<uintptr_t>(bt) % 16))
    err = (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (err == 0) err = tma::map_2d(&ma, a, m, kb, 128);
  if (err == 0) err = tma::map_2d(&mb, bt, n, kb, 128);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        gemm_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  gemm_s8_kernel<<<(unsigned)grid, tma_threads(2), smem, s>>>(
      ma, mb, static_cast<int8_t*>(out), p);
  return (int)cudaGetLastError();
}

int launch_chain_s8(const void* x, const void* wt, void* out, int64_t m,
                    int depth, int ring, int grid, int device,
                    cudaStream_t s) {
  const int smem = tma_smem(depth, ring, kChainSlot, kChainWGs);
  int err = check_tma_launch(device, smem, grid, ring);
  if (err == 0 && (reinterpret_cast<uintptr_t>(x) % 16 ||
                   reinterpret_cast<uintptr_t>(wt) % 16 ||
                   reinterpret_cast<uintptr_t>(out) % 16))
    err = (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  if (err == 0) err = tma::map_2d(&mx, x, m, kC, kChainRows);
  if (err == 0) err = tma::map_2d(&mw, wt, (uint64_t)depth * kC, kC, 128);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        chain_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  chain_s8_kernel<<<(unsigned)grid, tma_threads(kChainWGs), smem, s>>>(
      mx, mw, static_cast<int8_t*>(out), m, depth, ring);
  return (int)cudaGetLastError();
}

int launch_chain_bf16(const void* x, const void* wt, void* out, int64_t m,
                      int depth, int wring, int grid, int device,
                      cudaStream_t s) {
  const int smem = bf16_chain_smem(wring);
  int err = check_tma_launch(device, smem, grid, wring);
  if (err == 0 && (reinterpret_cast<uintptr_t>(x) % 16 ||
                   reinterpret_cast<uintptr_t>(wt) % 16 ||
                   reinterpret_cast<uintptr_t>(out) % 16))
    err = (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  if (err == 0) err = tma::map_2d(&mx, x, m, 2 * kC, kChainRows);
  if (err == 0) err = tma::map_2d(&mw, wt, (uint64_t)depth * kC, 2 * kC, 128);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        chain_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  chain_bf16_kernel<<<(unsigned)grid, tma_threads(kChainWGs), smem, s>>>(
      mx, mw, static_cast<uint8_t*>(out), m, depth, wring);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA-rate probe
// ---------------------------------------------------------------------------

constexpr int kFmaWarps = 8;
enum { kModeFma = 0, kModeMul = 1, kModeRoll = 2 };

template <int U>
__global__ void __launch_bounds__(kFmaWarps * 32)
    fma_kernel(const float4* __restrict__ x, const float4* __restrict__ y,
               float4* __restrict__ o, int64_t rows, int t, int mode) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kFmaWarps + (threadIdx.x >> 5);
  if (row >= rows) return;          // the whole warp leaves together
  const float4 xv = x[row * 32 + lane], yv = y[row * 32 + lane];
  const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
  float a[U][4];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const float c = (float)(0.5 + 0.01 * k);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[k][e] = __fmul_rn(ys[e], c);
  }
  if (mode == kModeFma) {
    for (int i = 0; i < t; ++i)
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[k][e] = fmaf(a[k][e], xs[e], ys[e]);
  } else if (mode == kModeMul) {
    for (int i = 0; i < t; ++i)
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[k][e] = __fmul_rn(a[k][e], xs[e]);
  } else {
    const int left = (lane + 31) & 31;
    for (int i = 0; i < t; ++i)
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const float in = __shfl_sync(0xffffffffu, a[k][3], left);
        a[k][3] = __fadd_rn(a[k][2], ys[3]);
        a[k][2] = __fadd_rn(a[k][1], ys[2]);
        a[k][1] = __fadd_rn(a[k][0], ys[1]);
        a[k][0] = __fadd_rn(in, ys[0]);
      }
  }
  float s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s[e] = a[0][e];
#pragma unroll
    for (int k = 1; k < U; ++k) s[e] = __fadd_rn(s[e], a[k][e]);
  }
  o[row * 32 + lane] = make_float4(s[0], s[1], s[2], s[3]);
}

template <int U>
void launch_fma(const void* x, const void* y, void* o, int64_t rows, int t,
                int mode, cudaStream_t s) {
  const int64_t blocks = (rows + kFmaWarps - 1) / kFmaWarps;
  fma_kernel<U><<<(unsigned)blocks, kFmaWarps * 32, 0, s>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(y),
      static_cast<float4*>(o), rows, t, mode);
}

}  // namespace

// a: (m, k) and bt: (n, k), B transposed, both int8 (dtype 0) or bf16
// (dtype 1), contiguous, k * element size a multiple of 16; out: (m, n)
// int32, or int8 with out8 (int8 inputs only), or bf16.  instance: 0
// mma.sync (int8), 1 wgmma (bf16), 2 s8 wgmma fed by TMA (out8, inputs
// 16-byte aligned; ring slots and grid, a multiple of the column slices, as
// ops/probes.py gemm_plan gives them; the other instances ignore both).
extern "C" int cwfa_tiled_gemm(const void* a, const void* bt, void* out,
                               int64_t m, int n, int k, int dtype, int out8,
                               int instance, int ring, int grid, int device,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || dtype < 0 || dtype > 1 || out8 < 0 ||
      out8 > 1 || (out8 && dtype != 0) || instance < 0 || instance > 2 ||
      (instance == 1) != (dtype == 1) || (instance == 2 && !out8))
    return (int)cudaErrorInvalidValue;
  const int64_t kb = (int64_t)k * (dtype == 1 ? 2 : 1);
  if (kb % 16 || kb > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 1)
    return n > 128 ? launch_gemm_wgmma<256>(a, bt, out, m, n, (int)kb, s)
                   : launch_gemm_wgmma<128>(a, bt, out, m, n, (int)kb, s);
  if (instance == 2)
    return launch_gemm_s8(a, bt, out, m, n, (int)kb, ring, grid, device, s);
  if (out8) return launch_gemm<int, kOutInt8>(a, bt, out, m, n, (int)kb, s);
  return launch_gemm<int, kOutInt32>(a, bt, out, m, n, (int)kb, s);
}

// x, out: (m, 128); wt: (depth, 128, 128) with every stage transposed
// (N, K); all int8 (dtype 0) or bf16 (dtype 1), contiguous.  instance: 0
// mma.sync; 1 s8 wgmma fed by TMA (int8, depth <= 8, 16-byte aligned, every
// stage after the first with its K permuted as ops/probes.chain_operand
// does it); 2 bf16 wgmma fed by TMA (bf16, 16-byte aligned, the weight ring
// `ring` slots of a stage).  Ring slots and grid as ops/probes.py
// chain_plan gives them, which instance 0 ignores.
extern "C" int cwfa_chained_gemm(const void* x, const void* wt, void* out,
                                 int64_t m, int depth, int dtype, int instance,
                                 int ring, int grid, int device,
                                 void* stream) {
  if (m <= 0 || depth <= 0 || dtype < 0 || dtype > 1 || instance < 0 ||
      instance > 2 || (instance == 1 && (dtype != 0 || depth > 8)) ||
      (instance == 2 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 1)
    return launch_chain_s8(x, wt, out, m, depth, ring, grid, device, s);
  if (instance == 2)
    return launch_chain_bf16(x, wt, out, m, depth, ring, grid, device, s);
  return dtype == 1 ? launch_chain<true>(x, wt, out, m, depth, s)
                    : launch_chain<false>(x, wt, out, m, depth, s);
}

// x, y, o: (rows, 128) f32, contiguous; u in 1..16; mode 0 fma, 1 mul,
// 2 roll.
extern "C" int cwfa_fma_probe(const void* x, const void* y, void* o,
                              int64_t rows, int t, int u, int mode, int device,
                              void* stream) {
  if (rows <= 0 || t < 0 || u < 1 || u > 16 || mode < 0 || mode > 2 ||
      (rows + kFmaWarps - 1) / kFmaWarps > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (u) {
#define CWFA_FMA_CASE(U) \
  case U:                \
    launch_fma<U>(x, y, o, rows, t, mode, s); \
    break;
    CWFA_FMA_CASE(1) CWFA_FMA_CASE(2) CWFA_FMA_CASE(3) CWFA_FMA_CASE(4)
    CWFA_FMA_CASE(5) CWFA_FMA_CASE(6) CWFA_FMA_CASE(7) CWFA_FMA_CASE(8)
    CWFA_FMA_CASE(9) CWFA_FMA_CASE(10) CWFA_FMA_CASE(11) CWFA_FMA_CASE(12)
    CWFA_FMA_CASE(13) CWFA_FMA_CASE(14) CWFA_FMA_CASE(15) CWFA_FMA_CASE(16)
#undef CWFA_FMA_CASE
  }
  return (int)cudaGetLastError();
}
