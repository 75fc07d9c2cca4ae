// The backward of the condition nets' fused 3-D pair, for Hopper (sm_90a).
//
// The TPU kernel cwfa_tpu/ops/cond_pair.py:276 (cond_pair_fused) is
// inference only: JAX trains through its XLA convs
// (cwfa_tpu/models/cond_net.py:259-265).  The port runs every 3-D pair on a
// card through csrc/cond_pair.cu, so training needs this backward.  The
// forward (pre, y in f32, R the rounding to x's type):
//
//   pre_k = Conv3d(1 -> K)(x)_k + b_a[k]
//   y_k   = R(R(PReLU(pre_k)) * m[b, k])     (m: the Dropout3d scale, or 1)
//   z     = Conv3d(K -> 1)(y) + b_b
//
// and from dz this kernel gives, all sums in f32:
//
//   dy_k   = conv_b^T(dz)_k * m[b, k]
//   dpre_k = dy_k * (pre_k > 0 ? 1 : alpha)
//   dx     = conv_a^T(dpre)                  (x's type)
//   dW_b[k, t] = sum_p dz(p) y_k(p + t),     db_b = sum_p dz(p)
//   dW_a[k, t] = sum_p dpre_k(p) x(p + t),   db_a[k] = sum_p dpre_k(p)
//   dalpha = sum_p dy_k(p) pre_k(p) [pre_k(p) <= 0]
//
// Three instances.  K = 32 runs the products on the tensor cores, bf16
// (cond_pair_bwd_tc_kernel) or f32 as 3xTF32 (cond_pair_bwd_tf32_kernel,
// m16n8k8: each f32 operand split into a TF32 high part and the remainder,
// hi*hi + hi*lo + lo*hi; its design beside it); another K runs on the CUDA
// cores (cond_pair_bwd_kernel).
//
// Design of the tensor-core instance (mma.sync m16n8k16 bf16, f32 sums, the
// products of the forward's cond_pair_tc_kernel):
//   - One block of 256 threads per (batch, depth chunk of <= 48, 8 x 32 H x
//     W tile).  x and dz with a 2-voxel halo are staged once as bf16, and a
//     copy of dz that is zero outside the block's own voxels.
//   - Per depth plane of the tile and its 1-voxel halo (10 x 34 positions,
//     22 tiles of 16 a warp walks): pre = the im2col of x in registers . W_a
//     (27 taps padded to 32); dy = the im2col of dz . the flipped W_b^T; then
//     y = R(R(PReLU(pre)) m) and dpre = dy m PReLU'(pre) on the CUDA cores,
//     db_a and dalpha summed there too.  A pre within 2^-16 of 0 is summed
//     again there as the CUDA-core instance sums it (in f32, tap by tap), so
//     that both instances take the same side of PReLU's kink.  dpre rounded to bf16 is, as it sits
//     in the sum registers, the A operand of dx's product: (positions x K) .
//     (K x 27, W_a flipped), 27 planes in shared memory, then the
//     shift-and-add of the forward's conv_b into three rolling dx sums.  y
//     never reaches device memory.
//   - dW_a[k, t] = sum_p dpre_k(p) x(p + t) over the block's own positions
//     and dW_b[k, t] = sum_p' y_k(p') dz_own(p' - t) over the plane's: (K x
//     positions) . (positions x 32 taps), the K-side read from the plane's
//     bf16 dpre and y in shared memory with ldmatrix.trans, the tap side
//     gathered from the staged x and own dz; f32 sums in registers for the
//     whole block, then summed over the 8 warps in order.  Only dpre is
//     rounded (once, as an operand); y is the forward's own rounding.
//
// Design of the CUDA-core instance: one block of 256 threads per (batch, 8
// depths, 8 x 32 H x W tile), as the forward's CUDA-core instance.  x and dz
// with a 2-voxel halo are staged once into shared memory as f32, zero
// outside the volume.  For each intermediate channel k: pre_k and
// conv_b^T(dz)_k are recomputed over the tile and its 1-voxel halo (y never
// reaches device memory, as in the forward), y_k and dpre_k go to shared
// memory, then every thread adds the channel's conv_a^T term to the dx of
// its own (h, w) column and sums its column's 27 + 27 weight terms; the
// block's sums per channel (warp shuffles, then the 8 warps in a fixed
// order) go to a partial-sum buffer.
//
// Both: a second pass (two, above 64 blocks) sums the blocks' partials in a
// fixed order.  No atomics: the result is the same from run to run.
//
// Bound at step 0 of the flagship (1, 48, 512, 512), K = 32: operations,
// 2 x 43.49 GFLOP, 0.088 ms on bf16 tensor cores, 0.527 ms as 3xTF32 (three
// TF32 products each at 495 TFLOP/s), 1.30 ms on f32 FMAs.
//
// Plain C interface for ctypes (cwfa_tpu_torch/ops/cond_pair.py); launches
// on the caller's stream, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tower_wg.cuh"                 // split_tf32

namespace {

using tower::split_tf32;

constexpr int kTW = 32, kTH = 8, kTD = 8;
constexpr int kThreads = kTW * kTH;     // one thread per output (h, w)
constexpr int kYW = kTW + 2, kYH = kTH + 2;
constexpr int kXW = kTW + 4, kXH = kTH + 4;
constexpr int kYCols = kYW * kYH;
constexpr int kXCols = kXW * kXH;
constexpr int kNV = 56;                 // a channel's sums: dW_a 27, dW_b 27,
                                        // db_a, dalpha
constexpr int kChunk = 64;              // blocks summed by one reduce thread

struct Params {
  const void* x;      // (B, D, H, W)
  const void* dz;     // (B, D, H, W)
  const void* wa;     // (K, 1, 3, 3, 3)
  const void* ba;     // (K)
  const void* wb;     // (1, K, 3, 3, 3)
  const void* alpha;  // (1)
  const float* scale; // (B, K) or null
  void* dx;           // (B, D, H, W)
  float* part;        // (blocks, K * kNV + 1)
  int D, H, W, K, nchunks;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The block's sum of v[0..n) into out[0..n) (threads < n write): each warp
// reduces with shuffles, then n threads add the 8 warps in order.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* swarp, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) swarp[warp * N + i] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int wi = 0; wi < kThreads / 32; ++wi) s += swarp[wi * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cond_pair_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, H = p.H, W = p.W, K = p.K;
  float* xs = smem;                          // (kTD+4, kXH, kXW)
  float* dzs = xs + (kTD + 4) * kXCols;      // (kTD+4, kXH, kXW)
  float* ys = dzs + (kTD + 4) * kXCols;      // (kTD+2, kYH, kYW): y_k
  float* gs = ys + (kTD + 2) * kYCols;       // (kTD+2, kYH, kYW): dpre_k
  float* swa = gs + (kTD + 2) * kYCols;      // (K, 27)
  float* swb = swa + K * 27;                 // (K, 27)
  float* sba = swb + K * 27;                 // (K)
  float* swarp = sba + K;                    // (8, 28)

  const int b = blockIdx.z / p.nchunks;
  const int d0 = (blockIdx.z % p.nchunks) * kTD;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int64_t vol = (int64_t)D * H * W;
  const T* x = static_cast<const T*>(p.x) + b * vol;
  const T* dz = static_cast<const T*>(p.dz) + b * vol;
  const int64_t blk = blockIdx.x + (int64_t)gridDim.x * (blockIdx.y + (int64_t)gridDim.y * blockIdx.z);
  float* part = p.part + blk * (K * kNV + 1);

  for (int i = threadIdx.x; i < (kTD + 4) * kXCols; i += kThreads) {
    const int dd = i / kXCols, rc = i % kXCols;
    const int d = d0 - 2 + dd, h = h0 - 2 + rc / kXW, w = w0 - 2 + rc % kXW;
    float xv = 0.f, gv = 0.f;
    if (d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W) {
      const int64_t o = ((int64_t)d * H + h) * W + w;
      xv = to_f(x[o]);
      gv = to_f(dz[o]);
    }
    xs[i] = xv;
    dzs[i] = gv;
  }
  const T* gwa = static_cast<const T*>(p.wa);
  const T* gwb = static_cast<const T*>(p.wb);
  const T* gba = static_cast<const T*>(p.ba);
  for (int i = threadIdx.x; i < K * 27; i += kThreads) {
    swa[i] = to_f(gwa[i]);
    swb[i] = to_f(gwb[i]);
  }
  for (int i = threadIdx.x; i < K; i += kThreads) sba[i] = to_f(gba[i]);
  const float alpha = to_f(*static_cast<const T*>(p.alpha));

  const int zr = threadIdx.x / kTW, zc = threadIdx.x % kTW;
  float dxacc[kTD];
#pragma unroll
  for (int i = 0; i < kTD; ++i) dxacc[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    __syncthreads();  // staged (k == 0) / the previous channel consumed
    float wa[27], wbf[27];
#pragma unroll
    for (int i = 0; i < 27; ++i) {
      wa[i] = swa[k * 27 + i];
      wbf[i] = swb[k * 27 + 26 - i];     // conv_b^T: every tap flipped
    }
    const float bias_a = sba[k];
    const float sk = p.scale ? p.scale[b * K + k] : 1.f;
    float sums[2] = {0.f, 0.f};          // db_a, dalpha of this thread
    // pre_k, y_k and dpre_k over the tile and its 1-voxel halo
    for (int it = threadIdx.x; it < kYCols; it += kThreads) {
      const int r = it / kYW, c = it % kYW;
      float pre[kTD + 2], gy[kTD + 2];
#pragma unroll
      for (int j = 0; j < kTD + 2; ++j) pre[j] = gy[j] = 0.f;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float* xc = xs + (r + dh) * kXW + c + dw;
          const float* gc = dzs + (r + dh) * kXW + c + dw;
#pragma unroll
          for (int dd = 0; dd < kTD + 4; ++dd) {
            const float xv = xc[dd * kXCols], gv = gc[dd * kXCols];
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              const int j = dd - e;
              if (j >= 0 && j < kTD + 2) {
                pre[j] = fmaf(wa[dh * 9 + dw * 3 + e], xv, pre[j]);
                gy[j] = fmaf(wbf[dh * 9 + dw * 3 + e], gv, gy[j]);
              }
            }
          }
        }
      const int h = h0 - 1 + r, w = w0 - 1 + c;
      const bool in_hw = h >= 0 && h < H && w >= 0 && w < W;
      const bool own_hw = r >= 1 && r <= kTH && c >= 1 && c <= kTW;
#pragma unroll
      for (int j = 0; j < kTD + 2; ++j) {
        const int d = d0 - 1 + j;
        const bool live = in_hw && d >= 0 && d < D;
        const float v = pre[j] + bias_a;
        float y = to_f(from_f<T>(v > 0.f ? v : alpha * v));
        if (p.scale) y = to_f(from_f<T>(y * sk));
        const float g = gy[j] * sk;
        const float gp = v > 0.f ? g : g * alpha;
        ys[j * kYCols + it] = live ? y : 0.f;
        gs[j * kYCols + it] = live ? gp : 0.f;
        if (live && own_hw && j >= 1 && j <= kTD) {
          sums[0] += gp;
          if (!(v > 0.f)) sums[1] += g * v;
        }
      }
    }
    __syncthreads();
    // this thread's column: dx, and its terms of dW_a, dW_b
    float own_g[kTD], own_dz[kTD];
#pragma unroll
    for (int i = 0; i < kTD; ++i) {
      own_g[i] = gs[(i + 1) * kYCols + (zr + 1) * kYW + zc + 1];
      own_dz[i] = dzs[(i + 2) * kXCols + (zr + 2) * kXW + zc + 2];
    }
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const float* col = gs + (zr + dh) * kYW + zc + dw;
#pragma unroll
        for (int dd = 0; dd < kTD + 2; ++dd) {
          const float v = col[dd * kYCols];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const int i = dd - e;
            if (i >= 0 && i < kTD) dxacc[i] = fmaf(wa[26 - (dh * 9 + dw * 3 + e)], v, dxacc[i]);
          }
        }
      }
    float acc[27];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const float* col = xs + (zr + 1 + dh) * kXW + zc + 1 + dw;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kTD; ++i) s = fmaf(own_g[i], col[(i + 1 + e) * kXCols], s);
          acc[dh * 9 + dw * 3 + e] = s;
        }
      }
    block_sum<27>(acc, swarp, part + k * kNV);
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const float* col = ys + (zr + dh) * kYW + zc + dw;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kTD; ++i) s = fmaf(own_dz[i], col[(i + e) * kYCols], s);
          acc[dh * 9 + dw * 3 + e] = s;
        }
      }
    block_sum<27>(acc, swarp, part + k * kNV + 27);
    block_sum<2>(sums, swarp, part + k * kNV + 54);
  }

  float dbb[1] = {0.f};
#pragma unroll
  for (int i = 0; i < kTD; ++i) dbb[0] += dzs[(i + 2) * kXCols + (zr + 2) * kXW + zc + 2];
  block_sum<1>(dbb, swarp, part + K * kNV);

  const int h = h0 + zr, w = w0 + zc;
  if (h >= H || w >= W) return;
  T* dx = static_cast<T*>(p.dx) + b * vol;
#pragma unroll
  for (int i = 0; i < kTD; ++i) {
    const int d = d0 + i;
    if (d < D) dx[((int64_t)d * H + h) * W + w] = from_f<T>(dxacc[i]);
  }
}

// ---------------------------------------------------------------------------
// the tensor-core instance: bf16, K = 32
// ---------------------------------------------------------------------------

constexpr int kK = 32;
constexpr int kYTiles = (kYCols + 15) / 16;     // 22 tiles of 16 positions
constexpr int kYRows = kYTiles * 16;            // 352: the plane's rows, padded
constexpr int kPStride = 356;                   // floats per contribution plane
constexpr int kDPitch = 40;                     // bf16 a row of the dpre / y
                                                // planes: 80 bytes, so the 8
                                                // rows of an ldmatrix hit
                                                // distinct banks
constexpr int kMaxTDtc = 48;                  // depths a block (x, dz, own dz
                                                // of 52 x 12 x 36 bf16 fit)

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* row) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }

__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// offset in the x window of tap t = 9 dh + 3 dw + dd (-1: a tap that pads 27
// to 32)
__device__ __forceinline__ int tap_off(int t) {
  return t < 27 ? (t % 3) * kXCols + (t / 9) * kXW + (t / 3) % 3 : -1;
}

// A pre-activation this close to 0 is summed again: where pre is within
// rounding of 0, the side of 0 it lands on depends on the order of its f32
// sums, and the other side takes PReLU's other slope, a jump of dpre that dx
// carries to 27 neighbours.  The tensor cores' sums truncate; near the kink
// pre is summed as the CUDA-core instance sums it, so that the two instances
// take the same slope.
constexpr uint32_t kKinkBits = 0x37800000u;     // |pre| < 2^-16, as f32 bits

// pre + b_a of channel ch at x-window position base, as cond_pair_bwd_kernel
// sums it: the 27 products in tap order with fused multiply-adds, then the
// bias.  Unrolled, so that the 54 loads are in flight together.
__device__ __noinline__ float f32_pre(const uint16_t* xs, int base, const uint16_t* gwa,
                                      int ch, float bias) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 27; ++t) s = fmaf(bf(gwa[ch * 27 + t]), bf(xs[base + tap_off(t)]), s);
  return s + bias;
}

// p.nchunks depth chunks of td depths each.
__global__ void __launch_bounds__(kThreads, 1) cond_pair_bwd_tc_kernel(const Params p, int td) {
  extern __shared__ __align__(16) float smem[];
  float* pbuf = smem;                                            // (27, kPStride)
  uint16_t* dpl = reinterpret_cast<uint16_t*>(pbuf + 27 * kPStride);   // (352, kDPitch)
  uint16_t* ypl = dpl + kYRows * kDPitch;                        // (352, kDPitch)
  uint16_t* xs = ypl + kYRows * kDPitch;                         // (td+4, kXH, kXW)
  uint16_t* dzs = xs + (td + 4) * kXCols;
  uint16_t* dzm = dzs + (td + 4) * kXCols;                       // dz, own voxels only
  const int D = p.D, H = p.H, W = p.W;
  const int b = blockIdx.z / p.nchunks;
  const int d0 = (blockIdx.z % p.nchunks) * td;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int64_t vol = (int64_t)D * H * W;
  const uint16_t* x = static_cast<const uint16_t*>(p.x) + b * vol;
  const uint16_t* dz = static_cast<const uint16_t*>(p.dz) + b * vol;
  const int64_t blk = blockIdx.x + (int64_t)gridDim.x * (blockIdx.y + (int64_t)gridDim.y * blockIdx.z);
  float* part = p.part + blk * (kK * kNV + 1);

  for (int i = threadIdx.x; i < (td + 4) * kXCols; i += kThreads) {
    const int dd = i / kXCols, rc = i % kXCols, r = rc / kXW, c = rc % kXW;
    const int d = d0 - 2 + dd, h = h0 - 2 + r, w = w0 - 2 + c;
    uint16_t xv = 0, gv = 0;
    const bool in = d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W;
    if (in) {
      const int64_t o = ((int64_t)d * H + h) * W + w;
      xv = x[o];
      gv = dz[o];
    }
    const bool own = in && dd >= 2 && dd < td + 2 && r >= 2 && r < kTH + 2 && c >= 2 &&
                     c < kTW + 2;
    xs[i] = xv;
    dzs[i] = gv;
    dzm[i] = own ? gv : 0;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const uint16_t* gwa = static_cast<const uint16_t*>(p.wa);
  const uint16_t* gwb = static_cast<const uint16_t*>(p.wb);
  // B fragments (k = 16 ks + 8 r + 2 q, + 1 in the two halves; n = 8 nt + g):
  // fa: pre = im2col(x) . W_a, [tap][channel]; fb: dy = im2col(dz) . the
  // flipped W_b^T, [tap][channel]; fc: dx's contributions = dpre . the
  // flipped W_a, [channel][tap]; the taps beyond 27 zero
  uint32_t fa[2][4][2], fb[2][4][2], fc[2][4][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k0 = 16 * ks + 8 * r + 2 * q, n = 8 * nt + g;
        const uint32_t a_lo = k0 < 27 ? gwa[n * 27 + k0] : 0;
        const uint32_t a_hi = k0 + 1 < 27 ? gwa[n * 27 + k0 + 1] : 0;
        fa[ks][nt][r] = a_lo | (a_hi << 16);
        const uint32_t b_lo = k0 < 27 ? gwb[n * 27 + 26 - k0] : 0;
        const uint32_t b_hi = k0 + 1 < 27 ? gwb[n * 27 + 25 - k0] : 0;
        fb[ks][nt][r] = b_lo | (b_hi << 16);
        const uint32_t c_lo = n < 27 ? gwa[k0 * 27 + 26 - n] : 0;
        const uint32_t c_hi = n < 27 ? gwa[(k0 + 1) * 27 + 26 - n] : 0;
        fc[ks][nt][r] = c_lo | (c_hi << 16);
      }
  const __nv_bfloat16* gba = static_cast<const __nv_bfloat16*>(p.ba);
  float bias_a[4][2], sc[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias_a[nt][e] = __bfloat162float(gba[8 * nt + 2 * q + e]);
      sc[nt][e] = p.scale ? p.scale[b * kK + 8 * nt + 2 * q + e] : 1.f;
    }
  const float alpha = __bfloat162float(*static_cast<const __nv_bfloat16*>(p.alpha));
  int aoff[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) aoff[ks][r][e] = tap_off(16 * ks + 8 * r + 2 * q + e);
  // the tap side of the weight gradients: tap 8 nt + g of x (dW_a) and of dz
  // flipped (dW_b)
  int xo[4], zo[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int t = 8 * nt + g;
    xo[nt] = tap_off(t);
    zo[nt] = t < 27 ? tap_off(26 - t) : -1;
  }

  float wa_acc[2][4][4], wb_acc[2][4][4], dba[4][2], dal[4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) wa_acc[mt][nt][i] = wb_acc[mt][nt][i] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) dba[nt][0] = dba[nt][1] = dal[nt][0] = dal[nt][1] = 0.f;

  const int zr = threadIdx.x / kTW, zc = threadIdx.x % kTW;
  const int zh = h0 + zr, zw = w0 + zc;
  uint16_t* dxo = static_cast<uint16_t*>(p.dx) + b * vol;
  float x2 = 0.f, x1 = 0.f, x0 = 0.f;   // dx at depths plane - 1, plane, plane + 1
  // ldmatrix: lane -> (position in the 16 of a chunk, channel offset)
  const int lrow = ((lane >> 4) & 1) * 8 + (lane & 7), lch = ((lane >> 3) & 1) * 8;

  __syncthreads();
  for (int j = 0; j < td + 2; ++j) {
    const int dj = d0 - 1 + j;          // this plane's depth
    const bool live = dj >= 0 && dj < D;
    const bool own_plane = live && j >= 1 && j <= td;
    if (live) {
      for (int tile = warp; tile < kYTiles; tile += kThreads / 32) {
        int base[2];
        bool in[2], own[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = 16 * tile + g + 8 * h;
          const int r = pos < kYCols ? pos / kYW : 0, c = pos < kYCols ? pos % kYW : 0;
          base[h] = j * kXCols + r * kXW + c;
          const int yh = h0 - 1 + r, yw = w0 - 1 + c;
          in[h] = pos < kYCols && yh >= 0 && yh < H && yw >= 0 && yw < W;
          own[h] = in[h] && own_plane && r >= 1 && r <= kTH && c >= 1 && c <= kTW;
        }
        // the im2col fragments of x and dz, gathered from the windows
        uint32_t ax[2][4], az[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o0 = aoff[ks][r][0], o1 = aoff[ks][r][1];
              ax[ks][2 * r + h] = (o0 >= 0 ? (uint32_t)xs[base[h] + o0] : 0u) |
                                  ((o1 >= 0 ? (uint32_t)xs[base[h] + o1] : 0u) << 16);
              az[ks][2 * r + h] = (o0 >= 0 ? (uint32_t)dzs[base[h] + o0] : 0u) |
                                  ((o1 >= 0 ? (uint32_t)dzs[base[h] + o1] : 0u) << 16);
            }
        float pre[4][4], gy[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) pre[nt][i] = gy[nt][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            mma_bf16(pre[nt], ax[ks], fa[ks][nt][0], fa[ks][nt][1]);
            mma_bf16(gy[nt], az[ks], fb[ks][nt][0], fb[ks][nt][1]);
          }
        }
        // pre + b_a; near the kink (rare: a warp with none skips the loop),
        // summed again as the CUDA-core instance sums it (outside the volume
        // too: those positions are zeroed below)
        bool kink = false;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pre[nt][i] += bias_a[nt][i & 1];
            kink |= (__float_as_uint(pre[nt][i]) & 0x7fffffffu) < kKinkBits;
          }
        if (__any_sync(0xffffffffu, kink)) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if ((__float_as_uint(pre[nt][i]) & 0x7fffffffu) < kKinkBits)
                pre[nt][i] = f32_pre(xs, base[i >> 1], gwa, 8 * nt + 2 * q + (i & 1),
                                     bias_a[nt][i & 1]);
        }
        // y and dpre; dpre's channel tiles 2 ks, 2 ks + 1 are dx's A
        // fragment ks
        uint32_t ad[2][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float yv[2], gp[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = pre[nt][2 * h + e];
              // y rounded as the forward rounds it (the last rounding is
              // the bf16 pack's)
              float yy = v > 0.f ? v : alpha * v;
              if (p.scale) yy = rnd(yy) * sc[nt][e];
              const float gd = gy[nt][2 * h + e] * sc[nt][e];
              const float gq = v > 0.f ? gd : gd * alpha;
              yv[e] = in[h] ? yy : 0.f;
              gp[e] = in[h] ? gq : 0.f;
              if (own[h]) {
                dba[nt][e] += gq;
                if (!(v > 0.f)) dal[nt][e] += gd * v;
              }
            }
            const int row = (16 * tile + g + 8 * h) * kDPitch + 8 * nt + 2 * q;
            const uint32_t dp = pack2(gp[0], gp[1]);
            *reinterpret_cast<uint32_t*>(ypl + row) = pack2(yv[0], yv[1]);
            *reinterpret_cast<uint32_t*>(dpl + row) = dp;
            ad[nt >> 1][2 * (nt & 1) + h] = dp;
          }
        // dx's contributions: every position's to its 27 neighbours
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float cc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) mma_bf16(cc, ad[ks], fc[ks][nt][0], fc[ks][nt][1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * nt + 2 * q + e;
            if (t < 27) {
              pbuf[t * kPStride + 16 * tile + g] = cc[e];
              pbuf[t * kPStride + 16 * tile + g + 8] = cc[2 + e];
            }
          }
        }
      }
    }
    __syncthreads();
    if (live) {
      // dpre at depth dj reaches dx at depth dj - dd + 1 through depth tap dd
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float* c = pbuf + (9 * dh + 3 * dw) * kPStride + (zr + dh) * kYW + zc + dw;
          x0 += c[0];
          x1 += c[kPStride];
          x2 += c[2 * kPStride];
        }
      // dW_a over the plane's own positions: 16 chunks of 16 (a row half)
      if (own_plane)
        for (int ch = warp; ch < 2 * kTH; ch += kThreads / 32) {
          const int rr = ch / 2 + 1, cs = (ch % 2) * 16 + 1;
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4_t(a[mt], dpl + (rr * kYW + cs + lrow) * kDPitch + 16 * mt + lch);
          const int xb = j * kXCols + rr * kXW + cs;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            uint32_t bb[2] = {0u, 0u};
            if (xo[nt] >= 0)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const uint16_t* s = xs + xb + xo[nt] + 2 * q + 8 * r;
                bb[r] = (uint32_t)s[0] | ((uint32_t)s[1] << 16);
              }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_bf16(wa_acc[mt][nt], a[mt], bb[0], bb[1]);
          }
        }
      // dW_b over the plane's 352 rows: y there against dz at the block's own
      // positions (zero elsewhere, and y is zero on the padding rows)
      for (int ch = warp; ch < kYTiles; ch += kThreads / 32) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4_t(a[mt], ypl + (16 * ch + lrow) * kDPitch + 16 * mt + lch);
        int zb[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = 16 * ch + 2 * q + 8 * r + e;
            const int pc = pos < kYCols ? pos : 0;
            zb[r][e] = j * kXCols + (pc / kYW) * kXW + pc % kYW;
          }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bb[2] = {0u, 0u};
          if (zo[nt] >= 0)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              bb[r] = (uint32_t)dzm[zb[r][0] + zo[nt]] | ((uint32_t)dzm[zb[r][1] + zo[nt]] << 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(wb_acc[mt][nt], a[mt], bb[0], bb[1]);
        }
      }
    }
    const int dxd = dj - 1;             // x2 is complete
    if (j >= 2 && dxd < D && zh < H && zw < W) {
      const __nv_bfloat16 v = __float2bfloat16_rn(x2);
      dxo[((int64_t)dxd * H + zh) * W + zw] = *reinterpret_cast<const uint16_t*>(&v);
    }
    x2 = x1;
    x1 = x0;
    x0 = 0.f;
    __syncthreads();
  }

  // the block's sums, in a fixed order: the 8 warps' weight sums through
  // shared memory (over the planes' buffers), the channel sums by shuffles
  float* red = smem;                                   // (8, 2, 32, 32)
  float* red2 = red + 8 * 2 * kK * kK;                 // (8, 2, 32)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * mt + g + 8 * (i >> 1), t = 8 * nt + 2 * q + (i & 1);
        red[((warp * 2 + 0) * kK + k) * kK + t] = wa_acc[mt][nt][i];
        red[((warp * 2 + 1) * kK + k) * kK + t] = wb_acc[mt][nt][i];
      }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s0 = dba[nt][e], s1 = dal[nt][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) {
        red2[(warp * 2 + 0) * kK + 8 * nt + 2 * q + e] = s0;
        red2[(warp * 2 + 1) * kK + 8 * nt + 2 * q + e] = s1;
      }
    }
  float dbb = 0.f;
  for (int i = threadIdx.x; i < (td + 4) * kXCols; i += kThreads) dbb += bf(dzm[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < kK * kNV; i += kThreads) {
    const int k = i / kNV, t = i % kNV;
    float s = 0.f;
    if (t < 54) {
      const int which = t / 27, tt = t % 27;
      for (int wi = 0; wi < kThreads / 32; ++wi) s += red[((wi * 2 + which) * kK + k) * kK + tt];
    } else {
      for (int wi = 0; wi < kThreads / 32; ++wi) s += red2[(wi * 2 + t - 54) * kK + k];
    }
    part[i] = s;
  }
  float v[1] = {dbb};
  __syncthreads();
  block_sum<1>(v, red2 + 16 * kK, part + kK * kNV);
}

// ---------------------------------------------------------------------------
// the tensor-core instance in f32: 3xTF32, K = 32
// ---------------------------------------------------------------------------

constexpr int kMaxTDtf = 11;                  // depths a block: x, dz, own dz
                                              // of 15 x 12 x 36 f32 fit beside
                                              // the planes and the weights

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

// Element (row, ch) of a (352, 32) f32 plane of dpre or y: the channel
// XOR-swizzled by the row, so that the sums' stores and the fragments'
// loads (8 rows x 4 channels, 4 rows x 8 channels) hit 32 banks.
__device__ __forceinline__ int sw(int row, int ch) {
  return row * kK + (ch ^ (((row & 3) << 3) | (((row >> 2) & 1) << 2)));
}

// pre + b_a of channel ch at x-window position base, as the f32 CUDA-core
// instances sum it: the 27 products in tap order with fused multiply-adds,
// then the bias.
__device__ __noinline__ float f32_pre_f(const float* xs, int base, const float* gwa, int ch,
                                        float bias) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 27; ++t) s = fmaf(gwa[ch * 27 + t], xs[base + tap_off(t)], s);
  return s + bias;
}

// The bf16 tensor-core instance's structure in f32 with m16n8k8 TF32
// products, each as 3xTF32: the same per-plane products (pre, dy, dx's
// contributions, dW_a, dW_b), every operand split in registers as it is
// loaded, the weights' fragments split once into shared memory.  What
// differs: the C fragment of a TF32 product is not the A fragment of the
// next, so dx's A is read back from the dpre plane; the planes are f32 with
// a swizzle (32-bit loads, ldmatrix.trans being 16-bit only); a depth chunk
// of at most 11 (the f32 windows); the weight sums of each plane go into
// zeroed registers that the CUDA cores add on (the tensor cores' sums
// truncate).
__global__ void __launch_bounds__(kThreads, 1) cond_pair_bwd_tf32_kernel(const Params p, int td) {
  extern __shared__ __align__(16) float smem[];
  float* pbuf = smem;                                            // (27, kPStride)
  float* dpl = pbuf + 27 * kPStride;                             // (352, 32), sw
  float* ypl = dpl + kYRows * kK;                                // (352, 32), sw
  uint4* wfr = reinterpret_cast<uint4*>(ypl + kYRows * kK);      // [3][ks][nt][lane]
  float* xs = reinterpret_cast<float*>(wfr + 3 * 16 * 32);       // (td+4, kXH, kXW)
  float* dzs = xs + (td + 4) * kXCols;
  float* dzm = dzs + (td + 4) * kXCols;                          // dz, own voxels only
  const int D = p.D, H = p.H, W = p.W;
  const int b = blockIdx.z / p.nchunks;
  const int d0 = (blockIdx.z % p.nchunks) * td;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const int64_t vol = (int64_t)D * H * W;
  const float* x = static_cast<const float*>(p.x) + b * vol;
  const float* dz = static_cast<const float*>(p.dz) + b * vol;
  const int64_t blk = blockIdx.x + (int64_t)gridDim.x * (blockIdx.y + (int64_t)gridDim.y * blockIdx.z);
  float* part = p.part + blk * (kK * kNV + 1);

  for (int i = threadIdx.x; i < (td + 4) * kXCols; i += kThreads) {
    const int dd = i / kXCols, rc = i % kXCols, r = rc / kXW, c = rc % kXW;
    const int d = d0 - 2 + dd, h = h0 - 2 + r, w = w0 - 2 + c;
    float xv = 0.f, gv = 0.f;
    const bool in = d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W;
    if (in) {
      const int64_t o = ((int64_t)d * H + h) * W + w;
      xv = x[o];
      gv = dz[o];
    }
    const bool own = in && dd >= 2 && dd < td + 2 && r >= 2 && r < kTH + 2 && c >= 2 &&
                     c < kTW + 2;
    xs[i] = xv;
    dzs[i] = gv;
    dzm[i] = own ? gv : 0.f;
  }
  const float* gwa = static_cast<const float*>(p.wa);
  const float* gwb = static_cast<const float*>(p.wb);
  // B fragments (k = 8 ks + q, + 4; n = 8 nt + g), split: 0: pre =
  // im2col(x) . W_a, [tap][channel]; 1: dy = im2col(dz) . the flipped W_b^T,
  // [tap][channel]; 2: dx's contributions = dpre . the flipped W_a,
  // [channel][tap]; the taps beyond 27 zero
  for (int i = threadIdx.x; i < 3 * 16 * 32; i += kThreads) {
    const int mat = i / 512, ks = (i / 128) % 4, nt = (i / 32) % 4, l = i % 32;
    const int n = 8 * nt + (l >> 2);
    uint32_t hi[2], lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = 8 * ks + (l & 3) + 4 * r;
      float v = 0.f;
      if (mat == 0 && k < 27) v = gwa[n * 27 + k];
      if (mat == 1 && k < 27) v = gwb[n * 27 + 26 - k];
      if (mat == 2 && n < 27) v = gwa[k * 27 + 26 - n];
      split_tf32(v, hi[r], lo[r]);
    }
    wfr[i] = make_uint4(hi[0], hi[1], lo[0], lo[1]);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const float* gba = static_cast<const float*>(p.ba);
  float bias_a[4][2], sc[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias_a[nt][e] = gba[8 * nt + 2 * q + e];
      sc[nt][e] = p.scale ? p.scale[b * kK + 8 * nt + 2 * q + e] : 1.f;
    }
  const float alpha = *static_cast<const float*>(p.alpha);
  int aoff[4][2];                       // taps 8 ks + q and + 4 of the im2col
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 2; ++r) aoff[ks][r] = tap_off(8 * ks + q + 4 * r);
  // the tap side of the weight gradients: tap 8 nt + g of x (dW_a) and of dz
  // flipped (dW_b)
  int xo[4], zo[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int t = 8 * nt + g;
    xo[nt] = tap_off(t);
    zo[nt] = t < 27 ? tap_off(26 - t) : -1;
  }

  float wa_acc[2][4][4], wb_acc[2][4][4], dba[4][2], dal[4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) wa_acc[mt][nt][i] = wb_acc[mt][nt][i] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) dba[nt][0] = dba[nt][1] = dal[nt][0] = dal[nt][1] = 0.f;

  const int zr = threadIdx.x / kTW, zc = threadIdx.x % kTW;
  const int zh = h0 + zr, zw = w0 + zc;
  float* dxo = static_cast<float*>(p.dx) + b * vol;
  float x2 = 0.f, x1 = 0.f, x0 = 0.f;   // dx at depths plane - 1, plane, plane + 1
  uint32_t ah[4][4], al[4][4];

  // a plane's weight-gradient products over 16 positions (two k-steps):
  // A = the plane (channels x positions) at rows row0 + k, B = the tap side
  // at window offsets base0 + k + off[nt] of src (off < 0: zero), summed
  // into tmp
  auto wgrad16 = [&](float (&tmp)[2][4][4], const float* pl, int row0, const float* src,
                     const int (&base)[2][2], const int (&off)[4]) {
#pragma unroll
    for (int kstep = 0; kstep < 2; ++kstep) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split_tf32(pl[sw(row0 + 8 * kstep + q + 4 * r, 16 * mt + g + 8 * h)],
                       ah[mt][2 * r + h], al[mt][2 * r + h]);
      uint4 bb[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          split_tf32(off[nt] >= 0 ? src[base[kstep][r] + off[nt]] : 0.f, bh[r], bl[r]);
        bb[nt] = make_uint4(bh[0], bh[1], bl[0], bl[1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_3x4(tmp[mt], ah[mt], al[mt], bb);
    }
  };

  __syncthreads();
  for (int j = 0; j < td + 2; ++j) {
    const int dj = d0 - 1 + j;          // this plane's depth
    const bool live = dj >= 0 && dj < D;
    const bool own_plane = live && j >= 1 && j <= td;
    if (live) {
      for (int tile = warp; tile < kYTiles; tile += kThreads / 32) {
        int base[2];
        bool in[2], own[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = 16 * tile + g + 8 * h;
          const int r = pos < kYCols ? pos / kYW : 0, c = pos < kYCols ? pos % kYW : 0;
          base[h] = j * kXCols + r * kXW + c;
          const int yh = h0 - 1 + r, yw = w0 - 1 + c;
          in[h] = pos < kYCols && yh >= 0 && yh < H && yw >= 0 && yw < W;
          own[h] = in[h] && own_plane && r >= 1 && r <= kTH && c >= 1 && c <= kTW;
        }
        // pre, then dy: the im2col fragments of x, then of dz (a0: position
        // g, tap 8 ks + q; a1: position g + 8; a2, a3: tap + 4)
        float pre[4][4], gy[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pre[nt][i] = gy[nt][i] = 0.f;
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const float* src = which ? dzs : xs;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int o = aoff[ks][r];
                split_tf32(o >= 0 ? src[base[h] + o] : 0.f, ah[ks][2 * r + h],
                           al[ks][2 * r + h]);
              }
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint4 bw[4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) bw[nt] = wfr[((which * 4 + ks) * 4 + nt) * 32 + lane];
            mma_3x4(which ? gy : pre, ah[ks], al[ks], bw);
          }
        }
        // pre + b_a; near the kink (rare: a warp with none skips the loop),
        // summed again as the CUDA-core instances sum it (outside the volume
        // too: those positions are zeroed below)
        bool kink = false;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pre[nt][i] += bias_a[nt][i & 1];
            kink |= (__float_as_uint(pre[nt][i]) & 0x7fffffffu) < kKinkBits;
          }
        if (__any_sync(0xffffffffu, kink)) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if ((__float_as_uint(pre[nt][i]) & 0x7fffffffu) < kKinkBits)
                pre[nt][i] = f32_pre_f(xs, base[i >> 1], gwa, 8 * nt + 2 * q + (i & 1),
                                       bias_a[nt][i & 1]);
        }
        // y and dpre into the planes
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float yv[2], gp[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = pre[nt][2 * h + e];
              float yy = v > 0.f ? v : alpha * v;
              if (p.scale) yy *= sc[nt][e];
              const float gd = gy[nt][2 * h + e] * sc[nt][e];
              const float gq = v > 0.f ? gd : gd * alpha;
              yv[e] = in[h] ? yy : 0.f;
              gp[e] = in[h] ? gq : 0.f;
              if (own[h]) {
                dba[nt][e] += gq;
                if (!(v > 0.f)) dal[nt][e] += gd * v;
              }
            }
            const int o = sw(16 * tile + g + 8 * h, 8 * nt + 2 * q);
            *reinterpret_cast<float2*>(ypl + o) = make_float2(yv[0], yv[1]);
            *reinterpret_cast<float2*>(dpl + o) = make_float2(gp[0], gp[1]);
          }
        __syncwarp();
        // dx's contributions: every position's to its 27 neighbours, A =
        // the tile's dpre read back from the plane
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              split_tf32(dpl[sw(16 * tile + g + 8 * h, 8 * ks + q + 4 * r)],
                         ah[ks][2 * r + h], al[ks][2 * r + h]);
        float cc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) cc[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint4 bw[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) bw[nt] = wfr[((8 + ks) * 4 + nt) * 32 + lane];
          mma_3x4(cc, ah[ks], al[ks], bw);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * nt + 2 * q + e;
            if (t < 27) {
              pbuf[t * kPStride + 16 * tile + g] = cc[nt][e];
              pbuf[t * kPStride + 16 * tile + g + 8] = cc[nt][2 + e];
            }
          }
      }
    }
    __syncthreads();
    if (live) {
      // dpre at depth dj reaches dx at depth dj - dd + 1 through depth tap dd
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float* c = pbuf + (9 * dh + 3 * dw) * kPStride + (zr + dh) * kYW + zc + dw;
          x0 += c[0];
          x1 += c[kPStride];
          x2 += c[2 * kPStride];
        }
      float tmp[2][4][4];
      // dW_a over the plane's own positions: 16 chunks of 16 (a row half)
      if (own_plane) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) tmp[mt][nt][i] = 0.f;
        for (int ch = warp; ch < 2 * kTH; ch += kThreads / 32) {
          const int rr = ch / 2 + 1, cs = (ch % 2) * 16 + 1;
          const int xb = j * kXCols + rr * kXW + cs;
          const int base[2][2] = {{xb + q, xb + q + 4}, {xb + 8 + q, xb + 12 + q}};
          wgrad16(tmp, dpl, rr * kYW + cs, xs, base, xo);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) wa_acc[mt][nt][i] += tmp[mt][nt][i];
      }
      // dW_b over the plane's 352 rows: y there against dz at the block's own
      // positions (zero elsewhere, and y is zero on the padding rows)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) tmp[mt][nt][i] = 0.f;
      for (int ch = warp; ch < kYTiles; ch += kThreads / 32) {
        int base[2][2];
#pragma unroll
        for (int kstep = 0; kstep < 2; ++kstep)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int pos = 16 * ch + 8 * kstep + q + 4 * r;
            const int pc = pos < kYCols ? pos : 0;
            base[kstep][r] = j * kXCols + (pc / kYW) * kXW + pc % kYW;
          }
        wgrad16(tmp, ypl, 16 * ch, dzm, base, zo);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) wb_acc[mt][nt][i] += tmp[mt][nt][i];
    }
    const int dxd = dj - 1;             // x2 is complete
    if (j >= 2 && dxd < D && zh < H && zw < W) dxo[((int64_t)dxd * H + zh) * W + zw] = x2;
    x2 = x1;
    x1 = x0;
    x0 = 0.f;
    __syncthreads();
  }

  // the block's sums, in a fixed order: the 8 warps' weight sums through
  // shared memory (over the planes' buffers), the channel sums by shuffles
  float* red = smem;                                   // (8, 2, 32, 32)
  float* red2 = red + 8 * 2 * kK * kK;                 // (8, 2, 32)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * mt + g + 8 * (i >> 1), t = 8 * nt + 2 * q + (i & 1);
        red[((warp * 2 + 0) * kK + k) * kK + t] = wa_acc[mt][nt][i];
        red[((warp * 2 + 1) * kK + k) * kK + t] = wb_acc[mt][nt][i];
      }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s0 = dba[nt][e], s1 = dal[nt][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) {
        red2[(warp * 2 + 0) * kK + 8 * nt + 2 * q + e] = s0;
        red2[(warp * 2 + 1) * kK + 8 * nt + 2 * q + e] = s1;
      }
    }
  float dbb = 0.f;
  for (int i = threadIdx.x; i < (td + 4) * kXCols; i += kThreads) dbb += dzm[i];
  __syncthreads();
  for (int i = threadIdx.x; i < kK * kNV; i += kThreads) {
    const int k = i / kNV, t = i % kNV;
    float s = 0.f;
    if (t < 54) {
      const int which = t / 27, tt = t % 27;
      for (int wi = 0; wi < kThreads / 32; ++wi) s += red[((wi * 2 + which) * kK + k) * kK + tt];
    } else {
      for (int wi = 0; wi < kThreads / 32; ++wi) s += red2[(wi * 2 + t - 54) * kK + k];
    }
    part[i] = s;
  }
  float v[1] = {dbb};
  __syncthreads();
  block_sum<1>(v, red2 + 16 * kK, part + kK * kNV);
}

// depth chunks of at most max_td depths each, as even as they come
int tc_blocks(int b, int d, int h, int w, int max_td, int* nchunks, int* td) {
  *nchunks = (d + max_td - 1) / max_td;
  *td = (d + *nchunks - 1) / *nchunks;
  return ((w + kTW - 1) / kTW) * ((h + kTH - 1) / kTH) * b * *nchunks;
}

// out[c][i] = sum of part[blk][i] over the blocks c*chunk .. (c+1)*chunk - 1,
// in block order.
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int nblk, int n, int chunk) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = blockIdx.y;
  const int end = min(nblk, (c + 1) * chunk);
  float s = 0.f;
  for (int k = c * chunk; k < end; ++k) s += part[(int64_t)k * n + i];
  out[(int64_t)c * n + i] = s;
}

int blocks_of(int b, int d, int h, int w, int* nchunks) {
  *nchunks = (d + kTD - 1) / kTD;
  return ((w + kTW - 1) / kTW) * ((h + kTH - 1) / kTH) * b * *nchunks;
}

}  // namespace

// Floats of the partial-sum space cwfa_cond_pair_bwd needs.
extern "C" int64_t cwfa_cond_pair_bwd_part(int b, int d, int h, int w, int k) {
  int nchunks;
  const int64_t nblk = blocks_of(b, d, h, w, &nchunks);
  return (nblk + (nblk + kChunk - 1) / kChunk) * ((int64_t)k * kNV + 1);
}

// x, dz, dx: (B, D, H, W); wa (K, 1, 3, 3, 3), ba (K), wb (1, K, 3, 3, 3),
// alpha (1), all contiguous and of x's type (dtype 0 = float32,
// 1 = bfloat16); scale: (B, K) f32 or null.  tensor_cores 1: the
// tensor-core instance of the dtype (k = 32 only), 0: the CUDA-core one.  grads: f32, K * 56 + 1 floats:
// per channel k, [k * 56 + t] dW_a (t < 27), dW_b (27 + t), db_a (54),
// dalpha's share (55); then db_b.  part: cwfa_cond_pair_bwd_part floats.
extern "C" int cwfa_cond_pair_bwd(const void* x, const void* dz, const void* wa,
                                  const void* ba, const void* wb, const void* alpha,
                                  const float* scale, void* dx, float* grads,
                                  float* part, int b, int d, int h, int w, int k,
                                  int dtype, int tensor_cores, int device, void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || w <= 0 || k <= 0 || dtype < 0 || dtype > 1 ||
      (tensor_cores && k != kK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int nchunks, td = kTD;
  const int nblk = tensor_cores ? tc_blocks(b, d, h, w, dtype ? kMaxTDtc : kMaxTDtf,
                                            &nchunks, &td)
                                : blocks_of(b, d, h, w, &nchunks);
  if ((int64_t)b * nchunks > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dz = dz;
  p.wa = wa;
  p.ba = ba;
  p.wb = wb;
  p.alpha = alpha;
  p.scale = scale;
  p.dx = dx;
  p.part = part;
  p.D = d;
  p.H = h;
  p.W = w;
  p.K = k;
  p.nchunks = nchunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = ((kTD + 4) * kXCols * 2 + (kTD + 2) * kYCols * 2 + k * 55 +
                    (kThreads / 32) * 28) * 4;
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, b * nchunks);
  if (tensor_cores && dtype == 0) {
    const int tsmem =
        (27 * kPStride + 2 * kYRows * kK + 3 * 16 * 32 * 4 + 3 * (td + 4) * kXCols) * 4;
    err = cudaFuncSetAttribute(cond_pair_bwd_tf32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tsmem);
    if (err != cudaSuccess) return (int)err;
    cond_pair_bwd_tf32_kernel<<<grid, kThreads, tsmem, s>>>(p, td);
  } else if (tensor_cores) {
    const int tsmem = 27 * kPStride * 4 + 2 * kYRows * kDPitch * 2 + 3 * (td + 4) * kXCols * 2;
    err = cudaFuncSetAttribute(cond_pair_bwd_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tsmem);
    if (err != cudaSuccess) return (int)err;
    cond_pair_bwd_tc_kernel<<<grid, kThreads, tsmem, s>>>(p, td);
  } else if (dtype == 0) {
    err = cudaFuncSetAttribute(cond_pair_bwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cond_pair_bwd_kernel<float><<<grid, kThreads, smem, s>>>(p);
  } else {
    err = cudaFuncSetAttribute(cond_pair_bwd_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cond_pair_bwd_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = k * kNV + 1;
  const int nred = (nblk + kChunk - 1) / kChunk;
  float* tmp = part + (int64_t)nblk * n;
  reduce_kernel<<<dim3((n + kThreads - 1) / kThreads, nred), kThreads, 0, s>>>(
      part, tmp, nblk, n, kChunk);
  reduce_kernel<<<dim3((n + kThreads - 1) / kThreads, 1), kThreads, 0, s>>>(
      tmp, grads, nred, n, nred);
  return (int)cudaGetLastError();
}
