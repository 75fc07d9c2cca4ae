// The condition nets' fused 3-D pair, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cwfa_tpu/ops/cond_pair.py:276
// (cond_pair_fused, via _run_slab):
//
//   y = PReLU(Conv3d(1 -> K, 3x3x3)(x) + b_a)        rounded to x's type
//   y = y * m[b, k]                                  (training only) rounded
//   z = Conv3d(K -> 1, 3x3x3)(y) + b_b               rounded to x's type
//
// m is the Dropout3d of training (cwfa_tpu/models/cond_net.py:259-265): a
// per-(sample, channel) scale, 0 or 1/keep, f32; without one (inference)
// nothing is multiplied.  The backward is csrc/cond_pair_bwd.cu.
//
// over (H, W, depth) of x (B, D, H, W): the kernel dims (kh, kw, kd) of both
// weights act on (H, W, depth), as nn.Conv3d does on the (B, 1, H, W, D)
// view.  SAME padding is zero padding in all three dims for both convs: y is
// zero outside the volume (not PReLU(b_a)).  Sums and epilogues are f32.
// The plain PyTorch version is cond_pair_reference in
// cwfa_tpu_torch/ops/cond_pair.py.
//
// Bound: multiply-adds.  Each output voxel needs 27*K + K*27 of them (1,728
// at K = 32, ~3.5 kFLOP) against ~4 bytes of x and z moved in bf16, so the
// pair is far above the card's ~20 f32 FLOP per byte of device memory.  The
// TPU kernel's lane packing (depth % 4, slabs, pre-shifted canvases,
// block-placed weights) is not carried over.
//
// Three instances.  K = 32 runs both convs on the tensor cores, bf16
// (cond_pair_tc_kernel, below) or f32 as 3xTF32 (cond_pair_tf32_kernel);
// any other K runs on the CUDA cores (cond_pair_kernel).
//
// Design of the tensor-core instance:
//   - Both convs are products with K = 32 on one side.  conv_a is
//     (positions x 27 taps, padded to 32) . (32 x K): its A operand is the
//     3x3x3 neighbourhood of x, an im2col that exists only in registers (a
//     thread gathers its 16 values of a 16-position tile from the x window in
//     shared memory).  conv_b is (positions x K) . (K x 27 taps, padded to
//     32): every y position's contribution to each of its 27 neighbours,
//     f32; z is then the shift-and-add of those 27 planes on the CUDA cores,
//     27 adds per voxel in place of 864 FMAs.
//   - mma.sync (m16n8k16 bf16, f32 sums), not wgmma: the products are a few
//     percent of the work, which is in gathering conv_a's operand and in the
//     shift-and-add, so the tensor cores' rate does not matter; a warp walks
//     16-position tiles of a (8+2) x (32+2) y plane on its own (340
//     positions: 22 tiles of 16 where 64-row tiles would compute 384), both
//     weight matrices stay in registers as B fragments for the whole kernel,
//     and conv_a's sums, after bias, PReLU and the rounding to bf16 that the
//     contract asks for, are conv_b's A fragments as they sit: y never
//     leaves the registers, let alone reaches device memory.
//   - One block of 256 threads per (batch, depth chunk, 8 x 32 H x W tile).
//     x with its 2-voxel halo is staged once as bf16.  For each y depth
//     plane the warps write the 27 contribution planes to shared memory;
//     after a barrier every thread adds the 9 values of each depth tap to
//     the z sums of its own (h, w) column: three rolling sums, the plane's
//     depth tap dd feeding z at depth (plane - dd + 1).  The order of the
//     f32 adds is fixed, so the result does not change from run to run.  y
//     planes outside the volume are zero and are skipped.
//   - Products of bf16 values are exact in f32; only the order of the f32
//     sums differs from the plain version (its bound: 2^-7 max|ref|).
//
// Design of the f32 tensor-core instance (3xTF32; bound at step 0 of the
// flagship, (1, 48, 512, 512): 3 x 43.49 G TF32 operations, 0.264 ms, against
// 0.649 ms on f32 FMAs): the bf16 instance's structure with mma.sync
// m16n8k8 TF32 products, each operand split in registers into a TF32 high
// part and the remainder, hi*hi + hi*lo + lo*hi with f32 sums (mma_3x4,
// shared with the backward's f32 instance through cond_pair_tc.cuh).
//   - conv_a is the backward's pre product, the same gather, splits and
//     order, so that both compute the same pre to the bit; a pre within
//     2^-16 of 0 is summed again in tap order as the CUDA-core instances sum
//     it (the kink rule), so that every instance and the f64 reference
//     (ops/cond_pair.py cond_pair_f64) take the same side of PReLU's kink.
//   - y stays in registers.  A TF32 sum fragment holds channels 2 q, 2 q + 1
//     of its rows, the next product's A fragment wants K columns q and q + 4;
//     conv_b's K is the channel, a sum over which any order serves, so W_b is
//     packed with slot q of each k-step of 8 holding channel 2 q and slot
//     q + 4 channel 2 q + 1: the sum tile is then the A fragment as it sits,
//     split in registers (no plane of y in shared memory, no barrier).
//   - Shared memory: the 27 f32 contribution planes (38 KB), the split B
//     fragments of both weights (16 KB) and the f32 x window, (td + 4) x 12
//     x 36; depth chunks of at most 24 keep a block within 113 KB, so two
//     blocks (16 warps) share an SM.
//   - z is the shift-and-add of the bf16 instance, in f32, in the same fixed
//     order: the result does not change from run to run.
//
// Design of the CUDA-core instance:
//   - One block of 256 threads per (batch, depth chunk of TD, 8x32 H x W
//     tile).  x with its 2-voxel halo, (TD+4) x 12 x 36, is staged once
//     into shared memory as f32, zero outside the volume.
//   - A loop over the K intermediate channels: one channel of y over the
//     tile plus its 1-voxel halo, (TD+2) x 10 x 34, goes into shared memory
//     (zero outside the volume), then every thread adds that channel's
//     conv_b contribution to the TD z sums of its own (h, w) column, held in
//     registers.  y never reaches device memory: at batch 8 of step 0 it
//     would be a 6 GiB bf16 tensor.
//   - Both convs walk a column of depths with the channel's 27 weights in
//     registers, so each shared-memory value feeds up to three FMAs.
//   - The weights (2 * 27 * K + K floats) sit in shared memory; alpha and the
//     biases are read from device pointers (no host sync).
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cond_pair_tc.cuh"              // geometry, 3xTF32, the kink rule

namespace {

using namespace cpair;

constexpr int kSmemMax = 232448;

struct Params {
  const void* x;      // (B, D, H, W)
  const void* wa;     // (K, 1, 3, 3, 3)
  const void* ba;     // (K)
  const void* wb;     // (1, K, 3, 3, 3)
  const void* bb;     // (1)
  const void* alpha;  // (1)
  const float* scale; // (B, K) or null: the Dropout3d scale
  void* z;            // (B, D, H, W)
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

template <typename T, int TD>
__global__ void __launch_bounds__(kThreads) cond_pair_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                         // (TD+4, kXH, kXW)
  float* ys = xs + (TD + 4) * kXCols;       // (TD+2, kYH, kYW)
  float* swa = ys + (TD + 2) * kYCols;      // (K, 27)
  float* swb = swa + p.K * 27;              // (K, 27)
  float* sba = swb + p.K * 27;              // (K)

  const int D = p.D, H = p.H, W = p.W, K = p.K;
  const int b = blockIdx.z / p.nchunks;
  const int d0 = (blockIdx.z % p.nchunks) * TD;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const T* x = static_cast<const T*>(p.x) + (int64_t)b * D * H * W;

  for (int i = threadIdx.x; i < (TD + 4) * kXCols; i += kThreads) {
    const int dz = i / kXCols, rc = i % kXCols;
    const int d = d0 - 2 + dz, h = h0 - 2 + rc / kXW, w = w0 - 2 + rc % kXW;
    float v = 0.f;
    if (d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W)
      v = to_f(x[((int64_t)d * H + h) * W + w]);
    xs[i] = v;
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
  const float bias_b = to_f(*static_cast<const T*>(p.bb));

  const int zr = threadIdx.x / kTW, zc = threadIdx.x % kTW;
  float zacc[TD];
#pragma unroll
  for (int i = 0; i < TD; ++i) zacc[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    __syncthreads();  // x staged (k == 0) / the previous channel's y consumed
    float w[27];
#pragma unroll
    for (int i = 0; i < 27; ++i) w[i] = swa[k * 27 + i];
    const float bias_a = sba[k];
    const float sk = p.scale ? p.scale[b * K + k] : 1.f;
    // one channel of y over the tile and its 1-voxel halo
    for (int it = threadIdx.x; it < kYCols; it += kThreads) {
      const int r = it / kYW, c = it % kYW;
      float acc[TD + 2];
#pragma unroll
      for (int j = 0; j < TD + 2; ++j) acc[j] = 0.f;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float* col = xs + (r + dh) * kXW + c + dw;
#pragma unroll
          for (int dz = 0; dz < TD + 4; ++dz) {
            const float v = col[dz * kXCols];
#pragma unroll
            for (int dd = 0; dd < 3; ++dd) {
              const int j = dz - dd;
              if (j >= 0 && j < TD + 2) acc[j] = fmaf(w[dh * 9 + dw * 3 + dd], v, acc[j]);
            }
          }
        }
      const int h = h0 - 1 + r, ww = w0 - 1 + c;
      const bool in_hw = h >= 0 && h < H && ww >= 0 && ww < W;
#pragma unroll
      for (int j = 0; j < TD + 2; ++j) {
        const int d = d0 - 1 + j;
        float v = acc[j] + bias_a;
        v = v > 0.f ? v : alpha * v;
        v = to_f(from_f<T>(v));
        if (p.scale) v = to_f(from_f<T>(v * sk));
        ys[j * kYCols + it] = (in_hw && d >= 0 && d < D) ? v : 0.f;
      }
    }
    __syncthreads();
    // its conv_b contribution to this thread's z column
#pragma unroll
    for (int i = 0; i < 27; ++i) w[i] = swb[k * 27 + i];
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        const float* col = ys + (zr + dh) * kYW + zc + dw;
#pragma unroll
        for (int dz = 0; dz < TD + 2; ++dz) {
          const float v = col[dz * kYCols];
#pragma unroll
          for (int dd = 0; dd < 3; ++dd) {
            const int i = dz - dd;
            if (i >= 0 && i < TD) zacc[i] = fmaf(w[dh * 9 + dw * 3 + dd], v, zacc[i]);
          }
        }
      }
  }

  const int h = h0 + zr, w = w0 + zc;
  if (h >= H || w >= W) return;
  T* z = static_cast<T*>(p.z) + (int64_t)b * D * H * W;
#pragma unroll
  for (int i = 0; i < TD; ++i) {
    const int d = d0 + i;
    if (d < D) z[((int64_t)d * H + h) * W + w] = from_f<T>(zacc[i] + bias_b);
  }
}

// ---------------------------------------------------------------------------
// the tensor-core instance: bf16, K = 32
// ---------------------------------------------------------------------------

constexpr int kMaxTD = 48;              // depths per block

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p.nchunks depth chunks of td depths each.
__global__ void __launch_bounds__(kThreads, 2)
cond_pair_tc_kernel(const Params p, int td) {
  extern __shared__ __align__(16) float smem[];
  float* pbuf = smem;                                        // (27, kPStride)
  uint16_t* xs = reinterpret_cast<uint16_t*>(pbuf + 27 * kPStride);
                                                             // (td+4, kXH, kXW)
  const int D = p.D, H = p.H, W = p.W;
  const int b = blockIdx.z / p.nchunks;
  const int d0 = (blockIdx.z % p.nchunks) * td;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const uint16_t* x = static_cast<const uint16_t*>(p.x) + (int64_t)b * D * H * W;

  for (int i = threadIdx.x; i < (td + 4) * kXCols; i += kThreads) {
    const int dz = i / kXCols, rc = i % kXCols;
    const int d = d0 - 2 + dz, h = h0 - 2 + rc / kXW, w = w0 - 2 + rc % kXW;
    uint16_t v = 0;
    if (d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W)
      v = x[((int64_t)d * H + h) * W + w];
    xs[i] = v;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  // Both weight matrices as B fragments (k = 16 ks + 8 r + 2 q, + 1 in the
  // two halves of register r; n = 8 nt + g): conv_a's is [tap][channel],
  // conv_b's [channel][tap], the taps beyond 27 zero.
  const uint16_t* gwa = static_cast<const uint16_t*>(p.wa);
  const uint16_t* gwb = static_cast<const uint16_t*>(p.wb);
  uint32_t fa[2][4][2], fb[2][4][2];
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
        const uint32_t b_lo = n < 27 ? gwb[k0 * 27 + n] : 0;
        const uint32_t b_hi = n < 27 ? gwb[(k0 + 1) * 27 + n] : 0;
        fb[ks][nt][r] = b_lo | (b_hi << 16);
      }
  const __nv_bfloat16* gba = static_cast<const __nv_bfloat16*>(p.ba);
  float bias_a[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bias_a[nt][0] = __bfloat162float(gba[8 * nt + 2 * q]);
    bias_a[nt][1] = __bfloat162float(gba[8 * nt + 2 * q + 1]);
  }
  const float alpha = __bfloat162float(*static_cast<const __nv_bfloat16*>(p.alpha));
  const float bias_b = __bfloat162float(*static_cast<const __nv_bfloat16*>(p.bb));
  // the Dropout3d scale of this thread's channels (1: none)
  float sc[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      sc[nt][e] = p.scale ? p.scale[b * kK + 8 * nt + 2 * q + e] : 1.f;
  // offsets in the x window of this thread's taps of conv_a's A fragments
  // (tap t = 9 dh + 3 dw + dd; -1: one of the 5 that pad 27 to 32)
  int aoff[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 16 * ks + 8 * r + 2 * q + e;
        aoff[ks][r][e] = tap_off(t);
      }

  const int zr = threadIdx.x / kTW, zc = threadIdx.x % kTW;
  const int zh = h0 + zr, zw = w0 + zc;
  uint16_t* z = static_cast<uint16_t*>(p.z) + (int64_t)b * D * H * W;
  float z2 = 0.f, z1 = 0.f, z0 = 0.f;   // z at depths plane - 1, plane, plane + 1

  __syncthreads();
  for (int j = 0; j < td + 2; ++j) {
    const int dj = d0 - 1 + j;          // this y plane's depth
    const bool live = dj >= 0 && dj < D;
    if (live) {
      for (int tile = warp; tile < kYTiles; tile += kThreads / 32) {
        int base[2];
        bool in[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = 16 * tile + g + 8 * h;
          const int r = pos < kYCols ? pos / kYW : 0, c = pos < kYCols ? pos % kYW : 0;
          base[h] = j * kXCols + r * kXW + c;
          const int yh = h0 - 1 + r, yw = w0 - 1 + c;
          in[h] = pos < kYCols && yh >= 0 && yh < H && yw >= 0 && yw < W;
        }
        // conv_a: the im2col fragments, gathered from the x window
        uint32_t a[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t lo = aoff[ks][r][0] >= 0 ? xs[base[h] + aoff[ks][r][0]] : 0;
              const uint32_t hi = aoff[ks][r][1] >= 0 ? xs[base[h] + aoff[ks][r][1]] : 0;
              a[ks][2 * r + h] = lo | (hi << 16);
            }
        float y[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) y[nt][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) mma_bf16(y[nt], a[ks], fa[ks][nt][0], fa[ks][nt][1]);
        }
        // bias, PReLU, round to bf16, zero outside the volume: conv_a's sums
        // of the channel tiles 2 ks, 2 ks + 1 are conv_b's A fragment ks
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = y[nt][2 * h] + bias_a[nt][0], v1 = y[nt][2 * h + 1] + bias_a[nt][1];
            v0 = v0 > 0.f ? v0 : alpha * v0;
            v1 = v1 > 0.f ? v1 : alpha * v1;
            if (p.scale) {
              v0 = __bfloat162float(__float2bfloat16_rn(v0)) * sc[nt][0];
              v1 = __bfloat162float(__float2bfloat16_rn(v1)) * sc[nt][1];
            }
            a[nt >> 1][2 * (nt & 1) + h] = in[h] ? pack2(v0, v1) : 0u;
          }
        // conv_b: every position's contribution to its 27 neighbours
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) y[nt][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) mma_bf16(y[nt], a[ks], fb[ks][nt][0], fb[ks][nt][1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = 8 * nt + 2 * q + e;
            if (t < 27) {
              pbuf[t * kPStride + 16 * tile + g] = y[nt][e];
              pbuf[t * kPStride + 16 * tile + g + 8] = y[nt][2 + e];
            }
          }
        }
      }
    }
    __syncthreads();
    if (live) {
      // y at depth dj reaches z at depth dj - dd + 1 through depth tap dd
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float* c = pbuf + (9 * dh + 3 * dw) * kPStride + (zr + dh) * kYW + zc + dw;
          z0 += c[0];
          z1 += c[kPStride];
          z2 += c[2 * kPStride];
        }
    }
    const int dzo = dj - 1;             // z2 is complete
    if (j >= 2 && dzo < D && zh < H && zw < W) {
      const __nv_bfloat16 v = __float2bfloat16_rn(z2 + bias_b);
      z[((int64_t)dzo * H + zh) * W + zw] = *reinterpret_cast<const uint16_t*>(&v);
    }
    z2 = z1;
    z1 = z0;
    z0 = 0.f;
    __syncthreads();
  }
}

int launch_tc(const Params& p0, int b, cudaStream_t stream) {
  Params p = p0;
  p.nchunks = (p.D + kMaxTD - 1) / kMaxTD;
  const int td = (p.D + p.nchunks - 1) / p.nchunks;
  const int smem = 27 * kPStride * 4 + (td + 4) * kXCols * 2;
  if ((int64_t)b * p.nchunks > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cond_pair_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + kTW - 1) / kTW, (p.H + kTH - 1) / kTH, b * p.nchunks);
  cond_pair_tc_kernel<<<grid, kThreads, smem, stream>>>(p, td);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core instance in f32: 3xTF32, K = 32
// ---------------------------------------------------------------------------

// Floats of its shared memory besides the x window: the 27 contribution
// planes and the two weights' split B fragments.
constexpr int kTf32Fixed = 27 * kPStride + 2 * 16 * 32 * 4;

// p.nchunks depth chunks of td depths each (ops/cond_pair.py pair_plan).
__global__ void __launch_bounds__(kThreads, 2)
cond_pair_tf32_kernel(const Params p, int td) {
  extern __shared__ __align__(16) float smem[];
  float* pbuf = smem;                                            // (27, kPStride)
  uint4* wfr = reinterpret_cast<uint4*>(pbuf + 27 * kPStride);   // [2][ks][nt][lane]
  float* xs = reinterpret_cast<float*>(wfr + 2 * 16 * 32);       // (td+4, kXH, kXW)
  const int D = p.D, H = p.H, W = p.W;
  const int b = blockIdx.z / p.nchunks;
  const int d0 = (blockIdx.z % p.nchunks) * td;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const float* x = static_cast<const float*>(p.x) + (int64_t)b * D * H * W;

  for (int i = threadIdx.x; i < (td + 4) * kXCols; i += kThreads) {
    const int dz = i / kXCols, rc = i % kXCols;
    const int d = d0 - 2 + dz, h = h0 - 2 + rc / kXW, w = w0 - 2 + rc % kXW;
    xs[i] = d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W
                ? x[((int64_t)d * H + h) * W + w]
                : 0.f;
  }
  const float* gwa = static_cast<const float*>(p.wa);
  const float* gwb = static_cast<const float*>(p.wb);
  // B fragments (k = 8 ks + q, + 4; n = 8 nt + g), split: 0: conv_a's
  // W_a, [tap][channel], as the backward's pre product reads it; 1:
  // conv_b's W_b, [channel slot][tap], slot q of k-step ks channel
  // 8 ks + 2 q and slot q + 4 channel 8 ks + 2 q + 1 (the order in which
  // conv_a's sums sit in a thread, below); the taps beyond 27 zero
  for (int i = threadIdx.x; i < 2 * 16 * 32; i += kThreads) {
    const int mat = i / 512, ks = (i / 128) % 4, nt = (i / 32) % 4, l = i % 32;
    const int n = 8 * nt + (l >> 2);
    uint32_t hi[2], lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = 8 * ks + (l & 3) + 4 * r;
      float v = 0.f;
      if (mat == 0 && k < 27) v = gwa[n * 27 + k];
      if (mat == 1 && n < 27) v = gwb[(8 * ks + 2 * (l & 3) + r) * 27 + n];
      split_tf32(v, hi[r], lo[r]);
    }
    wfr[i] = make_uint4(hi[0], hi[1], lo[0], lo[1]);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const float* gba = static_cast<const float*>(p.ba);
  float bias_a[4][2], sc[4][2];         // channel 8 nt + 2 q + e
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bias_a[nt][e] = gba[8 * nt + 2 * q + e];
      sc[nt][e] = p.scale ? p.scale[b * kK + 8 * nt + 2 * q + e] : 1.f;
    }
  const float alpha = *static_cast<const float*>(p.alpha);
  const float bias_b = *static_cast<const float*>(p.bb);
  int aoff[4][2];                       // taps 8 ks + q and + 4 of the im2col
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 2; ++r) aoff[ks][r] = tap_off(8 * ks + q + 4 * r);

  const int zr = threadIdx.x / kTW, zc = threadIdx.x % kTW;
  const int zh = h0 + zr, zw = w0 + zc;
  float* z = static_cast<float*>(p.z) + (int64_t)b * D * H * W;
  float z2 = 0.f, z1 = 0.f, z0 = 0.f;   // z at depths plane - 1, plane, plane + 1

  __syncthreads();
  for (int j = 0; j < td + 2; ++j) {
    const int dj = d0 - 1 + j;          // this y plane's depth
    const bool live = dj >= 0 && dj < D;
    if (live) {
      for (int tile = warp; tile < kYTiles; tile += kThreads / 32) {
        int base[2];
        bool in[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = 16 * tile + g + 8 * h;
          const int r = pos < kYCols ? pos / kYW : 0, c = pos < kYCols ? pos % kYW : 0;
          base[h] = j * kXCols + r * kXW + c;
          const int yh = h0 - 1 + r, yw = w0 - 1 + c;
          in[h] = pos < kYCols && yh >= 0 && yh < H && yw >= 0 && yw < W;
        }
        // conv_a: pre = the im2col of x (a0: position g, tap 8 ks + q; a1:
        // position g + 8; a2, a3: tap + 4) . W_a, as the backward sums it
        float pre[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pre[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = aoff[ks][r];
              split_tf32(o >= 0 ? xs[base[h] + o] : 0.f, ah[2 * r + h], al[2 * r + h]);
            }
          uint4 bw[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) bw[nt] = wfr[(ks * 4 + nt) * 32 + lane];
          mma_3x4(pre, ah, al, bw);
        }
        // pre + b_a; near the kink (rare: a warp with none skips the loop),
        // summed again as the CUDA-core instances sum it
        bool kink = false;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pre[nt][i] += bias_a[nt][i & 1];
            kink |= near_kink(pre[nt][i]);
          }
        if (__any_sync(0xffffffffu, kink)) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (near_kink(pre[nt][i]))
                pre[nt][i] = f32_pre_f(xs, base[i >> 1], gwa, 8 * nt + 2 * q + (i & 1),
                                       bias_a[nt][i & 1]);
        }
        // conv_b: y = PReLU(pre), times the scale, zero outside the volume.
        // Sum tile ks of conv_a (channels 8 ks + 2 q, + 1 of rows g, g + 8)
        // is, in the order of W_b's pack, conv_b's A fragment of k-step ks:
        // a0 = (g, slot q), a1 = (g + 8, slot q), a2, a3 = slot q + 4.  y
        // never leaves the registers.
        float cc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) cc[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = pre[ks][i];
            float yy = v > 0.f ? v : alpha * v;
            if (p.scale) yy *= sc[ks][i & 1];
            y[i] = in[i >> 1] ? yy : 0.f;
          }
          uint32_t ah[4], al[4];
          split_tf32(y[0], ah[0], al[0]);
          split_tf32(y[2], ah[1], al[1]);
          split_tf32(y[1], ah[2], al[2]);
          split_tf32(y[3], ah[3], al[3]);
          uint4 bw[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) bw[nt] = wfr[((4 + ks) * 4 + nt) * 32 + lane];
          mma_3x4(cc, ah, al, bw);
        }
        // every position's contribution to its 27 neighbours
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
      // y at depth dj reaches z at depth dj - dd + 1 through depth tap dd
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float* c = pbuf + (9 * dh + 3 * dw) * kPStride + (zr + dh) * kYW + zc + dw;
          z0 += c[0];
          z1 += c[kPStride];
          z2 += c[2 * kPStride];
        }
    }
    const int dzo = dj - 1;             // z2 is complete
    if (j >= 2 && dzo < D && zh < H && zw < W) z[((int64_t)dzo * H + zh) * W + zw] = z2 + bias_b;
    z2 = z1;
    z1 = z0;
    z0 = 0.f;
    __syncthreads();
  }
}

int launch_tf32(const Params& p0, int b, int td, cudaStream_t stream) {
  Params p = p0;
  if (td <= 0) return (int)cudaErrorInvalidValue;
  p.nchunks = (p.D + td - 1) / td;
  const int smem = (kTf32Fixed + (td + 4) * kXCols) * 4;
  if (smem > kSmemMax || (int64_t)b * p.nchunks > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cond_pair_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + kTW - 1) / kTW, (p.H + kTH - 1) / kTH, b * p.nchunks);
  cond_pair_tf32_kernel<<<grid, kThreads, smem, stream>>>(p, td);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the CUDA-core instance
// ---------------------------------------------------------------------------

template <typename T, int TD>
int launch(const Params& p0, int b, cudaStream_t stream) {
  Params p = p0;
  p.nchunks = (p.D + TD - 1) / TD;
  const int smem = ((TD + 4) * kXCols + (TD + 2) * kYCols + p.K * 55) * 4;
  if (smem > kSmemMax || (int64_t)b * p.nchunks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cond_pair_kernel<T, TD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + kTW - 1) / kTW, (p.H + kTH - 1) / kTH, b * p.nchunks);
  cond_pair_kernel<T, TD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The depth chunk: at most 16 depths; chunks of equal size rounded up to
// one of the compiled chunk sizes (D = 48 -> 3 x 16, 24 -> 2 x 12, 6 -> 8).
template <typename T>
int dispatch(const Params& p, int b, cudaStream_t stream) {
  const int nchunks = (p.D + 15) / 16;
  const int per = (p.D + nchunks - 1) / nchunks;
  if (per <= 4) return launch<T, 4>(p, b, stream);
  if (per <= 8) return launch<T, 8>(p, b, stream);
  if (per <= 12) return launch<T, 12>(p, b, stream);
  return launch<T, 16>(p, b, stream);
}

}  // namespace

// x, z: (B, D, H, W); wa (K, 1, 3, 3, 3), ba (K), wb (1, K, 3, 3, 3), bb (1),
// alpha (1), all contiguous and of x's type: dtype 0 = float32,
// 1 = bfloat16; scale: (B, K) f32 or null.  instance 0: the CUDA-core
// instance; 1: the tensor-core instance in bf16 (bfloat16, k = 32); 2: in
// f32 as 3xTF32 (float32, k = 32) with depth chunks of td (the others
// ignore td).
extern "C" int cwfa_cond_pair(const void* x, const void* wa, const void* ba,
                              const void* wb, const void* bb, const void* alpha,
                              const float* scale, void* z, int b, int d, int h, int w, int k,
                              int dtype, int instance, int td, int device,
                              void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || w <= 0 || k <= 0 || dtype < 0 || dtype > 1 ||
      instance < 0 || instance > 2 || (instance && (dtype != 2 - instance || k != kK)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.x = x;
  p.wa = wa;
  p.ba = ba;
  p.wb = wb;
  p.bb = bb;
  p.alpha = alpha;
  p.scale = scale;
  p.z = z;
  p.D = d;
  p.H = h;
  p.W = w;
  p.K = k;
  p.nchunks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 1) return launch_tc(p, b, s);
  if (instance == 2) return launch_tf32(p, b, td, s);
  return dtype ? dispatch<__nv_bfloat16>(p, b, s) : dispatch<float>(p, b, s);
}
