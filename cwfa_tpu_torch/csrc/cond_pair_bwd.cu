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
// Design: one block of 256 threads per (batch, 8 depths, 8 x 32 H x W tile),
// as the forward's CUDA-core instance.  x and dz with a 2-voxel halo are
// staged once into shared memory as f32, zero outside the volume.  For each
// intermediate channel k: pre_k and conv_b^T(dz)_k are recomputed over the
// tile and its 1-voxel halo (y never reaches device memory, as in the
// forward), y_k and dpre_k go to shared memory, then every thread adds the
// channel's conv_a^T term to the dx of its own (h, w) column and sums its
// column's 27 + 27 weight terms; the block's sums per channel (warp shuffles,
// then the 8 warps in a fixed order) go to a partial-sum buffer, and a
// second pass (two, above 64 blocks) sums the blocks in a fixed order.  No
// atomics: the result is the same from run to run.  CUDA-core FMAs; speed is
// later work.
//
// Bound at step 0 of the flagship (1, 48, 512, 512), K = 32: operations,
// 2 x 43.49 GFLOP, 0.088 ms on bf16 tensor cores, 1.30 ms on f32 FMAs.
//
// Plain C interface for ctypes (cwfa_tpu_torch/ops/cond_pair.py); launches
// on the caller's stream, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// 1 = bfloat16); scale: (B, K) f32 or null.  grads: f32, K * 56 + 1 floats:
// per channel k, [k * 56 + t] dW_a (t < 27), dW_b (27 + t), db_a (54),
// dalpha's share (55); then db_b.  part: cwfa_cond_pair_bwd_part floats.
extern "C" int cwfa_cond_pair_bwd(const void* x, const void* dz, const void* wa,
                                  const void* ba, const void* wb, const void* alpha,
                                  const float* scale, void* dx, float* grads,
                                  float* part, int b, int d, int h, int w, int k,
                                  int dtype, int device, void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || w <= 0 || k <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int nchunks;
  const int nblk = blocks_of(b, d, h, w, &nchunks);
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
  if (dtype == 0) {
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
