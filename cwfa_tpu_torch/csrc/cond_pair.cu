// The condition nets' fused 3-D pair, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cwfa_tpu/ops/cond_pair.py:276
// (cond_pair_fused, via _run_slab):
//
//   y = PReLU(Conv3d(1 -> K, 3x3x3)(x) + b_a)        rounded to x's type
//   z = Conv3d(K -> 1, 3x3x3)(y) + b_b               rounded to x's type
//
// over (H, W, depth) of x (B, D, H, W): the kernel dims (kh, kw, kd) of both
// weights act on (H, W, depth), as nn.Conv3d does on the (B, 1, H, W, D)
// view.  SAME padding is zero padding in all three dims for both convs: y is
// zero outside the volume (not PReLU(b_a)).  Sums and epilogues are f32.
// The plain PyTorch version is cond_pair_reference in
// cwfa_tpu_torch/ops/cond_pair.py.
//
// Bound: f32 FMAs on the CUDA cores.  Each output voxel needs 27*K + K*27
// multiply-adds (1,728 at K = 32, ~3.5 kFLOP) against ~4 bytes of x and z
// moved in bf16, so the pair is far above the card's ~20 f32 FLOP per byte
// of device memory.  The TPU kernel's lane packing (depth % 4, slabs,
// pre-shifted canvases, block-placed weights) is not carried over.
//
// Design (a simple first version):
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

namespace {

constexpr int kTW = 32;                 // output tile width (W)
constexpr int kTH = 8;                  // output tile height (H)
constexpr int kThreads = kTW * kTH;     // one thread per output (h, w)
constexpr int kYW = kTW + 2, kYH = kTH + 2;
constexpr int kXW = kTW + 4, kXH = kTH + 4;
constexpr int kYCols = kYW * kYH;
constexpr int kXCols = kXW * kXH;
constexpr int kSmemMax = 232448;

struct Params {
  const void* x;      // (B, D, H, W)
  const void* wa;     // (K, 1, 3, 3, 3)
  const void* ba;     // (K)
  const void* wb;     // (1, K, 3, 3, 3)
  const void* bb;     // (1)
  const void* alpha;  // (1)
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
// 1 = bfloat16.
extern "C" int cwfa_cond_pair(const void* x, const void* wa, const void* ba,
                              const void* wb, const void* bb, const void* alpha,
                              void* z, int b, int d, int h, int w, int k,
                              int dtype, int device, void* stream) {
  if (b <= 0 || d <= 0 || h <= 0 || w <= 0 || k <= 0 || dtype < 0 || dtype > 1)
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
  p.z = z;
  p.D = d;
  p.H = h;
  p.W = w;
  p.K = k;
  p.nchunks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? dispatch<__nv_bfloat16>(p, b, s) : dispatch<float>(p, b, s);
}
