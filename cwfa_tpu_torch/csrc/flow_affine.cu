// Flow-affine kernels of the CWF reverse chain, for Hopper (sm_90a).
//
// Replace the two Pallas TPU kernels of cwfa_tpu/ops/pallas_flow.py:
//   cwfa_cat_affine          <- cat_affine         (pallas_flow.py:138)
//   cwfa_haar_merge_affine   <- haar_merge_affine  (pallas_flow.py:118)
//
// Bound: both are elementwise with a few flops per element, so device-memory
// bytes bound them.  At bf16, cat_affine moves 8 bytes per element (read x,
// s_raw and t, write y) and haar_merge_affine 12 bytes per input element
// (read z, s_raw, t and avg, write two outputs).
//
// Design: one pass over the data in a grid-stride loop.
//   - s_raw and t are read in place from the coupling tower's contiguous
//     (B, 2C, H, W) output at channel offsets 0 and C, so the two
//     non-contiguous halves are never copied.
//   - The soft clamp s = clamp * f(s_raw) is fused in (Pallas TPU has no atan,
//     so the TPU path clamped in a separate XLA pass and stored s).
//   - Math is f32; storage is f32 or bf16 (round-to-nearest-even on store).
//     Products and sums use the _rn intrinsics, which the compiler does not
//     contract into FMAs, so the kernel rounds where the plain PyTorch
//     version rounds and the two agree to the bit in f32 (an FMA moves
//     outputs near a cancellation across a bf16 rounding boundary).
//   - haar_merge_affine takes t with a batch stride of 0 or C*H*W: its t is
//     -c_mean/sqrt(2) from a batch-1 mean cache, expanded over the batch.
//
// Plain C interface for ctypes (cwfa_tpu_torch/ops/flow_affine.py); each entry
// launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSqrt2Inv = 0.70710678118654752440f;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Activation codes follow CLAMP_ACTIVATIONS in cwfa_tpu_torch/flow/coupling.py.
__device__ __forceinline__ float soft_clamp(float u, float clamp, int act) {
  float f;
  if (act == 0) {
    f = 0.636f * atanf(u);
  } else if (act == 1) {
    f = tanhf(u);
  } else {
    f = 2.0f * (1.0f / (1.0f + expf(-u)) - 0.5f);
  }
  return clamp * f;
}

template <typename T>
__global__ void cat_affine_kernel(const T* __restrict__ x, const T* __restrict__ st,
                                  T* __restrict__ y, int64_t n, int64_t chw,
                                  float clamp, int act, int rev) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t b = i / chw;
    const int64_t js = i + b * chw;  // s_raw at (b, c) of (B, 2C, H, W); t at +C*H*W
    const float s = soft_clamp(load_f(st, js), clamp, act);
    const float t = load_f(st, js + chw);
    const float xv = load_f(x, i);
    store_f(y, i, rev ? __fmul_rn(__fsub_rn(xv, t), expf(-s))
                      : __fadd_rn(__fmul_rn(expf(s), xv), t));
  }
}

template <typename T>
__global__ void haar_merge_affine_kernel(const T* __restrict__ z, const T* __restrict__ s_raw,
                                         const T* __restrict__ t, const T* __restrict__ avg,
                                         T* __restrict__ out, int64_t n, int64_t chw,
                                         int64_t hw, int64_t t_bstride, float clamp,
                                         int act) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t b = i / chw;
    const int64_t r = i - b * chw;
    const int64_t c = r / hw;
    const int64_t p = r - c * hw;
    const float s = soft_clamp(load_f(s_raw, i), clamp, act);
    const float d = __fmul_rn(__fsub_rn(load_f(z, i), load_f(t, b * t_bstride + r)),
                              expf(-s));
    const float a = load_f(avg, i);
    const int64_t o = b * 2 * chw + 2 * c * hw + p;  // out[:, 2c] and out[:, 2c+1]
    store_f(out, o, __fmul_rn(__fadd_rn(a, d), kSqrt2Inv));
    store_f(out, o + hw, __fmul_rn(__fsub_rn(a, d), kSqrt2Inv));
  }
}

int64_t n_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  act: 0 ATAN, 1 TANH, 2 SIGMOID.
extern "C" int cwfa_cat_affine(const void* x, const void* st, void* y, int64_t b,
                               int64_t c, int64_t hw, float clamp, int act, int rev,
                               int dtype, int device, void* stream) {
  if (act < 0 || act > 2 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t chw = c * hw;
  const int64_t n = b * chw;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_blocks(n));
  if (dtype == 0) {
    cat_affine_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(st),
        static_cast<float*>(y), n, chw, clamp, act, rev);
  } else {
    cat_affine_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(st),
        static_cast<__nv_bfloat16*>(y), n, chw, clamp, act, rev);
  }
  return (int)cudaGetLastError();
}

extern "C" int cwfa_haar_merge_affine(const void* z, const void* s_raw, const void* t,
                                      const void* avg, void* out, int64_t b, int64_t c,
                                      int64_t hw, int64_t t_bstride, float clamp, int act,
                                      int dtype, int device, void* stream) {
  if (act < 0 || act > 2 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t chw = c * hw;
  const int64_t n = b * chw;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)n_blocks(n));
  if (dtype == 0) {
    haar_merge_affine_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(s_raw),
        static_cast<const float*>(t), static_cast<const float*>(avg),
        static_cast<float*>(out), n, chw, hw, t_bstride, clamp, act);
  } else {
    haar_merge_affine_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(s_raw),
        static_cast<const __nv_bfloat16*>(t), static_cast<const __nv_bfloat16*>(avg),
        static_cast<__nv_bfloat16*>(out), n, chw, hw, t_bstride, clamp, act);
  }
  return (int)cudaGetLastError();
}
