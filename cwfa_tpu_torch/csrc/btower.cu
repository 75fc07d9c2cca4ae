// The float subnet tower of the CWF coupling and input blocks on the CUDA
// cores of Hopper (sm_90a), in bf16 or f32: the instance for every tower
// width that csrc/btower_wg.cu (64 wide, on the warpgroup tensor cores) does
// not take, such as the small rig's 8-wide towers.
//
// Replaces the Pallas TPU kernel cwfa_tpu/ops/btower.py:235
// (fused_pair_tower_bf16), one tower per launch instead of a paired
// 128-wide one:
//
//   r1  = b1(x)                          1x1, Cin -> C
//   e2  = elu(b2b(elu(b2a(r1))) + r1)    3x3, 1x1, residual
//   e4  = elu(b4b(elu(b4a(e2))) + e2)
//   e6  = elu(b6b(elu(b6a(e4))) + e4)
//   out = b7(e6)                         3x3, C -> Nout
//
// Cast structure of pair_tower_bf16_reference (cwfa_tpu/ops/btower.py:291):
// every canvas between convs (x, r1, the 3x3 outputs, e2, e4, e6) is
// rounded to the canvas type T; sums, bias, ELU (exp(min(v, 0)) - 1) and
// the residual add are f32; the output is the f32 sum plus bias, rounded to
// T.  The plain PyTorch version is float_tower_reference in
// cwfa_tpu_torch/ops/btower.py.
//
// Bound: multiply-adds, as f32 FMAs (Cin*C + 3*(9*C*C + C*C) + 9*C*Nout per
// pixel against ~4 bytes in and ~Nout*4 bytes out); the 4-pixel halo adds
// 40-64% recomputed work.  The loop does one shared-memory load and one
// weight load per 8 FMAs, which is what holds it under the FMA rate; the
// 64-wide towers, where that mattered, left for the tensor cores.
// The TPU kernel's rows carried across its sequential grid, its 128-lane
// padding, its rolled canvases and the block-diagonal pairing (half of the
// paired MACs multiply zeros) are not carried over.
//
// Design:
//   - One block of 512 threads per (batch, TH x TW output tile), 16 x 16
//     for bf16 and 8 x 16 for f32.  The input window with its 4-pixel halo
//     is staged into shared memory; the layers then run on shrinking
//     canvases (halo 4 -> 3 -> 2 -> 1 -> 0) that keep one fixed geometry, so
//     a residual is read and written at the same address.  Two canvases: A
//     holds r1, e2, e4, e6 (each the residual of the next block), B holds x
//     and then each 3x3 output.
//   - Any tower width: the canvases are sized by the width (padded to a
//     multiple of 8; the padded channels have zero weights and biases, so
//     they stay 0 through ELU and the residual), and a width whose canvases
//     do not fit in shared memory at that tile takes a smaller tile (8 x 8,
//     then 4 x 4 for bf16; 4 x 8, then 2 x 4 for f32: up to 400 and 240
//     wide), at the price of a larger share of halo positions.
//   - A conv is an implicit GEMM: M = canvas positions, N = output
//     channels, K = taps x input channels.  Each warp owns 8 output channels
//     and 4 positions per lane (32 f32 sums per thread); a step reads two
//     channels of each position (one bf16x2 or float2 load) and the weights
//     of those two input channels for the 8 outputs (four float4 loads, the
//     same address for the whole warp) and does 64 FMAs.  Positions are
//     padded to a stride = 2 (mod 4) elements, so the lanes hit distinct
//     banks.
//   - The weights come from the pack of ops/btower.pack_float_tower, built
//     once per set of weights: per conv [tap][Cin][Cout] f32; the biases f32
//     beside it.
//   - SAME padding: every canvas that feeds a 3x3 conv (A) is written as 0 at
//     positions outside the image, so every conv sees the zero padding of
//     the plain version at the image border and at tile edges.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 4;             // total 3x3 halo of the four 3x3 convs
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNP = 4;               // positions per lane per work item
constexpr int kSmemMax = 232448;

struct Params {
  const void* x;       // (B, cin, H, W), T
  const float* wp;     // weight pack: w1 w2a w2b w4a w4b w6a w6b w7
  const float* bias;   // (7 * C + nout) f32: b1 b2a b2b b4a b4b b6a b6b b7
  void* out;           // (B, nout, H, W), T
  int woff[8];         // offset of each conv in the pack, in floats
  int H, W, cin, cinp, C, nout, ocp7;
  int rs, xs;          // canvas strides (elements per position): C-wide, input
  int a_bytes;         // bytes of canvas A (canvas B follows it)
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

// two consecutive channels of one position (the offset is even)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

__device__ __forceinline__ void fma8(float* acc, float a, const float4& w0,
                                     const float4& w1) {
  acc[0] = fmaf(a, w0.x, acc[0]);
  acc[1] = fmaf(a, w0.y, acc[1]);
  acc[2] = fmaf(a, w0.z, acc[2]);
  acc[3] = fmaf(a, w0.w, acc[3]);
  acc[4] = fmaf(a, w1.x, acc[4]);
  acc[5] = fmaf(a, w1.y, acc[5]);
  acc[6] = fmaf(a, w1.z, acc[6]);
  acc[7] = fmaf(a, w1.w, acc[7]);
}

// A K x K conv (K = 1 or 3) from the canvas `in` (`stride` elements per
// position, cinp input channels, even) into the outputs at canvas level
// `level` (rows [level, SH - level) and columns [level, SW - level) of the
// fixed geometry), with the packed weights `w` ([tap][cinp][ocp]) and ocp
// output channels (a multiple of 8).  epi(R, Cc, oc, acc) consumes each f32
// sum.
template <typename T, int TH, int TW, int K, typename Epi>
__device__ __forceinline__ void conv(const T* in, int stride, int cinp,
                                     const float* __restrict__ w, int ocp,
                                     int level, Epi epi) {
  constexpr int SH = TH + 2 * kHalo, SW = TW + 2 * kHalo;
  const int nc = SW - 2 * level;
  const int npos = (SH - 2 * level) * nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ngroups = ocp >> 3;
  const int nchunks = (npos + 32 * kNP - 1) / (32 * kNP);
  for (int item = warp; item < ngroups * nchunks; item += kWarps) {
    const int og = item % ngroups;
    const int chunk = item / ngroups;
    int base[kNP];
#pragma unroll
    for (int j = 0; j < kNP; ++j) {
      int p = chunk * 32 * kNP + j * 32 + lane;
      p = p < npos ? p : 0;
      base[j] = ((level + p / nc) * SW + level + p % nc) * stride;
    }
    float acc[kNP][8];
#pragma unroll
    for (int j = 0; j < kNP; ++j)
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[j][o] = 0.f;
    for (int t = 0; t < K * K; ++t) {
      const int off = K == 3 ? ((t / 3 - 1) * SW + (t % 3 - 1)) * stride : 0;
      const float* wt = w + t * cinp * ocp + og * 8;
#pragma unroll 2
      for (int ci = 0; ci < cinp; ci += 2) {
        const float4* w0 = reinterpret_cast<const float4*>(wt + ci * ocp);
        const float4* w1 = reinterpret_cast<const float4*>(wt + (ci + 1) * ocp);
        const float4 a0 = __ldg(w0), a1 = __ldg(w0 + 1);
        const float4 b0 = __ldg(w1), b1 = __ldg(w1 + 1);
#pragma unroll
        for (int j = 0; j < kNP; ++j) {
          const float2 v = load2(in + base[j] + off + ci);
          fma8(acc[j], v.x, a0, a1);
          fma8(acc[j], v.y, b0, b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNP; ++j) {
      const int p = chunk * 32 * kNP + j * 32 + lane;
      if (p >= npos) continue;
      const int R = level + p / nc, Cc = level + p % nc;
#pragma unroll
      for (int o = 0; o < 8; ++o) epi(R, Cc, og * 8 + o, acc[j][o]);
    }
  }
}


template <typename T, int TH, int TW>
__global__ void __launch_bounds__(kThreads, 1) btower_kernel(const Params p) {
  constexpr int SH = TH + 2 * kHalo, kSW = TW + 2 * kHalo;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ca = reinterpret_cast<T*>(smem);
  T* cb = reinterpret_cast<T*>(smem + p.a_bytes);

  const int C = p.C, RS = p.rs, XS = p.xs, H = p.H, W = p.W;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH - kHalo, c0 = blockIdx.x * TW - kHalo;
  auto inside = [=](int R, int Cc) {
    return (unsigned)(r0 + R) < (unsigned)H && (unsigned)(c0 + Cc) < (unsigned)W;
  };
  const T zero = from_f<T>(0.f);

  const float* bias = p.bias;

  // stage the input window (zero outside the image and for the channels
  // that pad Cin to cinp) into canvas B
  const T* x = static_cast<const T*>(p.x);
  for (int i = threadIdx.x; i < p.cinp * SH * kSW; i += kThreads) {
    const int ch = i / (SH * kSW), pix = i % (SH * kSW);
    const int R = pix / kSW, Cc = pix % kSW;
    T v = zero;
    if (ch < p.cin && inside(R, Cc))
      v = x[(((int64_t)b * p.cin + ch) * H + r0 + R) * W + c0 + Cc];
    cb[pix * XS + ch] = v;
  }
  __syncthreads();

  // b1 (1x1, level 0): r1 -> A
  conv<T, TH, TW, 1>(cb, XS, p.cinp, p.wp + p.woff[0], C, 0,
                 [&](int R, int Cc, int oc, float acc) {
    ca[(R * kSW + Cc) * RS + oc] = inside(R, Cc) ? from_f<T>(acc + bias[oc]) : zero;
  });

  // three residual blocks: 3x3 (A -> B), 1x1 + residual (B -> A)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int lv = k + 1;
    const float* wa = p.wp + p.woff[1 + 2 * k];
    const float* wb = p.wp + p.woff[2 + 2 * k];
    const float* ba = bias + (1 + 2 * k) * C;
    const float* bb = ba + C;
    __syncthreads();
    conv<T, TH, TW, 3>(ca, RS, C, wa, C, lv, [&](int R, int Cc, int oc, float acc) {
      cb[(R * kSW + Cc) * RS + oc] = from_f<T>(elu(acc + ba[oc]));
    });
    __syncthreads();
    conv<T, TH, TW, 1>(cb, RS, C, wb, C, lv, [&](int R, int Cc, int oc, float acc) {
      const int i = (R * kSW + Cc) * RS + oc;
      const float v = acc + bb[oc] + to_f(ca[i]);
      ca[i] = inside(R, Cc) ? from_f<T>(elu(v)) : zero;
    });
  }

  // b7 (3x3, level 4): the output, NCHW
  __syncthreads();
  const int nout = p.nout;
  const float* b7 = bias + 7 * C;
  conv<T, TH, TW, 3>(ca, RS, C, p.wp + p.woff[7], p.ocp7, kHalo,
                 [&](int R, int Cc, int oc, float acc) {
    if (oc >= nout || !inside(R, Cc)) return;
    const int64_t o = (((int64_t)b * nout + oc) * H + r0 + R) * W + c0 + Cc;
    static_cast<T*>(p.out)[o] = from_f<T>(acc + b7[oc]);
  });
}

int align16(int n) { return (n + 15) & ~15; }

constexpr int kTooWide = -1;   // the canvases of this tile exceed shared memory

template <typename T, int TH, int TW>
int launch(Params p, int b, cudaStream_t stream) {
  const int pix = (TH + 2 * kHalo) * (TW + 2 * kHalo);
  const int esz = (int)sizeof(T);
  p.a_bytes = align16(pix * p.rs * esz);
  const int64_t smem =
      p.a_bytes + (int64_t)align16(pix * (p.rs > p.xs ? p.rs : p.xs) * esz);
  if (smem > kSmemMax) return kTooWide;
  cudaError_t err = cudaFuncSetAttribute(
      btower_kernel<T, TH, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, b);
  btower_kernel<T, TH, TW><<<grid, kThreads, (int)smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The largest tile whose canvases fit.
template <typename T, int TH, int TW, int TH2, int TW2, int TH3, int TW3>
int launch_fitting(const Params& p, int b, cudaStream_t stream) {
  int rc = launch<T, TH, TW>(p, b, stream);
  if (rc == kTooWide) rc = launch<T, TH2, TW2>(p, b, stream);
  if (rc == kTooWide) rc = launch<T, TH3, TW3>(p, b, stream);
  return rc;
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

}  // namespace

// x and out: (B, cin, H, W) and (B, nout, H, W), dtype 0 = float32,
// 1 = bfloat16 (the canvas type);
// wp: the weight pack of ops/btower.pack_float_tower in the CUDA-core layout
// (f32 [tap][Cin][Cout], 16-byte aligned), bias: its (7 * c + nout) f32
// biases, both for the width padded to a multiple of 8.  Returns -1 for a
// width whose canvases exceed shared memory at the smallest tile.
extern "C" int cwfa_btower(const void* x, const void* wp, const void* bias,
                           void* out, int b, int h, int w, int cin, int c,
                           int nout, int dtype, int device, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || nout <= 0 || c <= 0 ||
      dtype < 0 || dtype > 1 || b > 65535 ||
      reinterpret_cast<uintptr_t>(wp) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.x = x;
  p.wp = static_cast<const float*>(wp);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.H = h;
  p.W = w;
  p.cin = cin;
  c = round_up(c, 8);
  p.C = c;
  p.nout = nout;
  p.a_bytes = 0;
  // padded input / output channel counts of the pack, and the canvas
  // strides: 2 (mod 4) elements for the FMA loads
  p.cinp = round_up(cin, 2);
  p.ocp7 = round_up(nout, 8);
  p.rs = c + 2;
  p.xs = p.cinp % 4 ? p.cinp : p.cinp + 2;
  // conv offsets: taps x padded inputs x padded outputs floats each
  const int taps[8] = {1, 9, 1, 9, 1, 9, 1, 9};
  int off = 0;
  for (int i = 0; i < 8; ++i) {
    p.woff[i] = off;
    off += taps[i] * (i == 0 ? p.cinp : c) * (i == 7 ? p.ocp7 : c);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_fitting<__nv_bfloat16, 16, 16, 8, 8, 4, 4>(p, b, s)
               : launch_fitting<float, 8, 16, 4, 8, 2, 4>(p, b, s);
}
