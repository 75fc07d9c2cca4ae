// The int8 subnet tower of the CWF coupling blocks on the CUDA cores of
// Hopper (sm_90a), with __dp4a: the instance for every tower width that
// csrc/qtower_wg.cu (64 wide, on the warpgroup tensor cores) does not take.
//
// Replaces the Pallas TPU kernel cwfa_tpu/ops/qtower.py:454
// (fused_pair_tower), one tower per launch instead of a paired 128-wide
// one:
//
//   r1  = b1(x)                          1x1, Cin -> C
//   e2  = elu(b2b(elu(b2a(r1))) + r1)    3x3, 1x1, residual
//   e4  = elu(b4b(elu(b4a(e2))) + e2)
//   e6  = elu(b6b(elu(b6a(e4))) + e4)
//   out = b7(e6)                         3x3, C -> Nout
//
// Every conv input is quantized to int8 per channel (v * inv_scale, round
// half to even, clip to +-127), every product accumulates in int32, and every
// epilogue (dequant, bias, ELU, requant, residual) runs in f32.  The residual
// canvases r1, e2, e4 are bf16, as on the TPU.  The plain PyTorch version is
// quantized_tower_reference in cwfa_tpu_torch/ops/qtower.py.
//
// Bound: int8 operations.  At the flagship widths the 16 coupling towers of
// one 512^2 frame need about 1.26 T int8 operations (Cin*64 + 3*(9*64*64 +
// 64*64) + 9*64*Nout multiply-adds per pixel, summed over Cin = 48/24/12/6)
// while they read ~94 MB of int8 input and write ~0.38 GB of bf16 output:
// ~2,700 operations per byte, far above the card's ~590 int8 operations per
// byte of device memory, so the kernel is bound by its multiply-add rate and
// by the shared-memory traffic that feeds it, not by device memory.
//
// Design:
//   - One block per (batch, 16x16 output tile).  The int8 input window with
//     its 4-pixel halo (24x24) is staged into shared memory; the layers then
//     run on shrinking canvases (24 -> 22 -> 20 -> 18 -> 16) that keep one
//     fixed 24x24 geometry, so a residual is read and written at the same
//     address.  Only the int8 input and the (s_raw|t) output touch device
//     memory; activations stay in shared memory: two int8 canvases (the conv
//     input and the 3x3 output) and one bf16 residual canvas, ~154 KB at
//     C = 64, plus the current layer's weights (<= 55 KB), so one block of
//     512 threads per SM, dynamic shared memory above 48 KB.
//   - Products are __dp4a: a 32-bit word holds 4 channels of one position
//     (activations) or 4 input channels of one output channel (weights, in
//     the (taps, ceil(I/4), ceil8(O), 4) layout).  Cin is zero-padded to a
//     multiple of 4.  Each warp owns 8 output channels (weights broadcast to
//     the warp) and 4 positions per lane (32 accumulators per thread).
//     Canvas rows per position are padded by one word so lanes on
//     neighbouring positions hit distinct banks.
//   - SAME padding: after every quantization, canvas positions outside the
//     image are set to 0, so every conv sees the zero padding of the plain
//     version at the image border and at tile edges.
//   - Epilogues use __fmul_rn/__fadd_rn (never contracted to FMAs), expf and
//     rintf, without --use_fast_math: each result is re-quantized, and an FMA
//     where the plain version rounds twice would flip int8 levels.
//   - Any tower width: the caller pads the width to a multiple of 8 (zero
//     weights, scales and biases: the padded channels stay 0), the canvases
//     are sized by the width, and a width whose canvases do not fit in shared
//     memory takes a smaller tile (8x8, then 4x4: up to 400 wide).  Where the
//     largest conv's weights do not fit beside the canvases (above 72 wide)
//     the convs read them from device memory instead of staging them.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 4;            // total 3x3 halo of the four 3x3 convs
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNP = 4;              // positions per lane per work item
constexpr int kSmemMax = 232448;

struct Params {
  const int8_t* x;       // (B, cin, H, W)
  const int8_t* w[8];    // b1, b2a, b2b, b4a, b4b, b6a, b6b, b7 (dp4a layout)
  const float* inv;      // (8, C) reciprocal activation scales
  const float* sw;       // (7, C) dequant scales of b1..b6b
  const float* bias;     // (7, C)
  const float* sw7;      // (nout)
  const float* bias7;    // (nout)
  void* out;             // (B, nout, H, W), f32 or bf16
  int H, W, cin, cin4, C, nout, nout8, out_bf16;
  int res_stride, q_stride, x_stride;  // elements/bytes per canvas position
  int res_bytes, qa_bytes, qb_bytes;
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : __fsub_rn(expf(fminf(v, 0.f)), 1.f);
}

__device__ __forceinline__ int8_t quant(float v, float inv) {
  return (int8_t)(int)fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
}

__device__ __forceinline__ float deq(int acc, float sw, float b) {
  return __fadd_rn(__fmul_rn((float)acc, sw), b);
}

// Copy one conv's weights (bytes % 16 == 0) into shared memory.
__device__ __forceinline__ void stage(int* dst, const int8_t* src, int bytes) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) d[i] = __ldg(s + i);
}

// A K x K conv (K = 1 or 3) from the int8 canvas `in` (stride bytes per
// position, ci4 words of 4 channels) into the outputs at canvas level
// `level` (positions [level, kS - level)^2 of the fixed geometry of side
// kS), with the weights `w` (in shared memory, or in device memory where
// they were not staged), ocp output channels (a multiple of 8).
// epi(R, Cc, oc, acc) consumes each int32 sum.
template <int K, int kS, typename Epi>
__device__ __forceinline__ void conv(const int8_t* in, int stride, int ci4,
                                     const int* w, int ocp, int level, Epi epi) {
  const int n = kS - 2 * level;
  const int npos = n * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ngroups = ocp >> 3;
  const int nchunks = (npos + 32 * kNP - 1) / (32 * kNP);
  const int wrow = ocp >> 2;  // int4 per (tap, ci4) row of weights
  for (int item = warp; item < ngroups * nchunks; item += kWarps) {
    const int og = item % ngroups;
    const int chunk = item / ngroups;
    int base[kNP];
    for (int j = 0; j < kNP; ++j) {
      int p = chunk * 32 * kNP + j * 32 + lane;
      p = p < npos ? p : 0;
      base[j] = ((level + p / n) * kS + level + p % n) * stride;
    }
    int acc[kNP][8];
    for (int j = 0; j < kNP; ++j)
      for (int o = 0; o < 8; ++o) acc[j][o] = 0;
    for (int t = 0; t < K * K; ++t) {
      const int off = K == 3 ? ((t / 3 - 1) * kS + (t % 3 - 1)) * stride : 0;
      const int4* wt = reinterpret_cast<const int4*>(w + t * ci4 * ocp + og * 8);
      for (int g = 0; g < ci4; ++g) {
        const int4 wa = wt[g * wrow];
        const int4 wb = wt[g * wrow + 1];
        for (int j = 0; j < kNP; ++j) {
          const int a = *reinterpret_cast<const int*>(in + base[j] + off + 4 * g);
          acc[j][0] = __dp4a(a, wa.x, acc[j][0]);
          acc[j][1] = __dp4a(a, wa.y, acc[j][1]);
          acc[j][2] = __dp4a(a, wa.z, acc[j][2]);
          acc[j][3] = __dp4a(a, wa.w, acc[j][3]);
          acc[j][4] = __dp4a(a, wb.x, acc[j][4]);
          acc[j][5] = __dp4a(a, wb.y, acc[j][5]);
          acc[j][6] = __dp4a(a, wb.z, acc[j][6]);
          acc[j][7] = __dp4a(a, wb.w, acc[j][7]);
        }
      }
    }
    for (int j = 0; j < kNP; ++j) {
      const int p = chunk * 32 * kNP + j * 32 + lane;
      if (p >= npos) continue;
      const int R = level + p / n, Cc = level + p % n;
      for (int o = 0; o < 8; ++o) epi(R, Cc, og * 8 + o, acc[j][o]);
    }
  }
}

// kT: the output tile's side; STAGED: each conv's weights are copied to
// shared memory before its products.
template <int kT, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1) qtower_kernel(const Params p) {
  constexpr int kS = kT + 2 * kHalo;   // canvas side
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* res = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* qa = reinterpret_cast<int8_t*>(smem + p.res_bytes);
  int8_t* qb = qa + p.qa_bytes;
  int* wbuf = reinterpret_cast<int*>(qb + p.qb_bytes);

  const int C = p.C, RS = p.res_stride, QS = p.q_stride, XS = p.x_stride;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kT - kHalo, c0 = blockIdx.x * kT - kHalo;
  const int H = p.H, W = p.W;
  auto inside = [=](int R, int Cc) {
    return (unsigned)(r0 + R) < (unsigned)H && (unsigned)(c0 + Cc) < (unsigned)W;
  };
  const float* inv = p.inv;
  const float* sw = p.sw;
  const float* bias = p.bias;

  // stage the int8 input window (zero outside the image and for the
  // channels that pad Cin to a multiple of 4) into qb
  const int cinp = p.cin4 * 4;
  for (int i = threadIdx.x; i < cinp * kS * kS; i += kThreads) {
    const int ch = i / (kS * kS), pix = i % (kS * kS);
    const int R = pix / kS, Cc = pix % kS;
    int8_t v = 0;
    if (ch < p.cin && inside(R, Cc))
      v = p.x[(((int64_t)b * p.cin + ch) * H + r0 + R) * W + c0 + Cc];
    qb[pix * XS + ch] = v;
  }
  // conv i's weights, after a barrier that ends the conv before it
  auto weights = [&](int i, int bytes) -> const int* {
    __syncthreads();
    if (!STAGED) return reinterpret_cast<const int*>(p.w[i]);
    stage(wbuf, p.w[i], bytes);
    __syncthreads();
    return wbuf;
  };

  // b1 (1x1, level 0): r1 -> bf16 residual canvas, q1 -> qa
  const int* w1 = weights(0, p.cin4 * C * 4);
  conv<1, kS>(qb, XS, p.cin4, w1, C, 0, [&](int R, int Cc, int oc, int acc) {
    const int pix = R * kS + Cc;
    const __nv_bfloat16 r = __float2bfloat16_rn(deq(acc, sw[oc], bias[oc]));
    res[pix * RS + oc] = r;
    qa[pix * QS + oc] = inside(R, Cc) ? quant(__bfloat162float(r), inv[C + oc]) : 0;
  });

  const int c4 = C / 4;
  // three residual blocks: 3x3 (qa -> qb), 1x1 + residual (qb -> qa)
  for (int k = 0; k < 3; ++k) {
    const int lv = k + 1;
    const int ka = 1 + 2 * k, kb = 2 + 2 * k;  // sw/bias rows of bXa, bXb
    const int* wa = weights(ka, 9 * c4 * C * 4);
    conv<3, kS>(qa, QS, c4, wa, C, lv, [&](int R, int Cc, int oc, int acc) {
      const float v = elu(deq(acc, sw[ka * C + oc], bias[ka * C + oc]));
      qb[(R * kS + Cc) * QS + oc] =
          inside(R, Cc) ? quant(v, inv[(ka + 1) * C + oc]) : 0;
    });
    const int* wb = weights(kb, c4 * C * 4);
    const bool last = k == 2;
    conv<1, kS>(qb, QS, c4, wb, C, lv, [&](int R, int Cc, int oc, int acc) {
      const int pix = R * kS + Cc;
      const float v = __fadd_rn(deq(acc, sw[kb * C + oc], bias[kb * C + oc]),
                                __bfloat162float(res[pix * RS + oc]));
      float e = elu(v);
      if (!last) {  // e2, e4 ride the bf16 residual canvas; e6 stays f32
        const __nv_bfloat16 eb = __float2bfloat16_rn(e);
        res[pix * RS + oc] = eb;
        e = __bfloat162float(eb);
      }
      qa[pix * QS + oc] = inside(R, Cc) ? quant(e, inv[(kb + 1) * C + oc]) : 0;
    });
  }

  // b7 (3x3, level 4): the (s_raw|t) output, NCHW
  const int* w7 = weights(7, 9 * c4 * p.nout8 * 4);
  const int nout = p.nout;
  conv<3, kS>(qa, QS, c4, w7, p.nout8, 4, [&](int R, int Cc, int oc, int acc) {
    if (oc >= nout || !inside(R, Cc)) return;
    const float v = deq(acc, p.sw7[oc], p.bias7[oc]);
    const int64_t o = (((int64_t)b * nout + oc) * H + r0 + R) * W + c0 + Cc;
    if (p.out_bf16)
      reinterpret_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
    else
      reinterpret_cast<float*>(p.out)[o] = v;
  });
}

int align16(int n) { return (n + 15) & ~15; }

constexpr int kTooWide = -1;   // the canvases of this tile exceed shared memory

// Launches with a kT x kT tile if its canvases fit, staging the weights if
// the largest conv's (wmax bytes) fit beside them.
template <int kT>
int launch(Params p, int wmax, int b, cudaStream_t stream) {
  constexpr int kS = kT + 2 * kHalo;
  const int pix = kS * kS;
  p.res_bytes = align16(pix * p.res_stride * 2);
  p.qa_bytes = align16(pix * p.q_stride);
  p.qb_bytes = align16(pix * (p.q_stride > p.x_stride ? p.q_stride : p.x_stride));
  const int canvases = p.res_bytes + p.qa_bytes + p.qb_bytes;
  if (canvases > kSmemMax) return kTooWide;
  const bool staged = canvases + wmax <= kSmemMax;
  const int smem = canvases + (staged ? wmax : 0);
  auto kernel = staged ? qtower_kernel<kT, true> : qtower_kernel<kT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + kT - 1) / kT, (p.H + kT - 1) / kT, b);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, cin, H, W) int8; w*: the eight convs' weights in the dp4a layout;
// inv (8, C), sw (7, C), bias (7, C), sw7 (nout), bias7 (nout) f32;
// out (B, nout, H, W), out_dtype 0 = float32, 1 = bfloat16.
// c % 8 == 0 (the caller pads).  Returns -1 for a width whose canvases exceed
// shared memory at the smallest tile.
extern "C" int cwfa_qtower(const void* x, const void* w1, const void* w2a,
                           const void* w2b, const void* w4a, const void* w4b,
                           const void* w6a, const void* w6b, const void* w7,
                           const void* inv, const void* sw, const void* bias,
                           const void* sw7, const void* bias7, void* out, int b,
                           int h, int w, int cin, int c, int nout, int out_dtype,
                           int device, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || nout <= 0 || c <= 0 || c % 8 ||
      out_dtype < 0 || out_dtype > 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  const void* ws[8] = {w1, w2a, w2b, w4a, w4b, w6a, w6b, w7};
  for (int i = 0; i < 8; ++i) {
    p.w[i] = static_cast<const int8_t*>(ws[i]);
    if (reinterpret_cast<uintptr_t>(ws[i]) % 16) return (int)cudaErrorMisalignedAddress;
  }
  p.inv = static_cast<const float*>(inv);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.sw7 = static_cast<const float*>(sw7);
  p.bias7 = static_cast<const float*>(bias7);
  p.out = out;
  p.H = h;
  p.W = w;
  p.cin = cin;
  p.cin4 = (cin + 3) / 4;
  p.C = c;
  p.nout = nout;
  p.nout8 = (nout + 7) / 8 * 8;
  p.out_bf16 = out_dtype;
  // one padding word per position: an odd word stride for C % 8 == 0
  p.res_stride = c + 2;
  p.q_stride = c + 4;
  p.x_stride = p.cin4 * 4 + ((p.cin4 % 2) ? 0 : 4);
  int wmax = p.cin4 * c * 4;
  const int w33 = 9 * (c / 4) * c * 4, w7b = 9 * (c / 4) * p.nout8 * 4;
  wmax = wmax > w33 ? wmax : w33;
  wmax = wmax > w7b ? wmax : w7b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = launch<16>(p, wmax, b, s);
  if (rc == kTooWide) rc = launch<8>(p, wmax, b, s);
  if (rc == kTooWide) rc = launch<4>(p, wmax, b, s);
  return rc;
}
