// The backward of the float subnet tower, for Hopper (sm_90a).
//
// The TPU kernel cwfa_tpu/ops/btower.py:235 (fused_pair_tower_bf16) has no
// backward: JAX trains through its XLA convs.  The port runs every float
// tower on a card through its kernel (csrc/btower_wg.cu, csrc/btower.cu), so
// training needs this one.  The tower (ops/btower.py):
//
//   r1 = R(b1(x))                                   1x1, Cin -> C
//   a2 = R(elu(v_a2)),  v_a2 = b2a(r1)              3x3
//   e2 = R(elu(v_e2)),  v_e2 = b2b(a2) + r1         1x1, residual
//   ... the same for (a4, e4) on e2 and (a6, e6) on e4
//   out = b7(e6)                                    3x3, C -> Nout
//
// with R the rounding to the compute type (bf16 or none), f32 sums, biases
// inside each conv.  cwfa_btower_bwd takes dy = d(out) and x and returns dx,
// every conv's dW (OIHW) and db, all f32 (the wrapper casts dx to x's type).
//
// Design: a simple kernel that is right, on the CUDA cores; speed is later
// work.  One host entry runs, on the caller's stream:
//   1. the forward again, conv by conv, writing the seven canvases (r1, a2,
//      e2, a4, e4, a6, e6, each rounded as the forward kernel rounds it) and
//      the six ELU pre-activations to a scratch buffer the wrapper allocates;
//   2. the tower backwards, layer by layer: a dgrad (the same direct conv
//      with the taps flipped and the channels swapped, the ELU' and the
//      residual fused in its epilogue) and a wgrad (per-block partial sums
//      over a band of rows into scratch, then a second pass that reduces the
//      bands in a fixed order; the bias sums ride along).  No atomics: the
//      result is the same from run to run.
// conv_kernel: one block per (batch, 16x16 tile, 64 output channels); a
// thread sums 4 positions x 16 channels; inputs and weights are staged 8
// input channels at a time in shared memory.  wgrad_kernel: one block per
// (batch, band of 8 rows, 16 input channels (64 for a 1x1), 64 output
// channels); a thread sums 4 output channels x 9 taps of one input channel
// (4 x 4 channels for a 1x1) over 2x32 sub-tiles of its band.
//
// Bound at step 0 of the flagship (Cin 48, C 64, Nout 96, 512^2, batch 1):
// operations, 2 x 95.03 GFLOP for the dgrads and wgrads (the recomputed
// forward not counted): 0.192 ms on bf16 tensor cores, 2.84 ms on f32 FMAs.
//
// Plain C interface for ctypes (cwfa_tpu_torch/ops/btower.py); launches on
// the caller's stream, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 16, kTW = 16;       // conv_kernel's output tile
constexpr int kCoT = 64;                // output channels per block
constexpr int kCiT = 8;                 // input channels staged at a time
constexpr int kPitch = 20;              // floats a staged row (>= 18; a
                                        // warp's reads hit 32 banks)
constexpr int kBand = 8;                // wgrad_kernel's rows per block
constexpr int kSR = 2, kSC = 32;        // wgrad_kernel's sub-tile

enum Mode { PLAIN = 0, FWD_ELU = 1, ROUND = 2, BWD_ELU = 3 };

__device__ __forceinline__ float round_to(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

struct ConvArgs {
  const float* in;      // (B, Ci, H, W)
  const float* wt;      // [tap][ci_pad][co_pad]
  const float* bias;    // (Co) or null
  const float* add;     // (B, Co, H, W) or null: added before the epilogue
  const float* pre;     // (B, Co, H, W): BWD_ELU's pre-activation
  float* out;           // (B, Co, H, W)
  float* out2;          // FWD_ELU: the canvas R(elu(v)) (out gets v)
  int ci, co, h, w, ci_pad, co_pad, mode, bf16;
};

// out = epilogue(sum_{ci, tap} w[tap][ci][co] in[ci](p + tap - KS/2)),
// SAME zero padding.
template <int KS>
__global__ void __launch_bounds__(kThreads) conv_kernel(const ConvArgs a) {
  constexpr int HALO = KS / 2, KK = KS * KS;
  constexpr int IR = kTH + 2 * HALO, IC = kTW + 2 * HALO, CH = IR * kPitch;
  __shared__ float ins[kCiT * CH];
  __shared__ __align__(16) float ws[KK * kCiT * kCoT];

  const int tiles_w = (a.w + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / tiles_w) * kTH, w0 = (blockIdx.x % tiles_w) * kTW;
  const int cot = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid / 64, pg = tid % 64;
  const int row = pg / 4, cb = pg % 4;   // positions (row, cb + 4 j)
  const int64_t plane = (int64_t)a.h * a.w;
  const float* in = a.in + (int64_t)b * a.ci * plane;

  float acc[4][16];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[j][c] = 0.f;

  for (int ci0 = 0; ci0 < a.ci; ci0 += kCiT) {
    __syncthreads();
    for (int i = tid; i < kCiT * IR * IC; i += kThreads) {
      const int cl = i / (IR * IC), rem = i % (IR * IC);
      const int r = rem / IC, c = rem % IC;
      const int hh = h0 - HALO + r, ww = w0 - HALO + c, ci = ci0 + cl;
      float v = 0.f;
      if (ci < a.ci && hh >= 0 && hh < a.h && ww >= 0 && ww < a.w)
        v = in[ci * plane + (int64_t)hh * a.w + ww];
      ins[cl * CH + r * kPitch + c] = v;
    }
    for (int i = tid; i < KK * kCiT * kCoT; i += kThreads) {
      const int tap = i / (kCiT * kCoT), cl = (i / kCoT) % kCiT, co = i % kCoT;
      ws[i] = a.wt[((int64_t)tap * a.ci_pad + ci0 + cl) * a.co_pad + cot * kCoT + co];
    }
    __syncthreads();
#pragma unroll 2
    for (int cl = 0; cl < kCiT; ++cl) {
#pragma unroll
      for (int ky = 0; ky < KS; ++ky)
#pragma unroll
        for (int kx = 0; kx < KS; ++kx) {
          const float* ip = ins + cl * CH + (row + ky) * kPitch + cb + kx;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = ip[4 * j];
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((ky * KS + kx) * kCiT + cl) * kCoT + cg * 16);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 wv = wp[q];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j][4 * q + 0] = fmaf(v[j], wv.x, acc[j][4 * q + 0]);
              acc[j][4 * q + 1] = fmaf(v[j], wv.y, acc[j][4 * q + 1]);
              acc[j][4 * q + 2] = fmaf(v[j], wv.z, acc[j][4 * q + 2]);
              acc[j][4 * q + 3] = fmaf(v[j], wv.w, acc[j][4 * q + 3]);
            }
          }
        }
    }
  }

  const int hh = h0 + row;
  if (hh >= a.h) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ww = w0 + cb + 4 * j;
    if (ww >= a.w) continue;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int co = cot * kCoT + cg * 16 + c;
      if (co >= a.co) continue;
      const int64_t idx = ((int64_t)b * a.co + co) * plane + (int64_t)hh * a.w + ww;
      float v = acc[j][c];
      if (a.bias) v += a.bias[co];
      if (a.add) v += a.add[idx];
      if (a.mode == FWD_ELU) {
        a.out[idx] = v;
        a.out2[idx] = round_to(elu(v), a.bf16);
      } else if (a.mode == ROUND) {
        a.out[idx] = round_to(v, a.bf16);
      } else if (a.mode == BWD_ELU) {
        const float p = a.pre[idx];
        a.out[idx] = p > 0.f ? v : v * expf(p);
      } else {
        a.out[idx] = v;
      }
    }
  }
}

// Partial sums over one band of rows: part[blk][co][ci][tap] =
// sum_p g[co](p) in[ci](p + tap - KS/2) and bpart[blk][co] = sum_p g[co](p),
// blk = b * bands + band.
template <int KS>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ g, const float* __restrict__ in,
             float* __restrict__ part, float* __restrict__ bpart, int ci_n,
             int co_n, int h, int w, int bands) {
  constexpr int HALO = KS / 2, KK = KS * KS;
  constexpr int CPT = KS == 3 ? 1 : 4;          // input channels a thread
  constexpr int CICH = 16 * CPT;                // ... a block
  constexpr int IR = kSR + 2 * HALO, IC = kSC + 2 * HALO;
  constexpr int ISTR = IR * IC + 1;             // odd: 16 channels, 16 banks
  constexpr int GSTR = kSR * kSC + 1;
  __shared__ float gs[kCoT * GSTR];
  __shared__ float is[CICH * ISTR];

  const int blk = blockIdx.x, b = blk / bands, band = blk % bands;
  const int cic = blockIdx.y, cot = blockIdx.z;
  const int tid = threadIdx.x, cog = tid / 16, cis = tid % 16;
  const int64_t plane = (int64_t)h * w;
  const float* gb = g + (int64_t)b * co_n * plane;
  const float* ib = in + (int64_t)b * ci_n * plane;
  const bool do_bias = cic == 0 && cis == 0;

  float acc[4][CPT][KK];
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int t = 0; t < KK; ++t) acc[j][c][t] = 0.f;

  const int r_end = min((band + 1) * kBand, h);
  for (int r0 = band * kBand; r0 < r_end; r0 += kSR) {
    for (int c0 = 0; c0 < w; c0 += kSC) {
      __syncthreads();
      for (int i = tid; i < kCoT * kSR * kSC; i += kThreads) {
        const int col = i / (kSR * kSC), rem = i % (kSR * kSC);
        const int co = cot * kCoT + col, hh = r0 + rem / kSC, ww = c0 + rem % kSC;
        float v = 0.f;
        if (co < co_n && hh < r_end && ww < w) v = gb[co * plane + (int64_t)hh * w + ww];
        gs[col * GSTR + rem] = v;
      }
      for (int i = tid; i < CICH * IR * IC; i += kThreads) {
        const int cl = i / (IR * IC), rem = i % (IR * IC);
        const int ci = cic * CICH + cl;
        const int hh = r0 - HALO + rem / IC, ww = c0 - HALO + rem % IC;
        float v = 0.f;
        if (ci < ci_n && hh >= 0 && hh < h && ww >= 0 && ww < w)
          v = ib[ci * plane + (int64_t)hh * w + ww];
        is[cl * ISTR + rem] = v;
      }
      __syncthreads();
#pragma unroll
      for (int pr = 0; pr < kSR; ++pr) {
        float win[CPT][KS][KS];
#pragma unroll
        for (int pc = 0; pc < kSC; ++pc) {
          float gv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) gv[j] = gs[(cog * 4 + j) * GSTR + pr * kSC + pc];
          if (do_bias) {
#pragma unroll
            for (int j = 0; j < 4; ++j) bacc[j] += gv[j];
          }
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            // input channel cis + 16 c of the block's chunk: a warp's 16
            // channels sit in 16 banks
            const float* ip = is + (cis + 16 * c) * ISTR + pr * IC + pc;
#pragma unroll
            for (int ky = 0; ky < KS; ++ky) {
              if (pc == 0) {
#pragma unroll
                for (int kx = 0; kx < KS; ++kx) win[c][ky][kx] = ip[ky * IC + kx];
              } else {
#pragma unroll
                for (int kx = 0; kx + 1 < KS; ++kx) win[c][ky][kx] = win[c][ky][kx + 1];
                win[c][ky][KS - 1] = ip[ky * IC + KS - 1];
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int ky = 0; ky < KS; ++ky)
#pragma unroll
                for (int kx = 0; kx < KS; ++kx)
                  acc[j][c][ky * KS + kx] = fmaf(gv[j], win[c][ky][kx], acc[j][c][ky * KS + kx]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = cot * kCoT + cog * 4 + j;
    if (co >= co_n) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int ci = cic * CICH + cis + 16 * c;
      if (ci >= ci_n) continue;
      float* dst = part + (((int64_t)blk * co_n + co) * ci_n + ci) * KK;
#pragma unroll
      for (int t = 0; t < KK; ++t) dst[t] = acc[j][c][t];
    }
    if (do_bias) bpart[(int64_t)blk * co_n + co] = bacc[j];
  }
}

// out[i] = sum over nblk partials, in block order.
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int nblk, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += part[(int64_t)k * n + i];
  out[i] = s;
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

struct Tower {
  int b, h, w, cin, c, nout, bf16;
  cudaStream_t s;
};

// conv i of the tower: (Ci, Co, KS)
struct Conv {
  int ci, co, ks;
};

int conv(const Tower& t, const Conv& cv, const float* in, const float* wgt,
         const float* bias, const float* add, const float* pre, float* out, float* out2,
         int mode) {
  ConvArgs a;
  a.in = in;
  a.wt = wgt;
  a.bias = bias;
  a.add = add;
  a.pre = pre;
  a.out = out;
  a.out2 = out2;
  a.ci = cv.ci;
  a.co = cv.co;
  a.h = t.h;
  a.w = t.w;
  a.ci_pad = round_up(cv.ci, kCiT);
  a.co_pad = round_up(cv.co, kCoT);
  a.mode = mode;
  a.bf16 = t.bf16;
  const dim3 grid(((t.h + kTH - 1) / kTH) * ((t.w + kTW - 1) / kTW), a.co_pad / kCoT, t.b);
  if (cv.ks == 3)
    conv_kernel<3><<<grid, kThreads, 0, t.s>>>(a);
  else
    conv_kernel<1><<<grid, kThreads, 0, t.s>>>(a);
  return (int)cudaGetLastError();
}

int wgrad(const Tower& t, const Conv& cv, const float* g, const float* in, float* part,
          float* dw, float* db) {
  const int bands = (t.h + kBand - 1) / kBand;
  const int nblk = t.b * bands;
  const int cich = cv.ks == 3 ? 16 : 64;
  const dim3 grid(nblk, (cv.ci + cich - 1) / cich, (cv.co + kCoT - 1) / kCoT);
  const int64_t nw = (int64_t)cv.co * cv.ci * cv.ks * cv.ks;
  float* bpart = part + (int64_t)nblk * nw;
  if (cv.ks == 3)
    wgrad_kernel<3><<<grid, kThreads, 0, t.s>>>(g, in, part, bpart, cv.ci, cv.co, t.h,
                                                t.w, bands);
  else
    wgrad_kernel<1><<<grid, kThreads, 0, t.s>>>(g, in, part, bpart, cv.ci, cv.co, t.h,
                                                t.w, bands);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((nw + kThreads - 1) / kThreads), kThreads, 0, t.s>>>(
      part, dw, nblk, nw);
  reduce_kernel<<<(cv.co + kThreads - 1) / kThreads, kThreads, 0, t.s>>>(bpart, db, nblk,
                                                                         cv.co);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch: 13 recomputed canvases and pre-activations, 3 gradients.
extern "C" int64_t cwfa_btower_bwd_scratch(int b, int h, int w, int c) {
  return 16 * (int64_t)b * c * h * w;
}

// Floats of partial-sum space for the wgrads' bands.
extern "C" int64_t cwfa_btower_bwd_part(int b, int h, int cin, int c, int nout) {
  const int64_t nblk = (int64_t)b * ((h + kBand - 1) / kBand);
  int64_t most = (int64_t)c * c * 9 + c;
  const int64_t w1 = (int64_t)c * cin + c, w7 = (int64_t)nout * c * 9 + nout;
  if (w1 > most) most = w1;
  if (w7 > most) most = w7;
  return nblk * most;
}

// x: (B, Cin, H, W) f32; dy: (B, Nout, H, W) f32; wf[8], wd[8]: each conv's
// forward [tap][Ci pad 8][Co pad 64] and dgrad [tap][Co pad 8][Ci pad 64]
// (taps flipped) layouts, f32 values of the compute type; bias[8]: f32 (Co);
// dx: (B, Cin, H, W) f32; dw[8] (OIHW), db[8] (Co): f32.  The convs in the
// order b1, b2a, b2b, b4a, b4b, b6a, b6b, b7.  scratch, part: the floats
// that cwfa_btower_bwd_scratch / _part give.  bf16: round the canvases to
// bf16 as the forward does.
extern "C" int cwfa_btower_bwd(const float* x, const float* dy, const float* const* wf,
                               const float* const* wd, const float* const* bias,
                               float* dx, float* const* dw, float* const* db,
                               float* scratch, float* part, int b, int h, int w,
                               int cin, int c, int nout, int bf16, int device,
                               void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || c <= 0 || nout <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Tower t{b, h, w, cin, c, nout, bf16, static_cast<cudaStream_t>(stream)};
  const Conv cv[8] = {{cin, c, 1}, {c, c, 3}, {c, c, 1}, {c, c, 3},
                      {c, c, 1},   {c, c, 3}, {c, c, 1}, {c, nout, 3}};
  const int64_t n = (int64_t)b * c * h * w;
  float* buf[16];
  for (int i = 0; i < 16; ++i) buf[i] = scratch + i * n;
  float *r1 = buf[0], *pa2 = buf[1], *a2 = buf[2], *pe2 = buf[3], *e2 = buf[4];
  float *pa4 = buf[5], *a4 = buf[6], *pe4 = buf[7], *e4 = buf[8], *pa6 = buf[9];
  float *a6 = buf[10], *pe6 = buf[11], *e6 = buf[12];
  float *ga = buf[13], *gb = buf[14], *gc = buf[15];
  int rc;
#define RUN(call)            \
  do {                       \
    rc = (call);             \
    if (rc != 0) return rc;  \
  } while (0)
  // 1. the forward again: canvases and ELU pre-activations
  RUN(conv(t, cv[0], x, wf[0], bias[0], nullptr, nullptr, r1, nullptr, ROUND));
  RUN(conv(t, cv[1], r1, wf[1], bias[1], nullptr, nullptr, pa2, a2, FWD_ELU));
  RUN(conv(t, cv[2], a2, wf[2], bias[2], r1, nullptr, pe2, e2, FWD_ELU));
  RUN(conv(t, cv[3], e2, wf[3], bias[3], nullptr, nullptr, pa4, a4, FWD_ELU));
  RUN(conv(t, cv[4], a4, wf[4], bias[4], e2, nullptr, pe4, e4, FWD_ELU));
  RUN(conv(t, cv[5], e4, wf[5], bias[5], nullptr, nullptr, pa6, a6, FWD_ELU));
  RUN(conv(t, cv[6], a6, wf[6], bias[6], e4, nullptr, pe6, e6, FWD_ELU));
  // 2. backwards; a dgrad is the conv of the gradient with the dgrad layout
  const Conv tr[8] = {{c, cin, 1}, {c, c, 3}, {c, c, 1}, {c, c, 3},
                      {c, c, 1},   {c, c, 3}, {c, c, 1}, {nout, c, 3}};
  RUN(conv(t, tr[7], dy, wd[7], nullptr, nullptr, pe6, ga, nullptr, BWD_ELU));  // d v_e6
  RUN(wgrad(t, cv[7], dy, e6, part, dw[7], db[7]));
  RUN(conv(t, tr[6], ga, wd[6], nullptr, nullptr, pa6, gb, nullptr, BWD_ELU));  // d v_a6
  RUN(wgrad(t, cv[6], ga, a6, part, dw[6], db[6]));
  RUN(conv(t, tr[5], gb, wd[5], nullptr, ga, pe4, gc, nullptr, BWD_ELU));  // d v_e4
  RUN(wgrad(t, cv[5], gb, e4, part, dw[5], db[5]));
  RUN(conv(t, tr[4], gc, wd[4], nullptr, nullptr, pa4, ga, nullptr, BWD_ELU));  // d v_a4
  RUN(wgrad(t, cv[4], gc, a4, part, dw[4], db[4]));
  RUN(conv(t, tr[3], ga, wd[3], nullptr, gc, pe2, gb, nullptr, BWD_ELU));  // d v_e2
  RUN(wgrad(t, cv[3], ga, e2, part, dw[3], db[3]));
  RUN(conv(t, tr[2], gb, wd[2], nullptr, nullptr, pa2, gc, nullptr, BWD_ELU));  // d v_a2
  RUN(wgrad(t, cv[2], gb, a2, part, dw[2], db[2]));
  RUN(conv(t, tr[1], gc, wd[1], nullptr, gb, nullptr, ga, nullptr, PLAIN));  // d r1
  RUN(wgrad(t, cv[1], gc, r1, part, dw[1], db[1]));
  RUN(conv(t, tr[0], ga, wd[0], nullptr, nullptr, nullptr, dx, nullptr, PLAIN));  // dx
  RUN(wgrad(t, cv[0], ga, x, part, dw[0], db[0]));
#undef RUN
  return 0;
}
