// The backward of the 64-wide float subnet tower on Hopper's warpgroup
// tensor cores (wgmma, sm_90a), in bf16 and in f32 as 3xTF32: the instances
// of float_tower_backward for the towers that training runs (ops/btower.py
// bwd_instance).  csrc/btower_bwd.cu stays the CUDA-core instance for the
// other widths.  The TPU kernel cwfa_tpu/ops/btower.py:235
// (fused_pair_tower_bf16) has no backward (JAX trains through its XLA
// convs); this differentiates the function of its port, csrc/btower_wg.cu:
//
//   r1 = R(b1(x))                                   1x1, Cin -> 64
//   a2 = R(elu(b2a(r1))),  e2 = R(elu(b2b(a2) + r1)) 3x3, 1x1, residual
//   ... (a4, e4) on e2, (a6, e6) on e4
//   out = b7(e6)                                    3x3, 64 -> Nout
//
// R the rounding to bf16, sums, biases, ELU and residual in f32.  From dy =
// d(out) the backward gives dx (bf16) and every conv's dW (OIHW) and db, f32.
//
// Bound: operations.  At step 0 of the flagship (1, 48, 512, 512) -> 96 the
// dgrads and wgrads are 2 x 95.03 GFLOP: 0.192 ms on the bf16 tensor cores
// (the recomputed forward, 95 GFLOP more, not counted).
//
// Design (one host entry, every launch on the caller's stream):
//   - The forward again, conv by conv, on the tensor cores, writing the seven
//     canvases r1, a2, e2, a4, e4, a6, e6 to scratch as bf16, rounded as the
//     forward rounds them: 7 x 128 bytes a position (235 MB at step 0).  x
//     and dy are read in their own bf16 (NCHW), copied once into the canvas
//     layout with their channels padded with zeros to a multiple of 16.
//   - Canvas layout in device memory: [batch][channel octet][H][W][8 bf16],
//     so a 16-byte unit is the 8 channels of one octet at one position, and
//     a tile with its halo is copied to shared memory with cp.async as
//     [octet][position][16 bytes] (zero outside the image: SAME padding for
//     every canvas that feeds a 3x3, the gradients' included).
//   - conv_kernel, two warpgroups a block (one where the shared memory of
//     two does not fit), persistent: each warpgroup walks its own 16 x 16
//     output tiles against the conv's weights, which stay in shared memory
//     for the whole run, so one warpgroup's epilogue runs beside the other's
//     products (one warpgroup alone ran the epilogue's 64 global round
//     trips a tile with one warp a scheduler: 3x slower).  A tile's epilogue
//     input (the residual canvas or the canvas for ELU') is copied while its
//     products run, the next tile's window while its epilogue runs.  An
//     implicit GEMM, M = 64 positions (an 8 x 8 block of the tile: the
//     descriptor's 8-row groups are canvas rows, sbo = the row pitch), N =
//     output channels, K = taps x input channels; a 3x3 tap is the same
//     descriptor shifted by (ky * pitch + kx) positions.  It serves the
//     forward convs (bias, ELU, residual, round in the epilogue) and the
//     dgrads: the weights flipped and transposed ([tap][Cout/8][Cin][8],
//     K-major like the forward's slices), ELU' taken from the stored canvas
//     (e + 1 where e <= 0), the sums started from the residual's f32
//     gradient; the gradient is stored twice, f32 for the residual chain and
//     bf16 as the operand of the next products.  Only the operand is
//     rounded.  What the epilogue does is a template flag set (MODE).
//     Cin up to 128 (the [x half | c_views] towers of the other coupling
//     types): the recomputed b1 reads K = Cin from a window of that many
//     channels; the dgrad into dx runs in launches of at most 64 of its
//     channels, the four M tiles' sums of 128 not fitting a thread.
//   - wgrad_kernel, three warpgroups a block, one block a streaming
//     multiprocessor, persistent over the same tiles: dW[co][ci, tap] =
//     sum_p g[co](p) in[ci](p + tap) with K = the 16 positions of a tile row,
//     both operands read straight from the canvas layout as MN-major bf16
//     operands (wgmma's transpose flags); a tap is a shifted start address.
//     A 3x3's 9 taps are split over the three warpgroups (3 x 64 x N f32
//     sums in registers each); a 1x1's rows are.  The bias sums ride along
//     on the CUDA cores.  Above 64 outputs (b7's Nout 80, 96) the outputs
//     go in two launches of at most 48; b1's wgrad (a 1x1, one tap a
//     thread's sums) takes N = Cin up to 128 in one.  Each block writes its partial
//     sums, and a second pass sums the partials in a fixed order: no
//     atomics, the same result from run to run.
//
// f32 (cwfa_btower_bwd_tf32): the same function with no canvas rounding,
// every product as 3xTF32 (each f32 operand split into a TF32 high part and
// the remainder, hi*hi + hi*lo + lo*hi, f32 sums; csrc/btower_wg.cu's f32
// forward).  Bound: the same 2 x 95.03 GFLOP, three TF32 products each:
// 1.152 ms at 495 TFLOP/s.  Where the bf16 design does not carry over:
//   - A 3x3's weights as hi + lo f32 (295 KB) do not fit shared memory, so
//     every conv streams its weight slices (a tap's 32 input channels, hi
//     then lo, csrc/btower_wg.cu's pack layout) through a ring of 4 slots,
//     one block of two warpgroups a 16 x 16 tile sharing one window of the
//     input canvas ([quad][position][4 f32]: 83 KB at 64 channels with the
//     halo); A comes from registers, split as it is loaded.
//   - wgmma takes tf32 operands from shared memory K-major only, so the
//     wgrad cannot read both sides MN-major: M = the conv's input channels
//     (A from registers, a tap a shifted read of the input's window), N =
//     the output channels, B = the gradient's tile split into hi and lo and
//     staged K-major through registers ([4 positions][N][4]).  A block takes
//     one kernel row of a 3x3 (3 taps: 3 x N / 2 sums a thread, with two
//     warpgroups on the tile's halves, no spill at N 64) or 64 input
//     channels of a 1x1; b7's outputs go in launches of at most 48.
//   - The tensor cores' accumulation truncates: each slice of a conv, and
//     each tile and tap of a wgrad, sums into zeroed registers that the
//     CUDA cores add on (round to nearest).
// The canvases: r1 .. e6 and three gradient canvases, f32, 64 channels:
// 10 x 256 bytes a position (671 MB at step 0), x and dy as canvases
// beside them.  ELU' from the stored canvas, the residual chain in f32,
// the bias sums from the staged gradient.
//
// Plain C interface for ctypes (cwfa_tpu_torch/ops/btower.py); launches on
// the caller's stream, does not synchronise, returns cudaGetLastError().

#include <algorithm>

#include "tower_wg.cuh"

namespace {

using tower::keep;
using tower::pack_bf16;
using tower::unpack_bf16;

constexpr int kT = 16;                  // output tile side
constexpr int kSmemMax = tower::kSmemMax;
constexpr int kWgThreads = 384;         // wgrad_kernel: three warpgroups

__device__ __forceinline__ void cp_async16_zfill(uint32_t smem, const void* gmem,
                                                 bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
}

struct Tiles {
  int H, W, tw, th, n;                  // image, tiles across, down, in all
  __device__ __forceinline__ void at(int t, int& b, int& y0, int& x0) const {
    b = t / (tw * th);
    const int r = t % (tw * th);
    y0 = (r / tw) * kT;
    x0 = (r % tw) * kT;
  }
};

// 16-byte units (bf16: channel octets; f32: quads) c0 .. c0 + nchunk - 1
// of a canvas of ntot units, a tile's window with a halo of `halo` (pitch
// 16 + 2 halo), into shared memory at dst as [unit][position][16 bytes],
// `plane` positions a unit (0: the window's), zero outside the image.
__device__ __forceinline__ void load_window(uint32_t dst, const void* src, int ntot,
                                            int c0, int nchunk, int halo, int b, int y0,
                                            int x0, const Tiles& T, int tid, int nthreads,
                                            int plane = 0) {
  const int pw = kT + 2 * halo, npos = pw * pw, pl = plane ? plane : npos;
  const uint4* s = static_cast<const uint4*>(src);
  for (int u = tid; u < nchunk * npos; u += nthreads) {
    const int c = u / npos, pos = u % npos;
    const int y = y0 - halo + pos / pw, x = x0 - halo + pos % pw;
    const bool in = (unsigned)y < (unsigned)T.H && (unsigned)x < (unsigned)T.W;
    const uint4* g = in ? s + (((int64_t)b * ntot + c0 + c) * T.H + y) * T.W + x : s;
    cp_async16_zfill(dst + (c * pl + pos) * 16, g, in);
  }
}

// NCHW bf16 (C channels) -> canvas layout with cp channels (the rest zero).
__global__ void to_canvas_kernel(const uint16_t* __restrict__ src, uint4* __restrict__ dst,
                                 int B, int C, int cp, int64_t hw) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int nchunk = cp / 8;
  if (i >= (int64_t)B * nchunk * hw) return;
  const int64_t pos = i % hw;
  const int c8 = (int)((i / hw) % nchunk), b = (int)(i / (hw * nchunk));
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c0 = 8 * c8 + 2 * k;
    const uint32_t lo = c0 < C ? src[((int64_t)b * C + c0) * hw + pos] : 0u;
    const uint32_t hi = c0 + 1 < C ? src[((int64_t)b * C + c0 + 1) * hw + pos] : 0u;
    w[k] = lo | (hi << 16);
  }
  dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// conv_kernel: the forward convs and the dgrads
// ---------------------------------------------------------------------------

// What a conv's epilogue does, as compile-time flags (the forward convs:
// FWD_R1, FWD_A, FWD_E; the dgrads: BWD_TOP (b7's), BWD_A (a 1x1's),
// BWD_E (a 3x3's), BWD_R1 (b2a's), BWD_DX (b1's))
enum : int {
  kBias = 1, kResB = 2, kResF = 4, kElu = 8, kDcan = 16, kOutB = 32, kOutF = 64, kNchw = 128,
  FWD_R1 = kBias | kOutB,
  FWD_A = kBias | kElu | kOutB,
  FWD_E = kBias | kResB | kElu | kOutB,
  BWD_TOP = kDcan | kOutB | kOutF,
  BWD_A = kDcan | kOutB,
  BWD_E = kResF | kDcan | kOutB | kOutF,
  BWD_R1 = kResF | kOutB,
  BWD_DX = kNchw,
};

struct ConvP {
  const void* in;           // canvas, kch channels
  const char* wt;           // [tap][kch / 8][N][8] bf16
  const float* bias;        // (N)
  const void* res_b;        // bf16 canvas (N) added before the ELU
  const float2* res_f;      // f32 canvas (N): the sums start from it
  const void* dcan;         // bf16 canvas (N): times ELU'(from it)
  uint32_t* out_b;          // bf16 canvas (N)
  float2* out_f;            // f32 canvas (N)
  uint16_t* out_nchw;       // bf16 NCHW (nvalid channels), from channel n_off
  int kch, nvalid, n_off;
  Tiles T;
};

__device__ __forceinline__ void bar_wg(int wgi) {      // one warpgroup's barrier
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

// Shared memory: the weights, then per warpgroup one canvas window and the
// epilogue's bf16 input (res_b or dcan: [octet][256 positions][16 bytes]).
// Each warpgroup walks its own tiles: its epilogue overlaps the other's
// products.  A tile's epilogue input is copied while its products run, the
// next tile's window while its epilogue runs.
template <int KS, int N, int MODE>
__global__ void __launch_bounds__(256, 1) conv_kernel(const ConvP p) {
  constexpr int HALO = KS / 2, PW = kT + 2 * HALO, NPOS = PW * PW, TAPS = KS * KS;
  constexpr int PLANE = NPOS * 16, EPI = (MODE & (kResB | kDcan)) ? (N / 8) * kT * kT * 16 : 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const int K = p.kch, nchunk = K / 8;
  const int wbytes = TAPS * K * N * 2;
  const int tid = threadIdx.x, nwg = blockDim.x >> 7;
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0), lt = tid & 127;
  const uint32_t cv = s0 + wbytes + wgi * (nchunk * PLANE + EPI), ee = cv + nchunk * PLANE;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  const Tiles& T = p.T;
  const int step = gridDim.x * nwg;

  for (int i = tid * 16; i < wbytes; i += blockDim.x * 16)
    tower::cp_async16(s0 + i, p.wt + i);
  int b, y0, x0;
  int t = blockIdx.x * nwg + wgi;
  if (t < T.n) {
    T.at(t, b, y0, x0);
    load_window(cv, p.in, nchunk, 0, nchunk, HALO, b, y0, x0, T, lt, 128);
  }
  tower::cp_async_commit();
  tower::cp_async_wait<0>();
  wg::fence_proxy_async();
  __syncthreads();                      // the weights, from every thread

  float bias[N / 8][2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    bias[j][0] = (MODE & kBias) ? p.bias[8 * j + 2 * q] : 0.f;
    bias[j][1] = (MODE & kBias) ? p.bias[8 * j + 2 * q + 1] : 0.f;
  }
  const uint64_t da = wg::desc_base(PLANE, PW * 16, wg::kSwizzleNone);
  const uint64_t dw = wg::desc_base(N * 16, 128, wg::kSwizzleNone);
  const void* epi_src = (MODE & kResB) ? p.res_b : p.dcan;

  for (bool first = true; t < T.n; t += step, first = false) {
    T.at(t, b, y0, x0);
    if (EPI) load_window(ee, epi_src, N / 8, 0, N / 8, 0, b, y0, x0, T, lt, 128);
    tower::cp_async_commit();
    float acc[4][N / 2];
    // the sums start from the residual's f32 gradient (or 0)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int y = y0 + 8 * (m >> 1) + 2 * warp + hh, x = x0 + 8 * (m & 1) + g;
        const bool in = (MODE & kResF) && y < T.H && x < T.W;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float2 r = make_float2(0.f, 0.f);
          if (in) r = __ldg(p.res_f + 4 * ((((int64_t)b * (N / 8) + j) * T.H + y) * T.W + x) + q);
          acc[m][4 * j + 2 * hh] = r.x;
          acc[m][4 * j + 2 * hh + 1] = r.y;
        }
      }
    if (!first) {
      tower::cp_async_wait<1>();        // the window
      wg::fence_proxy_async();
      bar_wg(wgi);
    }
    wg::fence();
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int shift = (tap / KS) * PW + tap % KS;
      const uint32_t wtap = s0 + tap * K * N * 2;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t a0 = cv + ((8 * (m >> 1)) * PW + 8 * (m & 1) + shift) * 16;
        for (int ks = 0; ks < K / 16; ++ks)
          wg::wgmma_ss_bf16<N>(acc[m], wg::desc_at(da, a0 + 2 * ks * PLANE),
                               wg::desc_at(dw, wtap + ks * 32 * N));
      }
    }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int m = 0; m < 4; ++m) keep(acc[m]);
    bar_wg(wgi);                        // every warp's products are done
    if (t + step < T.n) {               // the next window, during the epilogue
      int b2, y2, x2;
      T.at(t + step, b2, y2, x2);
      load_window(cv, p.in, nchunk, 0, nchunk, HALO, b2, y2, x2, T, lt, 128);
    }
    tower::cp_async_commit();
    if (EPI) {
      tower::cp_async_wait<1>();        // this tile's epilogue input
      bar_wg(wgi);
    }

    // sum row 16 warp + g (+ 8) of M tile m -> tile pixel (8 (m / 2) +
    // 2 warp (+ 1), 8 (m % 2) + g)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ty = 8 * (m >> 1) + 2 * warp + hh, tx = 8 * (m & 1) + g;
        const int y = y0 + ty, x = x0 + tx, pos = ty * kT + tx;
        if (y >= T.H || x >= T.W) continue;
        const int64_t u0 = (((int64_t)b * (N / 8)) * T.H + y) * T.W + x;
        const int64_t hw = (int64_t)T.H * T.W;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int64_t u = u0 + j * hw;
          const uint32_t o = ee + (j * kT * kT + pos) * 16 + q * 4;
          float v0 = acc[m][4 * j + 2 * hh] + bias[j][0];
          float v1 = acc[m][4 * j + 2 * hh + 1] + bias[j][1];
          if (MODE & kResB) {
            const float2 r = unpack_bf16(tower::lds32(o));
            v0 += r.x;
            v1 += r.y;
          }
          if (MODE & kElu) {
            v0 = elu(v0);
            v1 = elu(v1);
          }
          if (MODE & kDcan) {
            const float2 e = unpack_bf16(tower::lds32(o));
            v0 *= fminf(e.x, 0.f) + 1.f;
            v1 *= fminf(e.y, 0.f) + 1.f;
          }
          if (MODE & kOutB) p.out_b[4 * u + q] = pack_bf16(v0, v1);
          if (MODE & kOutF) p.out_f[4 * u + q] = make_float2(v0, v1);
          if (MODE & kNchw) {
            const int n = p.n_off + 8 * j + 2 * q;
            const int64_t o2 = (((int64_t)b * p.nvalid + n) * T.H + y) * T.W + x;
            const uint32_t v = pack_bf16(v0, v1);
            if (n < p.nvalid) p.out_nchw[o2] = (uint16_t)(v & 0xffffu);
            if (n + 1 < p.nvalid) p.out_nchw[o2 + hw] = (uint16_t)(v >> 16);
          }
        }
      }
    if (EPI) bar_wg(wgi);               // the epilogue buffer is free
  }
}

// ---------------------------------------------------------------------------
// wgrad_kernel: dW and db of one conv
// ---------------------------------------------------------------------------

struct WgradP {
  const void* m_in;         // canvas, 64 channels: the M side
  const void* n_in;         // canvas of n_tot channels: N of them from n_off
  float* part;              // per partial [co - co0][ci][taps] f32
  float* bpart;             // per block [384 / GC][GC] f32: the bias sums
  int m_shift;              // 1: M is the conv's input (dW^T: M = ci, N = co)
  int n_tot, n_off;
  int co, ci, nbuf;         // the conv's real channel counts
  Tiles T;
};

template <int KS, int N>
__global__ void __launch_bounds__(kWgThreads, 1) wgrad_kernel(const WgradP p) {
  constexpr int HALO = KS / 2, PW = kT + 2 * HALO, TAPS = KS * KS;
  constexpr int NPOS_H = PW * PW, NPOS_0 = kT * kT;
  const int plane_m = (p.m_shift ? NPOS_H : NPOS_0) * 16;
  const int plane_n = (p.m_shift ? NPOS_0 : NPOS_H) * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const int buf = 8 * plane_m + (N / 8) * plane_n;
  const int tid = threadIdx.x;
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  const Tiles& T = p.T;
  const int step = gridDim.x;
  // the bias sums: the gradient is the side that is not shifted
  const int gc = p.m_shift ? N : 64;
  const int bc = tid % gc, bs = tid / gc, bgroups = kWgThreads / gc;
  const int gplane = p.m_shift ? plane_n : plane_m;
  float bsum = 0.f;

  auto load = [&](uint32_t dst, int t) {
    int b, y0, x0;
    T.at(t, b, y0, x0);
    load_window(dst, p.m_in, 8, 0, 8, p.m_shift ? HALO : 0, b, y0, x0, T, tid,
                kWgThreads);
    load_window(dst + 8 * plane_m, p.n_in, p.n_tot / 8, p.n_off / 8, N / 8,
                p.m_shift ? 0 : HALO, b, y0, x0, T, tid, kWgThreads);
  };
  if ((int)blockIdx.x < T.n) load(s0, blockIdx.x);
  tower::cp_async_commit();

  constexpr int NT = KS == 3 ? 3 : 1;   // taps a warpgroup
  float acc[NT][N / 2];
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[k][e] = 0.f;
  const uint64_t da = wg::desc_base(128, plane_m, wg::kSwizzleNone);
  const uint64_t db = wg::desc_base(128, plane_n, wg::kSwizzleNone);

  int i = 0;
  for (int t = blockIdx.x; t < T.n; t += step, ++i) {
    const uint32_t cur = s0 + (p.nbuf == 2 && (i & 1) ? buf : 0);
    if (p.nbuf == 1) {
      if (i > 0) load(s0, t);
    } else if (t + step < T.n) {
      load(s0 + (i & 1 ? 0 : buf), t + step);
    }
    tower::cp_async_commit();
    if (p.nbuf == 2)
      tower::cp_async_wait<1>();
    else
      tower::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();

    const uint32_t mb = cur, nb = cur + 8 * plane_m;
    wg::fence();
    if (KS == 3) {
#pragma unroll 1
      for (int r = 0; r < kT; ++r)
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          const int tap = 3 * wgi + k;
          const int sh = (r + tap / 3) * PW + tap % 3;     // the shifted side
          const int pm = p.m_shift ? sh : r * kT, pn = p.m_shift ? r * kT : sh;
          wg::wgmma_ss_bf16_t<N>(acc[k], wg::desc_at(da, mb + pm * 16),
                                 wg::desc_at(db, nb + pn * 16));
        }
    } else {
#pragma unroll 1
      for (int r = wgi; r < kT; r += 3)
        wg::wgmma_ss_bf16_t<N>(acc[0], wg::desc_at(da, mb + r * kT * 16),
                               wg::desc_at(db, nb + r * kT * 16));
    }
    wg::commit();
    // the bias sums of this tile while the products run
    {
      // the gradient side has no halo: pitch 16
      const unsigned char* gs = smem + (cur - s0) + (p.m_shift ? 8 * plane_m : 0);
      for (int pos = bs; pos < NPOS_0; pos += bgroups) {
        const uint16_t v = *reinterpret_cast<const uint16_t*>(
            gs + (bc >> 3) * gplane + pos * 16 + (bc & 7) * 2);
        bsum += __uint_as_float((uint32_t)v << 16);
      }
    }
    wg::wait<0>();
#pragma unroll
    for (int k = 0; k < NT; ++k) keep(acc[k]);
    __syncthreads();            // the buffer is free for the copy after next
  }

  // this block's partial sums, in the OIHW order of dW, from output co0
  const int co0 = p.m_shift ? p.n_off : 0;
  const int nco = min(p.co - co0, p.m_shift ? N : 64);
  const int npart = KS == 3 ? blockIdx.x : blockIdx.x * 3 + wgi;
  float* part = p.part + (int64_t)npart * nco * p.ci * TAPS;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int tap = KS == 3 ? 3 * wgi + k : 0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = 16 * warp + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * q + e;
          const int co = p.m_shift ? n : m, ci = p.m_shift ? m : n;
          if (co < nco && ci < p.ci)
            part[((int64_t)co * p.ci + ci) * TAPS + tap] = acc[k][4 * j + 2 * hh + e];
        }
    }
  }
  p.bpart[((int64_t)blockIdx.x * bgroups + bs) * gc + bc] = bsum;
}

// out[i] = sum over k < nparts of part[k * stride + i]: 16 threads an
// element, each summing a contiguous range of k in order, then the 16 range
// sums added in order (a fixed order: the same result from run to run).
constexpr int kSlices = 16, kElems = 16;
__global__ void __launch_bounds__(kSlices * kElems)
sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out, int nparts, int64_t n,
                 int64_t stride) {
  __shared__ float sums[kSlices][kElems];
  const int e = threadIdx.x % kElems, sl = threadIdx.x / kElems;
  const int64_t i = (int64_t)blockIdx.x * kElems + e;
  const int per = (nparts + kSlices - 1) / kSlices;
  const int k0 = sl * per, k1 = min(nparts, k0 + per);
  float s = 0.f;
  if (i < n)
    for (int k = k0; k < k1; ++k) s += part[(int64_t)k * stride + i];
  sums[sl][e] = s;
  __syncthreads();
  if (sl == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) t += sums[k][e];
    out[i] = t;
  }
}

void sum_parts(const float* part, float* out, int nparts, int64_t n, int64_t stride,
               cudaStream_t s) {
  sum_parts_kernel<<<(unsigned)((n + kElems - 1) / kElems), kSlices * kElems, 0, s>>>(
      part, out, nparts, n, stride);
}

int round16(int n) { return (n + 15) / 16 * 16; }

struct Ctx {
  Tiles T;
  int nsm;
  cudaStream_t s;
};

template <int KS, int N, int MODE>
int conv(const Ctx& c, const void* in, int kch, const char* wt, const float* bias,
         const void* res, const void* res_f, void* out_b, void* out_f, void* out_nchw = nullptr,
         int nvalid = 0, int n_off = 0) {
  constexpr int PW = kT + 2 * (KS / 2);
  constexpr int EPI = (MODE & (kResB | kDcan)) ? (N / 8) * kT * kT * 16 : 0;
  ConvP p;
  p.in = in;
  p.wt = wt;
  p.bias = bias;
  p.res_b = (MODE & kResB) ? res : nullptr;
  p.dcan = (MODE & kDcan) ? res : nullptr;
  p.res_f = static_cast<const float2*>(res_f);
  p.out_b = static_cast<uint32_t*>(out_b);
  p.out_f = static_cast<float2*>(out_f);
  p.out_nchw = static_cast<uint16_t*>(out_nchw);
  p.kch = kch;
  p.nvalid = nvalid;
  p.n_off = n_off;
  p.T = c.T;
  const int wbytes = KS * KS * kch * N * 2, per_wg = (kch / 8) * PW * PW * 16 + EPI;
  const int nwg = wbytes + 2 * per_wg <= kSmemMax ? 2 : 1;
  const int smem = wbytes + nwg * per_wg;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<KS, N, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_kernel<KS, N, MODE>,
                                                      128 * nwg, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min((c.T.n + nwg - 1) / nwg, c.nsm * std::max(per_sm, 1));
  conv_kernel<KS, N, MODE><<<grid, 128 * nwg, smem, c.s>>>(p);
  return (int)cudaGetLastError();
}

// dW, db of output channels [co0, co0 + the launch's count) of a conv; the
// N side is channels n_off .. n_off + N - 1 of a canvas of n_tot
template <int KS, int N>
int wgrad(const Ctx& c, const void* m_in, const void* n_in, int n_tot, int n_off,
          int m_shift, int co, int ci, float* part, float* dw, float* dbias) {
  constexpr int PW = kT + 2 * (KS / 2);
  const int halo_pos = PW * PW, flat = kT * kT;
  const int bufb = (8 * (m_shift ? halo_pos : flat) + (N / 8) * (m_shift ? flat : halo_pos)) * 16;
  const int co0 = m_shift ? n_off : 0;
  const int nco = std::min(co - co0, m_shift ? N : 64);
  WgradP p;
  p.m_in = m_in;
  p.n_in = n_in;
  p.m_shift = m_shift;
  p.n_tot = n_tot;
  p.n_off = n_off;
  p.co = co;
  p.ci = ci;
  p.nbuf = 2 * bufb <= kSmemMax ? 2 : 1;
  p.T = c.T;
  const int grid = std::min(c.T.n, c.nsm);
  const int nparts = KS == 3 ? grid : 3 * grid;
  const int64_t nw = (int64_t)nco * ci * KS * KS;
  p.part = part;
  p.bpart = part + (int64_t)nparts * nw;
  const int smem = p.nbuf * bufb;
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel<KS, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<KS, N><<<grid, kWgThreads, smem, c.s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_parts(part, dw + (int64_t)co0 * ci * KS * KS, nparts, nw, nw, c.s);
  const int gc = m_shift ? N : 64;
  sum_parts(p.bpart, dbias + co0, grid * (kWgThreads / gc), nco, gc, c.s);
  return (int)cudaGetLastError();
}

// conv<1, N> / wgrad<KS, N> for the N that a width gives, at run time.  The
// dgrad into dx writes NCHW channels n_off .. n_off + N - 1 of nvalid.
int conv1_n(const Ctx& c, int n, const void* in, const char* wt, void* out, int nvalid,
            int n_off) {
  switch (n) {
#define CWFA_CASE(N) \
  case N:            \
    return conv<1, N, BWD_DX>(c, in, 64, wt, nullptr, nullptr, nullptr, nullptr, nullptr, out, \
                              nvalid, n_off);
    CWFA_CASE(16) CWFA_CASE(32) CWFA_CASE(48) CWFA_CASE(64)
#undef CWFA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// N above 64 only for a 1x1 (b1's wgrad, N = Cin up to 128: one tap's 64
// sums a thread); a 3x3 sums three taps a warpgroup and spills above 64
template <int KS>
int wgrad_n(const Ctx& c, int n, int n_tot, int n_off, const void* m_in, const void* n_in,
            int m_shift, int co, int ci, float* part, float* dw, float* dbias) {
  switch (n) {
#define CWFA_CASE(N) \
  case N:            \
    return wgrad<KS, N>(c, m_in, n_in, n_tot, n_off, m_shift, co, ci, part, dw, dbias);
    CWFA_CASE(16) CWFA_CASE(32) CWFA_CASE(48) CWFA_CASE(64)
  }
  if constexpr (KS == 1) {
    switch (n) { CWFA_CASE(80) CWFA_CASE(96) CWFA_CASE(112) CWFA_CASE(128) }
  }
#undef CWFA_CASE
  return (int)cudaErrorInvalidValue;
}

struct Layout {
  int64_t canvas, grad_f, x, dy, part, total;   // bytes
};

Layout layout(int b, int h, int w, int cin, int nout, int nsm) {
  const int64_t npos = (int64_t)b * h * w;
  const int64_t ntiles = (int64_t)b * ((h + kT - 1) / kT) * ((w + kT - 1) / kT);
  const int64_t nb = ntiles < nsm ? ntiles : nsm;
  Layout L;
  L.canvas = npos * 64 * 2;
  L.grad_f = npos * 64 * 4;
  L.x = npos * round16(cin) * 2;
  L.dy = npos * round16(nout) * 2;
  int64_t most = 3 * nb * 64 * 64;                                  // a 1x1
  most = most > nb * 64 * 64 * 9 ? most : nb * 64 * 64 * 9;         // a 3x3
  most = most > nb * 64 * (int64_t)nout * 9 ? most : nb * 64 * (int64_t)nout * 9;
  L.part = (most + nb * kWgThreads) * 4;
  L.total = 9 * L.canvas + 2 * L.grad_f + L.x + L.dy + L.part;
  return L;
}

int sm_count(int device, int* nsm) {
  return (int)cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, device);
}

// ---------------------------------------------------------------------------
// f32 as 3xTF32: the forward convs, the dgrads and the wgrads
// ---------------------------------------------------------------------------

constexpr int kThreadsF = 256;          // two warpgroups
constexpr int kRingF = 4;               // weight slices a conv keeps in flight

using tower::split_tf32;

// The f32 canvases: [batch][channel quad][H][W][4 f32], a 16-byte unit the
// 4 channels of one position.  NCHW f32 (C channels) -> cp channels (the
// rest zero).
__global__ void to_canvas_f32_kernel(const float* __restrict__ src, float4* __restrict__ dst,
                                     int B, int C, int cp, int64_t hw) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int nq = cp / 4;
  if (i >= (int64_t)B * nq * hw) return;
  const int64_t pos = i % hw;
  const int c4 = (int)((i / hw) % nq), b = (int)(i / (hw * nq));
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 4 * c4 + k;
    v[k] = c < C ? src[((int64_t)b * C + c) * hw + pos] : 0.f;
  }
  dst[i] = make_float4(v[0], v[1], v[2], v[3]);
}

struct ConvF {
  const void* in;           // canvas, kch channels
  const char* wp;           // per tap, per 32 input channels: hi [kc/4][N][4], then lo
  const float* bias;        // (N)
  const float2* res;        // canvas (64): added to the sums
  const float2* dcan;       // canvas (64): the sums times ELU'(from it)
  float2* out;              // canvas (64)
  float* out_nchw;          // NCHW (nvalid channels), from channel n_off
  int kch, nvalid, n_off;
  Tiles T;
};

// One block of two warpgroups per 16 x 16 output tile: the tile's window of
// kch channels in shared memory (cp.async), the conv's weight slices
// streamed through a ring of kRingF slots two ahead of the products, one
// block barrier a slice.  Warpgroup w owns the M tiles 2 w, 2 w + 1 (8 x 8
// blocks of the tile); A from registers, each value split into TF32 hi and
// lo as it is loaded; a slice's three products sum into zeroed registers
// that the CUDA cores add to the conv's sums.  Epilogue as MODE says (kBias,
// kResF, kElu, kDcan, then kOutF or kNchw).
template <int KS, int N, int MODE>
__global__ void __launch_bounds__(kThreadsF, 1) conv_tf32_kernel(const ConvF p) {
  constexpr int HALO = KS / 2, PW = kT + 2 * HALO, PLANE = PW * PW * 16, TAPS = KS * KS;
  constexpr int SLOT = 32 * N * 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const int nq = p.kch / 4;
  const uint32_t win = s0, ring = s0 + nq * PLANE;
  const int tid = threadIdx.x;
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  const Tiles& T = p.T;
  int b, y0, x0;
  T.at(blockIdx.x, b, y0, x0);

  // slice i: tap i / per_tap, input channels c .. c + kc - 1
  const int per_tap = (p.kch + 31) / 32, nslices = TAPS * per_tap;
  auto load_slice = [&](int i) {
    if (i < nslices) {
      const int tap = i / per_tap, c = (i % per_tap) * 32, kc = min(32, p.kch - c);
      const char* src = p.wp + ((int64_t)tap * p.kch + c) * N * 8;
      const uint32_t dst = ring + (i % kRingF) * SLOT;
      for (int o = tid * 16; o < kc * N * 8; o += kThreadsF * 16) tower::cp_async16(dst + o, src + o);
    }
    tower::cp_async_commit();
  };
  load_window(win, p.in, nq, 0, nq, HALO, b, y0, x0, T, tid, kThreadsF);
  tower::cp_async_commit();
  load_slice(0);
  load_slice(1);

  float acc[2][N / 2], part[N / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[m][e] = 0.f;
  uint32_t hi[4][4], lo[4][4];
  const uint64_t dw = wg::desc_base(N * 16, 128, wg::kSwizzleNone);
#pragma unroll 1
  for (int i = 0; i < nslices; ++i) {
    // slice i has landed (the window with slice 0), and every warpgroup is
    // done with slice i - 2, whose slot slice i + 2 takes
    tower::cp_async_wait<1>();
    wg::fence_proxy_async();
    __syncthreads();
    const int tap = i / per_tap, c = (i % per_tap) * 32, kc = min(32, p.kch - c);
    const uint32_t slot = ring + (i % kRingF) * SLOT;
    const int shift = (tap / KS) * PW + tap % KS;
#pragma unroll
    for (int mm = 0; mm < 2; ++mm) {
      const int m = 2 * wgi + mm;
      // rows 16 warp + g (+ 8) of M tile m: tile pixel (8 (m / 2) + 2 warp
      // (+ 1), 8 (m % 2) + g)
      const int p_lo = (8 * (m >> 1) + 2 * warp) * PW + 8 * (m & 1) + g + shift;
      tower::load_frags(hi, lo, win, PLANE, p_lo, p_lo + PW, c >> 2, kc >> 3, q);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) part[e] = 0.f;
      wg::fence();
      tower::mma_3xtf32<N>(part, hi, lo, kc >> 3, dw, slot, kc * N * 4);
      wg::commit();
      if (mm == 0) load_slice(i + 2);
      tower::finish_3xtf32(part, hi, lo);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[mm][e] += part[e];
    }
  }

  const int64_t hw = (int64_t)T.H * T.W;
#pragma unroll
  for (int mm = 0; mm < 2; ++mm) {
    const int m = 2 * wgi + mm;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + 8 * (m >> 1) + 2 * warp + h, x = x0 + 8 * (m & 1) + g;
      if (y >= T.H || x >= T.W) continue;
      const int64_t u0 = (((int64_t)b * (tower::kC / 4)) * T.H + y) * T.W + x;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int ch = 8 * j + 2 * q;
        // the float2 of channels ch, ch + 1 in a 64-channel canvas
        const int64_t u = (u0 + (ch >> 2) * hw) * 2 + ((ch >> 1) & 1);
        float v0 = acc[mm][4 * j + 2 * h], v1 = acc[mm][4 * j + 2 * h + 1];
        if (MODE & kBias) {
          v0 += p.bias[ch];
          v1 += p.bias[ch + 1];
        }
        if (MODE & kResF) {
          const float2 r = p.res[u];
          v0 += r.x;
          v1 += r.y;
        }
        if (MODE & kElu) {
          v0 = elu(v0);
          v1 = elu(v1);
        }
        if (MODE & kDcan) {
          const float2 e = p.dcan[u];
          v0 *= fminf(e.x, 0.f) + 1.f;
          v1 *= fminf(e.y, 0.f) + 1.f;
        }
        if (MODE & kOutF) p.out[u] = make_float2(v0, v1);
        if (MODE & kNchw) {
          const int n = p.n_off + ch;
          const int64_t o = (((int64_t)b * p.nvalid + n) * T.H + y) * T.W + x;
          if (n < p.nvalid) p.out_nchw[o] = v0;
          if (n + 1 < p.nvalid) p.out_nchw[o + hw] = v1;
        }
      }
    }
  }
}

struct WgradF {
  const void* a_in;         // canvas of a_tot quads: the conv's input
  const void* g_in;         // canvas of g_tot quads: the gradient, N channels from n_off
  float* part;              // per partial [co - n_off][ci][taps]
  float* bpart;             // per (block, position group) [N]: the bias sums
  int a_tot, g_tot, n_off;
  int co, ci;               // the conv's real channel counts
  Tiles T;
};

// dW^T[ci][co] of one tap = sum_p in[ci](p + tap) g[co](p): M = 64 input
// channels (A from registers, read from the input's window with its halo,
// so a tap is a shifted read), N = output channels (B: the gradient's tile,
// split into TF32 hi and lo and staged K-major, [4 positions][N][4],
// through registers), K = the tile's positions, two warpgroups on its top
// and bottom 8 rows.  Grid (blocks, groups), persistent over the tiles:
// for a 3x3 group r takes the kernel row r (taps 3 r .. 3 r + 2), for a 1x1
// group r the input channels 64 r .. 64 r + 63.  Per tile and tap the
// products sum into zeroed registers that the CUDA cores add on; the bias
// sums (group 0) ride along with the staging.
template <int KS, int N>
__global__ void __launch_bounds__(kThreadsF, 1) wgrad_tf32_kernel(const WgradF p) {
  constexpr int HALO = KS / 2, PW = kT + 2 * HALO, TAPS = KS * KS, NT = KS == 3 ? 3 : 1;
  // positions a plane of the input's window: 4 mod 8, so that a fragment's
  // 32 loads (8 channels x 4 positions) hit 32 banks
  constexpr int APOS = KS == 3 ? PW * PW : kT * kT + 4, APLANE = APOS * 16;
  // bytes of a group of 4 positions of B: N rows of 16 bytes, and 16 more
  // so that the staging's stores spread over the banks
  constexpr int GSTRIDE = N * 16 + 16, BBYTES = kT * kT / 4 * GSTRIDE;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t aw = s0, bh = s0 + 16 * APLANE, bl = bh + BBYTES;
  const int tid = threadIdx.x;
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, q = tid & 3;
  const Tiles& T = p.T;
  const int grp = blockIdx.y, m0 = KS == 3 ? 0 : 64 * grp;
  const int nq = min(16, p.a_tot - m0 / 4);
  const bool bias = grp == 0;
  const uint64_t dB = wg::desc_base(GSTRIDE, 128, wg::kSwizzleNone);
  const float4* gsrc = static_cast<const float4*>(p.g_in);

  float acc[NT][N / 2], part[N / 2], bsum[N / 16][4];
#pragma unroll
  for (int k = 0; k < NT; ++k)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[k][e] = 0.f;
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) bsum[k][c] = 0.f;
  uint32_t hi[4][4], lo[4][4];

#pragma unroll 1
  for (int t = blockIdx.x; t < T.n; t += gridDim.x) {
    int b, y0, x0;
    T.at(t, b, y0, x0);
    __syncthreads();                    // the last tile's operands are read
    load_window(aw, p.a_in, p.a_tot, m0 / 4, nq, HALO, b, y0, x0, T, tid, kThreadsF, APOS);
    tower::cp_async_commit();
    // B: a thread takes quad tid / 64 + 4 k of the N channels at the 4
    // positions of group gp = tid % 64 (tile row gp / 4, columns 4 (gp % 4)
    // ..), one column of the four a channel
#pragma unroll
    for (int k = 0; k < N / 16; ++k) {
      const int qd = tid / 64 + 4 * k, gp = tid % 64;
      const int y = y0 + gp / 4, xb = x0 + 4 * (gp % 4);
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (y < T.H && xb + i < T.W)
          v[i] = gsrc[(((int64_t)b * p.g_tot + p.n_off / 4 + qd) * T.H + y) * T.W + xb + i];
      }
      const float col[4][4] = {{v[0].x, v[1].x, v[2].x, v[3].x},
                               {v[0].y, v[1].y, v[2].y, v[3].y},
                               {v[0].z, v[1].z, v[2].z, v[3].z},
                               {v[0].w, v[1].w, v[2].w, v[3].w}};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t h4[4], l4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(col[c][i], h4[i], l4[i]);
        const uint32_t o = gp * GSTRIDE + (4 * qd + c) * 16;
        tower::sts128(bh + o, h4[0], h4[1], h4[2], h4[3]);
        tower::sts128(bl + o, l4[0], l4[1], l4[2], l4[3]);
        if (bias) bsum[k][c] += (col[c][0] + col[c][1]) + (col[c][2] + col[c][3]);
      }
    }
    tower::cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();

#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int tap = KS == 3 ? 3 * grp + k : 0;
      const int shift = (tap / KS) * PW + tap % KS;
#pragma unroll
      for (int e = 0; e < N / 2; ++e) part[e] = 0.f;
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {
        // four k-steps: tile rows 8 wgi + 2 s, + 1, each in two halves of 8
        // positions; A rows (input channels) 16 warp + g and + 8 are quads
        // 4 warp + g / 4 and + 2, element g % 4; k = positions q and q + 4
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = 4 * s + i, r = 8 * wgi + (kk >> 1);
          const uint32_t a = aw + (4 * warp + (g >> 2)) * APLANE +
                             (r * PW + 8 * (kk & 1) + q + shift) * 16 + (g & 3) * 4;
          split_tf32(__uint_as_float(tower::lds32(a)), hi[i][0], lo[i][0]);
          split_tf32(__uint_as_float(tower::lds32(a + 2 * APLANE)), hi[i][1], lo[i][1]);
          split_tf32(__uint_as_float(tower::lds32(a + 64)), hi[i][2], lo[i][2]);
          split_tf32(__uint_as_float(tower::lds32(a + 2 * APLANE + 64)), hi[i][3], lo[i][3]);
        }
        wg::fence();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = 4 * s + i, gp = 4 * (8 * wgi + (kk >> 1)) + 2 * (kk & 1);
          const uint64_t dh = wg::desc_at(dB, bh + gp * GSTRIDE);
          const uint64_t dl = wg::desc_at(dB, bl + gp * GSTRIDE);
          wg::wgmma_rs_tf32<N>(part, lo[i], dh);
          wg::wgmma_rs_tf32<N>(part, hi[i], dl);
          wg::wgmma_rs_tf32<N>(part, hi[i], dh);
        }
        wg::commit();
        tower::finish_3xtf32(part, hi, lo);
      }
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[k][e] += part[e];
    }
  }

  // this warpgroup's partial sums, in the OIHW order of dW, from output n_off
  const int nco = min(p.co - p.n_off, N);
  float* part_out = p.part + (int64_t)(blockIdx.x * 2 + wgi) * nco * p.ci * TAPS;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int tap = KS == 3 ? 3 * grp + k : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = m0 + 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * j + 2 * q + e;
          if (co < nco && ci < p.ci)
            part_out[((int64_t)co * p.ci + ci) * TAPS + tap] = acc[k][4 * j + 2 * h + e];
        }
    }
  }
  if (bias)
#pragma unroll
    for (int k = 0; k < N / 16; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p.bpart[((int64_t)blockIdx.x * 64 + tid % 64) * N + 4 * (tid / 64 + 4 * k) + c] =
            bsum[k][c];
}

template <int KS, int N, int MODE>
int conv_f32(const Ctx& c, const void* in, int kch, const char* wt, const float* bias,
             const void* res, const void* dcan, void* out, void* out_nchw = nullptr,
             int nvalid = 0, int n_off = 0) {
  constexpr int PW = kT + 2 * (KS / 2);
  ConvF p;
  p.in = in;
  p.wp = wt;
  p.bias = bias;
  p.res = static_cast<const float2*>(res);
  p.dcan = static_cast<const float2*>(dcan);
  p.out = static_cast<float2*>(out);
  p.out_nchw = static_cast<float*>(out_nchw);
  p.kch = kch;
  p.nvalid = nvalid;
  p.n_off = n_off;
  p.T = c.T;
  const int smem = (kch / 4) * PW * PW * 16 + kRingF * 32 * N * 8;
  if (kch % 8 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_tf32_kernel<KS, N, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_tf32_kernel<KS, N, MODE><<<c.T.n, kThreadsF, smem, c.s>>>(p);
  return (int)cudaGetLastError();
}

// The dgrad into dx: NCHW f32 channels n_off .. n_off + n - 1 of nvalid.
int conv1_f32_n(const Ctx& c, int n, const void* in, const char* wt, void* out, int nvalid,
                int n_off) {
  switch (n) {
#define CWFA_CASE(N)                                                                        \
  case N:                                                                                   \
    return conv_f32<1, N, kNchw>(c, in, 64, wt, nullptr, nullptr, nullptr, nullptr, out, \
                                 nvalid, n_off);
    CWFA_CASE(16) CWFA_CASE(32) CWFA_CASE(48) CWFA_CASE(64)
#undef CWFA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// dW, db of output channels [n_off, n_off + n) of a conv with co outputs
// and ci inputs: the input canvas of a_tot quads, the gradient of g_tot.
// One block a streaming multiprocessor over the groups.
template <int KS>
int wgrad_f32_n(const Ctx& c, int n, const void* a_in, int a_tot, const void* g_in, int g_tot,
                int n_off, int co, int ci, float* part, float* dw, float* dbias) {
  constexpr int TAPS = KS * KS;
  const int groups = KS == 3 ? 3 : (ci + 63) / 64;
  const int gx = std::max(1, std::min(c.T.n, c.nsm / groups));
  const int nco = std::min(co - n_off, n);
  const int64_t nw = (int64_t)nco * ci * TAPS;
  WgradF p;
  p.a_in = a_in;
  p.g_in = g_in;
  p.a_tot = a_tot;
  p.g_tot = g_tot;
  p.n_off = n_off;
  p.co = co;
  p.ci = ci;
  p.T = c.T;
  p.part = part;
  p.bpart = part + 2 * gx * nw;
  const int apos = KS == 3 ? (kT + 2) * (kT + 2) : kT * kT + 4;
  const int smem = 16 * apos * 16 + 2 * (kT * kT / 4) * (n * 16 + 16);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (n) {
#define CWFA_CASE(N)                                                               \
  case N:                                                                          \
    err = cudaFuncSetAttribute(wgrad_tf32_kernel<KS, N>,                           \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
    if (err != cudaSuccess) return (int)err;                                       \
    wgrad_tf32_kernel<KS, N><<<dim3(gx, groups), kThreadsF, smem, c.s>>>(p);       \
    break;
    CWFA_CASE(16) CWFA_CASE(32) CWFA_CASE(48) CWFA_CASE(64)
#undef CWFA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_parts(part, dw + (int64_t)n_off * ci * TAPS, 2 * gx, nw, nw, c.s);
  sum_parts(p.bpart, dbias + n_off, gx * 64, nco, n, c.s);
  return (int)cudaGetLastError();
}

struct LayoutF {
  int64_t canvas, x, dy, part, total;   // bytes
};

LayoutF layout_f32(int b, int h, int w, int cin, int nout, int nsm) {
  const int64_t npos = (int64_t)b * h * w;
  LayoutF L;
  L.canvas = npos * 64 * 4;
  L.x = npos * round16(cin) * 4;
  L.dy = npos * round16(nout) * 4;
  // the most partials: a 3x3 of 64 x 64 (b7's outputs in launches of at
  // most 64) or b1's 1x1 of up to 128 inputs, two a block, then the bias
  // sums, 64 position groups a block
  const int64_t nb = nsm, nw = std::max<int64_t>(64 * 64 * 9, 64 * 128);
  L.part = (2 * nb * nw + nb * 64 * 64) * 4;
  L.total = 10 * L.canvas + L.x + L.dy + L.part;
  return L;
}

}  // namespace

// Bytes of scratch cwfa_btower_bwd_wg needs.
extern "C" int64_t cwfa_btower_bwd_wg_scratch(int b, int h, int w, int cin, int nout,
                                              int device) {
  int nsm = 0;
  if (sm_count(device, &nsm) != 0) return -1;
  return layout(b, h, w, cin, nout, nsm).total;
}

// x: (B, cin, H, W) bf16; dy: (B, nout, H, W) bf16; wp: the pack of
// ops/btower.pack_float_tower_bwd (bf16, 16-byte aligned): the forward
// slices of b1, b2a, b2b, b4a, b4b, b6a, b6b ([tap][K/8][64][8], K = cin
// padded to 16 for b1, else 64), then the dgrad slices of b7, b6b, b6a, b4b,
// b4a, b2b, b2a, b1 (taps flipped, in and out swapped: [tap][K/8][N][8], K =
// nout padded to 16 for b7, else 64; N = 64 but for b1, whose N = cin padded
// to 16 comes in chunks of at most 64 outputs, one after the other);
// bias: the 7 x 64 f32 biases of b1 .. b6b.  dx: (B, cin, H, W) bf16;
// dw[8] (OIHW), db[8] (Co): f32, in the order b1, b2a, b2b, b4a, b4b, b6a,
// b6b, b7.  scratch: cwfa_btower_bwd_wg_scratch bytes, 16-byte aligned.
// The tower is 64 wide, cin <= 128, nout <= 96.
extern "C" int cwfa_btower_bwd_wg(const void* x, const void* dy, const void* wp,
                                  const float* bias, void* dx, float* const* dw,
                                  float* const* db, void* scratch, int b, int h, int w,
                                  int cin, int nout, int device, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin > 128 || nout <= 0 || nout > 96 ||
      reinterpret_cast<uintptr_t>(wp) % 16 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Ctx c;
  if (sm_count(device, &c.nsm) != 0) return (int)cudaErrorInvalidValue;
  c.T.H = h;
  c.T.W = w;
  c.T.tw = (w + kT - 1) / kT;
  c.T.th = (h + kT - 1) / kT;
  c.T.n = b * c.T.tw * c.T.th;
  c.s = static_cast<cudaStream_t>(stream);
  const int cinp = round16(cin), noutp = round16(nout);
  const Layout L = layout(b, h, w, cin, nout, c.nsm);
  char* sp = static_cast<char*>(scratch);
  void* cv[7];                  // r1, a2, e2, a4, e4, a6, e6
  for (int i = 0; i < 7; ++i) cv[i] = sp + i * L.canvas;
  void* gb[2] = {sp + 7 * L.canvas, sp + 8 * L.canvas};   // bf16 gradients
  void* gf[2] = {sp + 9 * L.canvas, sp + 9 * L.canvas + L.grad_f};   // f32
  char* xc = sp + 9 * L.canvas + 2 * L.grad_f;
  char* dyc = xc + L.x;
  float* part = reinterpret_cast<float*>(dyc + L.dy);

  // the weight slices, in the pack's order
  const char* wpk = static_cast<const char*>(wp);
  const char* fw[7];
  const char* dwt[8];           // dgrad slices of b7, b6b, b6a, b4b, b4a, b2b, b2a, b1
  int64_t off = 0;
  for (int i = 0; i < 7; ++i) {
    fw[i] = wpk + off;
    off += (int64_t)(i == 0 ? cinp : 64) * 64 * 2 * (i % 2 ? 9 : 1);
  }
  for (int i = 0; i < 8; ++i) {
    dwt[i] = wpk + off;
    const int taps = i == 0 || (i % 2 == 0 && i < 7) ? 9 : 1;
    const int k = i == 0 ? noutp : 64, n = i == 7 ? cinp : 64;
    off += (int64_t)taps * k * n * 2;
  }
  const float* bi[7];
  for (int i = 0; i < 7; ++i) bi[i] = bias + 64 * i;

  int rc;
#define RUN(call)           \
  do {                      \
    rc = (call);            \
    if (rc != 0) return rc; \
  } while (0)
  const int64_t hw = (int64_t)h * w;
  {
    const int64_t nx = (int64_t)b * (cinp / 8) * hw, ny = (int64_t)b * (noutp / 8) * hw;
    to_canvas_kernel<<<(unsigned)((nx + 255) / 256), 256, 0, c.s>>>(
        static_cast<const uint16_t*>(x), reinterpret_cast<uint4*>(xc), b, cin, cinp, hw);
    to_canvas_kernel<<<(unsigned)((ny + 255) / 256), 256, 0, c.s>>>(
        static_cast<const uint16_t*>(dy), reinterpret_cast<uint4*>(dyc), b, nout, noutp, hw);
    RUN((int)cudaGetLastError());
  }
  // 1. the forward again: r1, then (a, e) of each residual block
  RUN((conv<1, 64, FWD_R1>(c, xc, cinp, fw[0], bi[0], nullptr, nullptr, cv[0], nullptr)));
  for (int k = 0; k < 3; ++k) {
    const void* e = cv[2 * k];            // r1, e2, e4
    RUN((conv<3, 64, FWD_A>(c, e, 64, fw[1 + 2 * k], bi[1 + 2 * k], nullptr, nullptr,
                            cv[1 + 2 * k], nullptr)));
    RUN((conv<1, 64, FWD_E>(c, cv[1 + 2 * k], 64, fw[2 + 2 * k], bi[2 + 2 * k], e, nullptr,
                            cv[2 + 2 * k], nullptr)));
  }
  // 2. backwards.  g_e6 = b7^T(dy) * ELU'(e6), in f32 and bf16
  RUN((conv<3, 64, BWD_TOP>(c, dyc, noutp, dwt[0], nullptr, cv[6], nullptr, gb[0], gf[0])));
  // dW7 (M = e6 shifted, N = dy): at most 64 outputs a launch
  for (int n0 = 0; n0 < noutp; n0 += 48) {
    const int n = noutp <= 64 ? noutp : std::min(48, noutp - n0);
    RUN(wgrad_n<3>(c, n, noutp, n0, cv[6], dyc, 1, nout, 64, part, dw[7], db[7]));
    if (noutp <= 64) break;
  }
  // each residual block from the top: (a, e) = (a6, e6), (a4, e4), (a2, e2)
  for (int k = 2; k >= 0; --k) {
    const void* a = cv[1 + 2 * k];
    const void* below = cv[2 * k];         // e4, e2, r1: the block's input
    const int slot = 2 * (2 - k);          // dgrad slices of the 1x1, then the 3x3
    // g_a = b_1x1^T(g_e) * ELU'(a)                   gb[0] -> gb[1]
    RUN((conv<1, 64, BWD_A>(c, gb[0], 64, dwt[1 + slot], nullptr, a, nullptr, gb[1],
                            nullptr)));
    RUN(wgrad_n<1>(c, 64, 64, 0, gb[0], a, 0, 64, 64, part, dw[2 + 2 * k], db[2 + 2 * k]));
    // g_below = (b_3x3^T(g_a) + g_e) * ELU'(below), no ELU' for r1
    const int fi = (2 - k) & 1;            // g_e's f32 copy: gf[0], gf[1], gf[0]
    if (k > 0)
      RUN((conv<3, 64, BWD_E>(c, gb[1], 64, dwt[2 + slot], nullptr, below, gf[fi], gb[0],
                              gf[fi ^ 1])));
    else
      RUN((conv<3, 64, BWD_R1>(c, gb[1], 64, dwt[2 + slot], nullptr, nullptr, gf[fi], gb[0],
                               nullptr)));
    RUN(wgrad_n<3>(c, 64, 64, 0, gb[1], below, 0, 64, 64, part, dw[1 + 2 * k],
                   db[1 + 2 * k]));
  }
  // dx = b1^T(g_r1), at most 64 of its channels a launch (the sums of N
  // above 64 do not fit a thread's registers beside the four M tiles); dW1
  // from g_r1 and x
  for (int n0 = 0; n0 < cinp; n0 += 64)
    RUN(conv1_n(c, std::min(64, cinp - n0), gb[0], dwt[7] + (int64_t)n0 * 64 * 2, dx, cin,
                n0));
  RUN(wgrad_n<1>(c, cinp, cinp, 0, gb[0], xc, 0, 64, cin, part, dw[0], db[0]));
#undef RUN
  return 0;
}

// Bytes of scratch cwfa_btower_bwd_tf32 needs.
extern "C" int64_t cwfa_btower_bwd_tf32_scratch(int b, int h, int w, int cin, int nout,
                                                int device) {
  int nsm = 0;
  if (sm_count(device, &nsm) != 0) return -1;
  return layout_f32(b, h, w, cin, nout, nsm).total;
}

// The f32 instance, its products as 3xTF32.  x: (B, cin, H, W) f32; dy:
// (B, nout, H, W) f32; wp: the pack of ops/btower.pack_float_tower_bwd for
// f32 (16-byte aligned): per conv, per tap, per 32 input channels the TF32
// high parts [kc/4][N][4] then the low parts; the forward convs b1 .. b6b
// (b1's K = cin padded to 16, N = 64), then the dgrads of b7 (K = nout
// padded to 16), b6b .. b2a and b1 (N = cin in chunks of at most 64, each
// padded to 16); bias: the 7 x 64 f32 biases of b1 .. b6b.  dx: (B, cin,
// H, W) f32; dw[8] (OIHW), db[8]: f32, in the order b1 .. b7.  scratch:
// cwfa_btower_bwd_tf32_scratch bytes, 16-byte aligned.  The tower is 64
// wide, cin <= 128, nout <= 96.
extern "C" int cwfa_btower_bwd_tf32(const void* x, const void* dy, const void* wp,
                                    const float* bias, void* dx, float* const* dw,
                                    float* const* db, void* scratch, int b, int h, int w,
                                    int cin, int nout, int device, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin > 128 || nout <= 0 || nout > 96 ||
      reinterpret_cast<uintptr_t>(wp) % 16 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Ctx c;
  if (sm_count(device, &c.nsm) != 0) return (int)cudaErrorInvalidValue;
  c.T.H = h;
  c.T.W = w;
  c.T.tw = (w + kT - 1) / kT;
  c.T.th = (h + kT - 1) / kT;
  c.T.n = b * c.T.tw * c.T.th;
  c.s = static_cast<cudaStream_t>(stream);
  const int cinp = round16(cin), noutp = round16(nout);
  const LayoutF L = layout_f32(b, h, w, cin, nout, c.nsm);
  char* sp = static_cast<char*>(scratch);
  void* cv[7];                  // r1, a2, e2, a4, e4, a6, e6
  for (int i = 0; i < 7; ++i) cv[i] = sp + i * L.canvas;
  void* ge[2] = {sp + 7 * L.canvas, sp + 8 * L.canvas};   // the residual chain's gradient
  void* ga = sp + 9 * L.canvas;                           // a 3x3's output gradient
  char* xc = sp + 10 * L.canvas;
  char* dyc = xc + L.x;
  float* part = reinterpret_cast<float*>(dyc + L.dy);

  // the weight slices, in the pack's order: a conv's taps x K x N, hi + lo
  const char* wpk = static_cast<const char*>(wp);
  const char* fw[7];
  const char* dwt[8];           // dgrads of b7, b6b, b6a, b4b, b4a, b2b, b2a, b1
  int64_t off = 0;
  for (int i = 0; i < 7; ++i) {
    fw[i] = wpk + off;
    off += (int64_t)(i % 2 ? 9 : 1) * (i == 0 ? cinp : 64) * 64 * 8;
  }
  for (int i = 0; i < 7; ++i) {
    dwt[i] = wpk + off;
    off += (int64_t)(i % 2 ? 1 : 9) * (i == 0 ? noutp : 64) * 64 * 8;
  }
  dwt[7] = wpk + off;
  const float* bi[7];
  for (int i = 0; i < 7; ++i) bi[i] = bias + 64 * i;

  int rc;
#define RUN(call)           \
  do {                      \
    rc = (call);            \
    if (rc != 0) return rc; \
  } while (0)
  const int64_t hw = (int64_t)h * w;
  {
    const int64_t nx = (int64_t)b * (cinp / 4) * hw, ny = (int64_t)b * (noutp / 4) * hw;
    to_canvas_f32_kernel<<<(unsigned)((nx + 255) / 256), 256, 0, c.s>>>(
        static_cast<const float*>(x), reinterpret_cast<float4*>(xc), b, cin, cinp, hw);
    to_canvas_f32_kernel<<<(unsigned)((ny + 255) / 256), 256, 0, c.s>>>(
        static_cast<const float*>(dy), reinterpret_cast<float4*>(dyc), b, nout, noutp, hw);
    RUN((int)cudaGetLastError());
  }
  constexpr int F_R1 = kBias | kOutF, F_A = kBias | kElu | kOutF;
  constexpr int F_E = kBias | kResF | kElu | kOutF;
  constexpr int B_G = kDcan | kOutF, B_E = kResF | kDcan | kOutF, B_R1 = kResF | kOutF;
  // 1. the forward again: r1, then (a, e) of each residual block
  RUN((conv_f32<1, 64, F_R1>(c, xc, cinp, fw[0], bi[0], nullptr, nullptr, cv[0])));
  for (int k = 0; k < 3; ++k) {
    const void* e = cv[2 * k];            // r1, e2, e4
    RUN((conv_f32<3, 64, F_A>(c, e, 64, fw[1 + 2 * k], bi[1 + 2 * k], nullptr, nullptr,
                              cv[1 + 2 * k])));
    RUN((conv_f32<1, 64, F_E>(c, cv[1 + 2 * k], 64, fw[2 + 2 * k], bi[2 + 2 * k], e, nullptr,
                              cv[2 + 2 * k])));
  }
  // 2. backwards.  g_e6 = b7^T(dy) * ELU'(e6)
  RUN((conv_f32<3, 64, B_G>(c, dyc, noutp, dwt[0], nullptr, nullptr, cv[6], ge[0])));
  // dW7 (M = e6 shifted, N = dy): at most 64 outputs a launch
  for (int n0 = 0; n0 < noutp; n0 += 48) {
    const int n = noutp <= 64 ? noutp : std::min(48, noutp - n0);
    RUN(wgrad_f32_n<3>(c, n, cv[6], 16, dyc, noutp / 4, n0, nout, 64, part, dw[7], db[7]));
    if (noutp <= 64) break;
  }
  // each residual block from the top: (a, e) = (a6, e6), (a4, e4), (a2, e2)
  for (int k = 2; k >= 0; --k) {
    const void* a = cv[1 + 2 * k];
    const void* below = cv[2 * k];         // e4, e2, r1: the block's input
    const int slot = 2 * (2 - k);          // dgrads of the 1x1, then the 3x3
    const int fi = (2 - k) & 1;            // g_e in ge[fi], the next in ge[fi ^ 1]
    // g_a = b_1x1^T(g_e) * ELU'(a)
    RUN((conv_f32<1, 64, B_G>(c, ge[fi], 64, dwt[1 + slot], nullptr, nullptr, a, ga)));
    RUN(wgrad_f32_n<1>(c, 64, a, 16, ge[fi], 16, 0, 64, 64, part, dw[2 + 2 * k],
                       db[2 + 2 * k]));
    // g_below = (b_3x3^T(g_a) + g_e) * ELU'(below), no ELU' for r1
    if (k > 0)
      RUN((conv_f32<3, 64, B_E>(c, ga, 64, dwt[2 + slot], nullptr, ge[fi], below,
                                ge[fi ^ 1])));
    else
      RUN((conv_f32<3, 64, B_R1>(c, ga, 64, dwt[2 + slot], nullptr, ge[fi], nullptr,
                                 ge[fi ^ 1])));
    RUN(wgrad_f32_n<3>(c, 64, below, 16, ga, 16, 0, 64, 64, part, dw[1 + 2 * k],
                       db[1 + 2 * k]));
  }
  // dx = b1^T(g_r1), at most 64 of its channels a launch; dW1 from g_r1 and
  // x (M = x's channels in chunks of 64)
  const void* gr1 = ge[1];                 // after three blocks: ge[fi ^ 1] of k = 0
  for (int n0 = 0; n0 < cinp; n0 += 64)
    RUN(conv1_f32_n(c, std::min(64, cinp - n0), gr1, dwt[7] + (int64_t)n0 * 64 * 8, dx, cin,
                    n0));
  RUN(wgrad_f32_n<1>(c, 64, xc, cinp / 4, gr1, 16, 0, 64, cin, part, dw[0], db[0]));
#undef RUN
  return 0;
}
