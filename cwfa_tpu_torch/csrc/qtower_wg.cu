// The 64-wide int8 subnet tower on Hopper's warpgroup tensor cores (wgmma
// m64nNk32 s8 x s8 -> s32, sm_90a).  Same function and plain version
// (quantized_tower_reference in cwfa_tpu_torch/ops/qtower.py), equal to the
// bit, as csrc/qtower.cu, which keeps the __dp4a instance for the other
// widths; replaces the Pallas TPU kernel cwfa_tpu/ops/qtower.py:454
// (fused_pair_tower).
//
//   r1  = b1(x)                          1x1, Cin -> 64
//   e2  = elu(b2b(elu(b2a(r1))) + r1)    3x3, 1x1, residual
//   e4  = elu(b4b(elu(b4a(e2))) + e2)
//   e6  = elu(b6b(elu(b6a(e4))) + e4)
//   out = b7(e6)                         3x3, 64 -> Nout
//
// Every conv input is int8 (v * inv_scale, round half to even, clip to
// +-127), every product sums in int32 (exact in any order), every epilogue
// (dequant, bias, ELU, requant, residual) is f32, and the residual canvases
// r1, e2, e4 are bf16.
//
// Bound: int8 multiply-adds (~181 k per pixel at step 0 against ~48 bytes in
// and 192 out).  What sets the pace here is not the tensor cores but the
// epilogues on the CUDA cores: each of the 64 x 7 values per pixel is
// dequantized, passed through expf and requantized with every f32 operation
// rounded as the plain version rounds it (no FMA contraction, no fast
// math), some 25 instructions a value, while a 64 x 64 x 576 tile-conv is
// 18 products of 32 clocks.  The block's warpgroups move in step (one block
// per SM), so the tensor cores idle during the epilogues and the CUDA cores
// during the products.
//
// Design (the skeleton of csrc/btower_wg.cu's bf16 instance, csrc/tower_wg.cuh):
//   - One block of three warpgroups per (batch, 16 x 16 output tile), the
//     24 x 24 canvas as [16-channel chunk][position][16 bytes]: a chunk is
//     one K core matrix of the s8 product, k = 32 is two chunks, a 3x3 tap
//     a shifted no-swizzle descriptor.  Two int8 canvases ping-pong (x, q2,
//     q6 in one, q1, q4 in the other: 2 x 36 KB) beside one bf16 residual
//     canvas (72 KB) that a thread reads and rewrites in place.
//   - The weight pack (ops/qtower.pack_tower_wg) is streamed in consumption
//     order, a tap of a conv at a time, through the cp.async ring.
//   - 3x3 -> dequant -> ELU -> requant -> 1x1 stays in registers.  A thread
//     holds the s32 sums of columns 8 j + 2 q, 8 j + 2 q + 1; an s8 A
//     fragment wants 4 consecutive k per register.  The pack permutes the
//     1x1's input channels so that slot 4 q + e of every 16 is channel
//     8 (e / 2) + 2 q + e % 2: a thread's own 16 values of a row fill its
//     own A registers, four to a register, and no value crosses threads.
//   - Epilogues use __fmul_rn / __fadd_rn, expf and a round-to-nearest-even
//     conversion; every quantized canvas that feeds a 3x3 conv is 0 outside
//     the image (SAME padding).
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, returns cudaGetLastError().

#include "tower_wg.cuh"

namespace {

using namespace tower;

struct Params {
  const int8_t* x;     // (B, cin, H, W)
  const char* wp;      // weight pack, slices in order of use
  const float* inv;    // (8, 64) reciprocal activation scales
  const float* sw;     // (7, 64) dequant scales of b1..b6b
  const float* bias;   // (7, 64)
  const float* sw7;    // (nout)
  const float* bias7;  // (nout)
  void* out;           // (B, nout, H, W), f32 or bf16
  int H, W, cin, cinp, nout, nslices, out_bf16;
  int vec_in;          // W % 4 == 0 and x 4-byte aligned: 4 pixels a load
  int vec_out;         // bf16 out, W % 8 == 0, out 16-byte aligned
  int2 slice[kMaxSlices];   // (byte offset in the pack, bytes), in order of use
};

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : __fsub_rn(expf(fminf(v, 0.f)), 1.f);
}
// round half to even, clip to +-127 (the conversion rounds as rintf does)
__device__ __forceinline__ int quant(float v, float inv) {
  return max(-127, min(127, __float2int_rn(__fmul_rn(v, inv))));
}
__device__ __forceinline__ float deq(int acc, float sw, float b) {
  return __fadd_rn(__fmul_rn((float)acc, sw), b);
}
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)d << 24);
}
__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"((uint16_t)v) : "memory");
}

template <int NP7>
struct S8 {
  static constexpr int kTH = 16, kSH = kTH + 2 * kHalo, kP = kSH * kSW;
  // bytes of one plane: 16 int8 channels, or 8 bf16 channels, of every position
  static constexpr int kPlane = kP * 16;
  static constexpr int kRes = (kC / 8) * kPlane;       // the bf16 residual canvas
  static constexpr int kCanvas = (kC / 16) * kPlane;   // one int8 canvas
  static constexpr int kSlot = (NP7 > kC ? NP7 : kC) * 64;
  static constexpr int kQa = kRes, kQb = kRes + kCanvas;
  static constexpr int kRingAt = kRes + 2 * kCanvas;
  static constexpr int kTab = kRingAt + kRing * kSlot;
  // inv (8 x 64), sw (7 x 64), bias (7 x 64), sw7, bias7
  static constexpr int kNTab = 22 * kC + 2 * NP7;
  static constexpr int kSmem = kTab + kNTab * 4;
};

template <int NP7>
__global__ void __launch_bounds__(kThreads, 1) qtower_wg_kernel(const Params p) {
  using G = S8<NP7>;
  constexpr int PL = G::kPlane;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t res = s0, qa = s0 + G::kQa, qb = s0 + G::kQb;
  float* tab = reinterpret_cast<float*>(smem + G::kTab);
  const float* inv = tab;
  const float* sw = tab + 8 * kC;
  const float* bias = tab + 15 * kC;
  const float* sw7 = tab + 22 * kC;
  const float* bias7 = sw7 + NP7;
  Block<Params, G::kSH, G::kSlot> B(p, G::kTH, s0 + G::kRingAt);
  const int tid = B.tid, wgi = B.wgi, q = B.q;
  const int b = blockIdx.z, H = p.H, W = p.W;

  B.load_slice(0);
  B.load_slice(1);

  for (int i = tid; i < G::kNTab; i += kThreads) {
    float v;
    if (i < 8 * kC) {
      v = p.inv[i];
    } else if (i < 15 * kC) {
      v = p.sw[i - 8 * kC];
    } else if (i < 22 * kC) {
      v = p.bias[i - 15 * kC];
    } else {
      const int j = i - 22 * kC;
      const int oc = j < NP7 ? j : j - NP7;
      v = oc < p.nout ? (j < NP7 ? p.sw7[oc] : p.bias7[oc]) : 0.f;
    }
    tab[i] = v;
  }
  // the int8 input window (zero outside the image and in the channels that
  // pad Cin) into canvas B
  if (p.vec_in) {
    // a thread takes 16 channels x 4 pixels of a row (one 4-byte load per
    // channel, all in flight together), transposes the 16 x 4 bytes and
    // writes 4 positions of 16 bytes
    const uint32_t* x = reinterpret_cast<const uint32_t*>(p.x);
    const int nunits = (p.cinp >> 4) * G::kSH * 6;
    for (int u = tid; u < nunits; u += kThreads) {
      const int o = u / (G::kSH * 6), rem = u % (G::kSH * 6);
      const int R = rem / 6, Cc = (rem % 6) * 4;
      const int gr = B.r0 + R, gc = B.c0 + Cc;
      const bool in = (unsigned)gr < (unsigned)H && (unsigned)gc < (unsigned)W;
      uint32_t v[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int ch = 16 * o + c;
        v[c] = 0u;
        if (in && ch < p.cin)
          v[c] = __ldg(x + ((((int64_t)b * p.cin + ch) * H + gr) * W + gc) / 4);
      }
      uint32_t px[4][4];     // [pixel][word of 4 channels]
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t lo01 = __byte_perm(v[4 * m], v[4 * m + 1], 0x5140);
        const uint32_t lo23 = __byte_perm(v[4 * m + 2], v[4 * m + 3], 0x5140);
        const uint32_t hi01 = __byte_perm(v[4 * m], v[4 * m + 1], 0x7362);
        const uint32_t hi23 = __byte_perm(v[4 * m + 2], v[4 * m + 3], 0x7362);
        px[0][m] = __byte_perm(lo01, lo23, 0x5410);
        px[1][m] = __byte_perm(lo01, lo23, 0x7632);
        px[2][m] = __byte_perm(hi01, hi23, 0x5410);
        px[3][m] = __byte_perm(hi01, hi23, 0x7632);
      }
      const uint32_t dst = qb + o * PL + (R * kSW + Cc) * 16;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sts128(dst + 16 * j, px[j][0], px[j][1], px[j][2], px[j][3]);
    }
  } else {
    int8_t* xc = reinterpret_cast<int8_t*>(smem + G::kQb);
    for (int i = tid; i < p.cinp * G::kP; i += kThreads) {
      const int ch = i / G::kP, pos = i % G::kP;
      int8_t v = 0;
      if (ch < p.cin && B.inside(pos))
        v = p.x[(((int64_t)b * p.cin + ch) * H + B.r0 + pos / kSW) * W + B.c0 + pos % kSW];
      xc[(ch >> 4) * PL + pos * 16 + (ch & 15)] = v;
    }
  }

  const uint64_t da = wg::desc_base(PL, 128, wg::kSwizzleNone);
  const uint64_t dw = wg::desc_base(kC * 16, 128, wg::kSwizzleNone);
  int si = 0;
  int32_t acc[3][32];

  // ---- b1 (1x1, level 0, all 9 tiles): x (canvas B) -> r1 (residual
  // canvas, bf16) and q1 (canvas A)
  {
    const uint32_t slot = B.acquire(si++);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0;
    wg::fence();
    const int nks = p.cinp >> 5;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint32_t a0 = qb + (wgi + 3 * j) * 64 * 16;
      for (int ks = 0; ks < nks; ++ks)
        wg::wgmma_ss_s8<kC>(acc[j], wg::desc_at(da, a0 + 2 * ks * PL),
                            wg::desc_at(dw, slot + 2 * ks * kC * 16));
    }
    wg::commit();
    B.prefetch();
    wg::wait<0>();
#pragma unroll
    for (int j = 0; j < 3; ++j) keep(acc[j]);
    const float* inv1 = inv + kC;
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = (wgi + 3 * j) * 64 + B.r_lo + 8 * h;
        const bool in = B.inside(pos);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = 8 * nt + 2 * q;
          const float2 s = *reinterpret_cast<const float2*>(sw + c);
          const float2 bv = *reinterpret_cast<const float2*>(bias + c);
          const float2 iv = *reinterpret_cast<const float2*>(inv1 + c);
          const uint32_t rb = pack_bf16(deq(acc[j][4 * nt + 2 * h], s.x, bv.x),
                                        deq(acc[j][4 * nt + 2 * h + 1], s.y, bv.y));
          sts32(res + nt * PL + pos * 16 + q * 4, rb);
          const float2 r = unpack_bf16(rb);
          const int q0 = in ? quant(r.x, iv.x) : 0;
          const int q1 = in ? quant(r.y, iv.y) : 0;
          sts16(qa + (nt >> 1) * PL + pos * 16 + 8 * (nt & 1) + 2 * q,
                (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8));
        }
      }
  }

  // ---- three residual blocks: 3x3, ELU, requant, 1x1, residual, ELU
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    const int L = k + 1, ntl = B.tiles(L);
    const uint32_t src = k & 1 ? qb : qa, dst = k & 1 ? qa : qb;
    const int ka = 1 + 2 * k, kb = 2 + 2 * k;   // sw / bias rows of bXa, bXb
    const float* swa = sw + ka * kC;
    const float* ba = bias + ka * kC;
    const float* inva = inv + (ka + 1) * kC;
    const float* swb = sw + kb * kC;
    const float* bb = bias + kb * kC;
    const float* invb = inv + (kb + 1) * kC;
    const bool last = k == 2;                    // e6 stays f32
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t slot = B.acquire(si++);
      const int shift = (tap / 3 - 1) * kSW + tap % 3 - 1;
      wg::fence();
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int t = wgi + 3 * j;
        if (t < ntl) {
          const uint32_t a0 = src + (25 * L + 64 * t + shift) * 16;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            wg::wgmma_ss_s8<kC>(acc[j], wg::desc_at(da, a0 + 2 * ks * PL),
                                wg::desc_at(dw, slot + 2 * ks * kC * 16));
        }
      }
      wg::commit();
      B.prefetch();
    }
    const uint32_t slot = B.acquire(si++);      // the 1x1's weights
    wg::wait<0>();
#pragma unroll
    for (int j = 0; j < 3; ++j) keep(acc[j]);
    uint32_t af[2][2][4];
    auto finish = [&](int j) {                  // dequant, residual, ELU -> dst
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = 25 * L + 64 * (wgi + 3 * j) + B.r_lo + 8 * h;
        if (!B.valid(L, pos)) continue;
        const bool in = B.inside(pos);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = 8 * nt + 2 * q;
          const uint32_t o = res + nt * PL + pos * 16 + q * 4;
          const float2 r = unpack_bf16(lds32(o));
          const float2 s = *reinterpret_cast<const float2*>(swb + c);
          const float2 bv = *reinterpret_cast<const float2*>(bb + c);
          const float2 iv = *reinterpret_cast<const float2*>(invb + c);
          float e0 = elu(__fadd_rn(deq(acc[j][4 * nt + 2 * h], s.x, bv.x), r.x));
          float e1 = elu(__fadd_rn(deq(acc[j][4 * nt + 2 * h + 1], s.y, bv.y), r.y));
          if (!last) {                          // e2, e4 ride the bf16 canvas
            const uint32_t eb = pack_bf16(e0, e1);
            sts32(o, eb);
            const float2 f = unpack_bf16(eb);
            e0 = f.x;
            e1 = f.y;
          }
          const int q0 = in ? quant(e0, iv.x) : 0;
          const int q1 = in ? quant(e1, iv.y) : 0;
          sts16(dst + (nt >> 1) * PL + pos * 16 + 8 * (nt & 1) + 2 * q,
                (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8));
        }
      }
    };
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (wgi + 3 * j < ntl) {
        // dequant, ELU, requant: the sums become the 1x1's A fragments.
        // Register 2 r + h of k-step ks holds, for row g + 8 h, the slots
        // 16 r + 4 q .. + 3 of its 32: the channels of the n-tiles
        // jn = 4 ks + 2 r and jn + 1 that this thread's sums hold.
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int jn = 4 * ks + 2 * r;
            const int c = 8 * jn + 2 * q;
            const float2 s0v = *reinterpret_cast<const float2*>(swa + c);
            const float2 s1v = *reinterpret_cast<const float2*>(swa + c + 8);
            const float2 b0v = *reinterpret_cast<const float2*>(ba + c);
            const float2 b1v = *reinterpret_cast<const float2*>(ba + c + 8);
            const float2 i0v = *reinterpret_cast<const float2*>(inva + c);
            const float2 i1v = *reinterpret_cast<const float2*>(inva + c + 8);
            const int32_t* a = acc[j] + 4 * jn;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              af[j & 1][ks][2 * r + h] = pack4(
                  quant(elu(deq(a[2 * h], s0v.x, b0v.x)), i0v.x),
                  quant(elu(deq(a[2 * h + 1], s0v.y, b0v.y)), i0v.y),
                  quant(elu(deq(a[4 + 2 * h], s1v.x, b1v.x)), i1v.x),
                  quant(elu(deq(a[5 + 2 * h], s1v.y, b1v.y)), i1v.y));
          }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0;
        wg::fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          wg::wgmma_rs_s8<kC>(acc[j], af[j & 1][ks],
                              wg::desc_at(dw, slot + 2 * ks * kC * 16));
      }
      wg::commit();
      B.prefetch();
      if (j > 0) {
        wg::wait<1>();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) keep(af[(j - 1) & 1][ks]);
        keep(acc[j - 1]);
        if (wgi + 3 * (j - 1) < ntl) finish(j - 1);
      }
    }
    wg::wait<0>();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) keep(af[0][ks]);
    keep(acc[2]);
    if (wgi + 6 < ntl) finish(2);
  }

  // ---- b7 (3x3, level 4, 6 tiles): q6 (canvas B) -> out, NCHW
  {
    constexpr int L = kHalo;
    const uint64_t dw7 = wg::desc_base(NP7 * 16, 128, wg::kSwizzleNone);
    int32_t acc7[2][NP7 / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < NP7 / 2; ++i) acc7[j][i] = 0;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t slot = B.acquire(si++);
      const int shift = (tap / 3 - 1) * kSW + tap % 3 - 1;
      wg::fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t a0 = qb + (25 * L + 64 * (wgi + 3 * j) + shift) * 16;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          wg::wgmma_ss_s8<NP7>(acc7[j], wg::desc_at(da, a0 + 2 * ks * PL),
                               wg::desc_at(dw7, slot + 2 * ks * NP7 * 16));
      }
      wg::commit();
      B.prefetch();
    }
    wg::wait<0>();
    keep(acc7[0]);
    keep(acc7[1]);
    const int gy0 = blockIdx.y * G::kTH, gx0 = blockIdx.x * kTW;
    if (!p.out_bf16) {
      float* out = static_cast<float*>(p.out);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = 25 * L + 64 * (wgi + 3 * j) + B.r_lo + 8 * h;
          if (!B.valid(L, pos) || !B.inside(pos)) continue;
          const int64_t o =
              ((int64_t)b * p.nout * H + B.r0 + pos / kSW) * W + B.c0 + pos % kSW;
#pragma unroll
          for (int nt = 0; nt < NP7 / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int oc = 8 * nt + 2 * q + e;
              if (oc < p.nout)
                out[o + (int64_t)oc * H * W] =
                    deq(acc7[j][4 * nt + 2 * h + e], sw7[oc], bias7[oc]);
            }
        }
      return;
    }
    __syncthreads();     // every warpgroup has read q6: the canvases are free
    // The dequantized sums, rounded to bf16, go to a stage [channel][position
    // of the level's span] (a row of 392 positions, 4 (mod 32) words: the 8
    // rows of a stmatrix hit distinct banks), then to out in 16-byte pieces.
    constexpr int kRow = 392 * 2;
    static_assert(NP7 * kRow <= G::kRingAt, "output stage");
    const int lane = tid & 31;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // lane -> matrix lane / 8 = (nt parity, h), its row lane % 8
      const int rel = 64 * (wgi + 3 * j) + (B.r_lo & ~15) + 8 * ((lane >> 3) & 1);
      const uint32_t row = s0 + (8 * (lane >> 4) + (lane & 7)) * kRow + rel * 2;
#pragma unroll
      for (int nt = 0; nt < NP7 / 8; nt += 2) {
        const int c = 8 * nt + 2 * q;
        const float2 sa = *reinterpret_cast<const float2*>(sw7 + c);
        const float2 sb = *reinterpret_cast<const float2*>(sw7 + c + 8);
        const float2 b0 = *reinterpret_cast<const float2*>(bias7 + c);
        const float2 b1 = *reinterpret_cast<const float2*>(bias7 + c + 8);
        const int32_t* a = acc7[j] + 4 * nt;
        stmatrix_x4_trans(row + 8 * nt * kRow,
                          pack_bf16(deq(a[0], sa.x, b0.x), deq(a[1], sa.y, b0.y)),
                          pack_bf16(deq(a[2], sa.x, b0.x), deq(a[3], sa.y, b0.y)),
                          pack_bf16(deq(a[4], sb.x, b1.x), deq(a[5], sb.y, b1.y)),
                          pack_bf16(deq(a[6], sb.x, b1.x), deq(a[7], sb.y, b1.y)));
      }
    }
    __syncthreads();
    // output pixel (y, x) of the tile is canvas position (4 + y) * 24 + 4 + x,
    // position y * 24 + x of the span
    if (p.vec_out) {
      uint4* out = static_cast<uint4*>(p.out);
      for (int i = tid; i < p.nout * G::kTH * 2; i += kThreads) {
        const int oc = i / (G::kTH * 2), y = (i >> 1) % G::kTH, half = i & 1;
        if (gy0 + y < H && gx0 + 8 * half < W)
          out[((((int64_t)b * p.nout + oc) * H + gy0 + y) * W + gx0 + 8 * half) / 8] =
              lds128(s0 + oc * kRow + (y * kSW + 8 * half) * 2);
      }
    } else {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
      const __nv_bfloat16* stage = reinterpret_cast<const __nv_bfloat16*>(smem);
      for (int i = tid; i < p.nout * G::kTH * kTW; i += kThreads) {
        const int oc = i / (G::kTH * kTW), y = (i / kTW) % G::kTH, xx = i % kTW;
        if (gy0 + y < H && gx0 + xx < W)
          out[(((int64_t)b * p.nout + oc) * H + gy0 + y) * W + gx0 + xx] =
              stage[oc * (kRow / 2) + y * kSW + xx];
      }
    }
  }
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The slices in the order the kernel uses them: b1, then per block the 3x3's
// 9 taps and the 1x1, then b7's 9 taps; a byte per weight.
void slices(Params& p, int np7) {
  int n = 0, off = 0;
  auto add = [&](int bytes) {
    p.slice[n++] = make_int2(off, bytes);
    off += bytes;
  };
  add(p.cinp * kC);
  for (int k = 0; k < 3; ++k)
    for (int s = 0; s < 10; ++s) add(kC * kC);
  for (int t = 0; t < 9; ++t) add(np7 * kC);
  p.nslices = n;
}

// The padded output width of b7 that the kernel is built for (0: none).
int nout_pad(int nout) {
  const int sizes[5] = {16, 32, 48, 64, 96};
  for (int s : sizes)
    if (nout <= s) return s;
  return 0;
}

template <int NP7>
int launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int smem = S8<NP7>::kSmem;
  static_assert(smem <= kSmemMax, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      qtower_wg_kernel<NP7>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + kTW - 1) / kTW, (p.H + S8<NP7>::kTH - 1) / S8<NP7>::kTH, b);
  qtower_wg_kernel<NP7><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, cin, H, W) int8; wp: the weight pack of ops/qtower.pack_tower_wg
// (16-byte aligned); inv (8, 64), sw (7, 64), bias (7, 64), sw7 (nout),
// bias7 (nout) f32; out (B, nout, H, W), out_dtype 0 = float32,
// 1 = bfloat16.  The tower is 64 wide, cin <= 64, nout <= 96.
extern "C" int cwfa_qtower_wg(const void* x, const void* wp, const void* inv,
                              const void* sw, const void* bias, const void* sw7,
                              const void* bias7, void* out, int b, int h, int w,
                              int cin, int nout, int out_dtype, int device,
                              void* stream) {
  const int np7 = nout_pad(nout);
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin > kC || nout <= 0 ||
      np7 == 0 || out_dtype < 0 || out_dtype > 1 || b > 65535 ||
      reinterpret_cast<uintptr_t>(wp) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.wp = static_cast<const char*>(wp);
  p.inv = static_cast<const float*>(inv);
  p.sw = static_cast<const float*>(sw);
  p.bias = static_cast<const float*>(bias);
  p.sw7 = static_cast<const float*>(sw7);
  p.bias7 = static_cast<const float*>(bias7);
  p.out = out;
  p.H = h;
  p.W = w;
  p.cin = cin;
  p.cinp = round_up(cin, 32);
  p.nout = nout;
  p.out_bf16 = out_dtype;
  p.vec_in = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  p.vec_out = out_dtype == 1 && w % 8 == 0 &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0;
  slices(p, np7);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (np7) {
#define CWFA_CASE(N) \
  case N:            \
    return launch<N>(p, b, s);
    CWFA_CASE(16) CWFA_CASE(32) CWFA_CASE(48) CWFA_CASE(64) CWFA_CASE(96)
#undef CWFA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
