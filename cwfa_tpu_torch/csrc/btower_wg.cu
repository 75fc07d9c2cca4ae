// The 64-wide float subnet tower on Hopper's warpgroup tensor cores (wgmma,
// sm_90a): a bf16 instance and an f32 instance that runs its products as
// 3xTF32.  Same function, cast structure and plain version as
// csrc/btower.cu (which keeps the CUDA-core instances for the other
// widths); replaces the Pallas TPU kernel cwfa_tpu/ops/btower.py:235
// (fused_pair_tower_bf16).
//
//   r1  = b1(x)                          1x1, Cin -> 64
//   e2  = elu(b2b(elu(b2a(r1))) + r1)    3x3, 1x1, residual
//   e4  = elu(b4b(elu(b4a(e2))) + e2)
//   e6  = elu(b6b(elu(b6a(e4))) + e4)
//   out = b7(e6)                         3x3, 64 -> Nout
//
// Bound: multiply-adds (~181 k per pixel at step 0 against ~4 bytes in and
// 2 Nout bytes out).  What sets the pace here: the shared-memory pipe that
// feeds the tensor cores (a 64 x 64 x 16 bf16 product reads 2 KB of A and
// 2 KB of B in the 32 clocks it computes); the halo (a 16 x 16 output tile
// is computed from a 24 x 24 canvas, an 8 x 16 one in f32 from 16 x 24); the
// bias / ELU / residual passes on the CUDA cores, which the tensor cores
// wait for (one block per SM, and its warpgroups move in step); in f32 the
// three products per multiply-add and a drained tensor pipe per slice.
//
// Design:
//   - One block of three warpgroups (384 threads) per (batch, TH x 16
//     output tile); TH = 16 in bf16, 8 in f32.  The input window with its
//     4-pixel halo is a canvas of (TH + 8) x 24 positions kept as
//     [16-byte channel chunk][position][16 bytes] (8 bf16 or 4 f32
//     channels), so 8 consecutive positions of one chunk are one 128-byte
//     wgmma core matrix, and the layers run on shrinking levels (halo 4 ->
//     3 -> 2 -> 1 -> 0) of that one geometry.
//   - A conv is an implicit GEMM whose M tiles are 64 consecutive canvas
//     positions of the level's span (the ring columns outside the level are
//     computed and dropped), N the output channels, K taps x channels.  A
//     3x3 tap is the same A tile with its start shifted by (dy * 24 + dx)
//     positions.  A warpgroup owns the M tiles w, w + 3, w + 6 of a level.
//   - The weights reach the tensor cores from shared memory: the pack is a
//     stream of slices in the order the block consumes them (a tap of a
//     conv; in f32 32 input channels of a tap, high parts then low parts),
//     copied with cp.async through a ring of 4 slots, two slices ahead of
//     the products, with one block barrier per slice; after the barrier the
//     products are started before the next copies.
//   - 3x3 -> bias -> ELU -> round -> 1x1 stays in registers: the 3x3's sums
//     are, packed, the A operand of the 1x1 (wgmma with A from registers).
//   - bf16: A comes from the canvas through a descriptor (no swizzle, rows
//     16 bytes apart), a warpgroup accumulates its three M tiles at once so
//     a layer's weights are streamed once, and the canvases ping-pong (r1,
//     e4 in one, x, e2, e6 in the other): 2 x 72 KB + 4 x 12 KB of ring.
//   - f32 as 3xTF32: an f32 value v is split in registers into hi = v
//     rounded to TF32 and lo = v - hi; the weights are split in the pack;
//     a product is hi*hi + hi*lo + lo*hi with f32 sums (lo*lo, 2^-22 of the
//     product, is dropped).  A comes from registers (loaded from the canvas,
//     split there), so the rows of an M tile need not be evenly spaced:
//     the tiles take exactly the positions of the level, 64 to a tile (5 + 4
//     + 3 tiles for the three 3x3 convs of a block where the linear span
//     needs 6 + 5 + 4).  The tensor cores add to a running sum with truncation,
//     a bias that grows with the number of additions, so each 32-channel
//     slice of a 3x3 tap sums into a zeroed register tile that is then added
//     to the conv's sums by the CUDA cores (round to nearest).  One f32
//     canvas (96 KB) is all that fits beside the ring (4 x 24 KB), so a
//     level's results are held in registers until every warpgroup has read
//     the level's input, then written in place.
//   - SAME padding: every canvas that feeds a 3x3 conv is written as 0 at
//     positions outside the image.
//   - Cin up to 128 (the [x half | c_views] towers of the other coupling
//     types: Cin 72 at step 0): b1's K is cut into chunks of at most 64
//     input channels (a canvas is 64 channels wide; a wider one does not
//     fit beside the other canvas and the ring), one weight slice a chunk,
//     summed in the same registers.  bf16: x's channels past 64 are staged
//     in canvas A, free until b1's epilogue writes r1 there after a
//     barrier, so no staging runs while the sums are live.  f32 (one
//     canvas): the chunks pass in turn through it, a barrier before each
//     later chunk's staging, each in 32-channel slices.  The x canvas is
//     dead after b1, so the later levels are as for Cin <= 64.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise, returns cudaGetLastError().

#include <algorithm>

#include "tower_wg.cuh"

namespace {

using namespace tower;

struct Params {
  const void* x;       // (B, cin, H, W)
  const char* wp;      // weight pack
  const float* bias;   // (7 * 64 + nout) f32
  void* out;           // (B, nout, H, W)
  int H, W, cin, cinp, nout, nslices;
  int vec;             // W % 8 == 0 and x, out 16-byte aligned: vector loads and stores
  int2 slice[kMaxSlices];   // (byte offset in the pack, bytes), in order of use
};


// exp(min(v, 0)) - 1 below 0; FAST uses the exp2-based __expf (the bf16
// instance rounds the result to 8 bits)
template <bool FAST>
__device__ __forceinline__ float elu(float v) {
  const float e = FAST ? __expf(v) : expf(fminf(v, 0.f));
  return v > 0.f ? v : e - 1.f;
}


// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

template <int NP7>
struct Bf16 {
  static constexpr int kTH = 16, kSH = kTH + 2 * kHalo, kP = kSH * kSW;
  static constexpr int kPlane = kP * 16;               // bytes of one channel octet
  static constexpr int kCanvas = (kC / 8) * kPlane;
  static constexpr int kSlot = (NP7 > kC ? NP7 : kC) * 128;
  static constexpr int kBias = 2 * kCanvas + kRing * kSlot;
  static constexpr int kSmem = kBias + (7 * kC + NP7) * 4;
};

template <int NP7>
__global__ void __launch_bounds__(kThreads, 1) tower_bf16_kernel(const Params p) {
  using G = Bf16<NP7>;
  constexpr int PL = G::kPlane;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ca = s0, cb = s0 + G::kCanvas;
  const float* bias = reinterpret_cast<const float*>(smem + G::kBias);
  Block<Params, G::kSH, G::kSlot> B(p, G::kTH, s0 + 2 * G::kCanvas);
  const int tid = B.tid, wgi = B.wgi, q = B.q;
  const int b = blockIdx.z, H = p.H, W = p.W;

  B.load_slice(0);
  B.load_slice(1);

  for (int i = tid; i < 7 * kC + NP7; i += kThreads)
    reinterpret_cast<float*>(smem + G::kBias)[i] =
        i < 7 * kC + p.nout ? p.bias[i] : 0.f;
  // Channels c0 .. c0 + kc - 1 of the input window (zero outside the image
  // and in the channels that pad Cin) into the canvas at cvs: one chunk of
  // b1's K
  auto stage_x = [&](uint32_t cvs, int c0, int kc) {
    if (p.vec) {
      // a thread takes 8 channels x 4 pixels of a row (one 8-byte load per
      // channel, all in flight together) and writes 4 positions of 16 bytes
      const uint2* x = static_cast<const uint2*>(p.x);
      const int nunits = (kc >> 3) * G::kSH * 6;
      for (int u = tid; u < nunits; u += kThreads) {
        const int o = u / (G::kSH * 6), rem = u % (G::kSH * 6);
        const int R = rem / 6, Cc = (rem % 6) * 4;
        const int gr = B.r0 + R, gc = B.c0 + Cc;
        const bool in = (unsigned)gr < (unsigned)H && (unsigned)gc < (unsigned)W;
        uint2 v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int ch = c0 + 8 * o + c;
          v[c] = make_uint2(0u, 0u);
          if (in && ch < p.cin)
            v[c] = __ldg(x + ((((int64_t)b * p.cin + ch) * H + gr) * W + gc) / 4);
        }
        const uint32_t dst = cvs + o * PL + (R * kSW + Cc) * 16;
        sts128(dst, __byte_perm(v[0].x, v[1].x, 0x5410), __byte_perm(v[2].x, v[3].x, 0x5410),
               __byte_perm(v[4].x, v[5].x, 0x5410), __byte_perm(v[6].x, v[7].x, 0x5410));
        sts128(dst + 16, __byte_perm(v[0].x, v[1].x, 0x7632), __byte_perm(v[2].x, v[3].x, 0x7632),
               __byte_perm(v[4].x, v[5].x, 0x7632), __byte_perm(v[6].x, v[7].x, 0x7632));
        sts128(dst + 32, __byte_perm(v[0].y, v[1].y, 0x5410), __byte_perm(v[2].y, v[3].y, 0x5410),
               __byte_perm(v[4].y, v[5].y, 0x5410), __byte_perm(v[6].y, v[7].y, 0x5410));
        sts128(dst + 48, __byte_perm(v[0].y, v[1].y, 0x7632), __byte_perm(v[2].y, v[3].y, 0x7632),
               __byte_perm(v[4].y, v[5].y, 0x7632), __byte_perm(v[6].y, v[7].y, 0x7632));
      }
    } else {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
      __nv_bfloat16* xc = reinterpret_cast<__nv_bfloat16*>(smem + (cvs - s0));
      for (int i = tid; i < kc * G::kP; i += kThreads) {
        const int cl = i / G::kP, pos = i % G::kP, ch = c0 + cl;
        __nv_bfloat16 v = __float2bfloat16_rn(0.f);
        if (ch < p.cin && B.inside(pos))
          v = x[(((int64_t)b * p.cin + ch) * H + B.r0 + pos / kSW) * W + B.c0 + pos % kSW];
        xc[(cl >> 3) * (PL / 2) + pos * 8 + (cl & 7)] = v;
      }
    }
  };
  // x in canvas B, its channels past 64 in canvas A (free until b1's
  // epilogue)
  stage_x(cb, 0, min(kC, p.cinp));
  if (p.cinp > kC) stage_x(ca, kC, p.cinp - kC);

  const uint64_t da = wg::desc_base(PL, 128, wg::kSwizzleNone);
  const uint64_t dw = wg::desc_base(kC * 16, 128, wg::kSwizzleNone);
  int si = 0;
  float acc[3][32];

  // ---- b1 (1x1, level 0, all 9 tiles): x -> r1 (canvas A), its K in
  // chunks of at most 64 channels (canvas B, then canvas A), one weight
  // slice each, summed in the same registers as a 3x3's taps are
  {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < p.cinp; c0 += kC) {
      const uint32_t slot = B.acquire(si++);
      const uint32_t xcv = c0 ? ca : cb;
      wg::fence();
      const int nks = min(kC, p.cinp - c0) >> 4;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint32_t a0 = xcv + (wgi + 3 * j) * 64 * 16;
        for (int ks = 0; ks < nks; ++ks)
          wg::wgmma_ss_bf16<kC>(acc[j], wg::desc_at(da, a0 + 2 * ks * PL),
                                wg::desc_at(dw, slot + 2 * ks * kC * 16));
      }
      wg::commit();
      B.prefetch();
    }
    wg::wait<0>();
#pragma unroll
    for (int j = 0; j < 3; ++j) keep(acc[j]);
    if (p.cinp > kC) __syncthreads();   // every warpgroup has read x in canvas A
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = (wgi + 3 * j) * 64 + B.r_lo + 8 * h;
        const bool in = B.inside(pos);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * nt + 2 * q);
          sts32(ca + nt * PL + pos * 16 + q * 4,
                in ? pack_bf16(acc[j][4 * nt + 2 * h] + bv.x,
                               acc[j][4 * nt + 2 * h + 1] + bv.y)
                   : 0u);
        }
      }
  }

  // ---- three residual blocks: 3x3, ELU, 1x1, residual, ELU
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    const int L = k + 1, ntl = B.tiles(L);
    const uint32_t src = k & 1 ? cb : ca, dst = k & 1 ? ca : cb;
    const float* ba = bias + (1 + 2 * k) * kC;
    const float* bb = ba + kC;
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
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
          for (int ks = 0; ks < 4; ++ks)
            wg::wgmma_ss_bf16<kC>(acc[j], wg::desc_at(da, a0 + 2 * ks * PL),
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
    uint32_t af[2][4][4];
    auto finish = [&](int j) {                  // residual, ELU, -> dst
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = 25 * L + 64 * (wgi + 3 * j) + B.r_lo + 8 * h;
        if (!B.valid(L, pos)) continue;
        const bool in = B.inside(pos);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t o = nt * PL + pos * 16 + q * 4;
          const float2 res = unpack_bf16(lds32(src + o));
          const float2 bv = *reinterpret_cast<const float2*>(bb + 8 * nt + 2 * q);
          const float v0 = acc[j][4 * nt + 2 * h] + bv.x + res.x;
          const float v1 = acc[j][4 * nt + 2 * h + 1] + bv.y + res.y;
          sts32(dst + o, in ? pack_bf16(elu<true>(v0), elu<true>(v1)) : 0u);
        }
      }
    };
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (wgi + 3 * j < ntl) {
        // bias, ELU, round: the sums become the 1x1's A fragments
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 bv = *reinterpret_cast<const float2*>(
                ba + 16 * s + 8 * half + 2 * q);
            const float* a = acc[j] + 8 * s + 4 * half;
            af[j & 1][s][2 * half] =
                pack_bf16(elu<true>(a[0] + bv.x), elu<true>(a[1] + bv.y));
            af[j & 1][s][2 * half + 1] =
                pack_bf16(elu<true>(a[2] + bv.x), elu<true>(a[3] + bv.y));
          }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
        wg::fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wg::wgmma_rs_bf16<kC>(acc[j], af[j & 1][s],
                                wg::desc_at(dw, slot + 2 * s * kC * 16));
      }
      wg::commit();
      B.prefetch();
      if (j > 0) {
        wg::wait<1>();
#pragma unroll
        for (int s = 0; s < 4; ++s) keep(af[(j - 1) & 1][s]);
        keep(acc[j - 1]);
        if (wgi + 3 * (j - 1) < ntl) finish(j - 1);
      }
    }
    wg::wait<0>();
#pragma unroll
    for (int s = 0; s < 4; ++s) keep(af[0][s]);
    keep(acc[2]);
    if (wgi + 6 < ntl) finish(2);
  }

  // ---- b7 (3x3, level 4, 6 tiles): e6 (canvas B) -> out, NCHW
  {
    constexpr int L = kHalo;
    const uint64_t dw7 = wg::desc_base(NP7 * 16, 128, wg::kSwizzleNone);
    float acc7[2][NP7 / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < NP7 / 2; ++i) acc7[j][i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t slot = B.acquire(si++);
      const int shift = (tap / 3 - 1) * kSW + tap % 3 - 1;
      wg::fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t a0 = cb + (25 * L + 64 * (wgi + 3 * j) + shift) * 16;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wg::wgmma_ss_bf16<NP7>(acc7[j], wg::desc_at(da, a0 + 2 * ks * PL),
                                 wg::desc_at(dw7, slot + 2 * ks * NP7 * 16));
      }
      wg::commit();
      B.prefetch();
    }
    wg::wait<0>();
    keep(acc7[0]);
    keep(acc7[1]);
    __syncthreads();     // every warpgroup has read e6: the canvases are free
    // The sums + bias, rounded, go to a stage [channel][position of the
    // level's span] (a row of 392 positions, 4 (mod 32) words: the 8 rows
    // of a stmatrix hit distinct banks), then to out in 16-byte pieces.
    constexpr int kRow = 392 * 2;
    static_assert(NP7 * kRow <= 2 * G::kCanvas, "output stage");
    const float* b7 = bias + 7 * kC;
    const int lane = tid & 31;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // lane -> matrix lane / 8 = (nt parity, h), its row lane % 8
      const int rel = 64 * (wgi + 3 * j) + (B.r_lo & ~15) + 8 * ((lane >> 3) & 1);
      const uint32_t row = ca + (8 * (lane >> 4) + (lane & 7)) * kRow + rel * 2;
#pragma unroll
      for (int nt = 0; nt < NP7 / 8; nt += 2) {
        const float2 b0 = *reinterpret_cast<const float2*>(b7 + 8 * nt + 2 * q);
        const float2 b1 = *reinterpret_cast<const float2*>(b7 + 8 * nt + 8 + 2 * q);
        const float* a = acc7[j] + 4 * nt;
        stmatrix_x4_trans(row + 8 * nt * kRow,
                          pack_bf16(a[0] + b0.x, a[1] + b0.y),
                          pack_bf16(a[2] + b0.x, a[3] + b0.y),
                          pack_bf16(a[4] + b1.x, a[5] + b1.y),
                          pack_bf16(a[6] + b1.x, a[7] + b1.y));
      }
    }
    __syncthreads();
    // output pixel (y, x) of the tile is canvas position (4 + y) * 24 + 4 + x,
    // position y * 24 + x of the span
    const int gy0 = blockIdx.y * G::kTH, gx0 = blockIdx.x * kTW;
    if (p.vec) {
      uint4* out = static_cast<uint4*>(p.out);
      for (int i = tid; i < p.nout * G::kTH * 2; i += kThreads) {
        const int oc = i / (G::kTH * 2), y = (i >> 1) % G::kTH, half = i & 1;
        if (gy0 + y < H && gx0 + 8 * half < W)
          out[((((int64_t)b * p.nout + oc) * H + gy0 + y) * W + gx0 + 8 * half) / 8] =
              lds128(ca + oc * kRow + (y * kSW + 8 * half) * 2);
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

// ---------------------------------------------------------------------------
// f32 as 3xTF32
// ---------------------------------------------------------------------------

template <int NP7>
struct Tf32 {
  static constexpr int kTH = 8, kSH = kTH + 2 * kHalo, kP = kSH * kSW;
  static constexpr int kPlane = kP * 16;               // bytes of one channel quad
  static constexpr int kCanvas = (kC / 4) * kPlane;
  static constexpr int kSlot = (NP7 > kC ? NP7 : kC) * 256;   // 32 channels, hi + lo
  static constexpr int kBias = kCanvas + kRing * kSlot;
  static constexpr int kSmem = kBias + (7 * kC + NP7) * 4;
};

template <int NP7>
__global__ void __launch_bounds__(kThreads, 1) tower_tf32_kernel(const Params p) {
  using G = Tf32<NP7>;
  constexpr int PL = G::kPlane;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t cv = s0;
  const float* bias = reinterpret_cast<const float*>(smem + G::kBias);
  Block<Params, G::kSH, G::kSlot> B(p, G::kTH, s0 + G::kCanvas);
  const int tid = B.tid, wgi = B.wgi, q = B.q;
  const int b = blockIdx.z, H = p.H, W = p.W;

  B.load_slice(0);
  B.load_slice(1);

  for (int i = tid; i < 7 * kC + NP7; i += kThreads)
    reinterpret_cast<float*>(smem + G::kBias)[i] =
        i < 7 * kC + p.nout ? p.bias[i] : 0.f;
  // Channels c0 .. c0 + kc - 1 of the input window into the canvas: one
  // chunk of b1's K
  auto stage_x = [&](int c0, int kc) {
    if (p.vec) {
      // a thread takes 4 channels x 4 pixels of a row (one 16-byte load per
      // channel) and writes 4 positions of 16 bytes
      const float4* x = static_cast<const float4*>(p.x);
      const int nunits = (kc >> 2) * G::kSH * 6;
      for (int u = tid; u < nunits; u += kThreads) {
        const int o = u / (G::kSH * 6), rem = u % (G::kSH * 6);
        const int R = rem / 6, Cc = (rem % 6) * 4;
        const int gr = B.r0 + R, gc = B.c0 + Cc;
        const bool in = (unsigned)gr < (unsigned)H && (unsigned)gc < (unsigned)W;
        float4 v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ch = c0 + 4 * o + c;
          v[c] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in && ch < p.cin)
            v[c] = __ldg(x + ((((int64_t)b * p.cin + ch) * H + gr) * W + gc) / 4);
        }
        const uint32_t dst = cv + o * PL + (R * kSW + Cc) * 16;
        sts128(dst, __float_as_uint(v[0].x), __float_as_uint(v[1].x),
               __float_as_uint(v[2].x), __float_as_uint(v[3].x));
        sts128(dst + 16, __float_as_uint(v[0].y), __float_as_uint(v[1].y),
               __float_as_uint(v[2].y), __float_as_uint(v[3].y));
        sts128(dst + 32, __float_as_uint(v[0].z), __float_as_uint(v[1].z),
               __float_as_uint(v[2].z), __float_as_uint(v[3].z));
        sts128(dst + 48, __float_as_uint(v[0].w), __float_as_uint(v[1].w),
               __float_as_uint(v[2].w), __float_as_uint(v[3].w));
      }
    } else {
      const float* x = static_cast<const float*>(p.x);
      float* xc = reinterpret_cast<float*>(smem);
      for (int i = tid; i < kc * G::kP; i += kThreads) {
        const int cl = i / G::kP, pos = i % G::kP, ch = c0 + cl;
        float v = 0.f;
        if (ch < p.cin && B.inside(pos))
          v = x[(((int64_t)b * p.cin + ch) * H + B.r0 + pos / kSW) * W + B.c0 + pos % kSW];
        xc[(cl >> 2) * (PL / 4) + pos * 4 + (cl & 3)] = v;
      }
    }
  };
  stage_x(0, min(kC, p.cinp));

  const uint64_t dw = wg::desc_base(kC * 16, 128, wg::kSwizzleNone);
  int si = 0;
  uint32_t hi[4][4], lo[4][4];
  float res[2][32];            // a level's results, held until it has been read

  // A comes from registers here, so the rows of an M tile can be any
  // positions: the tiles take exactly the level's (SH - 2 L) x (24 - 2 L)
  // positions in row-major order, 64 to a tile (rows beyond the last read
  // position 0 of the level and are dropped).
  auto count = [](int L) { return (G::kSH - 2 * L) * (kSW - 2 * L); };
  auto position = [&](int L, int idx) {
    const int w = kSW - 2 * L;
    idx = idx < count(L) ? idx : 0;
    return (L + idx / w) * kSW + L + idx % w;
  };

  // a level's results -> the canvas, in place
  auto write_level = [&](int L) {
    __syncthreads();           // every warpgroup has read the level's input
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 64 * (wgi + 3 * r) + B.r_lo + 8 * h;
        if (idx >= count(L)) continue;
        const int pos = position(L, idx);
        const bool in = B.inside(pos);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          sts_f2(cv + (2 * nt + (q >> 1)) * PL + pos * 16 + (q & 1) * 8,
                 in ? res[r][4 * nt + 2 * h] : 0.f,
                 in ? res[r][4 * nt + 2 * h + 1] : 0.f);
      }
  };

  // ---- b1 (1x1, level 0, 6 tiles in two rounds): x -> r1.  Its K in
  // chunks of at most 64 channels staged in turn into the canvas, each
  // chunk's two rounds in slices of 32 channels; a slice's products sum into
  // a zeroed tile that the CUDA cores add to the level's results
  {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 32; ++i) res[r][i] = 0.f;
    float part[32];
#pragma unroll 1
    for (int c0 = 0; c0 < p.cinp; c0 += kC) {
      const int kch = min(kC, p.cinp - c0);
      if (c0 > 0) {
        __syncthreads();        // every warpgroup has read the last chunk
        stage_x(c0, kch);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = 64 * (wgi + 3 * r) + B.r_lo;
        for (int c = 0; c < kch; c += 32) {
          const uint32_t slot = B.acquire(si++);
          const int kc = min(32, kch - c);
          load_frags(hi, lo, cv, PL, pos, pos + 8, c >> 2, kc >> 3, q);
#pragma unroll
          for (int i = 0; i < 32; ++i) part[i] = 0.f;
          wg::fence();
          mma_3xtf32<kC>(part, hi, lo, kc >> 3, dw, slot, kc * kC * 4);
          wg::commit();
          B.prefetch();
          finish_3xtf32(part, hi, lo);
#pragma unroll
          for (int i = 0; i < 32; ++i) res[r][i] += part[i];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * nt + 2 * q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          res[r][4 * nt + 2 * h] += bv.x;
          res[r][4 * nt + 2 * h + 1] += bv.y;
        }
      }
    write_level(0);
  }

  // ---- three residual blocks
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    const int L = k + 1, ntl = (count(L) + 63) >> 6;
    const float* ba = bias + (1 + 2 * k) * kC;
    const float* bb = ba + kC;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (3 * r >= ntl) continue;          // the whole block skips the round
      const int t = wgi + 3 * r;
      const bool live = t < ntl;
      const int p_lo = position(L, 64 * t + B.r_lo);
      const int p_hi = position(L, 64 * t + B.r_lo + 8);
      float sum[32], part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = 0.f;
      // 3x3: 9 taps x 2 slices of 32 channels
#pragma unroll 1
      for (int s = 0; s < 18; ++s) {
        const uint32_t slot = B.acquire(si++);
        if (!live) continue;
        const int tap = s >> 1;
        const int shift = (tap / 3 - 1) * kSW + tap % 3 - 1;
        load_frags(hi, lo, cv, PL, p_lo + shift, p_hi + shift, 8 * (s & 1), 4, q);
#pragma unroll
        for (int i = 0; i < 32; ++i) part[i] = 0.f;
        wg::fence();
        mma_3xtf32<kC>(part, hi, lo, 4, dw, slot, 32 * kC * 4);
        wg::commit();
        B.prefetch();
        finish_3xtf32(part, hi, lo);
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[i] += part[i];
      }
      // bias, ELU: the sums become the 1x1's A fragments (its pack carries
      // the channel order: slot q is channel 2 q, slot q + 4 channel 2 q + 1)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(ba + 8 * nt + 2 * q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[4 * nt + 2 * h] = elu<false>(sum[4 * nt + 2 * h] + bv.x);
          sum[4 * nt + 2 * h + 1] = elu<false>(sum[4 * nt + 2 * h + 1] + bv.y);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) res[r][i] = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t slot = B.acquire(si++);
        if (!live) continue;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const float* a = sum + 4 * (4 * c + ks);
          split_tf32(a[0], hi[ks][0], lo[ks][0]);
          split_tf32(a[2], hi[ks][1], lo[ks][1]);
          split_tf32(a[1], hi[ks][2], lo[ks][2]);
          split_tf32(a[3], hi[ks][3], lo[ks][3]);
        }
        wg::fence();
        mma_3xtf32<kC>(res[r], hi, lo, 4, dw, slot, 32 * kC * 4);
        wg::commit();
        B.prefetch();
        finish_3xtf32(res[r], hi, lo);
      }
      if (!live) continue;
      // bias, residual, ELU
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 bv = *reinterpret_cast<const float2*>(bb + 8 * nt + 2 * q);
          const float2 rv = lds_f2(cv + (2 * nt + (q >> 1)) * PL +
                                   (h ? p_hi : p_lo) * 16 + (q & 1) * 8);
          res[r][4 * nt + 2 * h] = elu<false>(res[r][4 * nt + 2 * h] + bv.x + rv.x);
          res[r][4 * nt + 2 * h + 1] =
              elu<false>(res[r][4 * nt + 2 * h + 1] + bv.y + rv.y);
        }
    }
    write_level(L);
  }

  // ---- b7 (3x3, level 4: the 8 x 16 outputs, 2 tiles): e6 -> out, NCHW
  {
    constexpr int L = kHalo;
    const uint64_t dw7 = wg::desc_base(NP7 * 16, 128, wg::kSwizzleNone);
    const bool live = wgi < 2;
    const int p_lo = position(L, 64 * wgi + B.r_lo);
    const int p_hi = position(L, 64 * wgi + B.r_lo + 8);
    float sum[NP7 / 2], part[NP7 / 2];
#pragma unroll
    for (int i = 0; i < NP7 / 2; ++i) sum[i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < 18; ++s) {
      const uint32_t slot = B.acquire(si++);
      if (!live) continue;
      const int tap = s >> 1;
      const int shift = (tap / 3 - 1) * kSW + tap % 3 - 1;
      load_frags(hi, lo, cv, PL, p_lo + shift, p_hi + shift, 8 * (s & 1), 4, q);
#pragma unroll
      for (int i = 0; i < NP7 / 2; ++i) part[i] = 0.f;
      wg::fence();
      mma_3xtf32<NP7>(part, hi, lo, 4, dw7, slot, 32 * NP7 * 4);
      wg::commit();
      B.prefetch();
      finish_3xtf32(part, hi, lo);
#pragma unroll
      for (int i = 0; i < NP7 / 2; ++i) sum[i] += part[i];
    }
    const float* b7 = bias + 7 * kC;
    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ph = h ? p_hi : p_lo;
      if (!live || !B.inside(ph)) continue;
      const int64_t o = ((int64_t)b * p.nout * H + B.r0 + ph / kSW) * W + B.c0 + ph % kSW;
#pragma unroll
      for (int nt = 0; nt < NP7 / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int oc = 8 * nt + 2 * q + e;
          if (oc < p.nout)
            out[o + (int64_t)oc * H * W] = sum[4 * nt + 2 * h + e] + b7[oc];
        }
    }
  }
}

int round_up(int n, int m) { return (n + m - 1) / m * m; }

constexpr int kMaxCin = 2 * kC;   // b1's K: at most two chunks of the canvas

// The slices in the order tower_bf16_kernel uses them: b1 in chunks of 64
// input channels (the pack's [Cin/8][64][8] cut at every 8 KB), then per
// block the 3x3's 9 taps and the 1x1, then b7's 9 taps.
void slices_bf16(Params& p, int np7) {
  int n = 0, off = 0;
  auto add = [&](int bytes) {
    p.slice[n++] = make_int2(off, bytes);
    off += bytes;
  };
  for (int c0 = 0; c0 < p.cinp; c0 += kC) add(std::min(kC, p.cinp - c0) * 128);
  for (int k = 0; k < 3; ++k)
    for (int s = 0; s < 10; ++s) add(kC * 128);
  for (int t = 0; t < 9; ++t) add(np7 * 128);
  p.nslices = n;
}

// The f32 pack holds each conv once; the kernel walks a conv once per round
// of M tiles (two rounds but for b7), so the table repeats it.  b1 is walked
// per chunk of 64 input channels, each chunk's slices once per round.
void slices_tf32(Params& p, int np7) {
  int n = 0, off = 0;
  for (int c0 = 0; c0 < p.cinp; c0 += kC)
    for (int r = 0; r < 2; ++r)
      for (int c = c0; c < std::min(p.cinp, c0 + kC); c += 32)
        p.slice[n++] = make_int2(off + c * kC * 8, std::min(32, p.cinp - c) * kC * 8);
  off += p.cinp * kC * 8;
  auto conv = [&](int taps, int cinp, int np, int rounds, int next_taps,
                  int next_cinp) {
    // `next`: a 1x1 that follows each round of this 3x3 (0 taps: none)
    const int bytes = taps * cinp * np * 8;
    const int nbytes = next_taps * next_cinp * kC * 8;
    for (int r = 0; r < rounds; ++r) {
      int o = off;
      for (int t = 0; t < taps; ++t)
        for (int c = 0; c < cinp; c += 32) {
          const int kc = cinp - c < 32 ? cinp - c : 32;
          p.slice[n++] = make_int2(o, kc * np * 8);
          o += kc * np * 8;
        }
      for (int c = 0; c < next_taps * next_cinp; c += 32) {
        p.slice[n++] = make_int2(o, 32 * kC * 8);
        o += 32 * kC * 8;
      }
    }
    off += bytes + nbytes;
  };
  for (int k = 0; k < 3; ++k) {
    // level k + 1 has (16 - 2 L) x (24 - 2 L) positions, 64 to a tile, three
    // tiles to a round
    const int L = k + 1, tiles = ((16 - 2 * L) * (24 - 2 * L) + 63) / 64;
    conv(9, kC, kC, (tiles + 2) / 3, 1, kC);
  }
  conv(9, kC, np7, 1, 0, 0);
  p.nslices = n;
}

// The padded output width of b7 that the kernels are built for (0: none).
int nout_pad(int nout) {
  const int sizes[5] = {16, 32, 48, 64, 96};
  for (int s : sizes)
    if (nout <= s) return s;
  return 0;
}

template <template <int> class G, int NP7, typename K>
int launch(K kernel, const Params& p, int b, cudaStream_t stream) {
  constexpr int smem = G<NP7>::kSmem;
  static_assert(smem <= kSmemMax, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + kTW - 1) / kTW, (p.H + G<NP7>::kTH - 1) / G<NP7>::kTH, b);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x and out: (B, cin, H, W) and (B, nout, H, W), dtype 0 = float32 (3xTF32),
// 1 = bfloat16; the tower is 64 wide, cin <= 128, nout <= 96.  wp: the
// weight pack of ops/btower.pack_float_tower in the wgmma layout of that
// dtype (16-byte aligned), bias: its (7 * 64 + nout) f32 biases.
extern "C" int cwfa_btower_wg(const void* x, const void* wp, const void* bias,
                              void* out, int b, int h, int w, int cin, int nout,
                              int dtype, int device, void* stream) {
  const int np7 = nout_pad(nout);
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin > kMaxCin || nout <= 0 ||
      np7 == 0 || dtype < 0 || dtype > 1 || b > 65535 ||
      reinterpret_cast<uintptr_t>(wp) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.x = x;
  p.wp = static_cast<const char*>(wp);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.H = h;
  p.W = w;
  p.cin = cin;
  p.nout = nout;
  p.cinp = round_up(cin, dtype ? 16 : 8);
  p.vec = w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype) {
    slices_bf16(p, np7);
    switch (np7) {
#define CWFA_CASE(N) \
  case N:            \
    return launch<Bf16, N>(tower_bf16_kernel<N>, p, b, s);
      CWFA_CASE(16) CWFA_CASE(32) CWFA_CASE(48) CWFA_CASE(64) CWFA_CASE(96)
#undef CWFA_CASE
    }
  } else {
    slices_tf32(p, np7);
    switch (np7) {
#define CWFA_CASE(N) \
  case N:            \
    return launch<Tf32, N>(tower_tf32_kernel<N>, p, b, s);
      CWFA_CASE(16) CWFA_CASE(32) CWFA_CASE(48) CWFA_CASE(64) CWFA_CASE(96)
#undef CWFA_CASE
    }
  }
  return (int)cudaErrorInvalidValue;
}
