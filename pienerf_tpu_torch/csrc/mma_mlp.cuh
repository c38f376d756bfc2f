// The field MLP on Hopper's tensor cores: the bf16 instantiations of the
// field kernel (field_kernel.cu) and of the tile kernel (tile_kernel.cuh,
// every mode and schedule) run field_mlp.cuh's nets (Net64, Net128) here;
// the f32 instantiations keep field_mlp.cuh's FMA chains.
//
// One warp evaluates 32 samples, one per lane, as [32 x in] . [in x out]
// products of `mma.sync.m16n8k16` (bf16 A and B, f32 accumulators): two
// m16 row tiles, taken one after the other (rows 0-15 are lanes 0-15).
//   Weights: every layer staged once per block as bf16 in fragment order
//     (stage_mma_weights: per 16x8 tile of [in, out], 32 uint2, one a
//     lane), so a lane's B fragment is one conflict-free 8-byte load.
//     Net64 takes 39,936 B, Net128 129,024 B.
//   Activations: an m16n8 accumulator pair, rounded to bf16, is exactly
//     the A fragment of the next layer's k16 step (to_frag), so the chain
//     stays in registers. Layer 0 reads the encoding, and color layer 0's
//     first k16 step SH(d), from the warp's staging tile (field_mlp.cuh
//     kTileWords), each lane writing its own sample's row: the features
//     are the ladder's, never recomputed for another lane's row. Color
//     layer 0's second k16 step is the sigma head's accumulator tile
//     [sigma_raw, geo 0..14] itself, against weight rows shifted by one
//     past a zero row; sigma_raw is clamped to [-15, 15] first (sigma's own
//     clip), so that a sigma_raw rounding to +-inf cannot make 0 x inf a
//     NaN in the geo path. sigma and rgb go back to their lanes through
//     the tile.
// Semantics are the f32 path's: every layer reads bf16-rounded inputs and
// weights, multiplies exactly, accumulates in f32, rounds its outputs to
// bf16; ReLU between layers, not after the last. Only the summation order
// within a layer differs: each output's sum runs over the k16 tiles in
// increasing order, each tile's 16 products added to the running f32 sum
// by the tensor core in an order of its own (the CPU emulation of
// mma_bf16_16816, tests/test_torch_cuda_emu.py, adds them one by one in
// increasing k). Every MMA runs on all 32 lanes, converged (`.aligned`):
// the callers reach these functions warp-uniformly, and each starts with a
// __syncwarp.
//
// Bound on this card: the tensor cores (989 TFLOP/s bf16, dense). At the
// tile kernel's 41-53x distance from that bound (as FMA chains) the
// instruction's peak is not the limit: mma.sync is warp-local, so every
// warp enters its MLP after its own data-dependent window scan, and the CPU
// can emulate it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pienerf {

// d = a . b + c for one 16x8 tile, k = 16: the only use of the tensor-core
// instruction (fragments as the PTX ISA lays out m16n8k16 .bf16: lane
// l = 4 g + t holds A rows g, g + 8 at columns 2t, 2t + 1, 2t + 8, 2t + 9;
// B column g at rows 2t, 2t + 1, 2t + 8, 2t + 9; C rows g, g + 8 at
// columns 2t, 2t + 1).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2],
                                               const float (&c)[4]) {
#ifdef PIENERF_EMU_MMA
  emu_mma_bf16_16816(d, a, b, c);
#else
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
#endif
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Stage layer L (real extent in(L) x outp(L), row stride `stride` floats
// from `src`) as bf16 B fragments: for k16 tile kt and n8 tile nt, lane l
// = 4 g + t of fragment (kt, nt) holds rows 2t, 2t + 1 and 2t + 8, 2t + 9
// of column g. Padding is zero. Color layer 0 (L == 4) meets [SH(d) |
// sigma_raw, geo]: its rows 16..30 move to 17..31 behind a zero row 16.
// All threads of the block take part; the caller synchronises.
template <class N, int L>
__device__ __forceinline__ void stage_mma_layer(uint2* __restrict__ dst,
                                                const float* __restrict__ src,
                                                int stride) {
  constexpr int NT = N::out8(L) / 8;
  constexpr int FRAGS = N::in16(L) / 16 * NT * 32;
  for (int e = threadIdx.x; e < FRAGS; e += blockDim.x) {
    const int lane = e & 31;
    const int kt = (e >> 5) / NT;
    const int n = ((e >> 5) - kt * NT) * 8 + (lane >> 2);
    const int k = kt * 16 + 2 * (lane & 3);
    auto w = [&](int kk) {
      const int i = (L == 4 && kk >= 16) ? kk - 1 : kk;
      const bool ok = n < N::outp(L) && i < N::in(L) && !(L == 4 && kk == 16);
      return ok ? src[i * stride + n] : 0.f;
    };
    dst[e] = make_uint2(pack_bf16x2(w(k), w(k + 1)),
                        pack_bf16x2(w(k + 8), w(k + 9)));
  }
}

// every layer; src(l) is layer l's [in, out] block, row stride `stride`
template <class N, class Src>
__device__ __forceinline__ void stage_mma_layers(uint2* sw, Src src,
                                                 int stride) {
  stage_mma_layer<N, 0>(sw + N::frag_off(0), src(0), stride);
  stage_mma_layer<N, 1>(sw + N::frag_off(1), src(1), stride);
  stage_mma_layer<N, 2>(sw + N::frag_off(2), src(2), stride);
  stage_mma_layer<N, 3>(sw + N::frag_off(3), src(3), stride);
  stage_mma_layer<N, 4>(sw + N::frag_off(4), src(4), stride);
  stage_mma_layer<N, 5>(sw + N::frag_off(5), src(5), stride);
  stage_mma_layer<N, 6>(sw + N::frag_off(6), src(6), stride);
}

// from the pack [7, WD, WD]
template <class N>
__device__ __forceinline__ void stage_mma_weights(
    uint2* sw, const float* __restrict__ pw) {
  stage_mma_layers<N>(
      sw, [&](int l) { return pw + (size_t)l * N::kWd * N::kWd; }, N::kWd);
}

// from the paired pack [4, 128, 128]: sigma layer l in the diagonal block
// [0:64, 0:64] of position l, color layer l - 4 in [64:128, 64:128] of
// position l - 4 (as stage_weights_paired)
template <class N>
__device__ __forceinline__ void stage_mma_weights_paired(
    uint2* sw, const float* __restrict__ pw) {
  static_assert(N::kWd == 64, "only the 64-wide net pairs");
  constexpr int P = 128;
  stage_mma_layers<N>(
      sw,
      [&](int l) {
        return l < 4 ? pw + l * P * P : pw + 64 * P + 64 + (l - 4) * P * P;
      },
      P);
}

// K floats (bf16 values) into a tile row from word 0 of `row`, 16 B at a time
template <int K>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ row,
                                          const float (&f)[K]) {
  static_assert(K % 8 == 0, "whole 16-byte stores");
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    *reinterpret_cast<uint4*>(row + 4 * j) = make_uint4(
        pack_bf16x2(f[8 * j], f[8 * j + 1]),
        pack_bf16x2(f[8 * j + 2], f[8 * j + 3]),
        pack_bf16x2(f[8 * j + 4], f[8 * j + 5]),
        pack_bf16x2(f[8 * j + 6], f[8 * j + 7]));
  }
}

// this lane's sample: its encoding into its own tile row, zero-padded to
// 64 features
template <class N>
__device__ __forceinline__ void mma_stage_x(uint32_t* __restrict__ row,
                                            float x0, float x1, float x2,
                                            float bound) {
  float f[64];
  encode_to<true, N::kNf>(x0, x1, x2, bound,
                          [&](int i, float v) { f[i] = v; });
#pragma unroll
  for (int i = N::kEnc; i < 64; ++i) f[i] = 0.f;
  store_row<64>(row, f);
}

// this lane's SH(d) (sh4<true>) into its own tile row
__device__ __forceinline__ void mma_stage_sh(uint32_t* __restrict__ row,
                                             const float (&sh)[16]) {
  store_row<16>(row + kTileSh, sh);
}

// the A fragment of row tile mt at tile word w0 (= 8 x the k16 tile)
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const uint32_t* __restrict__ tile,
                                       int mt, int w0, int lane) {
  const uint32_t* r = tile + (16 * mt + (lane >> 2)) * kTileWords + w0 +
                      (lane & 3);
  a[0] = r[0];
  a[1] = r[8 * kTileWords];
  a[2] = r[4];
  a[3] = r[8 * kTileWords + 4];
}

// acc[nt] = sum over k16 tiles kt (increasing) of a[kt] . w(kt, nt)
template <int KT, int NT>
__device__ __forceinline__ void mma_layer(const uint2* __restrict__ w,
                                          const uint32_t (&a)[KT][4],
                                          float (&acc)[NT][4], int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint2 bw = w[(k * NT + n) * 32 + lane];
      const uint32_t b[2] = {bw.x, bw.y};
      mma_bf16_16816(acc[n], a[k], b, acc[n]);
    }
  }
}

// a hidden layer's accumulators as the next layer's A fragments: ReLU,
// then bf16 (rounding commutes with the ReLU but for the sign of a zero)
template <int NT>
__device__ __forceinline__ void to_frag(const float (&acc)[NT][4],
                                        uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int k = 0; k < NT / 2; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[k][2 * h] = pack_bf16x2(fmaxf(acc[2 * k + h][0], 0.f),
                                fmaxf(acc[2 * k + h][1], 0.f));
      a[k][2 * h + 1] = pack_bf16x2(fmaxf(acc[2 * k + h][2], 0.f),
                                    fmaxf(acc[2 * k + h][3], 0.f));
    }
  }
}

// The sigma chain of row tile mt, whose encoding is in the tile: returns
// the sigma head's 16 outputs [sigma_raw clamped to [-15, 15], geo 0..14]
// as bf16, an A fragment (color layer 0's second k16 step).
template <class N>
__device__ __forceinline__ void mma_sigma_chain(const uint2* __restrict__ sw,
                                                const uint32_t* tile, int mt,
                                                int lane,
                                                uint32_t (&head)[4]) {
  constexpr int W16 = N::kWd / 16, W8 = N::kWd / 8;
  uint32_t a[W16][4];
  {
    uint32_t a0[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) load_a(a0[k], tile, mt, 8 * k, lane);
    float acc[W8][4];
    mma_layer<4, W8>(sw + N::frag_off(0), a0, acc, lane);
    to_frag<W8>(acc, a);
  }
#pragma unroll
  for (int l = 1; l < 3; ++l) {
    float acc[W8][4];
    mma_layer<W16, W8>(sw + N::frag_off(l), a, acc, lane);
    to_frag<W8>(acc, a);
  }
  float h[2][4];
  mma_layer<W16, 2>(sw + N::frag_off(3), a, h, lane);
  const bool col0 = (lane & 3) == 0;    // holds column 0, sigma_raw
  h[0][0] = col0 ? fminf(fmaxf(h[0][0], -15.f), 15.f) : h[0][0];
  h[0][2] = col0 ? fminf(fmaxf(h[0][2], -15.f), 15.f) : h[0][2];
  head[0] = pack_bf16x2(h[0][0], h[0][1]);
  head[1] = pack_bf16x2(h[0][2], h[0][3]);
  head[2] = pack_bf16x2(h[1][0], h[1][1]);
  head[3] = pack_bf16x2(h[1][2], h[1][3]);
}

// The color chain of row tile mt from SH(d) (in the tile) and the sigma
// head's A fragment: the last layer's accumulators (columns 0..2 are rgb
// before the sigmoid, rounded to bf16 on the way to the tile).
template <class N>
__device__ __forceinline__ void mma_color_chain(const uint2* __restrict__ sw,
                                                const uint32_t* tile, int mt,
                                                int lane,
                                                const uint32_t (&head)[4],
                                                float (&c)[1][4]) {
  constexpr int W16 = N::kWd / 16, W8 = N::kWd / 8;
  uint32_t a[W16][4];
  {
    uint32_t a0[2][4];
    load_a(a0[0], tile, mt, kTileSh, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) a0[1][i] = head[i];
    float acc[W8][4];
    mma_layer<2, W8>(sw + N::frag_off(4), a0, acc, lane);
    to_frag<W8>(acc, a);
  }
  {
    float acc[W8][4];
    mma_layer<W16, W8>(sw + N::frag_off(5), a, acc, lane);
    to_frag<W8>(acc, a);
  }
  mma_layer<W16, 1>(sw + N::frag_off(6), a, c, lane);
}

// Row tile mt's outputs into the tile's output words of their rows (lane
// 4 g + t holds rows g and g + 8): rgb from the color chain's
// accumulators `c` (lanes t = 0, 1), and with `head` sigma_raw (lanes
// t = 0), all as bf16. Ends converged.
__device__ __forceinline__ void mma_put_out(uint32_t* tile, int mt, int lane,
                                            const float (&c)[1][4],
                                            const uint32_t* head) {
  uint32_t* r0 = tile + (16 * mt + (lane >> 2)) * kTileWords + kTileOut;
  uint32_t* r1 = r0 + 8 * kTileWords;
  __nv_bfloat16* h0 = reinterpret_cast<__nv_bfloat16*>(r0);
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(r1);
  const int t = lane & 3;
  if (t == 0) {                         // r, g
    r0[0] = pack_bf16x2(c[0][0], c[0][1]);
    r1[0] = pack_bf16x2(c[0][2], c[0][3]);
    if (head != nullptr) {              // sigma_raw, column 0 of the head
      h0[3] = __float2bfloat16_rn(bf16_lo(head[0]));
      h1[3] = __float2bfloat16_rn(bf16_lo(head[1]));
    }
  } else if (t == 1) {                  // b
    h0[2] = __float2bfloat16_rn(c[0][0]);
    h1[2] = __float2bfloat16_rn(c[0][2]);
  }
  __syncwarp();
}

// this lane's outputs from its own row: sigma (exp of the clamped
// sigma_raw) and rgb (sigmoid)
__device__ __forceinline__ void mma_get_out(const uint32_t* __restrict__ row,
                                            float& sigma, float& r, float& g,
                                            float& b) {
  const uint2 o = *reinterpret_cast<const uint2*>(row + kTileOut);
  sigma = expf(bf16_hi(o.y));
  r = 1.f / (1.f + expf(-bf16_lo(o.x)));
  g = 1.f / (1.f + expf(-bf16_hi(o.x)));
  b = 1.f / (1.f + expf(-bf16_lo(o.y)));
}

// The field at this warp's 32 samples, one a lane: every lane of the warp
// calls it with its own position; SH(d) must already be in its row
// (mma_stage_sh). `tile` is the warp's staging tile.
template <class N>
__device__ __forceinline__ void mma_field(const uint2* __restrict__ sw,
                                          uint32_t* tile, float x0, float x1,
                                          float x2, float bound, float& sigma,
                                          float& r, float& g, float& b) {
  const int lane = threadIdx.x & 31;
  mma_stage_x<N>(tile + lane * kTileWords, x0, x1, x2, bound);
  __syncwarp();                         // every row written, lanes converged
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t head[4];
    float c[1][4];
    mma_sigma_chain<N>(sw, tile, mt, lane, head);
    mma_color_chain<N>(sw, tile, mt, lane, head, c);
    mma_put_out(tile, mt, lane, c, head);
  }
  mma_get_out(tile + lane * kTileWords, sigma, r, g, b);
}

// The paired schedule's pass (tile_kernel.cuh PAIRED): this sample's sigma
// chain beside the pending sample's color chain, whose sigma head waits in
// `pending` (per row tile; zeros before the first sample); returns this
// sample's sigma, the pending sample's rgb, and leaves this sample's head
// pending. Each chain is the default schedule's, so every sum keeps its
// order.
template <class N>
__device__ __forceinline__ void mma_field_paired(
    const uint2* __restrict__ sw, uint32_t* tile, uint32_t (&pending)[2][4],
    float x0, float x1, float x2, float bound, float& sigma, float& r,
    float& g, float& b) {
  const int lane = threadIdx.x & 31;
  mma_stage_x<N>(tile + lane * kTileWords, x0, x1, x2, bound);
  __syncwarp();
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t head[4], prev[4];
    float c[1][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) prev[i] = mt ? pending[1][i] : pending[0][i];
    mma_sigma_chain<N>(sw, tile, mt, lane, head);
    mma_color_chain<N>(sw, tile, mt, lane, prev, c);
    mma_put_out(tile, mt, lane, c, head);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pending[0][i] = mt ? pending[0][i] : head[i];
      pending[1][i] = mt ? head[i] : pending[1][i];
    }
  }
  mma_get_out(tile + lane * kTileWords, sigma, r, g, b);
}

// the paired schedule's drain: the pending sample's rgb alone
template <class N>
__device__ __forceinline__ void mma_color_drain(const uint2* __restrict__ sw,
                                                uint32_t* tile,
                                                const uint32_t (&pending)[2][4],
                                                float& r, float& g,
                                                float& b) {
  const int lane = threadIdx.x & 31;
  __syncwarp();                         // earlier readers of the tile done
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t prev[4];
    float c[1][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) prev[i] = mt ? pending[1][i] : pending[0][i];
    mma_color_chain<N>(sw, tile, mt, lane, prev, c);
    mma_put_out(tile, mt, lane, c, nullptr);
  }
  float sigma;
  mma_get_out(tile + lane * kTileWords, sigma, r, g, b);
}

}  // namespace pienerf
