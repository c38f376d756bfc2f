// The field MLP on Hopper's tensor cores: the bf16 instantiations of the
// field kernel (field_kernel.cu) and of the tile kernel (tile_kernel.cuh,
// every mode and schedule) run field_mlp.cuh's nets (Net64, Net128) here;
// the f32 instantiations keep field_mlp.cuh's FMA chains.
//
// A warpgroup (four warps, 128 samples, one a lane) evaluates its samples
// as [64 x in] . [in x out] products of the warpgroup MMA (wgmma.cuh:
// `wgmma.mma_async` m64nNk16, bf16 A from registers, bf16 B from shared
// memory, f32 accumulators). A warp's 32 samples are two m16 row tiles
// (rows 0-15 are lanes 0-15); m64 tile mt of the warpgroup is row tile mt
// of each of its four warps, so every warp's rows stay in its own
// fragments and its own staging tile. Both m64 tiles' products of a layer
// go in one commit group (T = 2), or the tiles one after the other (T = 1,
// fewer live registers).
//   Weights: every layer staged once per block as bf16 in the MMA's
//     K-major, unswizzled B layout (stage_mma_weights), read by the tensor
//     cores through a descriptor: one 32 N-byte read of B per k16 step
//     serves the warpgroup's 64 rows. Net64 takes 39,936 B, Net128
//     129,024 B.
//   Activations: a warp's accumulators of an n8 column pair, rounded to
//     bf16, are exactly its A fragment of the next layer's k16 step
//     (to_frag), so the chain stays in registers. Layer 0 reads the
//     encoding, and color layer 0's first k16 step SH(d), from the warp's
//     staging tile (field_mlp.cuh kTileWords), each lane writing its own
//     sample's row: the features are the ladder's, never recomputed for
//     another lane's row. Color layer 0's second k16 step is the sigma
//     head's accumulator tile [sigma_raw, geo 0..14] itself, against
//     weight rows shifted by one past a zero row; sigma_raw is clamped to
//     [-15, 15] first (sigma's own clip), so that a sigma_raw rounding to
//     +-inf cannot make 0 x inf a NaN in the geo path. sigma and rgb go
//     back to their lanes through the tile.
// Semantics are the f32 path's: every layer reads bf16-rounded inputs and
// weights, multiplies exactly, accumulates in f32, rounds its outputs to
// bf16; ReLU between layers, not after the last. Only the summation order
// within a layer differs: each output's sum runs over the k16 steps in
// increasing order, each step's 16 products added to the running f32 sum
// by the tensor core in an order of its own (the CPU emulation of
// wgmma.cuh, tests/test_torch_cuda_emu.py, adds them one by one in
// increasing k). Every MMA runs on all 128 threads of the warpgroup,
// converged (`.sync.aligned`): the callers reach these functions
// warpgroup-uniformly.
//
// Bound on this card: the tensor cores (989 TFLOP/s bf16, dense, about
// 2,048 MACs a clock an SM). The warp-level mma.sync.m16n8k16 this
// replaced read its B fragment from shared memory for every 2,048 MACs
// (256 B: 0.125 B a MAC, 256 B a clock at that peak against shared
// memory's 128), which capped it near half the peak; a warpgroup MMA
// reads 32 N bytes for 1,024 N MACs (1/32 B a MAC), and runs
// asynchronously, so a warpgroup keeps both m64 tiles' products in flight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace pienerf {

// the B layout's strides (wgmma.cuh): the two core matrices of a k16 step
// (lbo), consecutive n8 groups (sbo)
constexpr uint32_t kLbo = 128;
constexpr uint32_t kSbo = 256;

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
// from `src`) as the warpgroup MMA's B (wgmma.cuh: bf16, K-major, no
// swizzle): k16 step kt starts kt * out8(L) * 32 bytes in (its
// descriptor's start); within it, n8 group g at 256 g (sbo), its rows k
// 0..7 and 8..15 128 bytes apart (lbo), column n's 8 k values a 16-byte
// row (kLbo, kSbo). Padding is zero. Color layer 0 (L == 4) meets [SH(d) | sigma_raw,
// geo]: its rows 16..30 move to 17..31 behind a zero row 16. All threads
// of the block take part, one 16-byte row at a time.
template <class N, int L>
__device__ __forceinline__ void stage_mma_layer(char* __restrict__ dst,
                                                const float* __restrict__ src,
                                                int stride) {
  static_assert(kLbo == 8 * 16 && kSbo == 2 * kLbo,
                "16-byte row e lies at 16 e: 8 a core matrix, 2 an n8 group");
  constexpr int NG = N::out8(L) / 8;
  constexpr int ROWS = N::in16(L) / 8 * N::out8(L);
  for (int e = threadIdx.x; e < ROWS; e += blockDim.x) {
    const int g = e >> 4;                 // kt * NG + n8 group
    const int kt = g / NG;
    const int n = (g - kt * NG) * 8 + (e & 7);
    const int k = kt * 16 + (e & 8);
    auto w = [&](int kk) {
      const int i = (L == 4 && kk >= 16) ? kk - 1 : kk;
      const bool ok = n < N::outp(L) && i < N::in(L) && !(L == 4 && kk == 16);
      return ok ? src[i * stride + n] : 0.f;
    };
    *reinterpret_cast<uint4*>(dst + 16 * e) =
        make_uint4(pack_bf16x2(w(k), w(k + 1)), pack_bf16x2(w(k + 2), w(k + 3)),
                   pack_bf16x2(w(k + 4), w(k + 5)),
                   pack_bf16x2(w(k + 6), w(k + 7)));
  }
}

// every layer; src(l) is layer l's [in, out] block, row stride `stride`.
// The MMAs read the weights through the async proxy: each thread fences
// its writes, and the caller's __syncthreads publishes them.
template <class N, class Src>
__device__ __forceinline__ void stage_mma_layers(void* sw, Src src,
                                                 int stride) {
  char* b = static_cast<char*>(sw);
  stage_mma_layer<N, 0>(b + N::mma_off(0), src(0), stride);
  stage_mma_layer<N, 1>(b + N::mma_off(1), src(1), stride);
  stage_mma_layer<N, 2>(b + N::mma_off(2), src(2), stride);
  stage_mma_layer<N, 3>(b + N::mma_off(3), src(3), stride);
  stage_mma_layer<N, 4>(b + N::mma_off(4), src(4), stride);
  stage_mma_layer<N, 5>(b + N::mma_off(5), src(5), stride);
  stage_mma_layer<N, 6>(b + N::mma_off(6), src(6), stride);
  fence_proxy_async();
}

// from the pack [7, WD, WD]
template <class N>
__device__ __forceinline__ void stage_mma_weights(
    void* sw, const float* __restrict__ pw) {
  stage_mma_layers<N>(
      sw, [&](int l) { return pw + (size_t)l * N::kWd * N::kWd; }, N::kWd);
}

// from the paired pack [4, 128, 128]: sigma layer l in the diagonal block
// [0:64, 0:64] of position l, color layer l - 4 in [64:128, 64:128] of
// position l - 4 (as stage_weights_paired)
template <class N>
__device__ __forceinline__ void stage_mma_weights_paired(
    void* sw, const float* __restrict__ pw) {
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

// acc[t] = a[t] . B for the T m64 tiles t, B the layer's KT k16 steps
// from descriptor `desc` (NO columns): every product of the T tiles in one
// commit group, so the tensor cores have them all at once; returns with
// them done
template <int T, int KT, int NO>
__device__ __forceinline__ void mma_layer(uint64_t desc,
                                          const uint32_t (&a)[T][KT][4],
                                          float (&acc)[T][NO / 8][4]) {
  wg_fence();
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      // the descriptor counts 16 bytes; a k16 step is NO * 32 bytes
      wgmma_bf16<NO>(acc[t], a[t][k], desc + (uint64_t)(2 * NO * k), k > 0);
    }
  }
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int t = 0; t < T; ++t) wg_fence_operand(acc[t]);
}

// two floats rounded to bf16, then ReLU (lo in the low half), as the
// plain version's layer output: one cvt.rn.relu.bf16x2 (a NaN stays NaN)
__device__ __forceinline__ uint32_t pack_relu_bf16x2(float lo, float hi) {
#ifdef PIENERF_EMU_WGMMA
  return emu_cvt_rn_relu_bf16x2(hi, lo);
#else
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
#endif
}

// a hidden layer's accumulators as the next layer's A fragments
template <int NT>
__device__ __forceinline__ void to_frag(const float (&acc)[NT][4],
                                        uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int k = 0; k < NT / 2; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[k][2 * h] = pack_relu_bf16x2(acc[2 * k + h][0], acc[2 * k + h][1]);
      a[k][2 * h + 1] =
          pack_relu_bf16x2(acc[2 * k + h][2], acc[2 * k + h][3]);
    }
  }
}

// the descriptor of layer l's staged weights, from d0, the descriptor of
// the block's staged weights
template <class N>
__device__ __forceinline__ uint64_t layer_desc(uint64_t d0, int l) {
  return d0 + (uint64_t)(N::mma_off(l) >> 4);
}

// The sigma chain of row tiles mt0 .. mt0 + T - 1, whose encodings are in
// the tile: the sigma head's 16 outputs of tile t, [sigma_raw clamped to
// [-15, 15], geo 0..14], as bf16 into head[t], an A fragment (color layer
// 0's second k16 step).
template <class N, int T>
__device__ __forceinline__ void mma_sigma_chain(uint64_t d0,
                                                const uint32_t* tile, int mt0,
                                                int lane,
                                                uint32_t (&head)[T][4]) {
  constexpr int W16 = N::kWd / 16, W8 = N::kWd / 8;
  uint32_t a[T][W16][4];
  {
    uint32_t a0[T][4][4];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int k = 0; k < 4; ++k) load_a(a0[t][k], tile, mt0 + t, 8 * k, lane);
    }
    float acc[T][W8][4];
    mma_layer<T, 4, N::kWd>(layer_desc<N>(d0, 0), a0, acc);
#pragma unroll
    for (int t = 0; t < T; ++t) to_frag<W8>(acc[t], a[t]);
  }
#pragma unroll
  for (int l = 1; l < 3; ++l) {
    float acc[T][W8][4];
    mma_layer<T, W16, N::kWd>(layer_desc<N>(d0, l), a, acc);
#pragma unroll
    for (int t = 0; t < T; ++t) to_frag<W8>(acc[t], a[t]);
  }
  float h[T][2][4];
  mma_layer<T, W16, 16>(layer_desc<N>(d0, 3), a, h);
  const bool col0 = (lane & 3) == 0;    // holds column 0, sigma_raw
#pragma unroll
  for (int t = 0; t < T; ++t) {
    h[t][0][0] = col0 ? fminf(fmaxf(h[t][0][0], -15.f), 15.f) : h[t][0][0];
    h[t][0][2] = col0 ? fminf(fmaxf(h[t][0][2], -15.f), 15.f) : h[t][0][2];
    head[t][0] = pack_bf16x2(h[t][0][0], h[t][0][1]);
    head[t][1] = pack_bf16x2(h[t][0][2], h[t][0][3]);
    head[t][2] = pack_bf16x2(h[t][1][0], h[t][1][1]);
    head[t][3] = pack_bf16x2(h[t][1][2], h[t][1][3]);
  }
}

// The color chain of row tiles mt0 .. mt0 + T - 1 from SH(d) (in the tile)
// and the sigma heads' A fragments: the last layer's accumulators (columns
// 0..2 are rgb before the sigmoid, rounded to bf16 on the way to the tile).
template <class N, int T>
__device__ __forceinline__ void mma_color_chain(uint64_t d0,
                                                const uint32_t* tile, int mt0,
                                                int lane,
                                                const uint32_t (&head)[T][4],
                                                float (&c)[T][1][4]) {
  constexpr int W16 = N::kWd / 16, W8 = N::kWd / 8;
  uint32_t a[T][W16][4];
  {
    uint32_t a0[T][2][4];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      load_a(a0[t][0], tile, mt0 + t, kTileSh, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) a0[t][1][i] = head[t][i];
    }
    float acc[T][W8][4];
    mma_layer<T, 2, N::kWd>(layer_desc<N>(d0, 4), a0, acc);
#pragma unroll
    for (int t = 0; t < T; ++t) to_frag<W8>(acc[t], a[t]);
  }
  {
    float acc[T][W8][4];
    mma_layer<T, W16, N::kWd>(layer_desc<N>(d0, 5), a, acc);
#pragma unroll
    for (int t = 0; t < T; ++t) to_frag<W8>(acc[t], a[t]);
  }
  mma_layer<T, W16, 8>(layer_desc<N>(d0, 6), a, c);
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

// The field at this warp's 32 samples, one a lane, T of its two row tiles
// in flight at a time: every lane of the warpgroup calls it with its own
// position; SH(d) must already be in its row (mma_stage_sh). `sw` is the
// block's staged weights, `tile` the warp's staging tile.
template <class N, int T>
__device__ __forceinline__ void mma_field(const void* sw, uint32_t* tile,
                                          float x0, float x1, float x2,
                                          float bound, float& sigma, float& r,
                                          float& g, float& b) {
  const int lane = threadIdx.x & 31;
  const uint64_t d0 = wg_desc(sw, kLbo, kSbo);
  mma_stage_x<N>(tile + lane * kTileWords, x0, x1, x2, bound);
  __syncwarp();                         // every row written, lanes converged
#pragma unroll 1
  for (int mt = 0; mt < 2; mt += T) {
    uint32_t head[T][4];
    float c[T][1][4];
    mma_sigma_chain<N, T>(d0, tile, mt, lane, head);
    mma_color_chain<N, T>(d0, tile, mt, lane, head, c);
#pragma unroll
    for (int t = 0; t < T; ++t) mma_put_out(tile, mt + t, lane, c[t], head[t]);
  }
  mma_get_out(tile + lane * kTileWords, sigma, r, g, b);
}

// The paired schedule's pass (tile_kernel.cuh PAIRED): this sample's sigma
// chain beside the pending sample's color chain, whose sigma head waits in
// `pending` (per row tile; zeros before the first sample); returns this
// sample's sigma, the pending sample's rgb, and leaves this sample's head
// pending. Each chain is the default schedule's, so every sum keeps its
// order.
template <class N, int T>
__device__ __forceinline__ void mma_field_paired(
    const void* sw, uint32_t* tile, uint32_t (&pending)[2][4], float x0,
    float x1, float x2, float bound, float& sigma, float& r, float& g,
    float& b) {
  const int lane = threadIdx.x & 31;
  const uint64_t d0 = wg_desc(sw, kLbo, kSbo);
  mma_stage_x<N>(tile + lane * kTileWords, x0, x1, x2, bound);
  __syncwarp();
#pragma unroll 1
  for (int mt = 0; mt < 2; mt += T) {
    uint32_t head[T][4], prev[T][4];
    float c[T][1][4];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        prev[t][i] = mt + t ? pending[1][i] : pending[0][i];
      }
    }
    mma_sigma_chain<N, T>(d0, tile, mt, lane, head);
    mma_color_chain<N, T>(d0, tile, mt, lane, prev, c);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      mma_put_out(tile, mt + t, lane, c[t], head[t]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pending[0][i] = mt + t ? pending[0][i] : head[t][i];
        pending[1][i] = mt + t ? head[t][i] : pending[1][i];
      }
    }
  }
  mma_get_out(tile + lane * kTileWords, sigma, r, g, b);
}

// the paired schedule's drain: the pending sample's rgb alone
template <class N, int T>
__device__ __forceinline__ void mma_color_drain(const void* sw,
                                                uint32_t* tile,
                                                const uint32_t (&pending)[2][4],
                                                float& r, float& g,
                                                float& b) {
  const int lane = threadIdx.x & 31;
  const uint64_t d0 = wg_desc(sw, kLbo, kSbo);
  __syncwarp();                         // earlier readers of the tile done
#pragma unroll 1
  for (int mt = 0; mt < 2; mt += T) {
    uint32_t prev[T][4];
    float c[T][1][4];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        prev[t][i] = mt + t ? pending[1][i] : pending[0][i];
      }
    }
    mma_color_chain<N, T>(d0, tile, mt, lane, prev, c);
#pragma unroll
    for (int t = 0; t < T; ++t) mma_put_out(tile, mt + t, lane, c[t], nullptr);
  }
  float sigma;
  mma_get_out(tile + lane * kTileWords, sigma, r, g, b);
}

}  // namespace pienerf
