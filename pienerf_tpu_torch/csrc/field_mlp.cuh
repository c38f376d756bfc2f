// Field MLP of the mlp backbone, shared by field_kernel.cu and
// tile_kernel.cu, for the two shipped nets:
//
//   x -> double-angle Fourier features (3 * (1 + 2 * NF))
//        -> sigma MLP enc-WD-WD-WD-16
//        -> sigma = exp(clip(h0, -15, 15)), geo = h[1:16]
//   SH4(d) (16) || geo (15) -> color MLP 31-WD-WD-3 -> sigmoid
//
// Net64 (WD 64, NF 8: 51-64-64-64-16 / 31-64-64-3, 18,752 MACs a point) and
// Net128 (WD 128, NF 10: 63-128-128-128-16 / 31-128-128-3, 63,616 MACs, the
// distilled 128-wide student) are the two instantiations of `Net`.
//
// Arithmetic follows the Pallas kernels (pienerf_tpu/ops/pallas/
// field_kernel.py:97-171, tile_kernel.py:201-235 and :527-549) in f32;
// ReLU between layers, not after the last. Every output's sum over inputs
// is one FMA chain in increasing input order, so zero-padded inputs or
// weights add exact zeros. (The encoding and SH(d) below, shared with the
// bf16 path, round to the compute dtype.)
//
// One thread runs one point's chains (`accumulate`, `hidden`, `last`,
// `paired_layer`): the point's activations in a shared-memory column, the
// weights staged in shared memory and read as broadcast float4s. The
// tile kernel's paired schedule (Net64 only) stages the compact weights
// from the block-diagonal pack (stage_weights_paired) and runs a sigma
// layer beside a color layer per pass over the inputs (paired_layer).
// Every other f32 path of both kernels runs the same chains
// register-blocked over a block of points (field_f32.cuh), bit for bit.
// The bf16 instantiations of both kernels run the same net on the tensor
// cores instead, a warpgroup's 128 samples at a time (mma_mlp.cuh,
// included at the end of this file).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace pienerf {

constexpr int kLayers = 7;              // 4 sigma + 3 color layers
constexpr float kPi = 3.14159265358979323846f;

// Layer l reads in(l) inputs and writes outp(l) columns (the last sigma
// layer's 16 = sigma + 15 geo; the last color layer's 3 padded to 4). The
// compact shared-memory layout keeps layer l at off(l), [in][outp]
// row-major; the [7, WD, WD] pack holds it at rows [0, in), cols [0, outp).
template <int WD, int NF>
struct Net {
  static constexpr int kWd = WD;
  static constexpr int kNf = NF;
  static constexpr int kEnc = 3 * (1 + 2 * NF);
  static constexpr int kLayers = pienerf::kLayers;
  static constexpr int kHead = 3;        // the sigma head
  static constexpr int kRgb = 6;         // the last color layer
  static constexpr bool kGrid = false;   // Fourier features, not a hash grid
  __host__ __device__ static constexpr int in(int l) {
    return l == 0 ? kEnc : (l == 4 ? 31 : WD);
  }
  __host__ __device__ static constexpr int outp(int l) {
    return l == 3 ? 16 : (l == 6 ? 4 : WD);
  }
  __host__ __device__ static constexpr int off(int l) {
    int o = 0;
    for (int k = 0; k < l; ++k) o += in(k) * outp(k);
    return o;
  }
  __host__ __device__ static constexpr int wfloats() {   // all layers
    return off(kLayers);
  }
  // the bf16 tensor-core extents (mma_mlp.cuh): layer l's inputs padded to
  // whole k16 steps (the encoding to 64; color layer 0 to SH(d) 16 plus
  // the sigma head's 16 outputs, a zero row against sigma_raw) and its
  // outputs to an N the warpgroup MMA takes (the last color layer's 3 to
  // 8). Layer l's staged bf16 weights start mma_off(l) bytes in.
  __host__ __device__ static constexpr int in16(int l) {
    return l == 0 ? 64 : (l == 4 ? 32 : WD);
  }
  __host__ __device__ static constexpr int out8(int l) {
    return l == 3 ? 16 : (l == 6 ? 8 : WD);
  }
  __host__ __device__ static constexpr int mma_off(int l) {
    int o = 0;
    for (int k = 0; k < l; ++k) o += in16(k) * out8(k) * 2;
    return o;
  }
  __host__ __device__ static constexpr size_t mma_bytes() {
    return (size_t)mma_off(kLayers);
  }
  static_assert(kEnc <= 64, "the encoding fills one 64-wide k extent");
};
using Net64 = Net<64, 8>;
using Net128 = Net<128, 10>;

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Stage layer L's live [in, outp] extent from `src` (row stride
// `src_stride` floats) into sw as [in][outp] (all threads of the block
// take part; the caller synchronises before use).
template <class N, int L>
__device__ __forceinline__ void stage_block(float* __restrict__ sw,
                                            const float* __restrict__ src,
                                            int src_stride) {
  constexpr int IN = N::in(L), OUTP = N::outp(L);
  constexpr int Q = OUTP / 4;                 // float4 per row
  for (int e = threadIdx.x; e < IN * Q; e += blockDim.x) {
    const int i = e / Q;
    const int o = (e - i * Q) * 4;
    *reinterpret_cast<float4*>(sw + i * OUTP + o) =
        *reinterpret_cast<const float4*>(src + i * src_stride + o);
  }
}

// Stage layer L of the pack pw [7, WD, WD].
template <class N, int L>
__device__ __forceinline__ void stage_layer(float* __restrict__ sw,
                                            const float* __restrict__ pw) {
  stage_block<N, L>(sw, pw + (size_t)L * N::kWd * N::kWd, N::kWd);
}

// Stage every layer of a net whose compact weights fit (Net64, and the
// hash-grid net's five, grid_encode.cuh).
template <class N>
__device__ __forceinline__ void stage_weights(float* sw,
                                              const float* __restrict__ pw) {
  stage_layer<N, 0>(sw + N::off(0), pw);
  stage_layer<N, 1>(sw + N::off(1), pw);
  stage_layer<N, 2>(sw + N::off(2), pw);
  stage_layer<N, 3>(sw + N::off(3), pw);
  stage_layer<N, 4>(sw + N::off(4), pw);
  if constexpr (N::kLayers == 7) {
    stage_layer<N, 5>(sw + N::off(5), pw);
    stage_layer<N, 6>(sw + N::off(6), pw);
  }
}

// Stage a 64-wide net from the paired pack [4, 128, 128]
// (kernels/field.py pack_weights_paired): position l holds sigma layer l
// in the diagonal block [0:64, 0:64] and color layer l in [64:128,
// 64:128]. Only those blocks are read, into the same compact layout as
// stage_weights; the zero off-diagonal blocks and the identity tail of the
// shorter chain are never touched.
template <class N>
__device__ __forceinline__ void stage_weights_paired(
    float* sw, const float* __restrict__ pw) {
  static_assert(N::kWd == 64, "only the 64-wide net pairs");
  constexpr int P = 128;                      // paired tile side
  const float* col = pw + 64 * P + 64;        // the color block of tile 0
  stage_block<N, 0>(sw + N::off(0), pw + 0 * P * P, P);
  stage_block<N, 1>(sw + N::off(1), pw + 1 * P * P, P);
  stage_block<N, 2>(sw + N::off(2), pw + 2 * P * P, P);
  stage_block<N, 3>(sw + N::off(3), pw + 3 * P * P, P);
  stage_block<N, 4>(sw + N::off(4), col + 0 * P * P, P);
  stage_block<N, 5>(sw + N::off(5), col + 1 * P * P, P);
  stage_block<N, 6>(sw + N::off(6), col + 2 * P * P, P);
}

// acc[j] += w_row[j] * hi for one input row of a layer's weights (NACC
// consecutive floats in shared memory), as float4 or float2 loads.
template <int NACC>
__device__ __forceinline__ void fma_row(const float* __restrict__ w_row,
                                        float hi, float (&acc)[NACC]) {
  static_assert(NACC % 2 == 0, "outputs come in pairs");
  if constexpr (NACC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NACC; j += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w_row + j);
      acc[j + 0] = __fmaf_rn(wv.x, hi, acc[j + 0]);
      acc[j + 1] = __fmaf_rn(wv.y, hi, acc[j + 1]);
      acc[j + 2] = __fmaf_rn(wv.z, hi, acc[j + 2]);
      acc[j + 3] = __fmaf_rn(wv.w, hi, acc[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NACC; j += 2) {
      const float2 wv = *reinterpret_cast<const float2*>(w_row + j);
      acc[j + 0] = __fmaf_rn(wv.x, hi, acc[j + 0]);
      acc[j + 1] = __fmaf_rn(wv.y, hi, acc[j + 1]);
    }
  }
}

// NACC outputs of one layer for one point: acc[j] = sum_i w[i][j] h[i];
// w is a row-major block with row stride WSTRIDE in shared memory. The
// point's activations live in a shared-memory column (element i at
// h[i * stride]; a warp's threads hold consecutive points, so it touches
// consecutive words); only the NACC accumulators are registers. Keeping
// the input out of registers lets the input loop stay rolled: fully
// unrolled register chains made ptxas spill and take minutes.
template <int IN, int NACC, int WSTRIDE>
__device__ __forceinline__ void accumulate(const float* __restrict__ w,
                                           const float* __restrict__ h,
                                           int stride, float (&acc)[NACC]) {
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int i = 0; i < IN; ++i) {
    fma_row<NACC>(w + i * WSTRIDE, h[i * stride], acc);
  }
}

// hidden layer: ReLU(w^T h) into another shared-memory column
template <int IN, int OUTP>
__device__ __forceinline__ void hidden(const float* __restrict__ w,
                                       const float* __restrict__ h,
                                       float* __restrict__ out, int stride) {
  float acc[OUTP];
  accumulate<IN, OUTP, OUTP>(w, h, stride, acc);
#pragma unroll
  for (int j = 0; j < OUTP; ++j) out[j * stride] = fmaxf(acc[j], 0.f);
}

// last layer: w^T h into registers, no activation
template <int IN, int OUTP, int OUT>
__device__ __forceinline__ void last(const float* __restrict__ w,
                                     const float* __restrict__ h, int stride,
                                     float (&o)[OUT]) {
  float acc[OUTP];
  accumulate<IN, OUTP, OUTP>(w, h, stride, acc);
#pragma unroll
  for (int j = 0; j < OUT; ++j) o[j] = acc[j];
}

// One position of the paired chain for one thread: the sigma layer
// (IN_S -> 64, ReLU, written back over its own column S) beside the color
// layer (IN_C -> OUTP_C, into `c`, for the caller to store), as two
// independent FMA chains in one pass over the inputs. All sums finish
// before anything is stored, so S is updated in place; each output's sum
// is still one chain in increasing input order, as in `accumulate`.
template <int IN_S, int IN_C, int OUTP_C>
__device__ __forceinline__ void paired_layer(const float* __restrict__ wS,
                                             const float* __restrict__ wC,
                                             float* S, const float* C,
                                             int stride,
                                             float (&c)[OUTP_C]) {
  constexpr int WD = 64;
  constexpr int IN_B = IN_S < IN_C ? IN_S : IN_C;
  float s[WD];
#pragma unroll
  for (int j = 0; j < WD; ++j) s[j] = 0.f;
#pragma unroll
  for (int j = 0; j < OUTP_C; ++j) c[j] = 0.f;
  for (int i = 0; i < IN_B; ++i) {
    fma_row<WD>(wS + i * WD, S[i * stride], s);
    fma_row<OUTP_C>(wC + i * OUTP_C, C[i * stride], c);
  }
  for (int i = IN_B; i < IN_S; ++i) fma_row<WD>(wS + i * WD, S[i * stride], s);
  for (int i = IN_B; i < IN_C; ++i) {
    fma_row<OUTP_C>(wC + i * OUTP_C, C[i * stride], c);
  }
#pragma unroll
  for (int j = 0; j < WD; ++j) S[j * stride] = fmaxf(s[j], 0.f);
}

// Degree-4 real SH of a unit direction, rounded to the compute dtype
// (same expression order as pienerf_tpu/ops/pallas/field_kernel.py:115-131).
template <bool BF16>
__device__ __forceinline__ void sh4(float x, float y, float z,
                                    float (&sh)[16]) {
  const float C0 = 0.28209479177387814f, C1 = 0.48860251190291987f;
  const float C20 = 1.0925484305920792f, C21 = 0.94617469575755997f,
              C22 = 0.31539156525251999f, C23 = 0.54627421529603959f;
  const float C30 = 0.59004358992664352f, C31 = 2.8906114426405538f,
              C32 = 0.45704579946446572f, C33 = 0.3731763325901154f,
              C34 = 1.4453057213202769f;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float x2 = x * x, y2 = y * y, z2 = z * z;
  sh[0] = rnd<BF16>(C0);
  sh[1] = rnd<BF16>(-C1 * y);
  sh[2] = rnd<BF16>(C1 * z);
  sh[3] = rnd<BF16>(-C1 * x);
  sh[4] = rnd<BF16>(C20 * xy);
  sh[5] = rnd<BF16>(-C20 * yz);
  sh[6] = rnd<BF16>(C21 * z2 - C22);
  sh[7] = rnd<BF16>(-C20 * xz);
  sh[8] = rnd<BF16>(C23 * (x2 - y2));
  sh[9] = rnd<BF16>(C30 * y * (-3.0f * x2 + y2));
  sh[10] = rnd<BF16>(C31 * xy * z);
  sh[11] = rnd<BF16>(C32 * y * (1.0f - 5.0f * z2));
  sh[12] = rnd<BF16>(C33 * z * (5.0f * z2 - 3.0f));
  sh[13] = rnd<BF16>(C32 * x * (1.0f - 5.0f * z2));
  sh[14] = rnd<BF16>(C34 * z * (x2 - y2));
  sh[15] = rnd<BF16>(C30 * x * (-x2 + 3.0f * y2));
}

// [c/bound, sin(2^k pi c/bound) k<NF, cos(2^k pi c/bound) k<NF] per axis,
// by the double-angle ladder (field_kernel.py:97-112): put(i, feature i).
template <bool BF16, int NF, class Put>
__device__ __forceinline__ void encode_to(float x0, float x1, float x2,
                                          float bound, Put put) {
  constexpr int F = 1 + 2 * NF;         // features per axis
  const float c[3] = {x0, x1, x2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float cn = c[a] / bound;
    float s = sinf(kPi * cn);
    float co = cosf(kPi * cn);
    put(F * a, rnd<BF16>(cn));
    put(F * a + 1, rnd<BF16>(s));
    put(F * a + 1 + NF, rnd<BF16>(co));
#pragma unroll
    for (int k = 1; k < NF; ++k) {
      const float s2 = 2.0f * s * co;
      const float c2 = co * co - s * s;
      s = s2;
      co = c2;
      put(F * a + 1 + k, rnd<BF16>(s));
      put(F * a + 1 + NF + k, rnd<BF16>(co));
    }
  }
}

// the encoding into a shared-memory column (element i at enc[i * stride])
template <bool BF16, int NF>
__device__ __forceinline__ void encode(float x0, float x1, float x2,
                                       float bound, float* __restrict__ enc,
                                       int stride) {
  encode_to<BF16, NF>(x0, x1, x2, bound,
                      [&](int i, float v) { enc[i * stride] = v; });
}

// The bf16 tensor-core path (mma_mlp.cuh): every layer's bf16 weights in
// the warpgroup MMA's B layout, and one staging tile per warp, 32 rows (one a lane) of
// kTileWords 32-bit words: the encoding in words [0, 32), SH(d) in
// [kTileSh, kTileSh + 8), sigma and rgb in [kTileOut, kTileOut + 2). The
// row stride of 44 words puts row g's words 8k + t, for the 8 rows g and
// 4 columns t of a fragment load, in 32 distinct banks.
constexpr int kTileWords = 44;
constexpr int kTileSh = 32;
constexpr int kTileOut = 40;
constexpr size_t kWarpTileBytes = 32 * kTileWords * 4;
template <class N>
__host__ __device__ constexpr size_t mma_smem_bytes(int threads) {
  return N::mma_bytes() + (size_t)(threads / 32) * kWarpTileBytes;
}

}  // namespace pienerf

#include "mma_mlp.cuh"
