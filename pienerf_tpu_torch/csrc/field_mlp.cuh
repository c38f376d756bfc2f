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
// field_kernel.py:97-171, tile_kernel.py:201-235 and :527-549): every layer
// reads inputs and weights rounded to the compute dtype, accumulates in
// f32, and rounds its output back to the compute dtype; ReLU between
// layers, not after the last. With BF16 the products of two bf16 values are
// exact in f32, so only the summation order differs from the reference.
// Every output's sum over inputs is one FMA chain in increasing input
// order, so zero-padded inputs or weights add exact zeros.
//
// Two ways to run the same layer code, by width:
//   Net64, `field_point`: one thread evaluates one point. The live
//     [in, out] extents of the [7, 64, 64] pack (75 KB as f32 rounded to
//     the compute dtype) are staged once per block in dynamic shared
//     memory. Every thread of a warp reads the same weight address at the
//     same time, so the loads broadcast; they are float4 wide so one load
//     feeds four FMAs. Each thread's layer activations sit in two
//     shared-memory columns beside them (see `accumulate`).
//   Net128, `field_points_wide`: the compact weights (255 KB) exceed a
//     block's 227 KB, and two 128-wide columns per thread at 256 threads
//     would take 256 KB. So the block's 256 threads evaluate 128 points at
//     a time, two threads per point, each computing half of every layer's
//     outputs with the same `accumulate`; the weights are staged one layer
//     at a time (at most 64 KB); the 128 points' activations live in two
//     [128 features][128 points] buffers (128 KB).
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
};
using Net64 = Net<64, 8>;
using Net128 = Net<128, 10>;

constexpr int kWidePoints = 128;        // points per Net128 pass

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Stage layer L of the pack pw [7, WD, WD] into sw as [in][outp] (all
// threads of the block take part; the caller synchronises before use).
template <bool BF16, class N, int L>
__device__ __forceinline__ void stage_layer(float* __restrict__ sw,
                                            const float* __restrict__ pw) {
  constexpr int IN = N::in(L), OUTP = N::outp(L), WD = N::kWd;
  constexpr int Q = OUTP / 4;                 // float4 per row
  const float* src = pw + (size_t)L * WD * WD;
  for (int e = threadIdx.x; e < IN * Q; e += blockDim.x) {
    const int i = e / Q;
    const int o = (e - i * Q) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + i * WD + o);
    *reinterpret_cast<float4*>(sw + i * OUTP + o) =
        make_float4(rnd<BF16>(v.x), rnd<BF16>(v.y), rnd<BF16>(v.z),
                    rnd<BF16>(v.w));
  }
}

// Stage every layer of a net whose compact weights fit (Net64).
template <bool BF16, class N>
__device__ __forceinline__ void stage_weights(float* sw,
                                              const float* __restrict__ pw) {
  stage_layer<BF16, N, 0>(sw + N::off(0), pw);
  stage_layer<BF16, N, 1>(sw + N::off(1), pw);
  stage_layer<BF16, N, 2>(sw + N::off(2), pw);
  stage_layer<BF16, N, 3>(sw + N::off(3), pw);
  stage_layer<BF16, N, 4>(sw + N::off(4), pw);
  stage_layer<BF16, N, 5>(sw + N::off(5), pw);
  stage_layer<BF16, N, 6>(sw + N::off(6), pw);
}

// NACC outputs of one layer for one point: acc[j] = sum_i w[i][j] h[i];
// w is a row-major block with row stride WSTRIDE in shared memory. The
// point's activations live in a shared-memory column (element i at
// h[i * stride]; a warp's threads hold consecutive points, so it touches
// consecutive words); only the NACC accumulators are registers. Keeping
// the input out of registers lets the input loop stay rolled: fully
// unrolled register chains made ptxas spill and take minutes.
template <int IN, int NACC, int WSTRIDE, bool BF16>
__device__ __forceinline__ void accumulate(const float* __restrict__ w,
                                           const float* __restrict__ h,
                                           int stride, float (&acc)[NACC]) {
  static_assert(NACC % 2 == 0, "outputs come in pairs");
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int i = 0; i < IN; ++i) {
    const float hi = h[i * stride];
    if constexpr (NACC % 4 == 0) {
#pragma unroll
      for (int j = 0; j < NACC; j += 4) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w + i * WSTRIDE + j);
        acc[j + 0] = __fmaf_rn(wv.x, hi, acc[j + 0]);
        acc[j + 1] = __fmaf_rn(wv.y, hi, acc[j + 1]);
        acc[j + 2] = __fmaf_rn(wv.z, hi, acc[j + 2]);
        acc[j + 3] = __fmaf_rn(wv.w, hi, acc[j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NACC; j += 2) {
        const float2 wv =
            *reinterpret_cast<const float2*>(w + i * WSTRIDE + j);
        acc[j + 0] = __fmaf_rn(wv.x, hi, acc[j + 0]);
        acc[j + 1] = __fmaf_rn(wv.y, hi, acc[j + 1]);
      }
    }
  }
}

// hidden layer: ReLU(round(w^T h)) into another shared-memory column
template <int IN, int OUTP, bool BF16>
__device__ __forceinline__ void hidden(const float* __restrict__ w,
                                       const float* __restrict__ h,
                                       float* __restrict__ out, int stride) {
  float acc[OUTP];
  accumulate<IN, OUTP, OUTP, BF16>(w, h, stride, acc);
#pragma unroll
  for (int j = 0; j < OUTP; ++j) {
    out[j * stride] = fmaxf(rnd<BF16>(acc[j]), 0.f);
  }
}

// last layer: round(w^T h) into registers, no activation
template <int IN, int OUTP, int OUT, bool BF16>
__device__ __forceinline__ void last(const float* __restrict__ w,
                                     const float* __restrict__ h, int stride,
                                     float (&o)[OUT]) {
  float acc[OUTP];
  accumulate<IN, OUTP, OUTP, BF16>(w, h, stride, acc);
#pragma unroll
  for (int j = 0; j < OUT; ++j) o[j] = rnd<BF16>(acc[j]);
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
// by the double-angle ladder (field_kernel.py:97-112), into a column.
template <bool BF16, int NF>
__device__ __forceinline__ void encode(float x0, float x1, float x2,
                                       float bound, float* __restrict__ enc,
                                       int stride) {
  constexpr int F = 1 + 2 * NF;         // features per axis
  const float c[3] = {x0, x1, x2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float cn = c[a] / bound;
    float s = sinf(kPi * cn);
    float co = cosf(kPi * cn);
    enc[(F * a) * stride] = rnd<BF16>(cn);
    enc[(F * a + 1) * stride] = rnd<BF16>(s);
    enc[(F * a + 1 + NF) * stride] = rnd<BF16>(co);
#pragma unroll
    for (int k = 1; k < NF; ++k) {
      const float s2 = 2.0f * s * co;
      const float c2 = co * co - s * s;
      s = s2;
      co = c2;
      enc[(F * a + 1 + k) * stride] = rnd<BF16>(s);
      enc[(F * a + 1 + NF + k) * stride] = rnd<BF16>(co);
    }
  }
}

// Shared memory a block needs for the MLP. Net64: all weights plus two
// 64-wide activation columns per thread. Net128: one layer's weights plus
// the two [128][128] activation buffers.
template <class N>
__host__ __device__ constexpr size_t mlp_smem_floats(int threads) {
  return N::kWd == 64
             ? (size_t)N::wfloats() + 2 * (size_t)N::kWd * threads
             : (size_t)N::kWd * N::kWd + 2 * (size_t)N::kWd * kWidePoints;
}
template <class N>
__host__ __device__ constexpr size_t mlp_smem_bytes(int threads) {
  return mlp_smem_floats<N>(threads) * sizeof(float);
}

// Field at one point with Net64: sigma (f32, before density scale) and
// rgb. `sh` holds the point's direction encoding from sh4<BF16>; `sw` the
// staged weights; `buf` is the block's activation area (2 * 64 *
// blockDim.x floats).
template <bool BF16>
__device__ __forceinline__ void field_point(const float* __restrict__ sw,
                                            float* __restrict__ buf,
                                            float x0, float x1, float x2,
                                            float bound, const float (&sh)[16],
                                            float& sigma, float& r, float& g,
                                            float& b) {
  using N = Net64;
  constexpr int WD = N::kWd;
  const int stride = blockDim.x;
  float* A = buf + threadIdx.x;
  float* B = buf + WD * stride + threadIdx.x;
  encode<BF16, N::kNf>(x0, x1, x2, bound, A, stride);
  hidden<N::kEnc, WD, BF16>(sw + N::off(0), A, B, stride);
  hidden<WD, WD, BF16>(sw + N::off(1), B, A, stride);
  hidden<WD, WD, BF16>(sw + N::off(2), A, B, stride);
  float h4[16];
  last<WD, 16, 16, BF16>(sw + N::off(3), B, stride, h4);
  sigma = expf(fminf(fmaxf(h4[0], -15.f), 15.f));

#pragma unroll
  for (int i = 0; i < 16; ++i) A[i * stride] = sh[i];
#pragma unroll
  for (int i = 0; i < 15; ++i) A[(16 + i) * stride] = h4[1 + i];
  hidden<31, WD, BF16>(sw + N::off(4), A, B, stride);
  hidden<WD, WD, BF16>(sw + N::off(5), B, A, stride);
  float c3[3];
  last<WD, 4, 3, BF16>(sw + N::off(6), A, stride, c3);
  r = 1.f / (1.f + expf(-c3[0]));
  g = 1.f / (1.f + expf(-c3[1]));
  b = 1.f / (1.f + expf(-c3[2]));
}

// One layer of the wide pass: stage layer L's weights, then thread
// (point p, half g) computes outputs [g * OUTP/2, (g + 1) * OUTP/2) of its
// point from column h into column out (stride kWidePoints). Both
// __syncthreads are block-wide: every thread of the block must call it.
template <bool BF16, class N, int L, bool RELU>
__device__ __forceinline__ void wide_layer(float* __restrict__ sw,
                                           const float* __restrict__ pw,
                                           const float* __restrict__ h,
                                           float* __restrict__ out, int g) {
  constexpr int IN = N::in(L), OUTP = N::outp(L), NACC = OUTP / 2;
  stage_layer<BF16, N, L>(sw, pw);
  __syncthreads();                     // weights and the layer input ready
  const int o0 = g * NACC;
  float acc[NACC];
  accumulate<IN, NACC, OUTP, BF16>(sw + o0, h, kWidePoints, acc);
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const float v = rnd<BF16>(acc[j]);
    out[(o0 + j) * kWidePoints] = RELU ? fmaxf(v, 0.f) : v;
  }
  __syncthreads();                     // outputs written; sw free again
}

// The wide net (Net128) for kWidePoints points, by all 256 threads of the
// block: thread t works on point p = t & 127 and output half g = t >> 7.
// For each point exactly one thread is its `owner`: it supplies x and sh
// and receives sigma and rgb (other threads' arguments are ignored and
// their outputs untouched). A and B are the two [128][128] activation
// buffers, sw room for one layer. Block-wide: every thread must call it.
template <bool BF16, class N>
__device__ __forceinline__ void field_points_wide(
    float* __restrict__ sw, float* __restrict__ A, float* __restrict__ B,
    const float* __restrict__ pw, bool owner, float x0, float x1, float x2,
    float bound, const float (&sh)[16], float& sigma, float& r, float& g,
    float& b) {
  static_assert(N::kWd == 2 * 64, "two threads of 64 outputs per point");
  constexpr int S = kWidePoints;
  const int p = threadIdx.x & (S - 1);
  const int half = threadIdx.x / S;
  float* a = A + p;
  float* bb = B + p;
  __syncthreads();                     // earlier readers of A, B are done
  if (owner) encode<BF16, N::kNf>(x0, x1, x2, bound, a, S);
  wide_layer<BF16, N, 0, true>(sw, pw, a, bb, half);
  wide_layer<BF16, N, 1, true>(sw, pw, bb, a, half);
  wide_layer<BF16, N, 2, true>(sw, pw, a, bb, half);
  wide_layer<BF16, N, 3, false>(sw, pw, bb, a, half);     // 16 rows in A
  if (owner) {
    sigma = expf(fminf(fmaxf(a[0], -15.f), 15.f));
#pragma unroll
    for (int i = 0; i < 16; ++i) bb[i * S] = sh[i];
#pragma unroll
    for (int i = 0; i < 15; ++i) bb[(16 + i) * S] = a[(1 + i) * S];
  }
  wide_layer<BF16, N, 4, true>(sw, pw, bb, a, half);
  wide_layer<BF16, N, 5, true>(sw, pw, a, bb, half);
  wide_layer<BF16, N, 6, false>(sw, pw, bb, a, half);     // 4 rows in A
  if (owner) {
    r = 1.f / (1.f + expf(-a[0]));
    g = 1.f / (1.f + expf(-a[S]));
    b = 1.f / (1.f + expf(-a[2 * S]));
  }
}

}  // namespace pienerf
