// Field MLP of the mlp backbone, shared by field_kernel.cu and
// tile_kernel.cu: one thread evaluates one point.
//
//   x -> double-angle Fourier features (51) -> sigma MLP 51-64-64-64-16
//        -> sigma = exp(clip(h0, -15, 15)), geo = h[1:16]
//   SH4(d) (16) || geo (15) -> color MLP 31-64-64-3 -> sigmoid
//
// Arithmetic follows the Pallas kernels (pienerf_tpu/ops/pallas/
// field_kernel.py:97-171, tile_kernel.py:201-235 and :527-549): every layer
// reads inputs and weights rounded to the compute dtype, accumulates in
// f32, and rounds its output back to the compute dtype; ReLU between
// layers, not after the last. With BF16 the products of two bf16 values are
// exact in f32, so only the summation order differs from the reference.
//
// The weights (the live [in, out] extents of the [7, 64, 64] pack, 75 KB
// as f32 rounded to the compute dtype) are staged once per block in
// dynamic shared memory. Every thread of a warp reads the same weight
// address at the same time, so the loads broadcast; they are float4 wide
// so one load feeds four FMAs. Each thread's layer activations sit in two
// shared-memory columns beside them (see `accumulate`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace pienerf {

constexpr int kWd = 64;                 // packed tile width (kernel_width)
constexpr int kLayers = 7;              // 4 sigma + 3 color layers
constexpr int kEnc = 51;                // 3 * (1 + 2 * n_freqs), n_freqs = 8
constexpr float kPi = 3.14159265358979323846f;

// compact shared-memory layout: layer l at kOff[l], [in][outp] row-major
constexpr int kS0 = 0;                  // 51 x 64
constexpr int kS1 = kS0 + 51 * 64;      // 64 x 64
constexpr int kS2 = kS1 + 64 * 64;      // 64 x 64
constexpr int kS3 = kS2 + 64 * 64;      // 64 x 16
constexpr int kC0 = kS3 + 64 * 16;      // 31 x 64
constexpr int kC1 = kC0 + 31 * 64;      // 64 x 64
constexpr int kC2 = kC1 + 64 * 64;      // 64 x 4 (3 live columns)
constexpr int kWFloats = kC2 + 64 * 4;
constexpr size_t kWBytes = kWFloats * sizeof(float);

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Stage the packed weights pw [7, 64, 64] into shared memory (all threads
// of the block take part; the caller synchronises before use).
template <bool BF16>
__device__ __forceinline__ void stage_weights(float* sw,
                                              const float* __restrict__ pw) {
  const int offs[kLayers] = {kS0, kS1, kS2, kS3, kC0, kC1, kC2};
  const int ins[kLayers] = {51, 64, 64, 64, 31, 64, 64};
  const int outp[kLayers] = {64, 64, 64, 16, 64, 64, 4};
  for (int l = 0; l < kLayers; ++l) {
    const int n = ins[l] * outp[l];
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = e / outp[l];
      const int o = e - i * outp[l];
      sw[offs[l] + e] = rnd<BF16>(pw[(l * kWd + i) * kWd + o]);
    }
  }
}

// One layer for one point: out = act(round(w^T h)); w is [IN][OUTP] in
// shared memory. The thread's activations live in a shared-memory column
// (element i at h[i * stride], stride = blockDim.x, so a warp touches 32
// consecutive words); only the OUTP accumulators are registers. Keeping
// the input out of registers lets the input loop stay rolled: fully
// unrolled register chains made ptxas spill and take minutes.
template <int IN, int OUTP, bool BF16>
__device__ __forceinline__ void accumulate(const float* __restrict__ w,
                                           const float* __restrict__ h,
                                           int stride, float (&acc)[OUTP]) {
#pragma unroll
  for (int j = 0; j < OUTP; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int i = 0; i < IN; ++i) {
    const float hi = h[i * stride];
#pragma unroll
    for (int j = 0; j < OUTP; j += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w + i * OUTP + j);
      acc[j + 0] = __fmaf_rn(wv.x, hi, acc[j + 0]);
      acc[j + 1] = __fmaf_rn(wv.y, hi, acc[j + 1]);
      acc[j + 2] = __fmaf_rn(wv.z, hi, acc[j + 2]);
      acc[j + 3] = __fmaf_rn(wv.w, hi, acc[j + 3]);
    }
  }
}

// hidden layer: ReLU(round(w^T h)) into another shared-memory column
template <int IN, int OUTP, bool BF16>
__device__ __forceinline__ void hidden(const float* __restrict__ w,
                                       const float* __restrict__ h,
                                       float* __restrict__ out, int stride) {
  float acc[OUTP];
  accumulate<IN, OUTP, BF16>(w, h, stride, acc);
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
  accumulate<IN, OUTP, BF16>(w, h, stride, acc);
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

// [c/bound, sin(2^k pi c/bound) k<8, cos(2^k pi c/bound) k<8] per axis, by
// the double-angle ladder (field_kernel.py:97-112), into a column.
template <bool BF16>
__device__ __forceinline__ void encode(float x0, float x1, float x2,
                                       float bound, float* __restrict__ enc,
                                       int stride) {
  const float c[3] = {x0, x1, x2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float cn = c[a] / bound;
    float s = sinf(kPi * cn);
    float co = cosf(kPi * cn);
    enc[(17 * a) * stride] = rnd<BF16>(cn);
    enc[(17 * a + 1) * stride] = rnd<BF16>(s);
    enc[(17 * a + 9) * stride] = rnd<BF16>(co);
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float s2 = 2.0f * s * co;
      const float c2 = co * co - s * s;
      s = s2;
      co = c2;
      enc[(17 * a + 1 + k) * stride] = rnd<BF16>(s);
      enc[(17 * a + 9 + k) * stride] = rnd<BF16>(co);
    }
  }
}

// Shared memory a block needs: the weights plus two 64-wide activation
// columns per thread.
__host__ __device__ constexpr size_t mlp_smem_bytes(int threads) {
  return kWBytes + 2 * (size_t)kWd * threads * sizeof(float);
}

// Field at one point: sigma (f32, before density scale) and rgb.
// `sh` holds the point's direction encoding from sh4<BF16>; `buf` is the
// block's activation area (2 * 64 * blockDim.x floats).
template <bool BF16>
__device__ __forceinline__ void field_point(const float* __restrict__ sw,
                                            float* __restrict__ buf,
                                            float x0, float x1, float x2,
                                            float bound, const float (&sh)[16],
                                            float& sigma, float& r, float& g,
                                            float& b) {
  const int stride = blockDim.x;
  float* A = buf + threadIdx.x;
  float* B = buf + kWd * stride + threadIdx.x;
  encode<BF16>(x0, x1, x2, bound, A, stride);
  hidden<kEnc, 64, BF16>(sw + kS0, A, B, stride);
  hidden<64, 64, BF16>(sw + kS1, B, A, stride);
  hidden<64, 64, BF16>(sw + kS2, A, B, stride);
  float h4[16];
  last<64, 16, 16, BF16>(sw + kS3, B, stride, h4);
  sigma = expf(fminf(fmaxf(h4[0], -15.f), 15.f));

#pragma unroll
  for (int i = 0; i < 16; ++i) A[i * stride] = sh[i];
#pragma unroll
  for (int i = 0; i < 15; ++i) A[(16 + i) * stride] = h4[1 + i];
  hidden<31, 64, BF16>(sw + kC0, A, B, stride);
  hidden<64, 64, BF16>(sw + kC1, B, A, stride);
  float c3[3];
  last<64, 4, 3, BF16>(sw + kC2, A, stride, c3);
  r = 1.f / (1.f + expf(-c3[0]));
  g = 1.f / (1.f + expf(-c3[1]));
  b = 1.f / (1.f + expf(-c3[2]));
}

}  // namespace pienerf
