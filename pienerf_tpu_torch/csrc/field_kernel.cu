// Fused radiance-field evaluation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pienerf_tpu/ops/pallas/field_kernel.py
// `_make_kernel` (launched by `_field_eval` / `field_eval`, :178-222) at
// both kernel widths: per point, Fourier features -> sigma MLP ->
// trunc-exp, SH4(d) || geo -> color MLP -> sigmoid; out [4, N] = (sigma,
// r, g, b).
//
// What bounds it on this card: operations. 18,752 MACs (Wd 64) or 63,616
// (Wd 128) per point against 40 B of I/O (x, d in; sigma, rgb out), about
// 940 or 3,200 FLOP per byte, far above the H100's ~20 FLOP/B f32 ridge.
// This version runs the MACs as f32 FMAs on the CUDA cores (67 TFLOP/s
// peak); bf16 compute is emulated by rounding, not run on the tensor cores.
//
// Design: every intermediate activation stays on chip (registers and
// shared memory); nothing but x, d and the 16 B result touches device
// memory. The grid is sized to the resident blocks of the card and walks
// the points in a grid-stride loop; a ragged N is masked in the loop.
//   Wd 64: one thread per point; the 75 KB of weights are staged once per
//     resident block and broadcast to the warp (see field_mlp.cuh).
//   Wd 128: 128 points per pass of the 256-thread block, two threads per
//     point, one layer's weights staged at a time (field_points_wide); the
//     owner threads (the first 128) load the points and store the results.

#include "field_mlp.cuh"

namespace pienerf {

constexpr int kFieldThreads = 256;

template <bool BF16>
__global__ void __launch_bounds__(kFieldThreads)
field_eval_kernel(const float* __restrict__ x, const float* __restrict__ d,
                  const float* __restrict__ pw, float* __restrict__ out,
                  int n, float bound) {
  using N = Net64;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* buf = sw + N::wfloats();
  stage_weights<BF16, N>(sw, pw);
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float sh[16];
    sh4<BF16>(d[i], d[n + i], d[2 * n + i], sh);
    float sigma, r, g, b;
    field_point<BF16>(sw, buf, x[i], x[n + i], x[2 * n + i], bound, sh,
                      sigma, r, g, b);
    out[i] = sigma;
    out[n + i] = r;
    out[2 * n + i] = g;
    out[3 * n + i] = b;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kFieldThreads)
field_eval_wide_kernel(const float* __restrict__ x,
                       const float* __restrict__ d,
                       const float* __restrict__ pw, float* __restrict__ out,
                       int n, float bound) {
  using N = Net128;
  constexpr int S = kWidePoints;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* A = sw + N::kWd * N::kWd;
  float* B = A + N::kWd * S;
  const bool owner = threadIdx.x < S;
  const int n_pass = (n + S - 1) / S;
  // block-uniform loop: field_points_wide synchronises the block
  for (int c = blockIdx.x; c < n_pass; c += gridDim.x) {
    const int i = c * S + (threadIdx.x & (S - 1));
    const bool live = owner && i < n;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 1.f;
    if (live) {
      x0 = x[i];
      x1 = x[n + i];
      x2 = x[2 * n + i];
      d0 = d[i];
      d1 = d[n + i];
      d2 = d[2 * n + i];
    }
    float sh[16];
    sh4<BF16>(d0, d1, d2, sh);
    float sigma = 0.f, r = 0.f, g = 0.f, b = 0.f;
    field_points_wide<BF16, N>(sw, A, B, pw, owner, x0, x1, x2, bound, sh,
                               sigma, r, g, b);
    if (live) {
      out[i] = sigma;
      out[n + i] = r;
      out[2 * n + i] = g;
      out[3 * n + i] = b;
    }
  }
}

template <bool BF16, bool WIDE>
cudaError_t launch(const float* x, const float* d, const float* pw,
                   float* out, int n, float bound, int n_sm,
                   cudaStream_t stream) {
  auto kern = WIDE ? field_eval_wide_kernel<BF16> : field_eval_kernel<BF16>;
  const size_t smem = WIDE ? mlp_smem_bytes<Net128>(kFieldThreads)
                           : mlp_smem_bytes<Net64>(kFieldThreads);
  // points one block covers per pass of its loop
  const int per_block = WIDE ? kWidePoints : kFieldThreads;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kFieldThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long need = ((long long)n + per_block - 1) / per_block;
  long long grid = (long long)per_sm * n_sm;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;
  kern<<<(int)grid, kFieldThreads, smem, stream>>>(x, d, pw, out, n, bound);
  return cudaGetLastError();
}

}  // namespace pienerf

// `wd` is the pack's width: 64 or 128 (the two shipped nets).
extern "C" int pienerf_field_eval(const void* x, const void* d,
                                  const void* pw, void* out, int n,
                                  float bound, int bf16, int wd, int n_sm,
                                  void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(d);
  const float* wf = static_cast<const float*>(pw);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (wd == 128) {
    err = bf16 ? pienerf::launch<true, true>(xf, df, wf, of, n, bound, n_sm, s)
               : pienerf::launch<false, true>(xf, df, wf, of, n, bound, n_sm,
                                              s);
  } else {
    err = bf16 ? pienerf::launch<true, false>(xf, df, wf, of, n, bound, n_sm,
                                              s)
               : pienerf::launch<false, false>(xf, df, wf, of, n, bound,
                                               n_sm, s);
  }
  return (int)err;
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
