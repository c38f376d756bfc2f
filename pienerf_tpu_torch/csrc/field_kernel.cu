// Fused radiance-field evaluation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pienerf_tpu/ops/pallas/field_kernel.py
// `_make_kernel` (launched by `_field_eval` / `field_eval`, :178-222):
// per point, Fourier features -> sigma MLP -> trunc-exp, SH4(d) || geo ->
// color MLP -> sigmoid; out [4, N] = (sigma, r, g, b).
//
// What bounds it on this card: operations. 18,752 MACs (37.5 kFLOP) per
// point against 40 B of I/O (x, d in; sigma, rgb out), about 940 FLOP per
// byte, far above the H100's ~20 FLOP/B f32 ridge. This first version runs
// the MACs as f32 FMAs on the CUDA cores (67 TFLOP/s peak); bf16 compute is
// emulated by rounding, not run on the tensor cores.
//
// Design: one thread per point, so every intermediate activation stays on
// chip (registers and the thread's shared-memory columns) and nothing but
// x, d and the 16 B result touches device memory.
// The weights are staged once per block in shared memory and broadcast to
// the warp (see field_mlp.cuh). The grid is sized to the resident blocks of
// the card and walks the points in a grid-stride loop, so the 75 KB of
// weights are staged once per resident block rather than once per point
// tile. A ragged N is masked in the loop.

#include "field_mlp.cuh"

namespace pienerf {

constexpr int kFieldThreads = 256;
constexpr size_t kFieldSmem = mlp_smem_bytes(kFieldThreads);

template <bool BF16>
__global__ void __launch_bounds__(kFieldThreads)
field_eval_kernel(const float* __restrict__ x, const float* __restrict__ d,
                  const float* __restrict__ pw, float* __restrict__ out,
                  int n, float bound) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* buf = sw + kWFloats;
  stage_weights<BF16>(sw, pw);
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
cudaError_t launch(const float* x, const float* d, const float* pw,
                   float* out, int n, float bound, int n_sm,
                   cudaStream_t stream) {
  auto kern = field_eval_kernel<BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFieldSmem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kFieldThreads, kFieldSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long need = ((long long)n + kFieldThreads - 1) / kFieldThreads;
  long long grid = (long long)per_sm * n_sm;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;
  kern<<<(int)grid, kFieldThreads, kFieldSmem, stream>>>(x, d, pw, out, n,
                                                          bound);
  return cudaGetLastError();
}

}  // namespace pienerf

extern "C" int pienerf_field_eval(const void* x, const void* d,
                                  const void* pw, void* out, int n,
                                  float bound, int bf16, int n_sm,
                                  void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(d);
  const float* wf = static_cast<const float*>(pw);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? pienerf::launch<true>(xf, df, wf, of, n, bound,
                                                 n_sm, s)
                         : pienerf::launch<false>(xf, df, wf, of, n, bound,
                                                  n_sm, s);
  return (int)err;
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
