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
// 940 or 3,200 FLOP per byte, far above the H100's ridge in either type.
// f32 runs the MACs as FMAs on the CUDA cores (67 TFLOP/s peak); bf16 runs
// them on the tensor cores (989 TFLOP/s, mma_mlp.cuh).
//
// Design: every intermediate activation stays on chip (registers and
// shared memory); nothing but x, d and the 16 B result touches device
// memory. The grid is sized to the resident blocks of the card and walks
// the points in a grid-stride loop; a ragged N is masked in the loop.
//   f32, either width (field_eval_f32_kernel, field_f32.cuh): the block's
//     512 threads evaluate 512 (Wd 64) or 256 (Wd 128) points a pass, one
//     layer at a time as a register-blocked SGEMM on the CUDA cores (a
//     thread owns 64 outputs of a hidden layer: 4 points x 16, or 8 x 8);
//     the activations sit in shared memory as [feature][point], each layer
//     overwriting its input. Net64's weights stay resident; Net128's stream
//     through a cp.async double buffer. Every output is the FMA chain of
//     field_mlp.cuh's f32 path, bit for bit.
//   bf16, either width (field_eval_mma_kernel): every layer's bf16 weights
//     staged once per block; each warp takes 32 consecutive points a pass,
//     one a lane, through mma_field. The loop runs over whole warps, so the
//     MMAs of the ragged tail's warp run converged on padding points; only
//     the loads and stores are masked.

#include <type_traits>

#include "field_f32.cuh"

namespace pienerf {

constexpr int kFieldThreads = 256;     // the bf16 kernel's block

template <class N>
__global__ void __launch_bounds__(kF32Threads, 1)
field_eval_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ d,
                      const float* __restrict__ pw, float* __restrict__ out,
                      int n, float bound) {
  constexpr int P = f32_points<N>();
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  // block-uniform loop: every pass synchronises the block
  if constexpr (N::kWd == 64) {
    float* A = s + N::wfloats();
    F32Resident<N> w{s};
    stage_weights<N>(s, pw);
    __syncthreads();
    for (int base = blockIdx.x * P; base < n; base += gridDim.x * P) {
      f32_pass<N>(w, A, x, d, out, n, base, bound);
    }
  } else {
    float* A = s + 2 * kChunkFloats;
    F32Streamed<N> w{pw, s, 0};
    w.first();
    for (int base = blockIdx.x * P; base < n; base += gridDim.x * P) {
      f32_pass<N>(w, A, x, d, out, n, base, bound);
    }
    w.last();
  }
}

template <class N>
__global__ void __launch_bounds__(kFieldThreads)
field_eval_mma_kernel(const float* __restrict__ x,
                      const float* __restrict__ d,
                      const float* __restrict__ pw, float* __restrict__ out,
                      int n, float bound) {
  extern __shared__ float4 smem4[];
  uint2* sw = reinterpret_cast<uint2*>(smem4);
  uint32_t* tile = reinterpret_cast<uint32_t*>(
      reinterpret_cast<char*>(smem4) + N::frag_bytes() +
      (threadIdx.x >> 5) * kWarpTileBytes);
  stage_mma_weights<N>(sw, pw);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  uint32_t* row = tile + lane * kTileWords;
  // warp-uniform loop over whole warps of points
  for (int base = (blockIdx.x * warps + (threadIdx.x >> 5)) * 32; base < n;
       base += gridDim.x * warps * 32) {
    const int i = base + lane;
    const bool live = i < n;
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
    sh4<true>(d0, d1, d2, sh);
    mma_stage_sh(row, sh);
    float sigma, r, g, b;
    mma_field<N>(sw, tile, x0, x1, x2, bound, sigma, r, g, b);
    if (live) {
      out[i] = sigma;
      out[n + i] = r;
      out[2 * n + i] = g;
      out[3 * n + i] = b;
    }
  }
}

// One instantiation's resident blocks per SM at the dynamic shared memory
// its launch asks for (both written; nothing runs).
template <bool BF16, bool WIDE>
cudaError_t occupancy(int* resident, int* smem_bytes) {
  using N = typename std::conditional<WIDE, Net128, Net64>::type;
  auto kern = BF16 ? field_eval_mma_kernel<N> : field_eval_f32_kernel<N>;
  const size_t smem =
      BF16 ? mma_smem_bytes<N>(kFieldThreads) : f32_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, kern, BF16 ? kFieldThreads : kF32Threads, smem);
}

template <bool BF16, bool WIDE>
cudaError_t launch(const float* x, const float* d, const float* pw,
                   float* out, int n, float bound, int n_sm,
                   cudaStream_t stream) {
  using N = typename std::conditional<WIDE, Net128, Net64>::type;
  auto kern = BF16 ? field_eval_mma_kernel<N> : field_eval_f32_kernel<N>;
  // points one block covers per pass of its loop
  const int per_block = BF16 ? kFieldThreads : f32_points<N>();
  int per_sm = 0, smem = 0;
  cudaError_t err = occupancy<BF16, WIDE>(&per_sm, &smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long need = ((long long)n + per_block - 1) / per_block;
  long long grid = (long long)per_sm * n_sm;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;
  const int threads = BF16 ? kFieldThreads : kF32Threads;
  kern<<<(int)grid, threads, smem, stream>>>(x, d, pw, out, n, bound);
  return cudaGetLastError();
}

using FieldLaunchFn = cudaError_t (*)(const float*, const float*,
                                      const float*, float*, int, float, int,
                                      cudaStream_t);
using FieldOccupancyFn = cudaError_t (*)(int*, int*);
// [wide][bf16]
constexpr FieldLaunchFn kFieldLaunch[2][2] = {
    {launch<false, false>, launch<true, false>},
    {launch<false, true>, launch<true, true>}};
constexpr FieldOccupancyFn kFieldOccupancy[2][2] = {
    {occupancy<false, false>, occupancy<true, false>},
    {occupancy<false, true>, occupancy<true, true>}};

}  // namespace pienerf

// `wd` is the pack's width: 64 or 128 (the two shipped nets).
extern "C" int pienerf_field_eval(const void* x, const void* d,
                                  const void* pw, void* out, int n,
                                  float bound, int bf16, int wd, int n_sm,
                                  void* stream) {
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  return (int)pienerf::kFieldLaunch[wd == 128][bf16 ? 1 : 0](
      static_cast<const float*>(x), static_cast<const float*>(d),
      static_cast<const float*>(pw), static_cast<float*>(out), n, bound,
      n_sm, static_cast<cudaStream_t>(stream));
}

// The resident blocks per SM of one instantiation at its launch's dynamic
// shared memory (both written; nothing is launched).
extern "C" int pienerf_field_occupancy(int bf16, int wd, int* blocks,
                                       int* smem_bytes) {
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  return (int)pienerf::kFieldOccupancy[wd == 128][bf16 ? 1 : 0](blocks,
                                                                smem_bytes);
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
