// The fused tile kernel's hash-grid instantiations (tile_kernel.cuh with
// grid_encode.cuh's GridNet64): torch-ngp's hash-grid field, f32, the
// default schedule, the three frame modes, one tile per thread block. A
// translation unit of its own, so that its nvcc runs beside the others'.

#include <cstring>

#include "tile_kernel.cuh"

namespace pienerf {

using GridLaunchFn = cudaError_t (*)(const float*, const int*, const float*,
                                     const float*, const float*, const float*,
                                     float*, int, int, int, int, int, int, int,
                                     int, float, const GridArgs&,
                                     cudaStream_t);

// [mode]: deformed, static, cut
constexpr GridLaunchFn kLaunchGrid[3] = {launch_grid<true, false>,
                                         launch_grid<false, false>,
                                         launch_grid<true, true>};
constexpr OccupancyFn kOccupancyGrid[3] = {occupancy_grid<true, false>,
                                           occupancy_grid<false, false>,
                                           occupancy_grid<true, true>};

}  // namespace pienerf

// pienerf_render_tiles's arguments for the hash-grid net packed [5, 64, 64]
// (no bf16, no width: the net is one), then the table [rows, 2] f32 on the
// device, `levels` the host's 65 32-bit words of GridLevels (16 scales as
// f32, 16 strides, 16 row counts, 16 first rows, the dense bit mask) and
// `counters` the device's 4 int64 sums (GridCounter) or null.
extern "C" int pienerf_render_tiles_grid(
    const void* tile_sc, const void* bin_start, const void* params,
    const void* dirs, const void* cand, const void* pw, void* out, int A,
    int block_tiles, int BS, int P, int K, int Ks, int Ksb, int Wn,
    int num_seek, float bound, int deformed, int cut, const void* table,
    const void* levels, void* counters, void* stream) {
  if (block_tiles != 1) return (int)cudaErrorInvalidValue;
  pienerf::GridArgs g;
  g.table = static_cast<const float2*>(table);
  std::memcpy(&g.lv, levels, sizeof(g.lv));
  g.ctr = static_cast<unsigned long long*>(counters);
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  cudaError_t err = pienerf::kLaunchGrid[mode](
      static_cast<const float*>(tile_sc), static_cast<const int*>(bin_start),
      static_cast<const float*>(params), static_cast<const float*>(dirs),
      static_cast<const float*>(cand), static_cast<const float*>(pw),
      static_cast<float*>(out), A, BS, P, K, Ks, Ksb, Wn, num_seek, bound, g,
      static_cast<cudaStream_t>(stream));
  return (int)err;
}

// The resident blocks per SM of one mode's instantiation and the dynamic
// shared memory its launch asks for at window Wn (both written; nothing
// runs).
extern "C" int pienerf_render_tiles_grid_occupancy(int deformed, int cut,
                                                   int Wn, int* blocks,
                                                   int* smem_bytes) {
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  return (int)pienerf::kOccupancyGrid[mode](Wn, blocks, smem_bytes);
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
