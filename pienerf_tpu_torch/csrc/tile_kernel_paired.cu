// The fused tile kernel's paired-schedule instantiations (tile_kernel.cuh,
// PAIRED): the 64-wide net read from the block-diagonal sigma || color pack
// [4, 128, 128] of kernels/field.py pack_weights_paired, f32 and bf16, the
// three frame modes, one or `block_tiles` tiles per thread block. A translation unit of its own, so that its nvcc runs
// beside tile_kernel.cu's.

#include "tile_kernel.cuh"

namespace pienerf {

// [block_tiles > 1][bf16][mode]: deformed, static, cut
constexpr LaunchFn kLaunchPaired[2][2][3] = {
    {{launch<false, true, false, true, false, Net64>,
      launch<false, false, false, true, false, Net64>,
      launch<false, true, true, true, false, Net64>},
     {launch<true, true, false, true, false, Net64>,
      launch<true, false, false, true, false, Net64>,
      launch<true, true, true, true, false, Net64>}},
    {{launch<false, true, false, true, true, Net64>,
      launch<false, false, false, true, true, Net64>,
      launch<false, true, true, true, true, Net64>},
     {launch<true, true, false, true, true, Net64>,
      launch<true, false, false, true, true, Net64>,
      launch<true, true, true, true, true, Net64>}}};
constexpr OccupancyFn kOccupancyPaired[2][2][3] = {
    {{occupancy<false, true, false, true, false, Net64>,
      occupancy<false, false, false, true, false, Net64>,
      occupancy<false, true, true, true, false, Net64>},
     {occupancy<true, true, false, true, false, Net64>,
      occupancy<true, false, false, true, false, Net64>,
      occupancy<true, true, true, true, false, Net64>}},
    {{occupancy<false, true, false, true, true, Net64>,
      occupancy<false, false, false, true, true, Net64>,
      occupancy<false, true, true, true, true, Net64>},
     {occupancy<true, true, false, true, true, Net64>,
      occupancy<true, false, false, true, true, Net64>,
      occupancy<true, true, true, true, true, Net64>}}};

}  // namespace pienerf

// Same arguments as pienerf_render_tiles; `pw` is the paired pack and `wd`
// the net's width, which must be 64.
extern "C" int pienerf_render_tiles_paired(
    const void* tile_sc, const void* bin_start, const void* params,
    const void* dirs, const void* cand, const void* pw, void* out, int A,
    int block_tiles, int BS, int P, int K, int Ks, int Ksb, int Wn,
    int num_seek, float bound, int bf16, int deformed, int cut, int wd,
    void* stream) {
  if (wd != 64) return (int)cudaErrorInvalidValue;
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  cudaError_t err = pienerf::kLaunchPaired[block_tiles > 1][bf16 ? 1 : 0][mode](
      static_cast<const float*>(tile_sc), static_cast<const int*>(bin_start),
      static_cast<const float*>(params), static_cast<const float*>(dirs),
      static_cast<const float*>(cand), static_cast<const float*>(pw),
      static_cast<float*>(out), A, block_tiles, BS, P, K, Ks, Ksb, Wn,
      num_seek, bound, nullptr, static_cast<cudaStream_t>(stream));
  return (int)err;
}

// The resident blocks per SM of one instantiation and the dynamic shared
// memory its launch asks for at window Wn (both written; nothing runs).
extern "C" int pienerf_render_tiles_paired_occupancy(int block_tiles, int bf16,
                                                     int deformed, int cut,
                                                     int wd, int Wn,
                                                     int* blocks,
                                                     int* smem_bytes) {
  if (wd != 64) return (int)cudaErrorInvalidValue;
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  return (int)pienerf::kOccupancyPaired[block_tiles > 1][bf16 ? 1 : 0][mode](
      Wn, blocks, smem_bytes);
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
