// The fused tile kernel's block_tiles instantiations (tile_kernel.cuh,
// MULTI): both widths, f32 and bf16, the three frame modes, `block_tiles`
// consecutive tiles per thread block. A translation unit of its own, so
// that its nvcc runs beside tile_kernel.cu's.

#include "tile_kernel.cuh"

namespace pienerf {

// [wide][bf16][mode]: deformed, static, cut
constexpr LaunchFn kLaunchBlock[2][2][3] = {
    {{launch<false, true, false, false, true, Net64>,
      launch<false, false, false, false, true, Net64>,
      launch<false, true, true, false, true, Net64>},
     {launch<true, true, false, false, true, Net64>,
      launch<true, false, false, false, true, Net64>,
      launch<true, true, true, false, true, Net64>}},
    {{launch<false, true, false, false, true, Net128>,
      launch<false, false, false, false, true, Net128>,
      launch<false, true, true, false, true, Net128>},
     {launch<true, true, false, false, true, Net128>,
      launch<true, false, false, false, true, Net128>,
      launch<true, true, true, false, true, Net128>}}};
constexpr OccupancyFn kOccupancyBlock[2][2][3] = {
    {{occupancy<false, true, false, false, true, Net64>,
      occupancy<false, false, false, false, true, Net64>,
      occupancy<false, true, true, false, true, Net64>},
     {occupancy<true, true, false, false, true, Net64>,
      occupancy<true, false, false, false, true, Net64>,
      occupancy<true, true, true, false, true, Net64>}},
    {{occupancy<false, true, false, false, true, Net128>,
      occupancy<false, false, false, false, true, Net128>,
      occupancy<false, true, true, false, true, Net128>},
     {occupancy<true, true, false, false, true, Net128>,
      occupancy<true, false, false, false, true, Net128>,
      occupancy<true, true, true, false, true, Net128>}}};

}  // namespace pienerf

// `cut` applies only with `deformed`, as in the Pallas kernel: deformed=0
// selects the static march whatever `cut` is. `wd` is the pack's width: 64
// or 128 (the two shipped nets). A is a multiple of block_tiles or the
// last block renders fewer tiles.
extern "C" int pienerf_render_tiles_block(const void* tile_sc, const void* bin_start,
                                    const void* params, const void* dirs,
                                    const void* cand, const void* pw,
                                    void* out, int A, int block_tiles, int BS,
                                    int P, int K, int Ks, int Ksb, int Wn,
                                    int num_seek, float bound, int bf16,
                                    int deformed, int cut, int wd,
                                    void* stream) {
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  cudaError_t err = pienerf::kLaunchBlock[wd == 128][bf16 ? 1 : 0][mode](
      static_cast<const float*>(tile_sc), static_cast<const int*>(bin_start),
      static_cast<const float*>(params), static_cast<const float*>(dirs),
      static_cast<const float*>(cand), static_cast<const float*>(pw),
      static_cast<float*>(out), A, block_tiles, BS, P, K, Ks, Ksb, Wn,
      num_seek, bound, nullptr, static_cast<cudaStream_t>(stream));
  return (int)err;
}

// The resident blocks per SM of one instantiation and the dynamic shared
// memory its launch asks for at window Wn (both written; nothing runs).
extern "C" int pienerf_render_tiles_block_occupancy(int bf16, int deformed,
                                                    int cut, int wd, int Wn,
                                                    int* blocks,
                                                    int* smem_bytes) {
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  return (int)pienerf::kOccupancyBlock[wd == 128][bf16 ? 1 : 0][mode](
      Wn, blocks, smem_bytes);
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
