// The fused tile kernel's default-schedule instantiations: both widths,
// f32 and bf16, the three frame modes, one tile per thread block
// (tile_kernel.cuh has the kernel and its notes; the timed ones are
// tile_kernel_timed.cu's).

#include "tile_kernel.cuh"

namespace pienerf {

// [wide][bf16][mode]: deformed, static, cut
constexpr LaunchFn kLaunch[2][2][3] = {
    {{launch<false, true, false, false, false, Net64>,
      launch<false, false, false, false, false, Net64>,
      launch<false, true, true, false, false, Net64>},
     {launch<true, true, false, false, false, Net64>,
      launch<true, false, false, false, false, Net64>,
      launch<true, true, true, false, false, Net64>}},
    {{launch<false, true, false, false, false, Net128>,
      launch<false, false, false, false, false, Net128>,
      launch<false, true, true, false, false, Net128>},
     {launch<true, true, false, false, false, Net128>,
      launch<true, false, false, false, false, Net128>,
      launch<true, true, true, false, false, Net128>}}};
constexpr OccupancyFn kOccupancy[2][2][3] = {
    {{occupancy<false, true, false, false, false, Net64>,
      occupancy<false, false, false, false, false, Net64>,
      occupancy<false, true, true, false, false, Net64>},
     {occupancy<true, true, false, false, false, Net64>,
      occupancy<true, false, false, false, false, Net64>,
      occupancy<true, true, true, false, false, Net64>}},
    {{occupancy<false, true, false, false, false, Net128>,
      occupancy<false, false, false, false, false, Net128>,
      occupancy<false, true, true, false, false, Net128>},
     {occupancy<true, true, false, false, false, Net128>,
      occupancy<true, false, false, false, false, Net128>,
      occupancy<true, true, true, false, false, Net128>}}};
}  // namespace pienerf

// `cut` applies only with `deformed`, as in the Pallas kernel: deformed=0
// selects the static march whatever `cut` is. `wd` is the pack's width: 64
// or 128 (the two shipped nets). block_tiles must be 1 (more tiles per
// block: pienerf_render_tiles_block).
extern "C" int pienerf_render_tiles(const void* tile_sc, const void* bin_start,
                                    const void* params, const void* dirs,
                                    const void* cand, const void* pw,
                                    void* out, int A, int block_tiles, int BS,
                                    int P, int K, int Ks, int Ksb, int Wn,
                                    int num_seek, float bound, int bf16,
                                    int deformed, int cut, int wd,
                                    void* stream) {
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  cudaError_t err = pienerf::kLaunch[wd == 128][bf16 ? 1 : 0][mode](
      static_cast<const float*>(tile_sc), static_cast<const int*>(bin_start),
      static_cast<const float*>(params), static_cast<const float*>(dirs),
      static_cast<const float*>(cand), static_cast<const float*>(pw),
      static_cast<float*>(out), A, block_tiles, BS, P, K, Ks, Ksb, Wn,
      num_seek, bound, nullptr, static_cast<cudaStream_t>(stream));
  return (int)err;
}

// The resident blocks per SM of one instantiation and the dynamic shared
// memory its launch asks for at window Wn (both written; nothing runs).
extern "C" int pienerf_render_tiles_occupancy(int bf16, int deformed, int cut,
                                              int wd, int Wn, int* blocks,
                                              int* smem_bytes) {
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  return (int)pienerf::kOccupancy[wd == 128][bf16 ? 1 : 0][mode](
      Wn, blocks, smem_bytes);
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
