// The fused tile kernel's timed instantiations (tile_kernel.cuh, TIMED):
// the default schedule with each tile's clock cycles split by phase, f32 and
// bf16, the two bending modes, both widths. A translation unit of its own,
// so that its nvcc runs beside tile_kernel.cu's.

#include "tile_kernel.cuh"

namespace pienerf {

// [wide][bf16][cut]
constexpr LaunchFn kLaunchTimed[2][2][2] = {
    {{launch<false, true, false, false, false, Net64, true>,
      launch<false, true, true, false, false, Net64, true>},
     {launch<true, true, false, false, false, Net64, true>,
      launch<true, true, true, false, false, Net64, true>}},
    {{launch<false, true, false, false, false, Net128, true>,
      launch<false, true, true, false, false, Net128, true>},
     {launch<true, true, false, false, false, Net128, true>,
      launch<true, true, true, false, false, Net128, true>}}};
constexpr OccupancyFn kOccupancyTimed[2][2][2] = {
    {{occupancy<false, true, false, false, false, Net64, true>,
      occupancy<false, true, true, false, false, Net64, true>},
     {occupancy<true, true, false, false, false, Net64, true>,
      occupancy<true, true, true, false, false, Net64, true>}},
    {{occupancy<false, true, false, false, false, Net128, true>,
      occupancy<false, true, true, false, false, Net128, true>},
     {occupancy<true, true, false, false, false, Net128, true>,
      occupancy<true, true, true, false, false, Net128, true>}}};

}  // namespace pienerf

// The timed kernel: pienerf_render_tiles's arguments, and `cyc` the int64
// split [A, 8 warps, kSplit] (tile_kernel.cuh, PhaseClock: cycles by
// phase, the f32 path's evaluated points and passes); a bending mode
// only. Its out equals pienerf_render_tiles's bit for bit.
extern "C" int pienerf_render_tiles_timed(
    const void* tile_sc, const void* bin_start, const void* params,
    const void* dirs, const void* cand, const void* pw, void* out, int A,
    int block_tiles, int BS, int P, int K, int Ks, int Ksb, int Wn,
    int num_seek, float bound, int bf16, int deformed, int cut, int wd,
    void* cyc, void* stream) {
  if ((wd != 64 && wd != 128) || !deformed)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      pienerf::kLaunchTimed[wd == 128][bf16 ? 1 : 0][cut ? 1 : 0](
      static_cast<const float*>(tile_sc), static_cast<const int*>(bin_start),
      static_cast<const float*>(params), static_cast<const float*>(dirs),
      static_cast<const float*>(cand), static_cast<const float*>(pw),
      static_cast<float*>(out), A, block_tiles, BS, P, K, Ks, Ksb, Wn,
      num_seek, bound, static_cast<long long*>(cyc),
      static_cast<cudaStream_t>(stream));
  return (int)err;
}

// The same for a timed instantiation (deformed or cut).
extern "C" int pienerf_render_tiles_timed_occupancy(int bf16, int cut, int wd,
                                                    int Wn, int* blocks,
                                                    int* smem_bytes) {
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  return (int)pienerf::kOccupancyTimed[wd == 128][bf16 ? 1 : 0][cut ? 1 : 0](
      Wn, blocks, smem_bytes);
}

// The columns of a tile's record in `cyc`: the phases' cycles, the total,
// the start and end, the points evaluated and the passes run.
extern "C" int pienerf_render_tiles_split_cols() { return pienerf::kSplit; }

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
