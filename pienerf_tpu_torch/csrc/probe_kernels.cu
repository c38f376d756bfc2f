// Probe kernels for Hopper (sm_90a): four ways to fetch table rows by
// index, and the tile kernel's empty shell. They measure mechanisms; no
// frame path runs them.
//
// The fetches replace the four Pallas TPU probes of
// tools/pallas_gather_probe.py (`onehot_fetch` :83, `dma_fetch` :127,
// `vmem_take_fetch` :187, `dynslice_fetch` :217). All compute
//   out[b, :] = table[idx[b], :],  table [T, 128] f32, idx [B] i32,
// exactly (an index outside [0, T) gives a row of zeros). Each is the
// mechanism of this card that answers the question its TPU twin asked:
//   onehot   a block of 512 indices streams the whole table through shared
//            memory in chunks and accumulates (idx[b] == row) * table[row]
//            with f32 FMAs: the exact one-hot product (the reference's
//            Precision.HIGHEST point; no tensor-core truncation). Bound by
//            operations: T x 128 MACs per fetched row.
//   dma      per-row asynchronous copies device memory -> shared memory,
//            8 in flight in a ring per block, then out. The copies are
//            `cp.async` (16 bytes per lane, one warp per 512-byte row, one
//            commit group per row, wait_prior(7)), not the bulk tensor
//            copy with an mbarrier: a lane reads back the 16 bytes it
//            copied itself, so no barrier is needed, and a fault cannot
//            leave a thread spinning on a barrier phase. Bound by bytes.
//   take     the card's native data-parallel gather: one warp per row, each
//            lane one coalesced 16-byte load and store. Bound by bytes.
//   dynslice one thread per block of 512 indices copies its rows one after
//            the other: the per-access latency floor.
// The TPU probes kept the two small tables (1 MB, 4 MB) resident in VMEM.
// A block here has 227 KB of shared memory, so no table is resident on
// chip in that sense: the small ones sit in the 50 MB L2, the 2^19-row one
// (256 MB) in device memory.
//
// The shell replaces tools/micro_floor.py `build_arm` (:56): the tile
// kernel's block shapes with no work, to price what a launch pays before
// any sample runs. One block handles `block_tiles` tiles; per tile it
// loads tile_sc [8], bin_start [BS] (i32 or i16), dirs [8, 256] and cand
// [P, 16] into shared memory, zeroes out[a] [8, 256] and adds 1 to row 0
// of an active tile. An arm leaves an input out by passing a null pointer.
// Bound by bytes: every input read once, the output written once.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pienerf {

constexpr int kRow = 128;          // floats per table row (512 bytes)
constexpr int kFetchBlock = 512;   // indices per block (onehot, dma, dynslice)
constexpr int kDepth = 8;          // dma: copies in flight per block

// ---- onehot -------------------------------------------------------------
constexpr int kOhCols = 32;        // columns a thread accumulates per pass
constexpr int kOhRows = 256;       // table rows per shared-memory chunk

__global__ void __launch_bounds__(kFetchBlock)
onehot_fetch_kernel(const float* __restrict__ table,
                    const int* __restrict__ idx, float* __restrict__ out,
                    int T) {
  extern __shared__ float4 smem4[];     // [kOhRows * kOhCols / 4]
  float4* chunk4 = smem4;
  float* chunk = reinterpret_cast<float*>(chunk4);
  const int t = threadIdx.x;
  const int b = blockIdx.x * kFetchBlock + t;
  const int row_b = idx[b];
  // four passes over the table, 32 of the 128 columns each: 32 f32
  // accumulators a thread, at 512 threads a block
  for (int c0 = 0; c0 < kRow; c0 += kOhCols) {
    float acc[kOhCols];
#pragma unroll
    for (int j = 0; j < kOhCols; ++j) acc[j] = 0.f;
    for (int r0 = 0; r0 < T; r0 += kOhRows) {
      __syncthreads();                 // the previous chunk's readers
      for (int e = t; e < kOhRows * kOhCols / 4; e += kFetchBlock) {
        const int rr = e / (kOhCols / 4);
        const int q = e - rr * (kOhCols / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + rr < T) {
          v = *reinterpret_cast<const float4*>(
              table + (size_t)(r0 + rr) * kRow + c0 + 4 * q);
        }
        chunk4[e] = v;
      }
      __syncthreads();
      for (int rr = 0; rr < kOhRows; ++rr) {
        const float m = (row_b == r0 + rr) ? 1.f : 0.f;
#pragma unroll
        for (int j = 0; j < kOhCols; j += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(chunk + rr * kOhCols + j);
          acc[j + 0] = __fmaf_rn(m, v.x, acc[j + 0]);
          acc[j + 1] = __fmaf_rn(m, v.y, acc[j + 1]);
          acc[j + 2] = __fmaf_rn(m, v.z, acc[j + 2]);
          acc[j + 3] = __fmaf_rn(m, v.w, acc[j + 3]);
        }
      }
    }
    float* o = out + (size_t)b * kRow + c0;
#pragma unroll
    for (int j = 0; j < kOhCols; j += 4) {
      *reinterpret_cast<float4*>(o + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    }
  }
}

// ---- dma ----------------------------------------------------------------
// One warp per block. Lane l owns bytes [16 l, 16 l + 16) of every slot.
__global__ void __launch_bounds__(32)
dma_fetch_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                 float* __restrict__ out, int T) {
  extern __shared__ float4 smem4[];     // the ring: [kDepth][kRow / 4]
  float4 (*ring)[kRow / 4] = reinterpret_cast<float4 (*)[kRow / 4]>(smem4);
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * kFetchBlock;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // start the copy of row idx[b0 + i] into `slot`; always one commit group
  auto start = [&](int slot, int i) {
    const int row = idx[b0 + i];
    if ((unsigned)row < (unsigned)T) {
      __pipeline_memcpy_async(
          &ring[slot][lane],
          reinterpret_cast<const float4*>(table + (size_t)row * kRow) + lane,
          sizeof(float4));
    } else {
      ring[slot][lane] = zero;
    }
    __pipeline_commit();
  };

  for (int s = 0; s < kDepth; ++s) start(s, s);      // fill the ring
  for (int i = 0; i < kFetchBlock; ++i) {
    const int slot = i % kDepth;
    __pipeline_wait_prior(kDepth - 1);               // copy i has landed
    reinterpret_cast<float4*>(out + (size_t)(b0 + i) * kRow)[lane] =
        ring[slot][lane];
    if (i + kDepth < kFetchBlock) {
      start(slot, i + kDepth);
    } else {
      __pipeline_commit();       // keep one group per step for wait_prior
    }
  }
}

// ---- take ---------------------------------------------------------------
constexpr int kTakeBlock = 256;    // 8 warps, one row each per step

__global__ void __launch_bounds__(kTakeBlock)
take_fetch_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  float* __restrict__ out, int T, int B) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kTakeBlock + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * kTakeBlock) >> 5;
#pragma unroll 4
  for (int b = warp; b < B; b += n_warps) {
    const int row = idx[b];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((unsigned)row < (unsigned)T) {
      v = reinterpret_cast<const float4*>(table + (size_t)row * kRow)[lane];
    }
    reinterpret_cast<float4*>(out + (size_t)b * kRow)[lane] = v;
  }
}

// ---- dynslice -----------------------------------------------------------
__global__ void __launch_bounds__(1)
dynslice_fetch_kernel(const float* __restrict__ table,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int T) {
  const int b0 = blockIdx.x * kFetchBlock;
  for (int i = 0; i < kFetchBlock; ++i) {
    const int row = idx[b0 + i];
    const bool ok = (unsigned)row < (unsigned)T;
    const float4* src =
        reinterpret_cast<const float4*>(table + (size_t)(ok ? row : 0) * kRow);
    float4* dst = reinterpret_cast<float4*>(out + (size_t)(b0 + i) * kRow);
    for (int q = 0; q < kRow / 4; ++q) {
      dst[q] = ok ? src[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ---- the tile kernel's shell ---------------------------------------------
constexpr int kT2 = 256;           // rays per tile, threads per block

// The loads must really happen, though nothing is computed from them: each
// input is staged to shared memory by all threads, and after a barrier
// every thread reads back an element that another thread staged and folds
// it into `keep`. `keep` feeds a store under a condition that never holds
// at run time (it compares against `never`, a launch argument the wrapper
// sets to NaN, which equals nothing) but that the compiler cannot decide,
// so it can drop neither the loads nor the staging.
template <class BinT>
__global__ void __launch_bounds__(kT2)
floor_shell_kernel(const float* __restrict__ tile_sc,
                   const BinT* __restrict__ bin_start,
                   const float* __restrict__ dirs,
                   const float* __restrict__ cand, float* __restrict__ out,
                   int A, int B, int BS, int P, float never) {
  extern __shared__ float4 smem4[];
  float* s_dirs = reinterpret_cast<float*>(smem4);            // [8 * 256]
  float* s_cand = s_dirs + 8 * kT2;                           // [P * 16]
  float* s_sc = s_cand + (size_t)P * 16;                      // [8]
  BinT* s_bs = reinterpret_cast<BinT*>(s_sc + 8);             // [BS]
  const int r = threadIdx.x;
  for (int b = 0; b < B; ++b) {
    const int a = blockIdx.x * B + b;
    if (a >= A) break;
    __syncthreads();                   // the previous tile's readers
    if (r < 8) s_sc[r] = tile_sc[(size_t)a * 8 + r];
    if (bin_start != nullptr) {
      for (int e = r; e < BS; e += kT2) s_bs[e] = bin_start[(size_t)a * BS + e];
    }
    if (dirs != nullptr) {
      const float4* src = reinterpret_cast<const float4*>(
          dirs + (size_t)a * 8 * kT2);
      for (int e = r; e < 8 * kT2 / 4; e += kT2) smem4[e] = src[e];
    }
    if (cand != nullptr) {
      const float4* src = reinterpret_cast<const float4*>(
          cand + (size_t)a * P * 16);
      float4* dst = reinterpret_cast<float4*>(s_cand);
      for (int e = r; e < P * 4; e += kT2) dst[e] = src[e];
    }
    __syncthreads();
    float keep = s_sc[(r + 1) & 7];
    if (bin_start != nullptr) keep += (float)s_bs[(r + 1) % BS];
    if (dirs != nullptr) {
      for (int e = r + 1; e < 8 * kT2 + r + 1; e += kT2) {
        keep += s_dirs[e % (8 * kT2)];
      }
    }
    if (cand != nullptr) {
      for (int e = r + 1; e < P * 16 + r + 1; e += kT2) {
        keep += s_cand[e % (P * 16)];
      }
    }
    float* o_t = out + (size_t)a * 8 * kT2;
    const bool active = s_sc[2] > 0.f;
    for (int row = 0; row < 8; ++row) o_t[row * kT2 + r] = 0.f;
    if (active) o_t[r] += 1.0f;
    if (keep == never) o_t[7 * kT2 + r] = keep;
  }
}

template <class BinT>
cudaError_t launch_shell(const float* tile_sc, const void* bin_start,
                         const float* dirs, const float* cand, float* out,
                         int A, int B, int BS, int P, float never,
                         cudaStream_t stream) {
  auto kern = floor_shell_kernel<BinT>;
  const size_t smem = (8 * kT2 + (size_t)P * 16 + 8) * sizeof(float) +
                      (size_t)BS * sizeof(BinT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<(A + B - 1) / B, kT2, smem, stream>>>(
      tile_sc, static_cast<const BinT*>(bin_start), dirs, cand, out, A, B, BS,
      P, never);
  return cudaGetLastError();
}

}  // namespace pienerf

// which: 0 onehot, 1 dma, 2 take, 3 dynslice. B must be a multiple of 512
// for all but take. `n_sm` sizes take's grid.
extern "C" int pienerf_fetch(int which, const void* table, const void* idx,
                             void* out, int T, int B, int n_sm,
                             void* stream) {
  using namespace pienerf;
  const float* tab = static_cast<const float*>(table);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (which != 2 && B % kFetchBlock != 0) return (int)cudaErrorInvalidValue;
  const int grid = B / kFetchBlock;
  if (which == 0) {
    const size_t smem = kOhRows * kOhCols * sizeof(float);
    onehot_fetch_kernel<<<grid, kFetchBlock, smem, s>>>(tab, ix, o, T);
  } else if (which == 1) {
    const size_t smem = kDepth * kRow * sizeof(float);
    dma_fetch_kernel<<<grid, 32, smem, s>>>(tab, ix, o, T);
  } else if (which == 2) {
    const int warps_per_block = kTakeBlock / 32;
    int g = (B + warps_per_block - 1) / warps_per_block;
    if (g > n_sm * 8) g = n_sm * 8;
    if (g < 1) g = 1;
    take_fetch_kernel<<<g, kTakeBlock, 0, s>>>(tab, ix, o, T, B);
  } else if (which == 3) {
    dynslice_fetch_kernel<<<grid, 1, 0, s>>>(tab, ix, o, T);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// A null bin_start, dirs or cand leaves that input out; bs_int16 says that
// bin_start holds 16-bit counts.
extern "C" int pienerf_floor_shell(const void* tile_sc, const void* bin_start,
                                   const void* dirs, const void* cand,
                                   void* out, int A, int block_tiles, int BS,
                                   int P, int bs_int16, float never,
                                   void* stream) {
  using namespace pienerf;
  if (A <= 0 || block_tiles < 1 || BS < 1 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const float* sc = static_cast<const float*>(tile_sc);
  const float* d = static_cast<const float*>(dirs);
  const float* c = static_cast<const float*>(cand);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bs_int16 ? launch_shell<int16_t>(sc, bin_start, d, c, o, A, block_tiles,
                                       BS, P, never, s)
               : launch_shell<int>(sc, bin_start, d, c, o, A, block_tiles, BS,
                                   P, never, s);
  return (int)err;
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
