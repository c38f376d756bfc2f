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
//   onehot   the dense one-hot product on the tensor cores, as the TPU
//            probe runs it on its MXU at Precision.HIGHEST: out = A . table
//            with A[b][row] = (idx[b] == row), every row of the table
//            multiplied (mma.sync m16n8k16, bf16 in, f32 accumulators; see
//            the onehot section). Bound by operations: 3 x T x 128 MACs per
//            fetched row at the bf16 rate.
//   dma      per-row bulk copies device memory -> shared memory, the
//            counterpart of the TPU probe's one DMA descriptor a row
//            (pltpu.make_async_copy, one semaphore a slot, depth 8): one
//            lane issues each 512-byte row as one cp.async.bulk that
//            completes on its slot's mbarrier (csrc/bulk.cuh), in a ring of
//            kDepth = 8 slots per issuing warp. kDmaWarps = 16 warps a
//            block, each over its own 32 of the block's 512 rows, keep 128
//            rows (64 KB) in flight an SM. The warp waits on a slot's phase
//            and writes the row out with its own 16-byte stores. Bound by
//            bytes. The cp.async ring of one warp a block that it replaced
//            kept at most 1,024 rows in flight across the card, too few to
//            cover the latency, and lost to torch.index_select; PERF.md
//            holds the times of both designs on the card.
//   take     the card's native data-parallel gather: one warp per row, each
//            lane one coalesced 16-byte load and store. Bound by bytes.
//   dynslice the per-access latency floor: the TPU probe copies its 512
//            rows one after the other, each one [1, 128] dynamic slice, its
//            indices in SMEM. Here one warp a block of 512 indices stages
//            them in shared memory, then copies row after row, each one
//            warp-wide access (16 bytes a lane, 512 coalesced bytes), in a
//            loop that is neither unrolled nor spread over more warps: so
//            each row waits for the last, and the time is 512 latencies of
//            a data-dependent row access that nothing hides. Bound by bytes
//            all the same, far above it by design. It replaced one thread
//            a block copying 32 float4s a row, which timed one thread's
//            issue rate rather than the access latency; PERF.md holds the
//            times of both designs on the card.
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

#include "bulk.cuh"
#include "mma.cuh"

namespace pienerf {

constexpr int kRow = 128;          // floats per table row (512 bytes)
constexpr int kFetchBlock = 512;   // B is a multiple (dma, dynslice: a block)
constexpr int kRowBytes = kRow * 4;
constexpr int kDepth = 8;          // dma: slots a warp's ring

// ---- onehot -------------------------------------------------------------
// The table is split into three bf16 parts, x = hi + mid + lo: hi keeps the
// top 8 significant bits of x (its bf16 pattern, truncated, so FLT_MAX
// cannot round to inf), mid the next 8 of x - hi, lo the rest of x - hi -
// mid. Each difference is exact in f32, so the three carry x's 24-bit
// significand exactly for every finite x whose bits lie at or above 2^-133
// (every x with |x| >= 2^-110, and every smaller one on bf16's grid); bf16
// has no bits below. onehot_split_kernel writes them once per call, in
// B-fragment order. The fetch kernel multiplies the one-hot A, built in
// registers from each lane's indices (exact in bf16), by all three parts of
// every k16 tile of the table, into three separate f32 accumulator sets:
// exactly one product in each output's sum is nonzero, so each
// accumulator is exact (never let the tensor core add the parts together:
// its internal alignment is not IEEE round-to-nearest). The output is
// (acc_hi + acc_mid) + acc_lo in f32: both adds are exact, so it is
// table[idx] bit for bit except the sign of zero (-0.0 reads +0.0: the
// accumulators start at +0 and the zero products of the other rows are
// added in); an index outside [0, T) hits no row and reads 0.
//
// Block: 256 fetches, 8 warps, in four passes of 32 columns. Warp w owns
// 4 m16 tiles of fetches (rows 64 (w / 2) ..) x 2 n8 tiles of the pass's
// columns (16 (w % 2) ..): each B fragment, loaded once from shared memory,
// feeds 4 MMAs (4 m16 tiles), and each A fragment 6 (2 n8 tiles x 3
// parts); 96 accumulators a lane. The parts stream through two
// shared-memory buffers of kOhKc k16 tiles (48 KB each) by cp.async, the
// next chunk in flight while this one is multiplied.
constexpr int kOhFetches = 256;    // fetches per block
constexpr int kOhThreads = 256;
constexpr int kOhMt = 4;           // m16 tiles a warp
constexpr int kOhNs = 2;           // n8 tiles a warp
constexpr int kOhPassCols = 32;    // columns per pass
constexpr int kOhPasses = kRow / kOhPassCols;
constexpr int kOhPassNt = kOhPassCols / 8;          // n8 tiles per pass
constexpr int kOhKc = 16;          // k16 tiles per staged chunk
// one k16 tile of one pass: 3 parts x 4 n8 tiles x 32 lanes of uint2
constexpr int kOhTileU2 = 3 * kOhPassNt * 32;
static_assert(kOhThreads / 32 == (kOhFetches / (16 * kOhMt)) *
                                     (kOhPassNt / kOhNs), "warps tile a pass");

__device__ __forceinline__ uint32_t bits_top16(float v) {
  return __float_as_uint(v) >> 16;
}

// parts [pass][k16 tile][part][n8 tile of the pass][lane] uint2: lane
// 4 g + t holds rows 2t, 2t + 1 (x) and 2t + 8, 2t + 9 (y) of column g of
// the tile, lower row in the low half; rows at or past T are zero.
__global__ void __launch_bounds__(256)
onehot_split_kernel(const float* __restrict__ table, uint2* __restrict__ parts,
                    int T, int KT) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;   // (kt, nt, lane)
  if (e >= KT * (kRow / 8) * 32) return;
  const int lane = e & 31, nt = (e >> 5) % (kRow / 8), kt = (e >> 5) / (kRow / 8);
  const int g = lane >> 2, t = lane & 3;
  const int col = nt * 8 + g;
  uint32_t p[3][4];                        // part, row 2t, 2t + 1, 2t + 8, +9
  const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = kt * 16 + rows[i];
    const float x = r < T ? table[(size_t)r * kRow + col] : 0.f;
    const float hi = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
    const float r1 = x - hi;
    const float mid = __uint_as_float(__float_as_uint(r1) & 0xffff0000u);
    p[0][i] = bits_top16(hi);
    p[1][i] = bits_top16(mid);
    p[2][i] = bits_top16(r1 - mid);
  }
  const int pass = nt / kOhPassNt, nl = nt % kOhPassNt;
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    parts[(((size_t)pass * KT + kt) * 3 + part) * kOhPassNt * 32 + nl * 32 +
          lane] = make_uint2(p[part][0] | (p[part][1] << 16),
                             p[part][2] | (p[part][3] << 16));
  }
}

__global__ void __launch_bounds__(kOhThreads, 1)
onehot_fetch_kernel(const uint2* __restrict__ parts,
                    const int* __restrict__ idx, float* __restrict__ out,
                    int T, int KT) {
  extern __shared__ float4 smem4[];       // 2 x [kOhKc][kOhTileU2] uint2
  uint2* buf = reinterpret_cast<uint2*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mg = warp / (kOhPassNt / kOhNs), ng = warp % (kOhPassNt / kOhNs);
  const int b0 = blockIdx.x * kOhFetches + mg * 16 * kOhMt;
  // per fetch row of this lane (rows g and g + 8 of each m16 tile): the k16
  // tile it hits (-1: none) and its A words there (columns 2t, 2t + 1 and
  // 2t + 8, 2t + 9; bf16 1.0 is 0x3f80)
  int hit[kOhMt][2];
  uint32_t wlo[kOhMt][2], whi[kOhMt][2];
#pragma unroll
  for (int m = 0; m < kOhMt; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = idx[b0 + 16 * m + g + 8 * h];
      const bool ok = (unsigned)v < (unsigned)T;
      const int k = v & 15;
      hit[m][h] = ok ? v >> 4 : -1;
      wlo[m][h] = k == 2 * t ? 0x3f80u : k == 2 * t + 1 ? 0x3f800000u : 0u;
      whi[m][h] = k == 2 * t + 8 ? 0x3f80u
                                 : k == 2 * t + 9 ? 0x3f800000u : 0u;
    }
  }
  const int n_chunks = (KT + kOhKc - 1) / kOhKc;
  // start chunk c of pass `pass` into slot; one commit group always
  auto start = [&](int pass, int c, int slot) {
    const int kt0 = c * kOhKc;
    const int nkt = min(kOhKc, KT - kt0);
    const uint2* src = parts + ((size_t)pass * KT + kt0) * kOhTileU2;
    uint2* dst = buf + slot * kOhKc * kOhTileU2;
    for (int e = threadIdx.x; e < nkt * kOhTileU2 / 2; e += kOhThreads) {
      __pipeline_memcpy_async(dst + 2 * e, src + 2 * e, sizeof(uint4));
    }
    __pipeline_commit();
  };
  start(0, 0, 0);
  int q = 0;                               // chunks started so far - 1
#pragma unroll 1
  for (int pass = 0; pass < kOhPasses; ++pass) {
    float acc[3][kOhMt][kOhNs][4];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int m = 0; m < kOhMt; ++m)
#pragma unroll
        for (int n = 0; n < kOhNs; ++n)
          acc[p][m][n][0] = acc[p][m][n][1] = acc[p][m][n][2] =
              acc[p][m][n][3] = 0.f;
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
      // the next chunk (of this pass, or the next pass's first)
      if (c + 1 < n_chunks) {
        start(pass, c + 1, (q + 1) & 1);
      } else if (pass + 1 < kOhPasses) {
        start(pass + 1, 0, (q + 1) & 1);
      } else {
        __pipeline_commit();               // keep one group per chunk
      }
      __pipeline_wait_prior(1);            // this thread's copies of chunk q
      __syncthreads();                     // everyone's
      const uint2* cb = buf + (q & 1) * kOhKc * kOhTileU2;
      const int kt0 = c * kOhKc;
      const int nkt = min(kOhKc, KT - kt0);
#pragma unroll 1
      for (int kk = 0; kk < nkt; ++kk) {
        const int kt = kt0 + kk;
        uint32_t a[kOhMt][4];
#pragma unroll
        for (int m = 0; m < kOhMt; ++m) {
          const bool h0 = hit[m][0] == kt, h1 = hit[m][1] == kt;
          a[m][0] = h0 ? wlo[m][0] : 0u;
          a[m][1] = h1 ? wlo[m][1] : 0u;
          a[m][2] = h0 ? whi[m][0] : 0u;
          a[m][3] = h1 ? whi[m][1] : 0u;
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
          for (int n = 0; n < kOhNs; ++n) {
            const uint2 bw =
                cb[(kk * 3 + p) * kOhPassNt * 32 + (ng * kOhNs + n) * 32 + lane];
            const uint32_t b[2] = {bw.x, bw.y};
#pragma unroll
            for (int m = 0; m < kOhMt; ++m) {
              mma_bf16_16816(acc[p][m][n], a[m], b, acc[p][m][n]);
            }
          }
        }
      }
      __syncthreads();                     // slot q & 1 free for chunk q + 2
      ++q;
    }
    // rows g, g + 8 of each m16 tile, columns 2t, 2t + 1 of each n8 tile
#pragma unroll
    for (int m = 0; m < kOhMt; ++m) {
#pragma unroll
      for (int n = 0; n < kOhNs; ++n) {
        const int col = pass * kOhPassCols + (ng * kOhNs + n) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = b0 + 16 * m + g + 8 * h;
          *reinterpret_cast<float2*>(out + (size_t)b * kRow + col) =
              make_float2((acc[0][m][n][2 * h] + acc[1][m][n][2 * h]) +
                              acc[2][m][n][2 * h],
                          (acc[0][m][n][2 * h + 1] + acc[1][m][n][2 * h + 1]) +
                              acc[2][m][n][2 * h + 1]);
        }
      }
    }
  }
  __pipeline_wait_prior(0);
}

// ---- dma ----------------------------------------------------------------
// kDmaWarps issuing warps a block, each over kDmaRows consecutive rows of
// the block's 512 with its own ring of kDepth slots and one mbarrier a
// slot. Lane 0 issues row i into slot i % kDepth: arrive.expect_tx of 512
// bytes, then the bulk copy; an index outside [0, T) issues no copy, zeroes
// the slot and arrives without bytes, so every use of a slot completes one
// phase and use i waits on parity (i / kDepth) & 1. After the wait every
// lane stores its 16 bytes of the row; the __syncwarp after the stores
// frees the slot, and lane 0 issues the slot's next row. The slot's generic
// reads have completed by then (each fed a store), so the next copy may
// overwrite it without a proxy fence; a generic write (the zeros) is fenced.
constexpr int kDmaWarps = 16;
constexpr int kDmaRows = kFetchBlock / kDmaWarps;
static_assert(kDepth <= kDmaRows, "a warp's rows fill its ring");
// dynamic shared memory: the rings, the mbarriers, the block's indices
constexpr size_t kDmaRingBytes = (size_t)kDmaWarps * kDepth * kRowBytes;
constexpr size_t kDmaSmem =
    kDmaRingBytes + kDmaWarps * kDepth * sizeof(uint64_t) + kFetchBlock * 4;

__global__ void __launch_bounds__(kDmaWarps * 32)
dma_fetch_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                 float* __restrict__ out, int T) {
  extern __shared__ float4 smem4[];
  constexpr int kQ = kRow / 4;                 // float4s a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t* all_bars =
      reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(smem4) +
                                  kDmaRingBytes);
  int* s_idx = reinterpret_cast<int*>(all_bars + kDmaWarps * kDepth);
  float4* ring = smem4 + warp * kDepth * kQ;   // [kDepth][kQ]
  uint64_t* bars = all_bars + warp * kDepth;
  const int b0 = blockIdx.x * kFetchBlock;
  for (int e = threadIdx.x; e < kFetchBlock; e += kDmaWarps * 32) {
    s_idx[e] = idx[b0 + e];
  }
  if (lane < kDepth) {
    mbar_init(&bars[lane], 1);
    fence_proxy_async();                       // the init, for the copies
  }
  __syncthreads();
  const int* rows = s_idx + warp * kDmaRows;
  float4* o = reinterpret_cast<float4*>(out) +
              (size_t)(b0 + warp * kDmaRows) * kQ;
  auto issue = [&](int i) {                    // lane 0 only
    const int s = i % kDepth;
    const int row = rows[i];
    if ((unsigned)row < (unsigned)T) {
      mbar_arrive_expect_tx(&bars[s], kRowBytes);
      bulk_load(ring + s * kQ, table + (size_t)row * kRow, kRowBytes,
                &bars[s]);
    } else {
      for (int q = 0; q < kQ; ++q) {
        ring[s * kQ + q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      fence_proxy_async();                     // before the next copy
      mbar_arrive(&bars[s]);
    }
  };
  if (lane == 0) {
    for (int i = 0; i < kDepth; ++i) issue(i);
  }
#pragma unroll 1
  for (int i = 0; i < kDmaRows; ++i) {
    const int s = i % kDepth;
    mbar_wait(&bars[s], (i / kDepth) & 1);
    o[(size_t)i * kQ + lane] = ring[s * kQ + lane];
    __syncwarp();                              // every lane has read slot s
    if (lane == 0 && i + kDepth < kDmaRows) issue(i + kDepth);
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
// One warp a block of 512 indices. The indices go to shared memory first
// (the TPU arm's SMEM index array), so the loop waits on no index load
// from device memory. The loop stays serial on purpose: no unrolling
// across rows and no second warp, because the arm measures the latency of
// one data-dependent row access that nothing else hides.
__global__ void __launch_bounds__(32)
dynslice_fetch_kernel(const float* __restrict__ table,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int T) {
  extern __shared__ float4 smem4[];
  constexpr int kQ = kRow / 4;
  int* s_idx = reinterpret_cast<int*>(smem4);  // [kFetchBlock]
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * kFetchBlock;
  for (int e = lane; e < kFetchBlock; e += 32) s_idx[e] = idx[b0 + e];
  __syncwarp();
  const float4* tab = reinterpret_cast<const float4*>(table);
  float4* o = reinterpret_cast<float4*>(out) + (size_t)b0 * kQ;
#pragma unroll 1
  for (int i = 0; i < kFetchBlock; ++i) {
    const int row = s_idx[i];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((unsigned)row < (unsigned)T) v = tab[(size_t)row * kQ + lane];
    o[(size_t)i * kQ + lane] = v;
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

// Dynamic shared memory of a fetch kernel's block (which as for
// pienerf_fetch; ptxas reports only static shared memory).
extern "C" long long pienerf_fetch_smem_bytes(int which) {
  using namespace pienerf;
  return which == 0 ? 2 * kOhKc * kOhTileU2 * (long long)sizeof(uint2)
         : which == 1 ? (long long)kDmaSmem
         : which == 3 ? kFetchBlock * 4 : 0;
}

// which: 0 onehot, 1 dma, 2 take, 3 dynslice. B must be a multiple of 512
// for all but take. `n_sm` sizes take's grid. `scratch` holds onehot's
// table parts (pienerf_onehot_scratch_bytes(T) bytes; unused otherwise).
extern "C" int pienerf_fetch(int which, const void* table, const void* idx,
                             void* out, void* scratch, int T, int B,
                             int n_sm, void* stream) {
  using namespace pienerf;
  const float* tab = static_cast<const float*>(table);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (which != 2 && B % kFetchBlock != 0) return (int)cudaErrorInvalidValue;
  const int grid = B / kFetchBlock;
  const size_t smem = pienerf_fetch_smem_bytes(which);
  if (which == 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    uint2* parts = static_cast<uint2*>(scratch);
    const int KT = (T + 15) / 16;
    const int n_split = KT * (kRow / 8) * 32;
    onehot_split_kernel<<<(n_split + 255) / 256, 256, 0, s>>>(tab, parts, T,
                                                              KT);
    cudaError_t err = cudaFuncSetAttribute(
        onehot_fetch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    onehot_fetch_kernel<<<B / kOhFetches, kOhThreads, smem, s>>>(parts, ix, o,
                                                                 T, KT);
  } else if (which == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        dma_fetch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dma_fetch_kernel<<<grid, kDmaWarps * 32, smem, s>>>(tab, ix, o, T);
  } else if (which == 2) {
    const int warps_per_block = kTakeBlock / 32;
    int g = (B + warps_per_block - 1) / warps_per_block;
    if (g > n_sm * 8) g = n_sm * 8;
    if (g < 1) g = 1;
    take_fetch_kernel<<<g, kTakeBlock, 0, s>>>(tab, ix, o, T, B);
  } else if (which == 3) {
    dynslice_fetch_kernel<<<grid, 32, smem, s>>>(tab, ix, o, T);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Bytes of onehot's scratch for a table of T rows: three bf16 parts of
// the table padded to whole k16 tiles.
extern "C" long long pienerf_onehot_scratch_bytes(int T) {
  using namespace pienerf;
  return (long long)(T + 15) / 16 * kRow / 8 * 32 * 3 * sizeof(uint2);
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
