// torch-ngp's hash-grid field (github.com/ashawkey/torch-ngp,
// NeRFNetwork(encoding="hashgrid"), nerf/network.py and gridencoder/) as a
// net of the fused tile kernel (tile_kernel.cuh, instantiated by
// tile_kernel_grid.cu), at its published widths:
//
//   x -> multiresolution hash encoding, 16 levels x 2 features (32)
//        -> sigma MLP 32-64-16 -> sigma = exp(clip(h0, -15, 15)), geo = h[1:16]
//   SH4(d) (16) || geo (15) -> color MLP 31-64-64-3 -> sigmoid
//
// 9,344 MACs a sample, bias-free, packed [5, 64, 64] as Net64 packs its
// seven layers (kernels/field.py pack_weights); the MLP is field_f32.cuh's
// register-blocked layers, in the same order of operations. Replaces no
// Pallas kernel: the JAX package renders the hash grid only through its
// non-fused renderers, and its fused frames serve the Fourier MLP alone.
//
// The encoding (gridencoder.cu:51-135, as benchmark/reference/hashgrid.py
// writes it down): x moves to [0, 1] as (x + bound) / (2 bound); outside
// [0, 1] on any axis (or NaN) every feature is 0 and no row is read. At
// level l, pos = u scale_l + 0.5 (two roundings, as the build's
// -fmad=false keeps them), its floor the cell's lower corner and
// pos - floor the trilinear factors. A corner's row is the dense index
// x + y (res + 1) + z (res + 1)^2 where (res + 1)^3 fits the level's
// rows (always below them for u in [0, 1]), else the 32-bit hash
// x ^ y 2654435761 ^ z 805459861 modulo the level's rows, a power of two
// there; then the level's first row. Bit d of a corner's number picks the
// upper corner on axis d, its weight the product of the axes' factors in
// axis order, and the 8 weighted rows are summed in corner order, each
// product rounded before its sum.
//
// What bounds it: not its operations (816 a sample against the MLP's
// 18,688) nor its bytes (the distinct rows a frame, ~27 MB at the
// published widths), but the latency of 128 dependent-address 8-byte
// loads a sample from a 49 MB table, about the card's 50 MB L2. Each
// level's 8 corner loads go through the read-only path (__ldg) and none
// waits on another level's sums, so they can overlap (ptxas keeps several
// levels' loads in flight: the instantiations take 255 registers); the
// table stays in global memory (staging it smarter is later work). On an
// H100 the encode stage takes 13-19% of the kernel's warp cycles (PERF.md
// section 6).
#pragma once

#include "field_mlp.cuh"

namespace pienerf {

constexpr int kGridLevels = 16;        // the published grid's levels
constexpr int kGridCorners = 8;        // a trilinear cell's corners
constexpr unsigned kPrime1 = 2654435761u;
constexpr unsigned kPrime2 = 805459861u;

// The hash-grid net's layers, in Net's interface (field_mlp.cuh): 0 the
// sigma net's hidden layer, 1 its head (sigma + 15 geo), 2-4 the color net
// (its last 3 outputs padded to 4). No tensor-core (bf16) instantiation.
struct GridNet64 {
  static constexpr int kWd = 64;
  static constexpr int kEnc = 2 * kGridLevels;
  static constexpr int kLayers = 5;
  static constexpr int kHead = 1;
  static constexpr int kRgb = 4;
  static constexpr bool kGrid = true;
  __host__ __device__ static constexpr int in(int l) {
    return l == 0 ? kEnc : (l == 2 ? 31 : kWd);
  }
  __host__ __device__ static constexpr int outp(int l) {
    return l == 1 ? 16 : (l == 4 ? 4 : kWd);
  }
  __host__ __device__ static constexpr int off(int l) {
    int o = 0;
    for (int k = 0; k < l; ++k) o += in(k) * outp(k);
    return o;
  }
  __host__ __device__ static constexpr int wfloats() { return off(kLayers); }
  __host__ __device__ static constexpr size_t mma_bytes() { return 0; }
};

// The grid's per-level constants (kernels/tile.py grid_levels, from the
// spec's grid as models/hash_encoder.make_spec lays it out), passed by
// value with the launch.
struct GridLevels {
  float scale[kGridLevels];     // 2^(l log2 b) base_resolution - 1
  unsigned stride[kGridLevels];  // resolution + 1: the dense index's stride
  unsigned rows[kGridLevels];    // the level's rows
  unsigned first[kGridLevels];   // the level's first row in the table
  unsigned dense;                // bit l: level l indexes densely
};
static_assert(sizeof(GridLevels) == (4 * kGridLevels + 1) * 4,
              "GridLevels is the host's 65 32-bit words");

// What a hash-grid launch reads besides Net64's arguments: the table
// [rows, 2] f32, its levels, and the traced run's counters (null when the
// host runs no profiler: then no clock is read).
struct GridArgs {
  const float2* table;
  GridLevels lv;
  unsigned long long* ctr;
};

// The counters' slots in GridArgs::ctr, each a sum over the launch: warp
// cycles in the encode stage, warp cycles of the whole tile, samples
// encoded (the MLP's evaluated points) and table rows read.
enum GridCounter { kCtrEncode, kCtrTile, kCtrSamples, kCtrRows };

// Encode one position: put(f, feature f) for the kEnc features (level
// major: 2 l + c). Returns whether it lies inside the grid's box (then it
// read kGridLevels x kGridCorners rows).
template <class Put>
__device__ __forceinline__ bool grid_encode_to(
    const float2* __restrict__ table, const GridLevels& lv, float x0,
    float x1, float x2, float bound, Put put) {
  const float span = 2.f * bound;
  const float u[3] = {(x0 + bound) / span, (x1 + bound) / span,
                      (x2 + bound) / span};
  const bool inside = u[0] >= 0.f && u[0] <= 1.f && u[1] >= 0.f &&
                      u[1] <= 1.f && u[2] >= 0.f && u[2] <= 1.f;
  if (!inside) {
#pragma unroll
    for (int f = 0; f < 2 * kGridLevels; ++f) put(f, 0.f);
    return false;
  }
#pragma unroll
  for (int l = 0; l < kGridLevels; ++l) {
    const float s = lv.scale[l];
    const bool dense = (lv.dense >> l) & 1u;
    const unsigned st = lv.stride[l];
    // per axis: the lower and the upper factor, and the lower and the
    // upper corner's index term (dense stride or hash prime)
    float fac[3][2];
    unsigned term[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = u[a] * s + 0.5f;
      const float cell = floorf(pos);
      const float frac = pos - cell;
      fac[a][0] = 1.f - frac;
      fac[a][1] = frac;
      const unsigned c = (unsigned)(int)cell;
      const unsigned m = a == 0 ? 1u
                         : dense ? (a == 1 ? st : st * st)
                                 : (a == 1 ? kPrime1 : kPrime2);
      term[a][0] = c * m;
      term[a][1] = (c + 1u) * m;
    }
    const float2* lvl = table + lv.first[l];
    const unsigned mask = lv.rows[l] - 1u;
    float2 v[kGridCorners];
    float w[kGridCorners];
#pragma unroll
    for (int k = 0; k < kGridCorners; ++k) {
      const int b0 = k & 1, b1 = (k >> 1) & 1, b2 = (k >> 2) & 1;
      const unsigned idx =
          dense ? term[0][b0] + term[1][b1] + term[2][b2]
                : (term[0][b0] ^ term[1][b1] ^ term[2][b2]) & mask;
      v[k] = __ldg(lvl + idx);
      w[k] = fac[0][b0] * fac[1][b1];
      w[k] = w[k] * fac[2][b2];
    }
    float f0 = w[0] * v[0].x, f1 = w[0] * v[0].y;
#pragma unroll
    for (int k = 1; k < kGridCorners; ++k) {
      f0 = f0 + w[k] * v[k].x;
      f1 = f1 + w[k] * v[k].y;
    }
    put(2 * l, f0);
    put(2 * l + 1, f1);
  }
  return true;
}

// A hash-grid launch's running sums (lane 0's, per warp), kept only by the
// grid instantiations and only while GridArgs::ctr is set; the other nets
// carry none. 32-bit, to keep registers: a warp's block runs far fewer than
// 2^32 cycles, and encodes far fewer than 2^32 / 128 samples.
template <bool ON>
struct GridCount {
  unsigned enc = 0, tile = 0, samples = 0, rows = 0, t_tile = 0;
};
template <>
struct GridCount<false> {};

}  // namespace pienerf
