// Fused per-tile frame kernel for Hopper (sm_90a): bend -> field ->
// composite for 16x16 image tiles, one thread per ray. The template is
// instantiated by tile_kernel.cu (both widths, one tile per block),
// tile_kernel_block.cu (the same with block_tiles tiles per block),
// tile_kernel_paired.cu (the 64-wide net from the paired pack, either) and
// tile_kernel_timed.cu (one tile per block, its cycles split by phase):
// four translation units, so their nvcc runs go side by side.
//
// Replaces the Pallas TPU kernel pienerf_tpu/ops/pallas/tile_kernel.py
// `_make_kernel` (launched by `render_tiles`, :640-742) for both packed
// widths (Wd 64, the classic net; Wd 128, the distilled student:
// field_mlp.cuh's Net64 / Net128), in its three frame modes, each a
// compile-time instantiation:
//   deformed (DEFORMED, !CUT): bend every sample; skip a segment with no
//     candidate in its halo window;
//   static (!DEFORMED): the march without bending (xm = x, found = true);
//     the candidate window is never staged or read, no segment skip;
//   cut (DEFORMED, CUT): bend every sample as in deformed mode, then keep
//     the bent position only strictly inside the cut box params[13:19]
//     (x > min && x < max per axis); outside it the sample renders unbent
//     with found = true (tile_kernel.py:480-493); no segment skip
//     (:593-608).
// and its two schedule variants:
//   block_tiles (MULTI; B, a launch argument; tile_kernel.py:269-271): one
//     thread block renders the B consecutive tiles [blockIdx * B,
//     blockIdx * B + B), re-zeroing its per-tile state for each. At Wd 64 the weights are
//     staged once per block, not once per tile: that staging is what the
//     TPU's per-grid-step floor becomes on this card. The block-wide early
//     exit and the segment skip stay per tile.
//   paired (PAIRED, Net64; tile_kernel.py:292-297, :329-347, :502-525,
//     :562-589, :616-634): the weights come as the block-diagonal
//     sigma || color pack [4, 128, 128], of which only the two diagonal
//     64x64 blocks of each position are staged. Each pass evaluates this
//     sample's sigma chain beside the previous executed sample's color
//     chain (paired_layer: two independent FMA chains over one input
//     loop). The previous sample's 15 geo features wait, as f32, in the
//     thread's color column beside SH(d); its composite weight waits in a
//     register. A segment's rgb sum closes, and is added to the ray's rgb,
//     on the first pass of the next executed segment (the pending flag);
//     the last pending sample drains through a color-only chain after the
//     segment loop. Every sum keeps the default schedule's order, so the
//     output equals it bit for bit.
// Inputs per tile a: tile_sc[a] (t0, t1, active), bin_start[a] (K+3 prefix
// counts of the depth-sorted candidates plus the valid count),
// dirs[a, 0:3, 256], cand[a, P, 16] (p_def, p_ori, F^-1, valid); params[24]
// holds the camera origin, march bbox, T_thresh, density scale, ip_dx,
// min_near, the cut box, t_jitter and the bend reach. Output out[a]
// [8, 256]: r, g, b, depth, weight sum, dropped candidate slots (0 in
// static mode).
//
// What bounds it on this card: operations. Each executed sample costs the
// 18,752-MAC (Wd 64) or 63,616-MAC (Wd 128) field MLP plus, in the bending
// modes, its distance to each of the Wn window rows and num_seek nearest
// picks; a tile reads ~30 KB and writes 8 KB. The work depends on the data
// (early exit, empty-segment skip): the bf16 and paired paths run executed
// segments x 256 rays x Ks samples through the MLP, the f32 path only the
// live ones among them (in range, found, on a ray not yet under T_thresh).
//
// Design: one thread per ray, 256 threads per block; every per-sample
// intermediate stays on chip (registers, and shared memory for the MLP).
// The bending modes work a sub-segment (Ksb samples, one candidate window)
// at a time: the window's Wn x 16 floats land in shared memory by one bulk
// copy on an mbarrier (bulk.cuh), issued by one thread as soon as the
// block is done with the previous window, so it lands while that
// sub-segment's samples run through the MLP; a copy issued for a segment
// the early exit then drops is waited on before the buffer is reused or
// the block exits. Each thread then makes one pass over the rows in range
// for up to kKsbMax samples of its ray at once (bend_samples: each row
// read once, as one 16-byte load, the nearest rows of every sample kept
// sorted in registers; the TPU kernel's [Wn, T2 * Ksb] distance array,
// tile_kernel.py:400-410), bends them, and leaves their bent positions in
// shared memory for the MLP loop, so that nothing of the scan is live
// across the MLP.
// bf16 (every mode, width and schedule): each warpgroup runs its 128 rays'
// samples through the MLP on the tensor cores (mma_mlp.cuh: mma_field, or
// mma_field_paired; warpgroup MMAs, kTileMmaTiles of each warp's two row
// tiles in flight at a time), every layer's bf16 weights staged once per
// block; the sample loops are block-uniform, so every thread of a
// warpgroup reaches the MMAs (mma_field's own __syncwarp reconverges each
// warp after the per-ray bending). f32, default and block_tiles schedules:
// the block evaluates only the samples the output needs. A group is up to
// kKsbMax consecutive samples of every ray (one bend pass; in static mode
// up to kKsbMax samples of a sub-segment, all of it at the default Ksb 4):
// each
// thread marks its ray's live samples in a bit mask (in the march's range,
// found by the bend, the ray's transmittance not yet under T_thresh), a
// block-wide scan (warp ballots, then the 8 warp totals) lists the live
// slots in shared memory, and the list runs through the MLP in
// ceil(n / 256) register-blocked passes of 256 points on the CUDA cores
// (f32_sample: field_f32.cuh's layers, every thread a 4 x 16 tile of each
// hidden layer at Wd 64, 8 x 16 at Wd 128, the activations [WD][256] in
// shared memory), thread r taking list entry 256 p + r with that slot's
// ray's position and direction; each result (sigma, rgb) goes back into
// its slot of xs, in the bending modes over the position it came from.
// Each thread then composites its own ray's samples in order, a sample
// that is not live with sigma 0 (sg 0, rgb 0): the output equals that of
// marching every sample bit for bit (see `live_from` for the dead rays).
// Net64's weights stay resident, staged once per block, Net128's (255 KB)
// stream through two 32 KB cp.async chunks, once a pass. Every output is
// the chain one thread a point computes, bit for bit. f32 paired (which,
// like bf16, marches every sample): each thread runs its ray's
// sample through paired_layer alone (one column pair a thread, the weights
// staged once per block). The TPU kernel's
// one-hot MXU fetch becomes a plain indexed read from the sub-segment's
// candidate window in shared memory. The nearest rows are kept on a strict
// `<` in row order, so ties go to the lowest row as jnp.argmin does and
// the rows come in the order of the reference's num_seek argmin passes.
// The per-tile early exit is a block-wide OR
// (__syncthreads_or) of "this ray's transmittance is still >= T_thresh",
// the only segment-level control flow besides the deformed mode's
// tile-uniform skip. A block carries only its staged weights and its
// window phase count from tile to tile, and uses no atomics.
// The build uses -fmad=false so the scalar sample, bend and cut-box
// arithmetic rounds as the reference does; the MLP uses explicit FMAs.
#pragma once

#include "bulk.cuh"
#include "field_f32.cuh"

namespace pienerf {

constexpr int kT2 = 256;   // rays per 16x16 tile
// bf16: how many of each warp's two row tiles go through a layer's MMAs at
// once (mma_mlp.cuh): at Wd 64 one, so that two blocks fit an SM (both
// took 146-167 registers); at Wd 128, one block an SM either way, both
template <class N>
constexpr int kTileMmaTiles = N::kWd == 64 ? 1 : 2;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// NaN-propagating min/max (jnp.minimum / jnp.maximum semantics)
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// The block's MLP shared memory. bf16: the weights in the warpgroup MMA's
// B layout and a staging tile a warp. f32 paired (Net64): the compact weights and two
// 64-wide activation columns a thread. f32 otherwise: Net64's compact
// weights or Net128's two streamed chunks, the [WD][kT2] activations of
// f32_sample and its kT2 sigmas.
template <bool BF16, bool PAIRED, class N>
__host__ __device__ constexpr size_t mlp_bytes() {
  return BF16 ? mma_smem_bytes<N>(kT2)
         : PAIRED ? ((size_t)N::wfloats() + 2 * (size_t)N::kWd * kT2) * 4
                  : ((N::kWd == 64 ? (size_t)N::wfloats()
                                   : 2 * (size_t)kChunkFloats) +
                     (size_t)(N::kWd + 1) * kT2) * 4;
}

// f32, default and block_tiles schedules: one sample of each of the
// block's kT2 rays through the MLP as one register-blocked pass of kT2
// points (field_f32.cuh's layers at kT2 threads). Thread r encodes its
// sample (x, bound) into column r of the [WD][kT2] activations A and
// receives its sigma (by way of sig[r]) and rgb; SH(d) of its direction
// dv is recomputed here rather than held in registers across the loop.
// Block-wide: every thread must call it.
template <class N, class W>
__device__ __forceinline__ void f32_sample(W& w, float* __restrict__ A,
                                           float* __restrict__ sig,
                                           float x0, float x1, float x2,
                                           float bound, const float* dv,
                                           float& sigma, float& cr,
                                           float& cg, float& cb) {
  const int r = threadIdx.x;
  encode_to<false, N::kNf>(x0, x1, x2, bound,
                           [&](int f, float v) { A[f * kT2 + r] = v; });
  f32_hidden<N, 0, kT2, kT2>(w, A);
  f32_hidden<N, 1, kT2, kT2>(w, A);
  f32_hidden<N, 2, kT2, kT2>(w, A);
  f32_head<N, kT2, kT2>(w, A, [&](int p, float s) { sig[p] = s; });
  float sh[16];
  sh4<false>(dv[0], dv[1], dv[2], sh);
#pragma unroll
  for (int f = 0; f < 16; ++f) A[f * kT2 + r] = sh[f];
  f32_hidden<N, 4, kT2, kT2>(w, A);
  f32_hidden<N, 5, kT2, kT2>(w, A);
  f32_rgb<N, kT2>(w, A, [&](float a, float b, float c) {
    cr = a;
    cg = b;
    cb = c;
  });
  sigma = sig[r];    // written before color layer 0's first barrier
}

// The timed instantiations (TIMED, tile_kernel_timed.cu) add up each
// warp's clock cycles per phase of a tile: window staging (its waits and
// barriers included), the nearest-row scan, the bend and blend, the MLP,
// the composite with the segment's early-exit barrier; then the tile's
// total cycles and its start and end on the global nanosecond timer; then,
// f32 (not paired), the points the MLP evaluated and the passes of kT2
// points it ran (0 in bf16, whose MLP takes every sample). Lane 0 of each
// warp writes them to cyc[a, warp, kSplit] (the counts are the block's, the
// same in every warp). The sums are 32-bit (a tile runs far fewer than
// 2^32 cycles), to keep the registers the untimed kernel has.
constexpr int kPhases = 5;
constexpr int kSplit = kPhases + 5;

__device__ __forceinline__ long long globaltimer_ns() {
#ifdef PIENERF_EMU_CLOCK
  return emu_globaltimer();
#else
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#endif
}

template <bool ON>
struct PhaseClock {
  unsigned sum[kPhases];
  unsigned last, t0;
  unsigned points, passes;
  __device__ __forceinline__ static unsigned now() {
    return (unsigned)clock64();
  }
  __device__ __forceinline__ static long long* slot(long long* cyc, int a) {
    return cyc + ((size_t)a * (kT2 / 32) + (threadIdx.x >> 5)) * kSplit;
  }
  __device__ __forceinline__ void tile_start(long long* cyc, int a) {
#pragma unroll
    for (int p = 0; p < kPhases; ++p) sum[p] = 0;
    points = passes = 0;
    if ((threadIdx.x & 31) == 0) slot(cyc, a)[kPhases + 1] = globaltimer_ns();
    t0 = last = now();
  }
  __device__ __forceinline__ void mark() { last = now(); }
  // a group's live points and the MLP passes they took
  __device__ __forceinline__ void count(int n, int n_pass) {
    points += n;
    passes += n_pass;
  }
  // the cycles since the last mark or lap go to phase p
  __device__ __forceinline__ void lap(int p) {
    const unsigned t = now();
    sum[p] += t - last;
    last = t;
  }
  __device__ __forceinline__ void tile_end(long long* cyc, int a) {
    const unsigned t1 = now();
    if ((threadIdx.x & 31) == 0) {
      long long* c = slot(cyc, a);
#pragma unroll
      for (int p = 0; p < kPhases; ++p) c[p] = sum[p];
      c[kPhases] = t1 - t0;
      c[kPhases + 2] = globaltimer_ns();
      c[kPhases + 3] = points;
      c[kPhases + 4] = passes;
    }
  }
};
template <>
struct PhaseClock<false> {
  __device__ __forceinline__ void tile_start(long long*, int) {}
  __device__ __forceinline__ void mark() {}
  __device__ __forceinline__ void count(int, int) {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void tile_end(long long*, int) {}
};

// The candidate window of one sub-segment (tile_kernel.py:366-380): rows
// [lo, hi) of the depth-sorted list lie within the bend reach of its
// samples; the block stages the Wn rows from wa, centred on the
// sub-segment's own bins when [lo, hi) exceeds Wn (the overflow is
// counted). k0 is the sub-segment's first sample.
struct Window {
  int lo, hi, wa;
};
__device__ __forceinline__ Window window_of(const int* bs, int k0, int Ksb,
                                            int halo, int K, int Wn, int P) {
  const int lo_i = k0 + 1 - halo;
  const int hi_i = k0 + Ksb + 1 + halo;
  Window w;
  w.lo = lo_i <= 0 ? 0 : bs[lo_i];
  w.hi = hi_i >= K + 2 ? bs[K + 3] : bs[hi_i];
  const int own_lo = bs[k0 + 1];
  const int own_hi = bs[k0 + Ksb + 1];
  int wa = own_lo - floordiv(Wn - (own_hi - own_lo), 2);
  wa = min(max(wa, w.lo), max(w.lo, w.hi - Wn));
  w.wa = min(max(wa, 0), P - Wn);
  return w;
}

// The first segment at or after s that runs: the deformed mode skips a
// segment with no candidate in its halo window (every sample unfound,
// sigma 0; tile-uniform).
template <bool SKIP>
__device__ __forceinline__ int next_segment(int s, int n_seg, const int* bs,
                                            int Ks, int K, int halo) {
  if constexpr (SKIP) {
    for (; s < n_seg; ++s) {
      const int slo_i = s * Ks + 1 - halo;
      const int shi_i = s * Ks + Ks + 1 + halo;
      const int slo = slo_i <= 0 ? 0 : bs[slo_i];
      const int shi = shi_i >= K + 2 ? bs[K + 3] : bs[shi_i];
      if (shi - slo > 0) break;
    }
  }
  return s;
}

// One thread issues a window: its Wn rows of 16 floats from `src` as one
// bulk copy, completed on `bar`. A reader waits on the phase first.
__device__ __forceinline__ void window_issue(float* win, uint64_t* bar,
                                             const float* src, int Wn) {
  const int bytes = Wn * 16 * (int)sizeof(float);
  mbar_arrive_expect_tx(bar, bytes);
  bulk_load(win, src, bytes, bar);
}

// Samples one window pass serves; a sub-segment of more makes one pass per
// kKsbMax of them.
constexpr int kKsbMax = 4;

// The f32 (not paired) path's list of live slots (kk kT2 + ray, u16) of
// one group and the 8 warps' counts of them.
constexpr size_t kListBytes =
    (size_t)kKsbMax * kT2 * sizeof(unsigned short) + (kT2 / 32) * sizeof(int);

// Bend nk (<= kKsbMax) consecutive samples of this thread's ray through
// the staged window (tile_kernel.py:396-463): one pass over rows [r0, r1)
// keeps each sample's NS nearest valid rows, sorted, in registers; then per
// sample the blend in that order: a single Newton step p_rest = p_ori +
// F^-1 (x - p_def) from each row, the per-axis ip_dx reject and the
// inverse-distance blend. Rows arrive in increasing order and a row goes in
// only on a strict `<`, so ties keep the lowest row first and a NaN or
// infinite distance never goes in: the rows and their order are those of
// NS argmin passes that each exclude the rows already taken. Writes the
// bent position and the found flag of sample kk to xs[(4 kk + i) kT2].
// Sample kk sits at t0 + ((seg0 + (k + kk)) + t_jit) dt_s.
template <int NS, bool CUT, class Clock>
__device__ __forceinline__ void bend_samples(
    const float* __restrict__ win, float* __restrict__ xs, int r0, int r1,
    int nk, float t0, float seg0, int k, float t_jit, float dt_s,
    const float* o, const float* dv, float ip_dx, const float* box,
    Clock& clk) {
  const int r = threadIdx.x;
  float x[kKsbMax][3];
  float d[kKsbMax][NS];
  int j[kKsbMax][NS];
#pragma unroll
  for (int kk = 0; kk < kKsbMax; ++kk) {
    const float t = t0 + ((seg0 + (float)(k + kk)) + t_jit) * dt_s;
#pragma unroll
    for (int i = 0; i < 3; ++i) x[kk][i] = o[i] + t * dv[i];
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      d[kk][q] = INFINITY;
      j[kk][q] = 0;
    }
  }
  for (int row = r0; row < r1; ++row) {     // block-uniform bounds
    const float* cw = win + row * 16;
    if (!(cw[15] > 0.f)) continue;          // invalid row; block-uniform
    const float4 p = *reinterpret_cast<const float4*>(cw);
#pragma unroll
    for (int kk = 0; kk < kKsbMax; ++kk) {
      if (kk >= nk) break;
      const float e0 = x[kk][0] - p.x;
      const float e1 = x[kk][1] - p.y;
      const float e2 = x[kk][2] - p.z;
      float dd = e0 * e0;
      dd = dd + e1 * e1;
      dd = dd + e2 * e2;
      if (dd < d[kk][NS - 1]) {
        // behind every kept distance <= dd, ahead of the rest
#pragma unroll
        for (int q = NS - 1; q >= 0; --q) {
          if (dd < d[kk][q]) {
            if (q + 1 < NS) {
              d[kk][q + 1] = d[kk][q];
              j[kk][q + 1] = j[kk][q];
            }
            d[kk][q] = dd;
            j[kk][q] = row;
          }
        }
      }
    }
  }
  clk.lap(1);
#pragma unroll
  for (int kk = 0; kk < kKsbMax; ++kk) {
    if (kk >= nk) break;
    const float x0 = x[kk][0], x1 = x[kk][1], x2 = x[kk][2];
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, wsum = 0.f;
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const float best = d[kk][q];
      if (!(best < INFINITY)) continue;     // nothing left: weight 0
      const float* c = win + j[kk][q] * 16;
      const float q0 = x0 - c[0];
      const float q1 = x1 - c[1];
      const float q2 = x2 - c[2];
      float rest0 = c[3] + c[6] * q0;
      rest0 = rest0 + c[7] * q1;
      rest0 = rest0 + c[8] * q2;
      float rest1 = c[4] + c[9] * q0;
      rest1 = rest1 + c[10] * q1;
      rest1 = rest1 + c[11] * q2;
      float rest2 = c[5] + c[12] * q0;
      rest2 = rest2 + c[13] * q1;
      rest2 = rest2 + c[14] * q2;
      const bool ok3 = fabsf(rest0 - c[3]) <= ip_dx &&
                       fabsf(rest1 - c[4]) <= ip_dx &&
                       fabsf(rest2 - c[5]) <= ip_dx;
      const float wgt = ok3 ? 1.0f / sqrtf(fmaxf(best, 1e-16f)) : 0.f;
      m0 = m0 + wgt * rest0;
      m1 = m1 + wgt * rest1;
      m2 = m2 + wgt * rest2;
      wsum = wsum + wgt;
    }
    bool found = wsum > 0.f;
    const float invw = 1.0f / fmaxf(wsum, 1e-30f);
    float xm0 = x0, xm1 = x1, xm2 = x2;
    if (found) {
      xm0 = m0 * invw;
      xm1 = m1 * invw;
      xm2 = m2 * invw;
    }
    if constexpr (CUT) {
      // outside the cut box the static scene renders unbent
      const bool in_cut = x0 > box[0] && x0 < box[1] && x1 > box[2] &&
                          x1 < box[3] && x2 > box[4] && x2 < box[5];
      if (!in_cut) {
        found = true;
        xm0 = x0;
        xm1 = x1;
        xm2 = x2;
      }
    }
    float* xk = xs + 4 * kk * kT2 + r;
    xk[0] = xm0;
    xk[kT2] = xm1;
    xk[2 * kT2] = xm2;
    xk[3 * kT2] = found ? 1.f : 0.f;
  }
  clk.lap(2);
}

// The f32 path's test of whether a ray may still add to its output in a
// group of samples, from what is known before the MLP runs: its optical
// depth cum before the segment and the segment's sum S before the group.
// The composite weighs a later sample of the segment by T_prev =
// expf(-(cum + ((S' + tau) - tau))), S' >= S its running sum, and gives it
// weight 0 once T_prev < T_thresh. The rounding of (S' + tau) - tau can
// leave up to (S + tau_max) 2^-23 less than S, tau_max the largest tau one
// sample can add (sigma <= expf(15) < 3.3e6), so a ray counts as dead only
// once T is under T_thresh at S less four times that: every later sample
// of the segment then weighs 0 whatever its sigma, and cum, which only
// grows, keeps the ray under T_thresh in every later segment, as the
// tile's early exit assumes. So a dead ray's samples may add tau 0
// instead of their own: no output row changes. With tau of either sign,
// or unbounded (tau_max not in [0, inf)), every ray counts as alive.
__device__ __forceinline__ bool live_from(float cum, float S, float tau_max,
                                          float T_thresh) {
  if (!(tau_max >= 0.f && tau_max < INFINITY)) return true;
  const float lo = fmaxf(S - (S + tau_max) * 0x1p-21f, 0.f);
  return !(expf(-(cum + lo)) < T_thresh);
}

// The kernel's body; render_tiles_kernel (bf16) and render_tiles_kernel_f32
// below are its entry points.
template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N, bool TIMED>
__device__ __forceinline__ void render_tiles_block(
    const float* __restrict__ tile_sc, const int* __restrict__ bin_start,
    const float* __restrict__ params, const float* __restrict__ dirs,
    const float* __restrict__ cand, const float* __restrict__ pw,
    float* __restrict__ out, int A, int B, int BS, int P, int K, int Ks,
    int Ksb, int Wn, int num_seek, float bound, long long* __restrict__ cyc) {
  constexpr bool kWide = N::kWd == 128;
  static_assert(!PAIRED || !kWide, "only the 64-wide net pairs");
  // f32, default and block_tiles schedules: only the live samples go
  // through the MLP (the notes at the top)
  constexpr bool kCompact = !BF16 && !PAIRED;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);      // weights
  [[maybe_unused]] float* buf =                     // f32 activations
      sw + (kWide ? 2 * kChunkFloats : N::wfloats());
  // f32 (not paired): the weights f32_sample's layers read, resident or
  // streamed
  [[maybe_unused]] auto w32 = [&] {
    if constexpr (kWide) {
      return F32Streamed<N>{pw, sw, 0};
    } else {
      return F32Resident<N>{sw};
    }
  }();
  // bf16: the weights in the MMA's B layout, then one staging tile a warp
  [[maybe_unused]] void* swm = smem4;
  [[maybe_unused]] uint32_t* wtile = reinterpret_cast<uint32_t*>(
      reinterpret_cast<char*>(smem4) + N::mma_bytes() +
      (threadIdx.x >> 5) * kWarpTileBytes);
  // bending modes: the bent positions and found flags of up to kKsbMax
  // samples [kKsbMax, 4, kT2] (f32, not paired: each live one's sigma and
  // rgb in their place once the MLP has run; in static mode those alone).
  // f32, not paired: the group's list of live slots [kKsbMax kT2] and the
  // warps' counts [kT2 / 32]. Bending modes: each thread's count of the
  // window phases it has waited on [kT2]; the window's mbarrier; the window
  // [Wn, 16]. In this order every offset is a constant.
  [[maybe_unused]] float* xs = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + mlp_bytes<BF16, PAIRED, N>());
  [[maybe_unused]] unsigned short* lst = reinterpret_cast<unsigned short*>(
      xs + (DEFORMED || kCompact ? kKsbMax * 4 * kT2 : 0));
  [[maybe_unused]] int* wtot =
      reinterpret_cast<int*>(lst + (kCompact ? kKsbMax * kT2 : 0));
  [[maybe_unused]] int* phase = wtot + (kCompact ? kT2 / 32 : 0);
  [[maybe_unused]] uint64_t* bar = reinterpret_cast<uint64_t*>(phase + kT2);
  [[maybe_unused]] float* win = reinterpret_cast<float*>(bar + 2);
  const int r = threadIdx.x;

  const float o[3] = {params[0], params[1], params[2]};
  const float T_thresh = params[9];
  const float dscale = params[10];
  const float ip_dx = params[11];
  const float min_near = params[12];
  const float t_jit = params[19];
  const float reach = params[20];
  // the cut box (x, y, z min/max), CUT only
  [[maybe_unused]] const float* box = params + 13;

  // the window's mbarrier: one arrival (the issuing thread's) and the
  // copy's bytes complete a phase; every thread counts the phases it has
  // waited on. The barrier below orders the init before any use.
  if constexpr (DEFORMED) {
    phase[r] = 0;
    if (r == 0) {
      mbar_init(bar, 1);
      fence_proxy_async();
    }
    __syncthreads();
  }

  PhaseClock<TIMED> clk;
  bool staged = false;                  // the weights, once per block
  // without MULTI the trip count is a compile-time 1: a loop whose count
  // the compiler cannot see costs the static mode 19% (Wd 64) to 48%
  // (Wd 128) of its time, so one tile per block keeps its own
  // instantiation
  const int n_b = MULTI ? B : 1;
  for (int b = 0; b < n_b; ++b) {
    const int a = blockIdx.x * n_b + b;
    if (a >= A) break;
    float* o_t = out + (size_t)a * 8 * kT2;
    const float* sc = tile_sc + (size_t)a * 8;
    const int* bs = bin_start + (size_t)a * BS;
    const float t0 = sc[0];
    const float t1 = sc[1];
    if (!(sc[2] > 0.f)) {                            // inactive slot
      for (int row = 0; row < 8; ++row) o_t[row * kT2 + r] = 0.f;
      continue;
    }
    if (!staged) {                      // tile-uniform, so block-uniform
      if constexpr (BF16 && PAIRED) {
        stage_mma_weights_paired<N>(swm, pw);
      } else if constexpr (BF16) {
        stage_mma_weights<N>(swm, pw);
      } else if constexpr (PAIRED) {
        stage_weights_paired<N>(sw, pw);
      } else if constexpr (kWide) {
        w32.first();                    // the first chunk's copy, in flight
      } else {
        stage_weights<N>(sw, pw);
      }
      // before the first read (the streamed chunks wait in their layer)
      if constexpr (BF16 || !kWide) __syncthreads();
      staged = true;
    }

    clk.tile_start(cyc, a);
    const float* dr = dirs + (size_t)a * 8 * kT2;
    const float dv[3] = {dr[r], dr[kT2 + r], dr[2 * kT2 + r]};

    // per-ray slab near/far against the march bbox
    const float BIG = 3.4e38f;
    float near = -BIG, far = BIG;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float inv = 1.0f / dv[i];
      const float ta = (params[3 + i] - o[i]) * inv;
      const float tb = (params[6 + i] - o[i]) * inv;
      near = jmax(near, jmin(ta, tb));
      far = jmin(far, jmax(ta, tb));
    }
    const bool thit = near <= far;
    near = jmax(near, min_near);

    const float dt_s = (t1 - t0) / (float)K;
    // per-tile halo: the window covers the bend reach at this tile's bin
    // width
    const int halo =
        DEFORMED ? max((int)ceilf(reach / jmax(dt_s, 1e-9f)), 1) : 0;
    // f32, not paired: the largest tau one sample can add (live_from)
    [[maybe_unused]] const float tau_max = (3.3e6f * dscale) * dt_s;

    // SH(d): bf16 stages it once a tile, f32 paired keeps it for the color
    // column (f32_sample recomputes it a sample)
    [[maybe_unused]] float sh[16];
    if constexpr (BF16 || PAIRED) sh4<BF16>(dv[0], dv[1], dv[2], sh);
    if constexpr (BF16) mma_stage_sh(wtile + (r & 31) * kTileWords, sh);

    // paired: this thread's sigma and color columns; the color column
    // starts as SH(d) || zero geo features (the reference zeroes its
    // scratch: the first pass's color half runs on it, masked by the
    // pending flag)
    [[maybe_unused]] float* colS = buf + r;
    [[maybe_unused]] float* colC = buf + N::kWd * kT2 + r;
    [[maybe_unused]] float w_prev = 0.f;     // the pending sample's weight
    [[maybe_unused]] bool pending = false;   // block-uniform
    // bf16: the pending sample's sigma head, per row tile of the warp
    [[maybe_unused]] uint32_t head_prev[2][4] = {};
    if constexpr (PAIRED && !BF16) {
#pragma unroll
      for (int i = 0; i < 16; ++i) colC[i * kT2] = sh[i];
#pragma unroll
      for (int i = 0; i < 15; ++i) colC[(16 + i) * kT2] = 0.f;
    }

    float cum = 0.f;
    int dropped = 0;
    float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_w = 0.f;
    // the open segment's rgb sums: the executing segment's, or with PAIRED
    // the one the pending sample belongs to
    float pr = 0.f, pg = 0.f, pb = 0.f;
    const int n_seg = K / Ks;
    const int n_sub = Ks / Ksb;
    constexpr bool kSkip = DEFORMED && !CUT;
    int s = next_segment<kSkip>(0, n_seg, bs, Ks, K, halo);
    if constexpr (DEFORMED) {
      // the first executed sub-segment's window; each later one is issued
      // once the block is done with the one before (one buffer)
      if (r == 0 && s < n_seg) {
        const Window w = window_of(bs, s * Ks, Ksb, halo, K, Wn, P);
        window_issue(win, bar, cand + ((size_t)a * P + w.wa) * 16, Wn);
      }
    }
    bool alive = true;
    while (s < n_seg && alive) {
      float seg_incl = 0.f;
      float pd = 0.f, pwt = 0.f;
      // f32, not paired: this ray's live samples of the open group, bit kk
      // for slot kk
      [[maybe_unused]] unsigned live = 0;
      // f32, not paired: the group of samples [k0, k0 + nk) of every ray
      // (slots 0 .. nk - 1 of xs) through the MLP, the live ones only:
      // mark, list, evaluate in passes of kT2 points. Block-wide.
      [[maybe_unused]] auto evaluate = [&](const int k0, const int nk) {
        clk.mark();
        live = 0;
        if (live_from(cum, seg_incl, tau_max, T_thresh)) {
#pragma unroll
          for (int kk = 0; kk < kKsbMax; ++kk) {
            if (kk >= nk) break;
            const float t =
                t0 + (((float)(s * Ks) + (float)(k0 + kk)) + t_jit) * dt_s;
            bool found = true;
            if constexpr (DEFORMED) found = xs[(4 * kk + 3) * kT2 + r] != 0.f;
            if (found && (t >= near) && (t <= far) && thit) live |= 1u << kk;
          }
        }
        // the list: warp w's slots after those of warps 0 .. w - 1, each
        // warp's in slot order, then in lane order
        const int lane = r & 31, warp = r >> 5;
        unsigned m[kKsbMax];
        int cnt = 0;
#pragma unroll
        for (int kk = 0; kk < kKsbMax; ++kk) {
          m[kk] = __ballot_sync(0xffffffffu, (live >> kk) & 1u);
          cnt += __popc(m[kk]);
        }
        if (lane == 0) wtot[warp] = cnt;
        __syncthreads();
        int off = 0, n = 0;
#pragma unroll
        for (int w = 0; w < kT2 / 32; ++w) {
          const int c = wtot[w];
          off += w < warp ? c : 0;
          n += c;
        }
        const unsigned below = (1u << lane) - 1u;
#pragma unroll
        for (int kk = 0; kk < kKsbMax; ++kk) {
          if ((live >> kk) & 1u) {
            lst[off + __popc(m[kk] & below)] = (unsigned short)(kk * kT2 + r);
          }
          off += __popc(m[kk]);
        }
        __syncthreads();                  // the list and every position
        // pass p: thread r takes entry p kT2 + r, its slot's ray's position
        // and direction; past the list a dummy point, its result dropped
        const int n_pass = (n + kT2 - 1) / kT2;
        for (int p = 0; p < n_pass; ++p) {
          const int e = p * kT2 + r;
          const int slot = e < n ? lst[e] : -1;
          const int kk = slot >> 8, ray = slot & (kT2 - 1);
          float x0 = 0.f, x1 = 0.f, x2 = 0.f;
          float d[3] = {0.f, 0.f, 1.f};
          if (slot >= 0) {
            d[0] = dr[ray];
            d[1] = dr[kT2 + ray];
            d[2] = dr[2 * kT2 + ray];
            if constexpr (DEFORMED) {
              const float* xk = xs + 4 * kk * kT2 + ray;
              x0 = xk[0];
              x1 = xk[kT2];
              x2 = xk[2 * kT2];
            } else {
              const float t =
                  t0 + (((float)(s * Ks) + (float)(k0 + kk)) + t_jit) * dt_s;
              x0 = o[0] + t * d[0];
              x1 = o[1] + t * d[1];
              x2 = o[2] + t * d[2];
            }
          }
          float sigma, cr, cg, cb;
          f32_sample<N>(w32, buf, buf + N::kWd * kT2, x0, x1, x2, bound, d,
                        sigma, cr, cg, cb);
          if (slot >= 0) {
            float* q = xs + 4 * kk * kT2 + ray;
            q[0] = sigma;
            q[kT2] = cr;
            q[2 * kT2] = cg;
            q[3 * kT2] = cb;
          }
        }
        __syncthreads();                  // every result in its slot
        clk.count(n, n_pass);
        clk.lap(3);
      };
      // sample k of the segment (kk its slot in xs) through the MLP (f32,
      // not paired: its result from xs) and the composite
      auto sample = [&](const int k, const int kk) {
        // the sample's t: the static march needs it for its position, the
        // bending modes (and the f32 path, whose MLP has run) take it
        // after the MLP, so that it is not live across it
        float t = 0.f;
        [[maybe_unused]] float xm0, xm1, xm2;
        if constexpr (!kCompact && DEFORMED) {
          const float* xk = xs + 4 * kk * kT2 + r;
          xm0 = xk[0];
          xm1 = xk[kT2];
          xm2 = xk[2 * kT2];
        } else if constexpr (!kCompact) {
          t = t0 + (((float)(s * Ks) + (float)k) + t_jit) * dt_s;
          xm0 = o[0] + t * dv[0];
          xm1 = o[1] + t * dv[1];
          xm2 = o[2] + t * dv[2];
        }

        // sigma of this sample; (cr, cg, cb) is this sample's color,
        // or with PAIRED the pending sample's
        clk.mark();
        float sigma, cr, cg, cb;
        if constexpr (kCompact) {
          // a sample that is not live: sigma 0, and rgb 0 against its
          // weight 0
          const bool on = (live >> kk) & 1u;
          const float* q = xs + 4 * kk * kT2 + r;
          sigma = on ? q[0] : 0.f;
          cr = on ? q[kT2] : 0.f;
          cg = on ? q[2 * kT2] : 0.f;
          cb = on ? q[3 * kT2] : 0.f;
        } else if constexpr (BF16 && PAIRED) {
          mma_field_paired<N, kTileMmaTiles<N>>(swm, wtile, head_prev, xm0,
                                                xm1, xm2, bound, sigma, cr,
                                                cg, cb);
        } else if constexpr (BF16) {
          mma_field<N, kTileMmaTiles<N>>(swm, wtile, xm0, xm1, xm2, bound,
                                         sigma, cr, cg, cb);
        } else if constexpr (PAIRED) {
          encode<false, N::kNf>(xm0, xm1, xm2, bound, colS, kT2);
          {
            float c[N::kWd];
            paired_layer<N::kEnc, 31, N::kWd>(
                sw + N::off(0), sw + N::off(4), colS, colC, kT2, c);
#pragma unroll
            for (int j = 0; j < N::kWd; ++j) {
              colC[j * kT2] = fmaxf(c[j], 0.f);
            }
            paired_layer<N::kWd, N::kWd, N::kWd>(
                sw + N::off(1), sw + N::off(5), colS, colC, kT2, c);
#pragma unroll
            for (int j = 0; j < N::kWd; ++j) {
              colC[j * kT2] = fmaxf(c[j], 0.f);
            }
          }
          float c4[4];
          paired_layer<N::kWd, N::kWd, 4>(
              sw + N::off(2), sw + N::off(6), colS, colC, kT2, c4);
          float h4[16];
          last<N::kWd, 16, 16>(sw + N::off(3), colS, kT2, h4);
          sigma = expf(fminf(fmaxf(h4[0], -15.f), 15.f));
          cr = sigmoidf(c4[0]);
          cg = sigmoidf(c4[1]);
          cb = sigmoidf(c4[2]);
          // this sample's color input waits in the color column
#pragma unroll
          for (int i = 0; i < 16; ++i) colC[i * kT2] = sh[i];
#pragma unroll
          for (int i = 0; i < 15; ++i) colC[(16 + i) * kT2] = h4[1 + i];
        }
        if constexpr (!kCompact) clk.lap(3);

        // transmittance composite with the carried optical depth
        bool found = true;
        if constexpr (kCompact || DEFORMED) {
          t = t0 + (((float)(s * Ks) + (float)k) + t_jit) * dt_s;
        }
        if constexpr (!kCompact && DEFORMED) {
          found = xs[(4 * kk + 3) * kT2 + r] != 0.f;
        }
        // f32, not paired: live is vmask on a ray not yet dead
        const bool vmask =
            kCompact ? ((live >> kk) & 1u) != 0
                     : found && (t >= near) && (t <= far) && thit;
        const float sg = vmask ? sigma * dscale : 0.f;
        const float tau = sg * dt_s;
        const float incl = seg_incl + tau;
        const float c_before = cum + (incl - tau);
        seg_incl = incl;
        const float T_prev = expf(-c_before);
        const float w = (T_prev >= T_thresh)
                            ? (1.0f - expf(-tau)) * T_prev
                            : 0.f;
        if constexpr (PAIRED) {
          // the pending sample's rgb against its stored weight (zero
          // the first time through); on a segment's first pass that
          // sample was the previous executed segment's last, so its
          // sums close
          const float wp = pending ? w_prev : 0.f;
          pr = pr + wp * cr;
          pg = pg + wp * cg;
          pb = pb + wp * cb;
          if (k == 0) {
            acc_r += pr;
            acc_g += pg;
            acc_b += pb;
            pr = pg = pb = 0.f;
          }
          w_prev = w;
          pending = true;
        } else {
          pr = pr + w * cr;
          pg = pg + w * cg;
          pb = pb + w * cb;
        }
        pd = pd + w * t;
        pwt = pwt + w;
        clk.lap(4);
      };
      if constexpr (DEFORMED) {
        // one loop index, so that little stays live across the MLP; a pass
        // bends sub-segment sb's samples [c0, c0 + nk) at its first one
        for (int k = 0; k < Ks; ++k) {
          const int sb = k / Ksb;
          const int kk = (k - sb * Ksb) % kKsbMax;
          if (kk == 0) {
            clk.mark();
            const int c0 = k - sb * Ksb;
            const int nk = min(kKsbMax, Ksb - c0);
            const Window w = window_of(bs, s * Ks + sb * Ksb, Ksb, halo, K,
                                       Wn, P);
            if (c0 == 0) {
              dropped += max(w.hi - w.lo - Wn, 0);
              mbar_wait(bar, phase[r] & 1);
              ++phase[r];
            }
            clk.lap(0);
            const float seg0 = (float)(s * Ks);
            const int r0 = max(w.lo - w.wa, 0);
            const int r1 = min(w.hi - w.wa, Wn);
            if (num_seek == 1) {
              bend_samples<1, CUT>(win, xs, r0, r1, nk, t0, seg0, k, t_jit,
                                   dt_s, o, dv, ip_dx, box, clk);
            } else if (num_seek == 2) {
              bend_samples<2, CUT>(win, xs, r0, r1, nk, t0, seg0, k, t_jit,
                                   dt_s, o, dv, ip_dx, box, clk);
            } else {
              bend_samples<3, CUT>(win, xs, r0, r1, nk, t0, seg0, k, t_jit,
                                   dt_s, o, dv, ip_dx, box, clk);
            }
            if (c0 + nk == Ksb) {
              // every thread is done with the window: the next executed
              // sub-segment's copies in while this one's samples run
              __syncthreads();
              const int sn =
                  sb + 1 < n_sub
                      ? s
                      : next_segment<kSkip>(s + 1, n_seg, bs, Ks, K, halo);
              if (r == 0 && sn < n_seg) {
                const int kn =
                    sn * Ks + (sb + 1 < n_sub ? (sb + 1) * Ksb : 0);
                const Window wn = window_of(bs, kn, Ksb, halo, K, Wn, P);
                window_issue(win, bar, cand + ((size_t)a * P + wn.wa) * 16,
                             Wn);
              }
              clk.lap(0);
            }
            if constexpr (kCompact) evaluate(k, nk);
          }
          sample(k, kk);
        }
      } else if constexpr (kCompact) {
        // the static march, a group of up to kKsbMax samples of a
        // sub-segment at a time
        for (int sb = 0; sb < n_sub; ++sb) {
          for (int c0 = 0; c0 < Ksb; c0 += kKsbMax) {
            const int nk = min(kKsbMax, Ksb - c0);
            evaluate(sb * Ksb + c0, nk);
            for (int kk = 0; kk < nk; ++kk) sample(sb * Ksb + c0 + kk, kk);
          }
        }
      } else {
        // the static march, a sub-segment at a time (a single loop costs
        // its f32 Wd 64 instantiation a spill)
        for (int sb = 0; sb < n_sub; ++sb) {
          for (int kk = 0; kk < Ksb; ++kk) sample(sb * Ksb + kk, kk);
        }
      }
      clk.mark();
      if constexpr (!PAIRED) {
        acc_r += pr;
        acc_g += pg;
        acc_b += pb;
        pr = pg = pb = 0.f;
      }
      acc_d += pd;
      acc_w += pwt;
      cum += seg_incl;
      // tile-wide early exit: alive while any ray's T is still >= T_thresh
      alive = __syncthreads_or(expf(-cum) >= T_thresh) != 0;
      clk.lap(4);
      const int s_next = next_segment<kSkip>(s + 1, n_seg, bs, Ks, K, halo);
      if constexpr (DEFORMED) {
        if (!alive && s_next < n_seg) {
          // the early exit drops the window issued for segment s_next: it
          // lands before the block exits or the buffer takes the next
          // tile's. Only the issuing thread waits (the others count the
          // phase), so that no thread falls a phase behind the next issue.
          if (r == 0) mbar_wait(bar, phase[r] & 1);
          ++phase[r];
        }
      }
      s = s_next;
    }
    if constexpr (PAIRED) {
      if (pending) {
        // drain: the last pending sample's color chain, closing the last
        // executed segment's rgb sums
        float c3[3];
        if constexpr (BF16) {
          mma_color_drain<N, kTileMmaTiles<N>>(swm, wtile, head_prev, c3[0],
                                               c3[1], c3[2]);
        } else {
          hidden<31, N::kWd>(sw + N::off(4), colC, colS, kT2);
          hidden<N::kWd, N::kWd>(sw + N::off(5), colS, colC, kT2);
          last<N::kWd, 4, 3>(sw + N::off(6), colC, kT2, c3);
#pragma unroll
          for (int i = 0; i < 3; ++i) c3[i] = sigmoidf(c3[i]);
        }
        pr = pr + w_prev * c3[0];
        pg = pg + w_prev * c3[1];
        pb = pb + w_prev * c3[2];
        acc_r += pr;
        acc_g += pg;
        acc_b += pb;
      }
    }
    o_t[0 * kT2 + r] = acc_r;
    o_t[1 * kT2 + r] = acc_g;
    o_t[2 * kT2 + r] = acc_b;
    o_t[3 * kT2 + r] = acc_d;
    o_t[4 * kT2 + r] = acc_w;
    o_t[5 * kT2 + r] = (float)dropped;
    o_t[6 * kT2 + r] = 0.f;
    o_t[7 * kT2 + r] = 0.f;
    clk.tile_end(cyc, a);
  }
  if constexpr (!BF16 && !PAIRED && kWide) {
    if (staged) w32.last();             // the next pass's chunk, prefetched
  }
}

#define PIENERF_TILE_ARGS                                                   \
  const float *__restrict__ tile_sc, const int *__restrict__ bin_start,    \
      const float *__restrict__ params, const float *__restrict__ dirs,    \
      const float *__restrict__ cand, const float *__restrict__ pw,        \
      float *__restrict__ out, int A, int B, int BS, int P, int K, int Ks, \
      int Ksb, int Wn, int num_seek, float bound, long long *__restrict__ cyc
#define PIENERF_TILE_CALL                                                  \
  render_tiles_block<BF16, DEFORMED, CUT, PAIRED, MULTI, N, TIMED>(        \
      tile_sc, bin_start, params, dirs, cand, pw, out, A, B, BS, P, K, Ks, \
      Ksb, Wn, num_seek, bound, cyc)

// bf16: ptxas picks the registers (two blocks an SM at Wd 64).
template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N, bool TIMED>
__global__ void __launch_bounds__(kT2) render_tiles_kernel(PIENERF_TILE_ARGS) {
  PIENERF_TILE_CALL;
}

// f32: its shared memory holds one block an SM, so a thread may take any
// register; without the minimum ptxas held the static Wd 64 instantiation
// to 128 registers and spilled.
template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N, bool TIMED>
__global__ void __launch_bounds__(kT2, 1)
    render_tiles_kernel_f32(PIENERF_TILE_ARGS) {
  PIENERF_TILE_CALL;
}

#undef PIENERF_TILE_ARGS
#undef PIENERF_TILE_CALL

// the entry point of an instantiation
template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N, bool TIMED>
constexpr auto tile_kernel_entry() {
  if constexpr (BF16) {
    return render_tiles_kernel<BF16, DEFORMED, CUT, PAIRED, MULTI, N, TIMED>;
  } else {
    return render_tiles_kernel_f32<BF16, DEFORMED, CUT, PAIRED, MULTI, N,
                                   TIMED>;
  }
}

// The dynamic shared memory of one launch at window Wn: the MLP's; in the
// bending modes and on the f32 (not paired) path the group's kKsbMax
// samples of 4 floats a ray; on that path the list of live slots and the
// warps' counts (kListBytes); in the bending modes the phase counts, the
// window's mbarrier (16 bytes, keeping the window 16-byte aligned) and the
// candidate window.
template <bool BF16, bool DEFORMED, bool PAIRED, class N>
size_t launch_smem(int Wn) {
  constexpr bool kCompact = !BF16 && !PAIRED;
  return mlp_bytes<BF16, PAIRED, N>() +
         (DEFORMED || kCompact ? (size_t)kKsbMax * 4 * kT2 * 4 : 0) +
         (kCompact ? kListBytes : 0) +
         (DEFORMED ? ((size_t)Wn * 16 + kT2) * 4 + 16 : 0);
}

template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N, bool TIMED = false>
cudaError_t launch(const float* tile_sc, const int* bin_start,
                   const float* params, const float* dirs, const float* cand,
                   const float* pw, float* out, int A, int B, int BS, int P,
                   int K, int Ks, int Ksb, int Wn, int num_seek, float bound,
                   long long* cyc, cudaStream_t stream) {
  auto kern =
      tile_kernel_entry<BF16, DEFORMED, CUT, PAIRED, MULTI, N, TIMED>();
  const size_t smem = launch_smem<BF16, DEFORMED, PAIRED, N>(Wn);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (B < 1 || (!MULTI && B != 1)) return cudaErrorInvalidValue;
  if (A > 0) {
    kern<<<(A + B - 1) / B, kT2, smem, stream>>>(tile_sc, bin_start, params,
                                                 dirs, cand, pw, out, A, B,
                                                 BS, P, K, Ks, Ksb, Wn,
                                                 num_seek, bound, cyc);
  }
  return cudaGetLastError();
}

// One instantiation's resident blocks per SM at the dynamic shared memory
// its launch asks for at window Wn (both written; nothing runs).
template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N, bool TIMED = false>
cudaError_t occupancy(int Wn, int* resident, int* smem_bytes) {
  auto kern =
      tile_kernel_entry<BF16, DEFORMED, CUT, PAIRED, MULTI, N, TIMED>();
  const size_t smem = launch_smem<BF16, DEFORMED, PAIRED, N>(Wn);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kern, kT2,
                                                       smem);
}

using LaunchFn = cudaError_t (*)(const float*, const int*, const float*,
                                 const float*, const float*, const float*,
                                 float*, int, int, int, int, int, int, int,
                                 int, int, float, long long*, cudaStream_t);
using OccupancyFn = cudaError_t (*)(int, int*, int*);

}  // namespace pienerf
