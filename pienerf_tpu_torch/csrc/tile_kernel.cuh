// Fused per-tile frame kernel for Hopper (sm_90a): bend -> field ->
// composite for 16x16 image tiles, one thread per ray. The template is
// instantiated by tile_kernel.cu (both widths, one tile per block),
// tile_kernel_block.cu (the same with block_tiles tiles per block) and
// tile_kernel_paired.cu (the 64-wide net from the paired pack, either):
// three translation units, so their nvcc runs go side by side.
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
// modes, num_seek
// nearest-candidate passes over a Wn-row window; a tile reads ~30 KB and
// writes 8 KB. The work depends on the data (early exit, empty-segment
// skip), so the bound counts executed segments x 256 rays x Ks samples.
//
// Design: one thread per ray, 256 threads per block; every per-sample
// intermediate stays on chip (registers, and shared memory for the MLP).
// bf16 (every mode, width and schedule): each warp runs its 32 rays'
// samples through the MLP on the tensor cores (mma_mlp.cuh: mma_field, or
// mma_field_paired), every layer's bf16 weights staged once per block; the
// sample loops are block-uniform, so every lane of a warp reaches the MMAs
// (mma_field's own __syncwarp reconverges the warp after the per-ray
// bending). f32: at Wd 64 each thread runs its ray's sample through the
// MLP alone (field_point, weights staged once per block); at Wd 128 the
// block runs its 256 samples through the MLP in two passes of 128, two
// threads per sample and one layer's weights staged at a time
// (field_points_wide), which every thread reaches. The TPU kernel's
// one-hot MXU fetch becomes a plain indexed read from the sub-segment's
// candidate window,
// which the block copies to shared memory (Wn x 16 f32) beside the staged
// weights. The argmin uses a strict `<` in row order, so ties go to the
// lowest row as jnp.argmin does, and previously chosen rows are excluded
// instead of overwritten. The per-tile early exit is a block-wide OR
// (__syncthreads_or) of "this ray's transmittance is still >= T_thresh",
// the only segment-level control flow besides the deformed mode's
// tile-uniform skip. Blocks carry nothing across tiles and use no atomics.
// The build uses -fmad=false so the scalar sample, bend and cut-box
// arithmetic rounds as the reference does; the MLP uses explicit FMAs.
#pragma once

#include "field_mlp.cuh"

namespace pienerf {

constexpr int kT2 = 256;   // rays per 16x16 tile

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

// the block's MLP shared memory: bf16 on the tensor cores, f32 on the
// CUDA cores
template <bool BF16, class N>
__host__ __device__ constexpr size_t mlp_bytes() {
  return BF16 ? mma_smem_bytes<N>(kT2) : mlp_smem_bytes<N>(kT2);
}

template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N>
__global__ void __launch_bounds__(kT2)
render_tiles_kernel(const float* __restrict__ tile_sc,
                    const int* __restrict__ bin_start,
                    const float* __restrict__ params,
                    const float* __restrict__ dirs,
                    const float* __restrict__ cand,
                    const float* __restrict__ pw, float* __restrict__ out,
                    int A, int B, int BS, int P, int K, int Ks, int Ksb,
                    int Wn, int num_seek, float bound) {
  constexpr bool kWide = N::kWd == 128;
  static_assert(!PAIRED || !kWide, "only the 64-wide net pairs");
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);      // weights
  [[maybe_unused]] float* buf =                     // f32 activations
      sw + (kWide ? N::kWd * N::kWd : N::wfloats());
  // bf16: the weights in fragment order, then one staging tile a warp
  [[maybe_unused]] uint2* swm = reinterpret_cast<uint2*>(smem4);
  [[maybe_unused]] uint32_t* wtile = reinterpret_cast<uint32_t*>(
      reinterpret_cast<char*>(smem4) + N::frag_bytes() +
      (threadIdx.x >> 5) * kWarpTileBytes);
  float* win = reinterpret_cast<float*>(  // [Wn, 16], bending modes only
      reinterpret_cast<char*>(smem4) + mlp_bytes<BF16, N>());
  const int r = threadIdx.x;

  const float o[3] = {params[0], params[1], params[2]};
  const float T_thresh = params[9];
  const float dscale = params[10];
  const float ip_dx = params[11];
  const float min_near = params[12];
  const float t_jit = params[19];
  const float reach = params[20];
  float box[6];                         // cut box (x, y, z min/max), CUT only
#pragma unroll
  for (int i = 0; i < 6; ++i) box[i] = CUT ? params[13 + i] : 0.f;

  bool staged = false;                  // Wd 64: the weights, once per block
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
    if constexpr (BF16 || !kWide) {
      if (!staged) {                    // tile-uniform, so block-uniform
        if constexpr (BF16 && PAIRED) {
          stage_mma_weights_paired<N>(swm, pw);
        } else if constexpr (BF16) {
          stage_mma_weights<N>(swm, pw);
        } else if constexpr (PAIRED) {
          stage_weights_paired<N>(sw, pw);
        } else {
          stage_weights<N>(sw, pw);
        }
        __syncthreads();
        staged = true;
      }
    }

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

    float sh[16];
    sh4<BF16>(dv[0], dv[1], dv[2], sh);
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
    bool alive = true;
    for (int s = 0; s < n_seg && alive; ++s) {
      if constexpr (DEFORMED && !CUT) {
        // whole-segment skip: no candidate in the segment's halo window
        // means every sample is unfound (sigma 0); tile-uniform
        const int slo_i = s * Ks + 1 - halo;
        const int shi_i = s * Ks + Ks + 1 + halo;
        const int slo = slo_i <= 0 ? 0 : bs[slo_i];
        const int shi = shi_i >= K + 2 ? bs[K + 3] : bs[shi_i];
        if (shi - slo <= 0) continue;
      }

      float seg_incl = 0.f;
      float pd = 0.f, pwt = 0.f;
      for (int sb = 0; sb < Ks / Ksb; ++sb) {
        int rlo = 0, rhi = 0;
        if constexpr (DEFORMED) {
          const int k0 = s * Ks + sb * Ksb;
          const int lo_i = k0 + 1 - halo;
          const int hi_i = k0 + Ksb + 1 + halo;
          const int lo = lo_i <= 0 ? 0 : bs[lo_i];
          const int hi = hi_i >= K + 2 ? bs[K + 3] : bs[hi_i];
          // center the kept rows on the sub-segment's own bins when
          // [lo, hi) exceeds Wn; the overflow is counted
          const int own_lo = bs[k0 + 1];
          const int own_hi = bs[k0 + Ksb + 1];
          int wa = own_lo - floordiv(Wn - (own_hi - own_lo), 2);
          wa = min(max(wa, lo), max(lo, hi - Wn));
          wa = min(max(wa, 0), P - Wn);
          dropped += max(hi - lo - Wn, 0);

          __syncthreads();             // previous window's readers are done
          const float* src = cand + ((size_t)a * P + wa) * 16;
          for (int e = r; e < Wn * 16; e += kT2) win[e] = src[e];
          __syncthreads();
          rlo = lo - wa;
          rhi = hi - wa;
        }

        for (int kk = 0; kk < Ksb; ++kk) {
          const int k = sb * Ksb + kk;
          const float t = t0 + (((float)(s * Ks) + (float)k) + t_jit) * dt_s;
          const float x0 = o[0] + t * dv[0];
          const float x1 = o[1] + t * dv[1];
          const float x2 = o[2] + t * dv[2];

          bool found = true;
          float xm0 = x0, xm1 = x1, xm2 = x2;
          if constexpr (DEFORMED) {
            // num_seek rounds: nearest remaining candidate -> single
            // Newton step p_rest = p_ori + F^-1 (x - p_def) -> per-axis
            // ip_dx reject -> inverse-distance blend
            int j0 = -1, j1 = -1;
            float m0 = 0.f, m1 = 0.f, m2 = 0.f, wsum = 0.f;
            for (int q = 0; q < num_seek; ++q) {
              float best = INFINITY;
              int jb = 0;
              for (int row = 0; row < Wn; ++row) {
                const float* cw = win + row * 16;
                if (row < rlo || row >= rhi || !(cw[15] > 0.f) ||
                    row == j0 || row == j1)
                  continue;
                const float e0 = x0 - cw[0];
                const float e1 = x1 - cw[1];
                const float e2 = x2 - cw[2];
                float dd = e0 * e0;
                dd = dd + e1 * e1;
                dd = dd + e2 * e2;
                if (dd < best) {
                  best = dd;
                  jb = row;
                }
              }
              if (q == 0) j0 = jb; else if (q == 1) j1 = jb;
              if (!(best < INFINITY)) continue;      // nothing left: weight 0
              const float* c = win + jb * 16;
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
            found = wsum > 0.f;
            const float invw = 1.0f / fmaxf(wsum, 1e-30f);
            if (found) {
              xm0 = m0 * invw;
              xm1 = m1 * invw;
              xm2 = m2 * invw;
            }
            if constexpr (CUT) {
              // outside the cut box the static scene renders unbent
              const bool in_cut = x0 > box[0] && x0 < box[1] &&
                                  x1 > box[2] && x1 < box[3] &&
                                  x2 > box[4] && x2 < box[5];
              if (!in_cut) {
                found = true;
                xm0 = x0;
                xm1 = x1;
                xm2 = x2;
              }
            }
          }

          // sigma of this sample; (cr, cg, cb) is this sample's color, or
          // with PAIRED the pending sample's
          float sigma, cr, cg, cb;
          if constexpr (BF16 && PAIRED) {
            mma_field_paired<N>(swm, wtile, head_prev, xm0, xm1, xm2, bound,
                                sigma, cr, cg, cb);
          } else if constexpr (BF16) {
            mma_field<N>(swm, wtile, xm0, xm1, xm2, bound, sigma, cr, cg,
                         cb);
          } else if constexpr (kWide) {
            // rays [128 h, 128 h + 128) own the samples of pass h
            for (int h = 0; h < 2; ++h) {
              field_points_wide<N>(sw, buf, buf + N::kWd * kWidePoints, pw,
                                   r / kWidePoints == h, xm0, xm1, xm2, bound,
                                   sh, sigma, cr, cg, cb);
            }
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
          } else {
            field_point(sw, buf, xm0, xm1, xm2, bound, sh, sigma, cr, cg,
                        cb);
          }

          // transmittance composite with the carried optical depth
          const bool vmask = found && (t >= near) && (t <= far) && thit;
          const float sg = vmask ? sigma * dscale : 0.f;
          const float tau = sg * dt_s;
          const float incl = seg_incl + tau;
          const float c_before = cum + (incl - tau);
          seg_incl = incl;
          const float T_prev = expf(-c_before);
          const float w = (T_prev >= T_thresh) ? (1.0f - expf(-tau)) * T_prev
                                               : 0.f;
          if constexpr (PAIRED) {
            // the pending sample's rgb against its stored weight (zero the
            // first time through); on a segment's first pass that sample
            // was the previous executed segment's last, so its sums close
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
        }
      }
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
    }
    if constexpr (PAIRED) {
      if (pending) {
        // drain: the last pending sample's color chain, closing the last
        // executed segment's rgb sums
        float c3[3];
        if constexpr (BF16) {
          mma_color_drain<N>(swm, wtile, head_prev, c3[0], c3[1], c3[2]);
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
  }
}

// The dynamic shared memory of one launch at window Wn: the MLP's, and in
// the bending modes the candidate window.
template <bool BF16, bool DEFORMED, class N>
size_t launch_smem(int Wn) {
  return mlp_bytes<BF16, N>() +
         (DEFORMED ? (size_t)Wn * 16 * sizeof(float) : 0);
}

template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N>
cudaError_t launch(const float* tile_sc, const int* bin_start,
                   const float* params, const float* dirs, const float* cand,
                   const float* pw, float* out, int A, int B, int BS, int P,
                   int K, int Ks, int Ksb, int Wn, int num_seek, float bound,
                   cudaStream_t stream) {
  auto kern = render_tiles_kernel<BF16, DEFORMED, CUT, PAIRED, MULTI, N>;
  const size_t smem = launch_smem<BF16, DEFORMED, N>(Wn);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (B < 1 || (!MULTI && B != 1)) return cudaErrorInvalidValue;
  if (A > 0) {
    kern<<<(A + B - 1) / B, kT2, smem, stream>>>(tile_sc, bin_start, params,
                                                 dirs, cand, pw, out, A, B,
                                                 BS, P, K, Ks, Ksb, Wn,
                                                 num_seek, bound);
  }
  return cudaGetLastError();
}

// One instantiation's resident blocks per SM at the dynamic shared memory
// its launch asks for at window Wn (both written; nothing runs).
template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N>
cudaError_t occupancy(int Wn, int* resident, int* smem_bytes) {
  auto kern = render_tiles_kernel<BF16, DEFORMED, CUT, PAIRED, MULTI, N>;
  const size_t smem = launch_smem<BF16, DEFORMED, N>(Wn);
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
                                 int, int, float, cudaStream_t);
using OccupancyFn = cudaError_t (*)(int, int*, int*);

}  // namespace pienerf
