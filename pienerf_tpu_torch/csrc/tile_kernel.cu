// Fused per-tile frame kernel for Hopper (sm_90a): bend -> field ->
// composite for one 16x16 image tile per thread block.
//
// Replaces the Pallas TPU kernel pienerf_tpu/ops/pallas/tile_kernel.py
// `_make_kernel` (launched by `render_tiles`, :640-742) with paired=False
// and one tile per grid step, for both packed widths (Wd 64, the classic
// net; Wd 128, the distilled student: field_mlp.cuh's Net64 / Net128), in
// its three frame modes, each a compile-time instantiation:
//   deformed (DEFORMED, !CUT): bend every sample; skip a segment with no
//     candidate in its halo window;
//   static (!DEFORMED): the march without bending (xm = x, found = true);
//     the candidate window is never staged or read, no segment skip;
//   cut (DEFORMED, CUT): bend every sample as in deformed mode, then keep
//     the bent position only strictly inside the cut box params[13:19]
//     (x > min && x < max per axis); outside it the sample renders unbent
//     with found = true (tile_kernel.py:480-493); no segment skip
//     (:593-608).
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
// intermediate stays on chip (registers, and shared-memory activation
// columns for the MLP). At Wd 64 each thread runs its ray's sample through
// the MLP alone (field_point, weights staged once per tile); at Wd 128 the
// block runs its 256 samples through the MLP in two passes of 128, two
// threads per sample and one layer's weights staged at a time
// (field_points_wide), which every thread reaches: the sample loops are
// block-uniform. The TPU kernel's one-hot MXU fetch
// becomes a plain indexed read from the sub-segment's candidate window,
// which the block copies to shared memory (Wn x 16 f32) beside the staged
// weights. The argmin uses a strict `<` in row order, so ties go to the
// lowest row as jnp.argmin does, and previously chosen rows are excluded
// instead of overwritten. The per-tile early exit is a block-wide OR
// (__syncthreads_or) of "this ray's transmittance is still >= T_thresh",
// the only segment-level control flow besides the deformed mode's
// tile-uniform skip. Blocks carry nothing across tiles and use no atomics.
// The build uses -fmad=false so the scalar sample, bend and cut-box
// arithmetic rounds as the reference does; the MLP uses explicit FMAs.

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

template <bool BF16, bool DEFORMED, bool CUT, class N>
__global__ void __launch_bounds__(kT2)
render_tiles_kernel(const float* __restrict__ tile_sc,
                    const int* __restrict__ bin_start,
                    const float* __restrict__ params,
                    const float* __restrict__ dirs,
                    const float* __restrict__ cand,
                    const float* __restrict__ pw, float* __restrict__ out,
                    int BS, int P, int K, int Ks, int Ksb, int Wn,
                    int num_seek, float bound) {
  constexpr bool kWide = N::kWd == 128;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);      // weights
  float* buf = sw + (kWide ? N::kWd * N::kWd : N::wfloats());  // activations
  float* win = sw + mlp_smem_floats<N>(kT2);  // [Wn, 16], bending modes only
  const int a = blockIdx.x;
  const int r = threadIdx.x;
  float* o_t = out + (size_t)a * 8 * kT2;
  const float* sc = tile_sc + (size_t)a * 8;
  const int* bs = bin_start + (size_t)a * BS;
  const float t0 = sc[0];
  const float t1 = sc[1];
  if (!(sc[2] > 0.f)) {                              // inactive slot
    for (int row = 0; row < 8; ++row) o_t[row * kT2 + r] = 0.f;
    return;
  }
  if constexpr (!kWide) {
    stage_weights<BF16, N>(sw, pw);  // bending modes sync at the first window
    if constexpr (!DEFORMED) __syncthreads();
  }

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
  // per-tile halo: the window covers the bend reach at this tile's bin width
  const int halo =
      DEFORMED ? max((int)ceilf(reach / jmax(dt_s, 1e-9f)), 1) : 0;

  float sh[16];
  sh4<BF16>(dv[0], dv[1], dv[2], sh);

  float cum = 0.f;
  int dropped = 0;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, acc_w = 0.f;
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
    float pr = 0.f, pg = 0.f, pb = 0.f, pd = 0.f, pwt = 0.f;
    for (int sb = 0; sb < Ks / Ksb; ++sb) {
      int rlo = 0, rhi = 0;
      if constexpr (DEFORMED) {
        const int k0 = s * Ks + sb * Ksb;
        const int lo_i = k0 + 1 - halo;
        const int hi_i = k0 + Ksb + 1 + halo;
        const int lo = lo_i <= 0 ? 0 : bs[lo_i];
        const int hi = hi_i >= K + 2 ? bs[K + 3] : bs[hi_i];
        // center the kept rows on the sub-segment's own bins when [lo, hi)
        // exceeds Wn; the overflow is counted
        const int own_lo = bs[k0 + 1];
        const int own_hi = bs[k0 + Ksb + 1];
        int wa = own_lo - floordiv(Wn - (own_hi - own_lo), 2);
        wa = min(max(wa, lo), max(lo, hi - Wn));
        wa = min(max(wa, 0), P - Wn);
        dropped += max(hi - lo - Wn, 0);

        __syncthreads();               // previous window (and weights) done
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
          // num_seek rounds: nearest remaining candidate -> single Newton
          // step p_rest = p_ori + F^-1 (x - p_def) -> per-axis ip_dx reject
          // -> inverse-distance blend
          int j0 = -1, j1 = -1;
          float m0 = 0.f, m1 = 0.f, m2 = 0.f, wsum = 0.f;
          for (int q = 0; q < num_seek; ++q) {
            float best = INFINITY;
            int jb = 0;
            for (int row = 0; row < Wn; ++row) {
              const float* cw = win + row * 16;
              if (row < rlo || row >= rhi || !(cw[15] > 0.f) || row == j0 ||
                  row == j1)
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
            if (!(best < INFINITY)) continue;        // nothing left: weight 0
            const float* c = win + jb * 16;
            const float q0 = x0 - c[0];
            const float q1 = x1 - c[1];
            const float q2 = x2 - c[2];
            float pr0 = c[3] + c[6] * q0;
            pr0 = pr0 + c[7] * q1;
            pr0 = pr0 + c[8] * q2;
            float pr1 = c[4] + c[9] * q0;
            pr1 = pr1 + c[10] * q1;
            pr1 = pr1 + c[11] * q2;
            float pr2 = c[5] + c[12] * q0;
            pr2 = pr2 + c[13] * q1;
            pr2 = pr2 + c[14] * q2;
            const bool ok3 = fabsf(pr0 - c[3]) <= ip_dx &&
                             fabsf(pr1 - c[4]) <= ip_dx &&
                             fabsf(pr2 - c[5]) <= ip_dx;
            const float wgt = ok3 ? 1.0f / sqrtf(fmaxf(best, 1e-16f)) : 0.f;
            m0 = m0 + wgt * pr0;
            m1 = m1 + wgt * pr1;
            m2 = m2 + wgt * pr2;
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

        float sigma, cr, cg, cb;
        if constexpr (kWide) {
          // rays [128 h, 128 h + 128) own the samples of pass h
          for (int h = 0; h < 2; ++h) {
            field_points_wide<BF16, N>(sw, buf, buf + N::kWd * kWidePoints,
                                       pw, r / kWidePoints == h, xm0, xm1,
                                       xm2, bound, sh, sigma, cr, cg, cb);
          }
        } else {
          field_point<BF16>(sw, buf, xm0, xm1, xm2, bound, sh, sigma, cr, cg,
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
        pr = pr + w * cr;
        pg = pg + w * cg;
        pb = pb + w * cb;
        pd = pd + w * t;
        pwt = pwt + w;
      }
    }
    acc_r += pr;
    acc_g += pg;
    acc_b += pb;
    acc_d += pd;
    acc_w += pwt;
    cum += seg_incl;
    // tile-wide early exit: alive while any ray's T is still >= T_thresh
    alive = __syncthreads_or(expf(-cum) >= T_thresh) != 0;
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

template <bool BF16, bool DEFORMED, bool CUT, class N>
cudaError_t launch(const float* tile_sc, const int* bin_start,
                   const float* params, const float* dirs, const float* cand,
                   const float* pw, float* out, int A, int BS, int P, int K,
                   int Ks, int Ksb, int Wn, int num_seek, float bound,
                   cudaStream_t stream) {
  auto kern = render_tiles_kernel<BF16, DEFORMED, CUT, N>;
  // the candidate window exists only in the bending modes
  const size_t smem = mlp_smem_bytes<N>(kT2) +
                      (DEFORMED ? (size_t)Wn * 16 * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (A > 0) {
    kern<<<A, kT2, smem, stream>>>(tile_sc, bin_start, params, dirs, cand,
                                   pw, out, BS, P, K, Ks, Ksb, Wn, num_seek,
                                   bound);
  }
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const int*, const float*,
                                 const float*, const float*, const float*,
                                 float*, int, int, int, int, int, int, int,
                                 int, float, cudaStream_t);

// [wide][bf16][mode]: deformed, static, cut
constexpr LaunchFn kLaunch[2][2][3] = {
    {{launch<false, true, false, Net64>, launch<false, false, false, Net64>,
      launch<false, true, true, Net64>},
     {launch<true, true, false, Net64>, launch<true, false, false, Net64>,
      launch<true, true, true, Net64>}},
    {{launch<false, true, false, Net128>, launch<false, false, false, Net128>,
      launch<false, true, true, Net128>},
     {launch<true, true, false, Net128>, launch<true, false, false, Net128>,
      launch<true, true, true, Net128>}}};

}  // namespace pienerf

// `cut` applies only with `deformed`, as in the Pallas kernel: deformed=0
// selects the static march whatever `cut` is. `wd` is the pack's width: 64
// or 128 (the two shipped nets).
extern "C" int pienerf_render_tiles(const void* tile_sc, const void* bin_start,
                                    const void* params, const void* dirs,
                                    const void* cand, const void* pw,
                                    void* out, int A, int BS, int P, int K,
                                    int Ks, int Ksb, int Wn, int num_seek,
                                    float bound, int bf16, int deformed,
                                    int cut, int wd, void* stream) {
  if (wd != 64 && wd != 128) return (int)cudaErrorInvalidValue;
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  cudaError_t err = pienerf::kLaunch[wd == 128][bf16 ? 1 : 0][mode](
      static_cast<const float*>(tile_sc), static_cast<const int*>(bin_start),
      static_cast<const float*>(params), static_cast<const float*>(dirs),
      static_cast<const float*>(cand), static_cast<const float*>(pw),
      static_cast<float*>(out), A, BS, P, K, Ks, Ksb, Wn, num_seek, bound,
      static_cast<cudaStream_t>(stream));
  return (int)err;
}

extern "C" const char* pienerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
