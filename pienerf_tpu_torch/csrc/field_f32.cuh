// The f32 field MLP of both kernels, register-blocked for the CUDA cores:
// a block of THREADS threads evaluates P points a pass, one layer at a
// time, each layer as a small SGEMM micro-kernel. The field kernel runs
// 512 threads on 512 (Net64) or 256 (Net128) points a pass; the tile
// kernel its 256 threads on one sample of each of its 256 rays.
//
// Why: per-point FMA chains (one thread a point, the weights broadcast,
// the activations in a column a thread; the port's first f32 MLP) load a
// float4 of weights from shared memory for every 4 FMAs, and an activation
// for every input row besides: the shared-memory load pipe, not the FMA
// pipe, sets their pace (38% of the f32 bound at Wd 64 on an H100, 34% at
// Wd 128). Here a thread owns a tile of TP points x 4 TO4 outputs of a
// layer (on the hidden layers 4 x 16 at Wd 64; at Wd 128 8 x 8 in the
// field kernel, 8 x 16 in the tile kernel), and the block's activations
// live in shared memory as [feature][point], so one input row costs the
// thread TP / 4 activation loads and TO4 float4 weight loads for 4 TP TO4
// FMAs: 4 to 6 loads for 64 or 128 FMAs. The activations sit in one
// [WD][P] buffer that each layer overwrites in place once every thread
// has read its input (one more barrier a layer): half the shared memory of
// two buffers, so twice the points a pass and, in the field kernel, 16
// warps an SM instead of 8 in the same 206 KB (Wd 64) or 197 KB (Wd 128),
// which hides the loads' latency better.
//   Bank layout: within a warp, 32 / NOG point groups read one contiguous
//   run of a row (one wavefront); output group og reads the float4 at
//   column 4 (og + j NOG), so a warp's NOG groups read NOG distinct,
//   adjacent float4s (one wavefront at NOG 4 or 8, two at 16) and the rest
//   is broadcast.
//
// Semantics are field_mlp.cuh's f32 chains exactly: every output's sum is
// one __fmaf_rn chain over the inputs in increasing order starting from
// 0.f (register blocking changes which thread runs a chain, not its
// order), the encoding and SH(d) are encode_to<false> and sh4<false>, ReLU
// between layers, sigma = expf(clamp(h0, -15, 15)) and rgb = 1 / (1 +
// expf(-c)). So the outputs equal those of one point a thread through
// field_mlp.cuh's `hidden` / `last` bit for bit (the paired schedule's
// chains; the CPU emulation keeps the per-point path these replaced), and
// the 64-wide net embedded in the 128-wide one renders the same bits.
//
// Weights: Net64's compact weights (75 KB) stay resident for the block's
// lifetime (F32Resident). Net128's (255 KB) do not fit in a block's 227 KB:
// F32Streamed streams each layer in chunks of at most 64 input rows (32 KB)
// through two shared-memory buffers filled by cp.async, chunk k + 1 in
// flight while chunk k is multiplied; the accumulators stay in registers
// across a layer's chunks, so each chain keeps its input order. The chunk
// after a pass's last is the next pass's first (the weights repeat).
#pragma once

#include <cuda_pipeline.h>

#include "field_mlp.cuh"

namespace pienerf {

constexpr int kF32Threads = 512;
constexpr int kChunkFloats = 64 * 128;   // one streamed chunk: 32 KB

// points a pass: the hidden layers' tile of 64 accumulators a thread
template <class N>
__host__ __device__ constexpr int f32_points() {
  return N::kWd == 64 ? 512 : 256;
}

// Shared memory of the f32 field kernel: the weights (Net64 all of them,
// Net128 two chunk buffers) and the [WD][P] activation buffer.
template <class N>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return ((N::kWd == 64 ? (size_t)N::wfloats() : 2 * (size_t)kChunkFloats) +
          (size_t)N::kWd * f32_points<N>()) * sizeof(float);
}

// A layer's thread tiling: TP points x 4 TO4 outputs a thread; thread t
// takes output group og = t % NOG and point group pg = t / NOG.
template <int OUTP, int TP, int TO4, int P>
struct F32Tile {
  static constexpr int kNog = OUTP / (4 * TO4);
  static constexpr int kThreads = kNog * (P / TP);
  static_assert(kNog * 4 * TO4 == OUTP && (P / TP) * TP == P, "tiling");
  static_assert(kThreads <= kF32Threads, "one layer, one block");
  // the output column of accumulator 4 j + c of output group og
  __device__ static constexpr int col(int og, int j, int c) {
    return 4 * (og + j * kNog) + c;
  }
};

template <int TP>
__device__ __forceinline__ void load_points(const float* __restrict__ p,
                                            float (&v)[TP]) {
  if constexpr (TP % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TP; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      v[q] = a.x; v[q + 1] = a.y; v[q + 2] = a.z; v[q + 3] = a.w;
    }
  } else if constexpr (TP == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    static_assert(TP == 1, "1, 2 or a multiple of 4 points a thread");
    v[0] = p[0];
  }
}

// acc[q][4 j + c] = fma(w[r][col(og, j, c)], h[r][TP pg + q], acc) for the
// input rows r = 0 .. rows - 1 in order. w: [rows][OUTP] in shared memory;
// h: [rows][P], rows of the layer's input.
template <int OUTP, int TP, int TO4, int P>
__device__ __forceinline__ void fma_rows(const float* __restrict__ w,
                                         const float* __restrict__ h,
                                         int rows, int og, int pg,
                                         float (&acc)[TP][4 * TO4]) {
  using T = F32Tile<OUTP, TP, TO4, P>;
  const float* hp = h + pg * TP;
  const float* wp = w + 4 * og;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    float v[TP];
    load_points<TP>(hp + r * P, v);
#pragma unroll
    for (int j = 0; j < TO4; ++j) {
      const float4 wv =
          *reinterpret_cast<const float4*>(wp + r * OUTP + 4 * j * T::kNog);
#pragma unroll
      for (int q = 0; q < TP; ++q) {
        acc[q][4 * j + 0] = __fmaf_rn(wv.x, v[q], acc[q][4 * j + 0]);
        acc[q][4 * j + 1] = __fmaf_rn(wv.y, v[q], acc[q][4 * j + 1]);
        acc[q][4 * j + 2] = __fmaf_rn(wv.z, v[q], acc[q][4 * j + 2]);
        acc[q][4 * j + 3] = __fmaf_rn(wv.w, v[q], acc[q][4 * j + 3]);
      }
    }
  }
}

// Net64: the compact weights staged once per block (the caller
// synchronises before the first pass). A layer waits for its input,
// multiplies, and waits for every reader of the input, so that the caller
// may overwrite it with the outputs.
template <class N>
struct F32Resident {
  const float* sw;
  template <int L, int TP, int TO4, int P>
  __device__ __forceinline__ void layer(const float* __restrict__ h, int og,
                                        int pg, float (&acc)[TP][4 * TO4]) {
    __syncthreads();                     // the layer's input is written
    if (threadIdx.x < F32Tile<N::outp(L), TP, TO4, P>::kThreads) {
      fma_rows<N::outp(L), TP, TO4, P>(sw + N::off(L), h, N::in(L), og, pg,
                                       acc);
    }
    __syncthreads();                     // every reader of the input done
  }
};

// Net128: each layer's live [in, outp] extent in chunks of rows(L) input
// rows, through two buffers of kChunkFloats. Like F32Resident, a layer
// returns once every reader of its input is done.
template <class N>
struct F32Streamed {
  const float* pw;                       // the [7, WD, WD] pack
  float* buf;                            // 2 x kChunkFloats
  int g;                                 // chunks started so far - 1

  __host__ __device__ static constexpr int rows(int l) {
    return N::in(l) < kChunkFloats / N::outp(l) ? N::in(l)
                                                : kChunkFloats / N::outp(l);
  }
  __host__ __device__ static constexpr int count(int l) {
    return (N::in(l) + rows(l) - 1) / rows(l);
  }
  // start the copy of chunk c of layer l into buffer `slot`, as
  // [rows][outp(l)], and commit it as one group
  __device__ __forceinline__ void start(int l, int c, int slot) {
    const int outp = N::outp(l), q4 = outp / 4;
    const int r0 = c * rows(l);
    const int nr = min(rows(l), N::in(l) - r0);
    const float* src = pw + (size_t)l * N::kWd * N::kWd + (size_t)r0 * N::kWd;
    float* dst = buf + slot * kChunkFloats;
    for (int e = threadIdx.x; e < nr * q4; e += blockDim.x) {
      const int r = e / q4, q = e - r * q4;
      __pipeline_memcpy_async(dst + r * outp + 4 * q, src + r * N::kWd + 4 * q,
                              sizeof(float4));
    }
    __pipeline_commit();
  }
  __device__ __forceinline__ void first() {   // before the first pass
    g = 0;
    start(0, 0, 0);
  }
  template <int L, int TP, int TO4, int P>
  __device__ __forceinline__ void layer(const float* __restrict__ h, int og,
                                        int pg, float (&acc)[TP][4 * TO4]) {
    constexpr int R = rows(L), C = count(L);
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      // the next chunk, into the buffer the previous chunk's readers left
      if (c + 1 < C) {
        start(L, c + 1, (g + 1) & 1);
      } else {
        start((L + 1) % kLayers, 0, (g + 1) & 1);
      }
      __pipeline_wait_prior(1);          // this thread's copies of chunk g
      __syncthreads();                   // everyone's; the layer's input
      if (threadIdx.x < F32Tile<N::outp(L), TP, TO4, P>::kThreads) {
        fma_rows<N::outp(L), TP, TO4, P>(buf + (g & 1) * kChunkFloats,
                                         h + c * R * P,
                                         min(R, N::in(L) - c * R), og, pg,
                                         acc);
      }
      __syncthreads();                   // buffer g & 1 free for chunk g + 2
      ++g;
    }
  }
  __device__ __forceinline__ void last() { __pipeline_wait_prior(0); }
};

template <int TP, int NA>
__device__ __forceinline__ void zero(float (&acc)[TP][NA]) {
#pragma unroll
  for (int q = 0; q < TP; ++q) {
#pragma unroll
    for (int j = 0; j < NA; ++j) acc[q][j] = 0.f;
  }
}

// hidden layer L: ReLU(w^T h) over the [WD][P] buffer h, in place, by
// THREADS threads
template <class N, int L, int P, int THREADS = kF32Threads, class W>
__device__ __forceinline__ void f32_hidden(W& w, float* __restrict__ h) {
  // WD P / THREADS accumulators a thread: 4 points x 16 outputs (Wd 64),
  // 8 x 8 (Wd 128 in the field kernel: the faster shape at each width on
  // an H100) or 8 x 16 (Wd 128 at 256 threads a pass of 256)
  constexpr int TP = N::kWd == 64 ? 4 : 8;
  constexpr int TO4 = N::kWd * P / THREADS / (4 * TP);
  using T = F32Tile<N::kWd, TP, TO4, P>;
  static_assert(T::kThreads == THREADS, "every thread a tile");
  const int og = threadIdx.x % T::kNog, pg = threadIdx.x / T::kNog;
  float acc[TP][4 * TO4];
  zero(acc);
  w.template layer<L, TP, TO4, P>(h, og, pg, acc);
#pragma unroll
  for (int j = 0; j < TO4; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int q = 0; q < TP; q += 4) {
        *reinterpret_cast<float4*>(h + T::col(og, j, c) * P + TP * pg + q) =
            make_float4(fmaxf(acc[q][4 * j + c], 0.f),
                        fmaxf(acc[q + 1][4 * j + c], 0.f),
                        fmaxf(acc[q + 2][4 * j + c], 0.f),
                        fmaxf(acc[q + 3][4 * j + c], 0.f));
      }
    }
  }
}

// The sigma head (layer N::kHead, 16 outputs) from buffer h: put_sigma(p,
// sigma) for every point p of the pass, geo 0..14 into rows 16..30 of h
// (color layer 0's input after SH(d), which the caller puts in rows 0..15).
template <class N, int P, int THREADS = kF32Threads, class W, class Put>
__device__ __forceinline__ void f32_head(W& w, float* __restrict__ h,
                                         Put put_sigma) {
  constexpr int TP = 4 * P / THREADS, TO4 = 1;
  using T = F32Tile<16, TP, TO4, P>;
  static_assert(T::kThreads == THREADS, "every thread a tile");
  const int og = threadIdx.x % T::kNog, pg = threadIdx.x / T::kNog;
  float acc[TP][4];
  zero(acc);
  w.template layer<N::kHead, TP, TO4, P>(h, og, pg, acc);
#pragma unroll
  for (int q = 0; q < TP; ++q) {
    const int p = TP * pg + q;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = T::col(og, 0, c);
      if (col == 0) {
        put_sigma(p, expf(fminf(fmaxf(acc[q][c], -15.f), 15.f)));
      } else {
        h[(15 + col) * P + p] = acc[q][c];
      }
    }
  }
}

// The last color layer (N::kRgb, 3 outputs, padded to 4) from buffer h:
// thread p < P computes point p's rgb and calls put_rgb(r, g, b).
template <class N, int P, class W, class Put>
__device__ __forceinline__ void f32_rgb(W& w, const float* __restrict__ h,
                                        Put put_rgb) {
  using T = F32Tile<4, 1, 1, P>;
  float acc[1][4];
  zero(acc);
  w.template layer<N::kRgb, 1, 1, P>(h, 0, threadIdx.x, acc);
  if (threadIdx.x < T::kThreads) {
    put_rgb(1.f / (1.f + expf(-acc[0][0])), 1.f / (1.f + expf(-acc[0][1])),
            1.f / (1.f + expf(-acc[0][2])));
  }
}

// One pass: points [base, base + P) (those at or past n compute on padding
// and are not stored). A is the [WD][P] activation buffer; every layer
// overwrites its input with its outputs once all its readers are done.
// Block-wide: every thread must call it.
template <class N, class W>
__device__ __forceinline__ void f32_pass(W& w, float* __restrict__ A,
                                         const float* __restrict__ x,
                                         const float* __restrict__ d,
                                         float* __restrict__ out, int n,
                                         int base, float bound) {
  constexpr int P = f32_points<N>();
  const int p = threadIdx.x, i = base + p;
  const bool own = p < P, live = own && i < n;
  if (own) {
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (live) {
      x0 = x[i];
      x1 = x[n + i];
      x2 = x[2 * n + i];
    }
    encode_to<false, N::kNf>(x0, x1, x2, bound,
                             [&](int f, float v) { A[f * P + p] = v; });
  }
  f32_hidden<N, 0, P>(w, A);
  f32_hidden<N, 1, P>(w, A);
  f32_hidden<N, 2, P>(w, A);
  f32_head<N, P>(w, A, [&](int q, float sigma) {
    if (base + q < n) out[base + q] = sigma;
  });
  if (own) {
    float d0 = 0.f, d1 = 0.f, d2 = 1.f;
    if (live) {
      d0 = d[i];
      d1 = d[n + i];
      d2 = d[2 * n + i];
    }
    float sh[16];
    sh4<false>(d0, d1, d2, sh);
#pragma unroll
    for (int f = 0; f < 16; ++f) A[f * P + p] = sh[f];
  }
  f32_hidden<N, 4, P>(w, A);
  f32_hidden<N, 5, P>(w, A);
  f32_rgb<N, P>(w, A, [&](float r, float g, float b) {
    if (live) {
      out[n + i] = r;
      out[2 * n + i] = g;
      out[3 * n + i] = b;
    }
  });
}

}  // namespace pienerf
