"""The port's CUDA sources run on the CPU (no card, no nvcc): each ``.cu``
file of ``kernels/_build.py:SOURCES`` is compiled by the host C++ compiler
against a small header that emulates the CUDA subset the kernels use (one
fiber per CUDA thread of a block, all on one host thread, switched at
``__syncthreads``, per warp at ``__syncwarp``, and at an mbarrier wait;
``cp.async`` as an immediate copy; blocks in turn), and its C entry point
is held against the plain PyTorch version on small inputs: the field
kernel, the tile kernel in every mode and schedule (default, paired,
``block_tiles``), f32 and bf16, its hash-grid net (``tile_kernel_grid.cu``)
in every mode with its device counters, the four fetch probes and the
shell. The
one-hot fetch's tensor-core instruction (``mma.cuh:mma_bf16_16816``) is
emulated at a warp barrier from the 32 lanes' fragments, and the bf16
MLP's warpgroup MMA (``wgmma.cuh``) at a warpgroup barrier from the 128
threads' fragments, B read from shared memory through its descriptor,
the accumulators NaN until the ``wait_group`` that retires them: bf16
products exact in f32, added to the accumulator one by one in increasing
k. The bulk copies and mbarriers of the dma fetch
(``bulk.cuh``) are emulated as late as they may land: a bulk load is
recorded on its mbarrier and lands only when a wait on its phase
completes; a bulk store reads shared memory at the ``bulk_wait_read`` that
retires its group, or when its thread ends; a wait yields its fiber until
the phase completes. Shared memory is filled with NaN before every block,
so a slot read before its wait, or overwritten before its store has read
it, gives a wrong row (``MBAR_REF_CU`` shows both are caught). The f32
field and tile kernels are also held bit for bit against the per-point FMA
chains their register-blocked MLP replaced (``PER_POINT_CUH``, through
``FIELD_REF_CU`` and ``TILE_REF_CU``). The fibers run in a fixed order
that reverses from pass to pass, so a missing barrier shows on every run.
A block whose threads all wait (a warpgroup a warp short at its MMA,
say) fails its launch, where a card would hang. This checks the kernels'
indexing, barriers and control flow; the card's compiler, timing and
rounding are checked by ``chip_smoke.py``."""

import ctypes
import ctypes.util
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pienerf_tpu_torch.kernels import _build
from pienerf_tpu_torch.kernels import field as tfk
from pienerf_tpu_torch.kernels import probes as tpr
from pienerf_tpu_torch.kernels import tile as ttk
from pienerf_tpu_torch.models import network as tnet
from pienerf_tpu_torch.ops import beam_bend as tbb
from pienerf_tpu_torch.render import interactive as tint
from pienerf_tpu_torch.weights import field_from_numpy

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pienerf_tpu_torch", "csrc")
CPU = torch.device("cpu")
WIDE = dict(hidden_dim=128, hidden_dim_color=128, n_freqs=10)

CUDA_RUNTIME_H = r"""
#pragma once
#include <cmath>
#include <cstddef>
#include <cstring>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <algorithm>
#include <functional>
#include <map>
#include <memory>
#include <vector>
#include <math.h>
#include <setjmp.h>
#include <ucontext.h>
#define PIENERF_EMU_MMA 1
#define PIENERF_EMU_BULK 1
#define PIENERF_EMU_WGMMA 1
#define PIENERF_EMU_CLOCK 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float2 make_float2(float a, float b) { return {a, b}; }
// a kernel parameter's address is taken in place (no copy to make here)
#define __grid_constant__
// the read-only path is a plain read; one host thread runs every fiber, so
// an atomic add is a plain add
template <class T>
inline T __ldg(const T* p) { return *p; }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}
// the cycle counter and the global timer: one tick a read
inline long long emu_ticks = 0;
inline long long clock64() { return ++emu_ticks; }
inline long long emu_globaltimer() { return ++emu_ticks; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
// Blocks run in turn. Each CUDA thread of a block is a fiber on the calling
// host thread (entered with setcontext on a stack of its own, then switched
// with _setjmp / _longjmp, which save no signal mask and so make no system
// call); the scheduler resumes the fibers round robin, each
// until it ends or waits at a barrier, and alternates the direction of its
// passes, so that a read missing its barrier meets the write in one order
// or the other. The last member to arrive at a barrier runs its completion
// step, if any, and releases the others. A fiber that waits on an
// mbarrier phase yields until the phase completes. A pass in which every
// unfinished thread waits is a deadlock (threads of a block, a warp or a
// warpgroup at different barriers, or on a phase that never completes),
// where a card would hang: the launch fails.
struct EmuBarrier {
  int expected = 0, count = 0;
  unsigned gen = 0;
};
// An mbarrier (bulk.cuh): arrivals and transaction bytes outstanding in the
// current phase. A bulk load takes its bytes off at once but is only
// recorded: it lands when a wait on its phase completes, so a read of the
// slot before that wait sees the poison (or an older row).
struct EmuCopy {
  void* dst;
  const void* src;
  size_t n;
  unsigned phase;                           // the phase it completes
};
struct EmuMbar {
  int expected = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
  std::vector<EmuCopy> copies;              // not yet landed
};
// A bulk store is recorded in its thread's bulk groups and reads shared
// memory at the thread's bulk_wait_read that retires its group, or when
// the thread ends.
struct EmuStore {
  void* dst;
  const void* src;
  size_t n;
};
// a warpgroup MMA's result in flight to a thread's accumulator registers
struct EmuAcc {
  float* dst;                               // the thread's registers
  int n;
  float v[64];
};
struct EmuFiber {
  ucontext_t start;                         // its first entry
  jmp_buf env;                              // where it waits
  const EmuBarrier* wait = nullptr;
  unsigned wait_gen = 0;
  const EmuMbar* mbar = nullptr;            // or the mbarrier it waits on
  unsigned mbar_parity = 0;
  bool started = false, done = false;
  int gen = 0;                              // __syncthreads_or's slot
  std::vector<EmuStore> open;               // the open bulk group
  std::vector<std::vector<EmuStore>> groups;  // committed, oldest first
  bool wg_fenced = false;                   // a wgmma.fence since its wait
  std::vector<EmuAcc> wg_open;       // products in flight, uncommitted
  std::vector<std::vector<EmuAcc>> wg_groups;  // committed
};
inline jmp_buf emu_sched;
inline std::vector<EmuFiber> emu_fibers;
inline std::function<void()> emu_body;
inline EmuBarrier emu_block_bar;
inline EmuBarrier emu_warp_bar[32];
inline EmuBarrier emu_wg_bar[8];
inline int emu_or[2];
template <class Step>
inline void emu_arrive_and_wait(EmuBarrier& b, Step step) {
  if (++b.count == b.expected) {
    b.count = 0;
    step();
    ++b.gen;
    return;
  }
  EmuFiber& f = emu_fibers[threadIdx.x];
  f.wait = &b;
  f.wait_gen = b.gen;
  if (!_setjmp(f.env)) _longjmp(emu_sched, 1);  // back once b.gen moved on
}
// mma.sync m16n8k16 .bf16 -> .f32: every lane stages its A, B and C
// fragments for the warp and arrives at the warp barrier, whose completion
// step (all lanes arrived) computes every lane's D
struct EmuWarp {
  uint32_t a[32][4], b[32][2];
  float c[32][4], d[32][4];
  bool mma = false;
};
inline EmuWarp emu_warp[32];
inline float emu_bf16(uint32_t u, int hi) {
  const uint32_t v = hi ? (u & 0xffff0000u) : (u << 16);
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}
struct EmuWarpStep {
  EmuWarp* w;
  void operator()() noexcept {
    if (!w->mma) return;                     // a plain __syncwarp
    w->mma = false;
    // lane 4 g + t: A register r holds row g + 8 (r % 2), columns
    // 2 t + 8 (r / 2) (low half) and the next; B register r column g, rows
    // 2 t + 8 r and the next
    float A[16][16], B[16][8];
    for (int lane = 0; lane < 32; ++lane) {
      const int g = lane / 4, t = lane % 4;
      for (int r = 0; r < 4; ++r) {
        A[g + 8 * (r % 2)][2 * t + 8 * (r / 2)] = emu_bf16(w->a[lane][r], 0);
        A[g + 8 * (r % 2)][2 * t + 8 * (r / 2) + 1] =
            emu_bf16(w->a[lane][r], 1);
      }
      for (int r = 0; r < 2; ++r) {
        B[2 * t + 8 * r][g] = emu_bf16(w->b[lane][r], 0);
        B[2 * t + 8 * r + 1][g] = emu_bf16(w->b[lane][r], 1);
      }
    }
    // D: lane 4 g + t, register i holds row g + 8 (i / 2), column
    // 2 t + i % 2
    for (int lane = 0; lane < 32; ++lane) {
      const int g = lane / 4, t = lane % 4;
      for (int i = 0; i < 4; ++i) {
        const float* a = A[g + 8 * (i / 2)];
        const int col = 2 * t + i % 2;
        float s = w->c[lane][i];
        for (int k = 0; k < 16; ++k) s = s + a[k] * B[k][col];
        w->d[lane][i] = s;
      }
    }
  }
};
inline void __syncthreads() { emu_arrive_and_wait(emu_block_bar, [] {}); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  const int w = threadIdx.x / 32;
  emu_arrive_and_wait(emu_warp_bar[w], EmuWarpStep{&emu_warp[w]});
}
inline void emu_mma_bf16_16816(float* d, const uint32_t* a,
                               const uint32_t* b, const float* c) {
  EmuWarp& w = emu_warp[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  std::memcpy(w.a[lane], a, 16);
  std::memcpy(w.b[lane], b, 8);
  std::memcpy(w.c[lane], c, 16);
  w.mma = true;
  __syncwarp();
  std::memcpy(d, w.d[lane], 16);
}
inline std::map<const void*, EmuMbar> emu_mbars;   // this block's
inline EmuMbar& emu_mbar(const void* bar) {
  auto it = emu_mbars.find(bar);
  if (it == emu_mbars.end()) {
    std::fprintf(stderr, "emulated mbarrier used before its init\n");
    std::abort();
  }
  return it->second;
}
inline void emu_mbar_step(EmuMbar& m) {        // the phase may complete
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.expected;
  }
}
inline void emu_mbar_init(uint64_t* bar, int count) {
  emu_mbars[bar] = EmuMbar{count, count};
}
inline void emu_mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  EmuMbar& m = emu_mbar(bar);
  if (m.pending == 0) {
    std::fprintf(stderr, "emulated mbarrier: an arrival too many\n");
    std::abort();
  }
  m.tx += bytes;
  --m.pending;
  emu_mbar_step(m);
}
inline void emu_mbar_arrive(uint64_t* bar) { emu_mbar_arrive_expect_tx(bar, 0); }
inline void emu_bulk_load(void* dst, const void* src, int bytes,
                          uint64_t* bar) {
  EmuMbar& m = emu_mbar(bar);
  m.copies.push_back({dst, src, (size_t)bytes, m.phase});
  m.tx -= bytes;
  emu_mbar_step(m);
}
inline void emu_mbar_wait(uint64_t* bar, int parity) {
  EmuMbar& m = emu_mbar(bar);
  if ((m.phase & 1u) == (unsigned)parity) {    // not yet complete: yield
    EmuFiber& f = emu_fibers[threadIdx.x];
    f.mbar = &m;
    f.mbar_parity = (unsigned)parity;
    if (!_setjmp(f.env)) _longjmp(emu_sched, 1);
  }
  size_t k = 0;                                 // land completed phases'
  for (const EmuCopy& c : m.copies) {
    if (c.phase < m.phase) {
      std::memcpy(c.dst, c.src, c.n);
    } else {
      m.copies[k++] = c;
    }
  }
  m.copies.resize(k);
}
inline void emu_bulk_store(void* dst, const void* src, int bytes) {
  emu_fibers[threadIdx.x].open.push_back({dst, src, (size_t)bytes});
}
inline void emu_bulk_commit() {
  EmuFiber& f = emu_fibers[threadIdx.x];
  f.groups.push_back(std::move(f.open));
  f.open.clear();
}
inline void emu_bulk_wait_read(int n) {
  EmuFiber& f = emu_fibers[threadIdx.x];
  while (f.groups.size() > (size_t)n) {
    for (const EmuStore& st : f.groups.front())
      std::memcpy(st.dst, st.src, st.n);
    f.groups.erase(f.groups.begin());
  }
}
// __ballot_sync: each lane sets its bit and arrives at the warp barrier,
// whose completion step (all 32 lanes arrived) publishes the mask and
// clears the bits for the next ballot; a lane reads the mask before it can
// arrive at the next barrier, which no completion step passes before then
inline unsigned emu_ballot_bits[32], emu_ballot_mask[32];
struct EmuBallotStep {
  int w;
  void operator()() noexcept {
    emu_ballot_mask[w] = emu_ballot_bits[w];
    emu_ballot_bits[w] = 0;
  }
};
inline unsigned __ballot_sync(unsigned, int p) {
  const int w = threadIdx.x / 32;
  if (p) emu_ballot_bits[w] |= 1u << (threadIdx.x % 32);
  emu_arrive_and_wait(emu_warp_bar[w], EmuBallotStep{w});
  return emu_ballot_mask[w];
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __syncthreads_or(int p) {
  int& slot = emu_fibers[threadIdx.x].gen;
  const int g = slot;
  slot ^= 1;
  if (p) emu_or[g] = 1;
  __syncthreads();
  const int r = emu_or[g];
  __syncthreads();
  if (threadIdx.x == 0) emu_or[g] = 0;
  return r;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchFailure = 719
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef struct CUstream_st* cudaStream_t;
constexpr size_t kEmuSmem = 232448;          // an H100 block's limit
inline cudaError_t emu_err = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_err;
  emu_err = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return (size_t)bytes > kEmuSmem ? cudaErrorInvalidValue : cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
namespace pienerf { extern float4 smem4[]; }
// wgmma.mma_async m64nNk16 .bf16 -> .f32, A from registers, B through a
// shared-memory descriptor (wgmma.cuh): each of a warpgroup's 128 threads
// stages its A fragment and accumulators and arrives at the warpgroup's
// barrier, whose completion step (all 128 arrived) computes every
// thread's D, reading B from shared memory by decoding the descriptor.
// A product is in flight until the wait_group that retires its commit
// group: till then its accumulator registers read as NaN, and a later
// product into the same registers chains from it. The completion step
// lands NaN for a product it refuses: threads that differ in N,
// descriptor or scale-d, one without a wgmma.fence since its last wait,
// a descriptor with a swizzle or a base offset, or B outside shared
// memory.
struct EmuWgThread {
  uint32_t a[4];
  float c[64];
  int n;                                    // accumulator registers
  uint64_t desc;
  int scale_d;
  bool fenced;
};
struct EmuWarpgroup {
  EmuWgThread t[128];
  float d[128][64];
};
inline EmuWarpgroup emu_wg[8];
inline uint32_t emu_smem_addr(const void* p) {
  return (uint32_t)((const char*)p - (const char*)pienerf::smem4);
}
struct EmuWgStep {
  EmuWarpgroup* g;
  void operator()() noexcept {
    const EmuWgThread& t0 = g->t[0];
    const int n = 2 * t0.n;                 // columns
    bool ok = t0.n > 0 && t0.n <= 64;
    for (const EmuWgThread& t : g->t) {
      ok = ok && t.fenced && t.n == t0.n && t.desc == t0.desc &&
           t.scale_d == t0.scale_d;
    }
    // the descriptor: start address, lbo and sbo (each >> 4), nothing else
    const uint64_t fields = 0x3fffull | 0x3fffull << 16 | 0x3fffull << 32;
    ok = ok && (t0.desc & ~fields) == 0;
    const size_t start = (t0.desc & 0x3fff) << 4;
    const size_t lbo = ((t0.desc >> 16) & 0x3fff) << 4;
    const size_t sbo = ((t0.desc >> 32) & 0x3fff) << 4;
    // B [16][n], K-major without swizzle: core matrix (k / 8, col / 8) at
    // (k / 8) lbo + (col / 8) sbo, column col's 8 k values a 16-byte row
    float B[16][128] = {};
    for (int k = 0; ok && k < 16; ++k) {
      for (int col = 0; col < n; ++col) {
        const size_t off = start + (k / 8) * lbo + (col / 8) * sbo +
                           (col % 8) * 16 + (k % 8) * 2;
        if (off + 2 > kEmuSmem) {
          ok = false;
          break;
        }
        uint16_t h;
        std::memcpy(&h, (const char*)pienerf::smem4 + off, 2);
        B[k][col] = emu_bf16(h, 0);
      }
    }
    // warp q holds rows 16 q .. 16 q + 15 in mma.sync's A layout (lane
    // 4 g + t, register r: row g + 8 (r % 2), columns 2 t + 8 (r / 2) and
    // the next); D register i of lane 4 g + t: row g + 8 (i % 4 / 2),
    // column 8 (i / 4) + 2 t + i % 2
    float A[64][16];
    for (int th = 0; th < 128; ++th) {
      const int row = 16 * (th / 32) + (th % 32) / 4, t = th % 4;
      for (int r = 0; r < 4; ++r) {
        for (int h = 0; h < 2; ++h) {
          A[row + 8 * (r % 2)][2 * t + 8 * (r / 2) + h] =
              emu_bf16(g->t[th].a[r], h);
        }
      }
    }
    for (int th = 0; th < 128; ++th) {
      const int row = 16 * (th / 32) + (th % 32) / 4, t = th % 4;
      for (int i = 0; i < t0.n && ok; ++i) {
        const float* a = A[row + 8 * (i % 4 / 2)];
        const int col = 8 * (i / 4) + 2 * t + i % 2;
        float s = g->t[th].scale_d ? g->t[th].c[i] : 0.f;
        for (int k = 0; k < 16; ++k) s = s + a[k] * B[k][col];
        g->d[th][i] = s;
      }
      for (int i = 0; i < 64 && !ok; ++i) g->d[th][i] = NAN;
    }
  }
};
inline void emu_wg_fence() { emu_fibers[threadIdx.x].wg_fenced = true; }
// cvt.rn.relu.bf16x2.f32 d, a, b: a to the high half, b to the low, each
// rounded to bf16, a negative result clamped to +0, a NaN canonical
inline uint32_t emu_cvt_rn_relu_bf16x2(float a, float b) {
  auto one = [](float f) -> uint32_t {
    if (std::isnan(f)) return 0x7fffu;
    uint32_t u;
    std::memcpy(&u, &f, 4);
    u += 0x7fffu + ((u >> 16) & 1u);
    return (u & 0x80000000u) ? 0u : u >> 16;
  };
  return one(a) << 16 | one(b);
}
inline void emu_wgmma_bf16(float* d, int n, const uint32_t* a,
                           uint64_t desc, int scale_d) {
  EmuFiber& f = emu_fibers[threadIdx.x];
  EmuWarpgroup& g = emu_wg[threadIdx.x / 128];
  const int me = threadIdx.x % 128, regs = n / 2;
  EmuWgThread& t = g.t[me];
  std::memcpy(t.a, a, 16);
  t.n = regs;
  t.desc = desc;
  t.scale_d = scale_d;
  t.fenced = f.wg_fenced;
  if (scale_d) {                      // C: the product in flight, if any
    const float* c = d;
    for (auto it = f.wg_open.rbegin(); it != f.wg_open.rend(); ++it) {
      if (it->dst == d) { c = it->v; break; }
    }
    for (auto g_ = f.wg_groups.rbegin(); c == d && g_ != f.wg_groups.rend();
         ++g_) {
      for (auto it = g_->rbegin(); it != g_->rend(); ++it) {
        if (it->dst == d) { c = it->v; break; }
      }
    }
    std::memcpy(t.c, c, regs * 4);
  }
  emu_arrive_and_wait(emu_wg_bar[threadIdx.x / 128], EmuWgStep{&g});
  EmuAcc acc{d, regs, {}};
  std::memcpy(acc.v, g.d[me], regs * 4);
  f.wg_open.push_back(acc);
  for (int i = 0; i < regs; ++i) d[i] = NAN;  // in flight
}
inline void emu_wg_commit() {
  EmuFiber& f = emu_fibers[threadIdx.x];
  f.wg_groups.push_back(std::move(f.wg_open));
  f.wg_open.clear();
}
inline void emu_wg_wait(int k) {
  EmuFiber& f = emu_fibers[threadIdx.x];
  while (f.wg_groups.size() > (size_t)k) {
    for (const EmuAcc& acc : f.wg_groups.front())
      std::memcpy(acc.dst, acc.v, acc.n * 4);
    f.wg_groups.erase(f.wg_groups.begin());
  }
  f.wg_fenced = false;
}
inline void emu_fiber_entry() {
  emu_body();
  emu_bulk_commit();                        // what is left reads now
  emu_bulk_wait_read(0);
  emu_fibers[threadIdx.x].done = true;
  _longjmp(emu_sched, 1);
}
template <class K, class... A>
void emu_launch(K k, long long grid, int threads, size_t smem, cudaStream_t,
                A... args) {
  if (smem > kEmuSmem) { emu_err = cudaErrorInvalidValue; return; }
  gridDim.x = (unsigned)grid;
  blockDim.x = threads;
  constexpr size_t kStack = 1 << 18;
  std::unique_ptr<char[]> stacks(new char[(size_t)threads * kStack]);
  emu_body = [&] { k(args...); };
  for (long long b = 0; b < grid; ++b) {
    blockIdx.x = (unsigned)b;
    std::memset(pienerf::smem4, 0xff, smem);   // NaN: no zeros to lean on
    emu_mbars.clear();
    emu_block_bar = EmuBarrier{threads};
    for (int w = 0; w < (threads + 31) / 32; ++w)
      emu_warp_bar[w] = EmuBarrier{std::min(32, threads - 32 * w)};
    for (EmuBarrier& wg : emu_wg_bar) wg = EmuBarrier{128};
    emu_or[0] = emu_or[1] = 0;
    emu_fibers.assign(threads, EmuFiber{});
    for (int t = 0; t < threads; ++t) {
      ucontext_t& c = emu_fibers[t].start;
      getcontext(&c);
      c.uc_stack.ss_sp = stacks.get() + (size_t)t * kStack;
      c.uc_stack.ss_size = kStack;
      c.uc_link = nullptr;
      makecontext(&c, emu_fiber_entry, 0);
    }
    for (int pass = 0, left = threads; left > 0; ++pass) {
      bool ran = false;
      for (int i = 0; i < threads; ++i) {
        const int t = pass % 2 ? threads - 1 - i : i;
        EmuFiber& f = emu_fibers[t];
        if (f.done || (f.wait != nullptr && f.wait->gen == f.wait_gen) ||
            (f.mbar != nullptr && (f.mbar->phase & 1u) == f.mbar_parity))
          continue;
        f.wait = nullptr;
        f.mbar = nullptr;
        threadIdx.x = t;
        ran = true;
        if (!_setjmp(emu_sched)) {
          if (f.started) _longjmp(f.env, 1);
          f.started = true;
          setcontext(&f.start);
        }
        if (f.done) --left;
      }
      if (!ran) {
        std::fprintf(stderr, "emulated block %lld: deadlock at a barrier "
                     "or an mbarrier phase\n", b);
        emu_err = cudaErrorLaunchFailure;
        return;
      }
    }
  }
}
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t b; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 64)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.b << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
"""

# cp.async as an immediate copy: the emulation checks the ring's indexing
# and group counting, not the overlap
CUDA_PIPELINE_H = r"""
#pragma once
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
"""

# The f32 MLP the port's kernels ran before the register-blocked layers of
# csrc/field_f32.cuh: one point a thread through field_point (Net64) and
# 128 points a pass, two threads a point, through field_points_wide
# (Net128), with the shared memory they took (mlp_smem_bytes), as
# csrc/field_mlp.cuh held them. FIELD_REF_CU and TILE_REF_CU keep them, so
# that the kernels are held bit for bit to these chains.
PER_POINT_CUH = r"""
#pragma once
#include "field_mlp.cuh"
namespace pienerf {
constexpr int kWidePoints = 128;        // points per Net128 pass

// Shared memory a block needs for the MLP. Net64: all weights plus two
// 64-wide activation columns per thread. Net128: one layer's weights plus
// the two [128][128] activation buffers.
template <class N>
__host__ __device__ constexpr size_t mlp_smem_floats(int threads) {
  return N::kWd == 64
             ? (size_t)N::wfloats() + 2 * (size_t)N::kWd * threads
             : (size_t)N::kWd * N::kWd + 2 * (size_t)N::kWd * kWidePoints;
}
template <class N>
__host__ __device__ constexpr size_t mlp_smem_bytes(int threads) {
  return mlp_smem_floats<N>(threads) * sizeof(float);
}

// Field at one point with Net64: sigma (f32, before density scale) and
// rgb. `sh` holds the point's direction encoding from sh4<false>; `sw` the
// staged weights; `buf` is the block's activation area (2 * 64 *
// blockDim.x floats).
__device__ __forceinline__ void field_point(const float* __restrict__ sw,
                                            float* __restrict__ buf,
                                            float x0, float x1, float x2,
                                            float bound, const float (&sh)[16],
                                            float& sigma, float& r, float& g,
                                            float& b) {
  using N = Net64;
  constexpr int WD = N::kWd;
  const int stride = blockDim.x;
  float* A = buf + threadIdx.x;
  float* B = buf + WD * stride + threadIdx.x;
  encode<false, N::kNf>(x0, x1, x2, bound, A, stride);
  hidden<N::kEnc, WD>(sw + N::off(0), A, B, stride);
  hidden<WD, WD>(sw + N::off(1), B, A, stride);
  hidden<WD, WD>(sw + N::off(2), A, B, stride);
  float h4[16];
  last<WD, 16, 16>(sw + N::off(3), B, stride, h4);
  sigma = expf(fminf(fmaxf(h4[0], -15.f), 15.f));

#pragma unroll
  for (int i = 0; i < 16; ++i) A[i * stride] = sh[i];
#pragma unroll
  for (int i = 0; i < 15; ++i) A[(16 + i) * stride] = h4[1 + i];
  hidden<31, WD>(sw + N::off(4), A, B, stride);
  hidden<WD, WD>(sw + N::off(5), B, A, stride);
  float c3[3];
  last<WD, 4, 3>(sw + N::off(6), A, stride, c3);
  r = 1.f / (1.f + expf(-c3[0]));
  g = 1.f / (1.f + expf(-c3[1]));
  b = 1.f / (1.f + expf(-c3[2]));
}

// One layer of the wide pass: stage layer L's weights, then thread
// (point p, half g) computes outputs [g * OUTP/2, (g + 1) * OUTP/2) of its
// point from column h into column out (stride kWidePoints). Both
// __syncthreads are block-wide: every thread of the block must call it.
template <class N, int L, bool RELU>
__device__ __forceinline__ void wide_layer(float* __restrict__ sw,
                                           const float* __restrict__ pw,
                                           const float* __restrict__ h,
                                           float* __restrict__ out, int g) {
  constexpr int IN = N::in(L), OUTP = N::outp(L), NACC = OUTP / 2;
  stage_layer<N, L>(sw, pw);
  __syncthreads();                     // weights and the layer input ready
  const int o0 = g * NACC;
  float acc[NACC];
  accumulate<IN, NACC, OUTP>(sw + o0, h, kWidePoints, acc);
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    out[(o0 + j) * kWidePoints] = RELU ? fmaxf(acc[j], 0.f) : acc[j];
  }
  __syncthreads();                     // outputs written; sw free again
}

// The wide net (Net128) for kWidePoints points, by all 256 threads of the
// block: thread t works on point p = t & 127 and output half g = t >> 7.
// For each point exactly one thread is its `owner`: it supplies x and sh
// and receives sigma and rgb (other threads' arguments are ignored and
// their outputs untouched). A and B are the two [128][128] activation
// buffers, sw room for one layer. Block-wide: every thread must call it.
template <class N>
__device__ __forceinline__ void field_points_wide(
    float* __restrict__ sw, float* __restrict__ A, float* __restrict__ B,
    const float* __restrict__ pw, bool owner, float x0, float x1, float x2,
    float bound, const float (&sh)[16], float& sigma, float& r, float& g,
    float& b) {
  static_assert(N::kWd == 2 * 64, "two threads of 64 outputs per point");
  constexpr int S = kWidePoints;
  const int p = threadIdx.x & (S - 1);
  const int half = threadIdx.x / S;
  float* a = A + p;
  float* bb = B + p;
  __syncthreads();                     // earlier readers of A, B are done
  if (owner) encode<false, N::kNf>(x0, x1, x2, bound, a, S);
  wide_layer<N, 0, true>(sw, pw, a, bb, half);
  wide_layer<N, 1, true>(sw, pw, bb, a, half);
  wide_layer<N, 2, true>(sw, pw, a, bb, half);
  wide_layer<N, 3, false>(sw, pw, bb, a, half);     // 16 rows in A
  if (owner) {
    sigma = expf(fminf(fmaxf(a[0], -15.f), 15.f));
#pragma unroll
    for (int i = 0; i < 16; ++i) bb[i * S] = sh[i];
#pragma unroll
    for (int i = 0; i < 15; ++i) bb[(16 + i) * S] = a[(1 + i) * S];
  }
  wide_layer<N, 4, true>(sw, pw, bb, a, half);
  wide_layer<N, 5, true>(sw, pw, a, bb, half);
  wide_layer<N, 6, false>(sw, pw, bb, a, half);     // 4 rows in A
  if (owner) {
    r = 1.f / (1.f + expf(-a[0]));
    g = 1.f / (1.f + expf(-a[S]));
    b = 1.f / (1.f + expf(-a[2 * S]));
  }
}

}  // namespace pienerf
"""

# The f32 field kernel as it was before the register-blocked MLP: one
# point a thread through field_point (Net64) and 128 points a pass, two
# threads a point, through field_points_wide (Net128). The field kernel
# must equal it bit for bit.
FIELD_REF_CU = r"""
#include "per_point_ref.cuh"
namespace pienerf {
__global__ void field_ref64(const float* x, const float* d, const float* pw,
                            float* out, int n, float bound) {
  using N = Net64;
  float* sw = reinterpret_cast<float*>(smem4);
  float* buf = sw + N::wfloats();
  stage_weights<N>(sw, pw);
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float sh[16];
    sh4<false>(d[i], d[n + i], d[2 * n + i], sh);
    float sigma, r, g, b;
    field_point(sw, buf, x[i], x[n + i], x[2 * n + i], bound, sh, sigma, r,
                g, b);
    out[i] = sigma;
    out[n + i] = r;
    out[2 * n + i] = g;
    out[3 * n + i] = b;
  }
}
__global__ void field_ref128(const float* x, const float* d, const float* pw,
                             float* out, int n, float bound) {
  using N = Net128;
  constexpr int S = kWidePoints;
  float* sw = reinterpret_cast<float*>(smem4);
  float* A = sw + N::kWd * N::kWd;
  float* B = A + N::kWd * S;
  const bool owner = threadIdx.x < S;
  for (int c = blockIdx.x; c < (n + S - 1) / S; c += gridDim.x) {
    const int i = c * S + (threadIdx.x & (S - 1));
    const bool live = owner && i < n;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 1.f;
    if (live) {
      x0 = x[i]; x1 = x[n + i]; x2 = x[2 * n + i];
      d0 = d[i]; d1 = d[n + i]; d2 = d[2 * n + i];
    }
    float sh[16];
    sh4<false>(d0, d1, d2, sh);
    float sigma = 0.f, r = 0.f, g = 0.f, b = 0.f;
    field_points_wide<N>(sw, A, B, pw, owner, x0, x1, x2, bound, sh, sigma,
                         r, g, b);
    if (live) {
      out[i] = sigma; out[n + i] = r; out[2 * n + i] = g; out[3 * n + i] = b;
    }
  }
}
}  // namespace pienerf
extern "C" int field_ref(const float* x, const float* d, const float* pw,
                         float* out, int n, float bound, int wd) {
  using namespace pienerf;
  if (wd == 64) {
    emu_launch(field_ref64, 2, 256, mlp_smem_bytes<Net64>(256),
               (cudaStream_t)nullptr, x, d, pw, out, n, bound);
  } else {
    emu_launch(field_ref128, 2, 256, mlp_smem_bytes<Net128>(256),
               (cudaStream_t)nullptr, x, d, pw, out, n, bound);
  }
  return (int)cudaGetLastError();
}
"""

# Two kernels of the emulated bulk copies themselves. read_around_wait: lane
# 0 issues one 512-byte bulk load into a slot, and every lane copies its 16
# bytes of the slot out before the mbarrier wait (early) and after it
# (late). store_then_overwrite: one thread bulk-stores a slot it filled,
# then overwrites the slot, with or without bulk_wait_read<0> between.
MBAR_REF_CU = r"""
#include "bulk.cuh"
namespace pienerf {
__global__ void read_around_wait(const float* row, float* early,
                                 float* late) {
  float4* slot = smem4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4 + 32);
  const int lane = threadIdx.x;
  if (lane == 0) {
    mbar_init(bar, 1);
    fence_proxy_async();
  }
  __syncwarp();
  if (lane == 0) {
    mbar_arrive_expect_tx(bar, 512);
    bulk_load(slot, row, 512, bar);
  }
  reinterpret_cast<float4*>(early)[lane] = slot[lane];
  mbar_wait(bar, 0);
  reinterpret_cast<float4*>(late)[lane] = slot[lane];
}
__global__ void store_then_overwrite(const float* row, float* out,
                                     int wait_read) {
  float* slot = reinterpret_cast<float*>(smem4);
  for (int q = 0; q < 128; ++q) slot[q] = row[q];
  fence_proxy_async();
  bulk_store(out, slot, 512);
  bulk_commit();
  if (wait_read) bulk_wait_read<0>();
  for (int q = 0; q < 128; ++q) slot[q] = -1.f;
}
}  // namespace pienerf
extern "C" int mbar_read(const float* row, float* early, float* late) {
  emu_launch(pienerf::read_around_wait, 1, 32, 512 + 8,
             (cudaStream_t)nullptr, row, early, late);
  return (int)cudaGetLastError();
}
extern "C" int bulk_store_overwrite(const float* row, float* out,
                                    int wait_read) {
  emu_launch(pienerf::store_then_overwrite, 1, 1, 512,
             (cudaStream_t)nullptr, row, out, wait_read);
  return (int)cudaGetLastError();
}
"""


# Two kernels of the emulated warpgroup MMA (wgmma.cuh) and the bf16 MLP's
# weight staging. read_back: one warpgroup stages a net's weights as the
# kernels do (stage_mma_weights, or stage_mma_weights_paired from the
# paired pack) and reads every layer back through its descriptor: for each
# k16 step, A selects row r % 16 of the step for row r, so warp 0's 16
# rows of D are the step's 16 rows of B, written to out[l] [in16, out8]
# (rows and columns of stride 128). wg_fault: the same selector against a
# [16 x 64] B staged from w, warp 0's D to out [16, 64]; `fault` breaks
# one rule: 1 stages B row-major instead of the MMA's layout, 2 reads the
# accumulators before wait_group, 3 leaves warp 3 out of the MMA, 4
# issues it without a wgmma.fence.
WGMMA_REF_CU = r"""
#include "field_mlp.cuh"
namespace pienerf {
// lane 4 g + t: row g picks column g, row g + 8 column g + 8
__device__ void selector(uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  a[0] = a[3] = pack_bf16x2(g == 2 * t, g == 2 * t + 1);
  a[1] = a[2] = 0u;
}
// warp 0's rows of D (lane 4 g + t, register i: row g + 8 (i % 4 / 2),
// column 8 (i / 4) + 2 t + i % 2) into out, row stride `ld`
template <int T>
__device__ void put_rows(const float (&acc)[T][4], float* out, int ld) {
  if (threadIdx.x >= 32) return;
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  for (int j = 0; j < T; ++j) {
    for (int i = 0; i < 4; ++i) {
      out[(g + 8 * (i / 2)) * ld + 8 * j + 2 * t + i % 2] = acc[j][i];
    }
  }
}
template <class N, int L>
__device__ void read_layer(uint64_t d0, float* out) {
  constexpr int NO = N::out8(L);
  uint32_t a[4];
  selector(a);
  for (int kt = 0; kt < N::in16(L) / 16; ++kt) {
    float acc[NO / 8][4];
    wg_fence();
    wgmma_bf16<NO>(acc, a, layer_desc<N>(d0, L) + 2 * NO * kt, 0);
    wg_commit();
    wg_wait<0>();
    wg_fence_operand(acc);
    put_rows(acc, out + (L * 128 + 16 * kt) * 128, 128);
  }
}
template <class N, bool PAIRED>
__global__ void read_back(const float* pw, float* out) {
  if constexpr (PAIRED) {
    stage_mma_weights_paired<N>(smem4, pw);
  } else {
    stage_mma_weights<N>(smem4, pw);
  }
  __syncthreads();
  const uint64_t d0 = wg_desc(smem4, kLbo, kSbo);
  read_layer<N, 0>(d0, out);
  read_layer<N, 1>(d0, out);
  read_layer<N, 2>(d0, out);
  read_layer<N, 3>(d0, out);
  read_layer<N, 4>(d0, out);
  read_layer<N, 5>(d0, out);
  read_layer<N, 6>(d0, out);
}
__global__ void wg_fault(const float* w, float* out, int fault) {
  char* b = reinterpret_cast<char*>(smem4);
  for (int e = threadIdx.x; e < 16 * 64; e += blockDim.x) {
    const int k = e / 64, n = e % 64;
    const int off = fault == 1 ? 2 * e
                               : (n / 8) * kSbo + (k / 8) * kLbo +
                                     (n % 8) * 16 + (k % 8) * 2;
    *reinterpret_cast<__nv_bfloat16*>(b + off) = __float2bfloat16_rn(w[e]);
  }
  fence_proxy_async();
  __syncthreads();
  if (fault == 3 && threadIdx.x >= 96) return;
  uint32_t a[4];
  selector(a);
  float acc[8][4];
  if (fault != 4) wg_fence();
  wgmma_bf16<64>(acc, a, wg_desc(smem4, kLbo, kSbo), 0);
  wg_commit();
  if (fault == 2) put_rows(acc, out, 64);
  wg_wait<0>();
  wg_fence_operand(acc);
  if (fault != 2) put_rows(acc, out, 64);
}
}  // namespace pienerf
extern "C" int wg_read_back(const float* pw, float* out, int wd,
                            int paired) {
  using namespace pienerf;
  const cudaStream_t st = nullptr;
  if (wd == 128) {
    emu_launch(read_back<Net128, false>, 1, 128, Net128::mma_bytes(), st, pw,
               out);
  } else if (paired) {
    emu_launch(read_back<Net64, true>, 1, 128, Net64::mma_bytes(), st, pw,
               out);
  } else {
    emu_launch(read_back<Net64, false>, 1, 128, Net64::mma_bytes(), st, pw,
               out);
  }
  return (int)cudaGetLastError();
}
extern "C" int wg_fault_run(const float* w, float* out, int fault) {
  emu_launch(pienerf::wg_fault, 1, 128, 16 * 64 * 2, (cudaStream_t)nullptr,
             w, out, fault);
  return (int)cudaGetLastError();
}
"""

# The tile kernel as it was before the one-pass window scan: per sample,
# num_seek argmin passes over the staged window's rows (each row tested
# against [rlo, rhi), its validity and the rows already taken), the window
# staged by scalar copies between two barriers, and its f32 MLP the
# per-point chains of PER_POINT_CUH. The kernel must equal it bit for bit:
# the same rows in the same order, the same sums.
TILE_REF_KERNEL = r"""
template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N>
__global__ void __launch_bounds__(kT2)
render_tiles_ref(const float* __restrict__ tile_sc,
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
  // bf16: the weights in the MMA's B layout, then one staging tile a warp
  [[maybe_unused]] void* swm = smem4;
  [[maybe_unused]] uint32_t* wtile = reinterpret_cast<uint32_t*>(
      reinterpret_cast<char*>(smem4) + N::mma_bytes() +
      (threadIdx.x >> 5) * kWarpTileBytes);
  float* win = reinterpret_cast<float*>(  // [Wn, 16], bending modes only
      reinterpret_cast<char*>(smem4) + ref_mlp_bytes<BF16, N>());
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
            mma_field_paired<N, kTileMmaTiles<N>>(swm, wtile, head_prev, xm0,
                                                  xm1, xm2, bound, sigma, cr,
                                                  cg, cb);
          } else if constexpr (BF16) {
            mma_field<N, kTileMmaTiles<N>>(swm, wtile, xm0, xm1, xm2, bound,
                                           sigma, cr, cg, cb);
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
  }
}
"""

TILE_REF_CU = r"""
#include "tile_kernel.cuh"
#include "per_point_ref.cuh"
namespace pienerf {
// the reference's MLP shared memory: the per-point f32 path's, or bf16's
template <bool BF16, class N>
constexpr size_t ref_mlp_bytes() {
  return BF16 ? mma_smem_bytes<N>(kT2) : mlp_smem_bytes<N>(kT2);
}
""" + TILE_REF_KERNEL + r"""
template <bool BF16, bool DEFORMED, bool CUT, bool PAIRED, bool MULTI,
          class N>
cudaError_t ref_launch(const float* tile_sc, const int* bin_start,
                       const float* params, const float* dirs,
                       const float* cand, const float* pw, float* out, int A,
                       int B, int BS, int P, int K, int Ks, int Ksb, int Wn,
                       int num_seek, float bound) {
  auto kern = render_tiles_ref<BF16, DEFORMED, CUT, PAIRED, MULTI, N>;
  const size_t smem = ref_mlp_bytes<BF16, N>() +
                      (DEFORMED ? (size_t)Wn * 16 * sizeof(float) : 0);
  cudaStream_t st = nullptr;
  kern<<<(A + B - 1) / B, kT2, smem, st>>>(tile_sc, bin_start, params, dirs,
                                          cand, pw, out, A, B, BS, P, K, Ks,
                                          Ksb, Wn, num_seek, bound);
  return cudaGetLastError();
}
using RefFn = cudaError_t (*)(const float*, const int*, const float*,
                              const float*, const float*, const float*,
                              float*, int, int, int, int, int, int, int, int,
                              int, float);
// [paired][multi][bf16][mode: deformed, static, cut][wide]
constexpr RefFn kRef[2][2][2][3][2] = {
""" + ",\n".join(
    "{" + ", ".join(
        "{" + ", ".join(
            "{" + ", ".join(
                "{" + ", ".join(
                    "nullptr" if (pa and w) else
                    f"ref_launch<{'true' if bf else 'false'}, "
                    f"{'false' if m == 1 else 'true'}, "
                    f"{'true' if m == 2 else 'false'}, "
                    f"{'true' if pa else 'false'}, "
                    f"{'true' if mu else 'false'}, "
                    f"{'Net128' if w else 'Net64'}>"
                    for w in (0, 1)) + "}"
                for m in range(3)) + "}"
            for bf in (0, 1)) + "}"
        for mu in (0, 1)) + "}"
    for pa in (0, 1)) + r"""};
}  // namespace pienerf
extern "C" int tile_ref(const void* tile_sc, const void* bin_start,
                        const void* params, const void* dirs,
                        const void* cand, const void* pw, void* out, int A,
                        int block_tiles, int BS, int P, int K, int Ks,
                        int Ksb, int Wn, int num_seek, float bound, int bf16,
                        int deformed, int cut, int wd, int paired) {
  const int mode = !deformed ? 1 : (cut ? 2 : 0);
  return (int)pienerf::kRef[paired][block_tiles > 1][bf16][mode][wd == 128](
      static_cast<const float*>(tile_sc), static_cast<const int*>(bin_start),
      static_cast<const float*>(params), static_cast<const float*>(dirs),
      static_cast<const float*>(cand), static_cast<const float*>(pw),
      static_cast<float*>(out), A, block_tiles, BS, P, K, Ks, Ksb, Wn,
      num_seek, bound);
}
// The tile kernel's window staging alone: thread 0 issues a window of Wn
// rows (window_issue), and every thread copies the buffer out before the
// mbarrier wait (early) and after it (late).
namespace pienerf {
__global__ void window_read(const float* src, int Wn, float* early,
                            float* late) {
  float* win = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(win + Wn * 16);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0) window_issue(win, bar, src, Wn);
  for (int e = threadIdx.x; e < Wn * 16; e += kT2) early[e] = win[e];
  mbar_wait(bar, 0);
  for (int e = threadIdx.x; e < Wn * 16; e += kT2) late[e] = win[e];
}
}  // namespace pienerf
extern "C" int window_read_run(const float* src, int Wn, float* early,
                               float* late) {
  cudaStream_t st = nullptr;
  auto kern = pienerf::window_read;
  kern<<<1, pienerf::kT2, (size_t)Wn * 64 + 16, st>>>(src, Wn, early, late);
  return (int)cudaGetLastError();
}
"""

@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the tensors here are small, and the test
    workers share the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every kernel source built for the emulation, loaded with ctypes."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation")
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "cuda_bf16.h").write_text(CUDA_BF16_H)
    (d / "cuda_pipeline.h").write_text(CUDA_PIPELINE_H)
    (d / "per_point_ref.cuh").write_text(PER_POINT_CUH)

    def emulated(code, is_cu=True):
        """kern<<<grid, block, smem, stream>>>(args) -> emu_launch(...), in
        the headers too; a .cu file defines the shared memory"""
        code = re.sub(r"(\w+)<<<(.*?),\s*(\w+)>>>\(",
                      r"emu_launch(\1, \2, (cudaStream_t)\3, ", code)
        return code + ("\nnamespace pienerf { float4 smem4[232448 / 16]; }\n"
                       if is_cu else "")

    for src in os.listdir(CSRC):
        with open(os.path.join(CSRC, src)) as f:
            code = emulated(f.read(), src.endswith(".cu"))
        (d / src.replace(".cu", ".cpp") if src.endswith(".cu")
         else d / src).write_text(code)
    tests_cu = {"field_ref": FIELD_REF_CU, "mbar_ref": MBAR_REF_CU,
                "tile_ref": TILE_REF_CU, "wgmma_ref": WGMMA_REF_CU}
    for name, code in tests_cu.items():
        (d / f"{name}.cpp").write_text(emulated(code))
    procs = {}
    # all compilers at once; without _FORTIFY_SOURCE, whose checked
    # longjmp refuses a jump to another stack (a fiber's)
    for name, src in {**_build.SOURCES,
                      **{n: f"{n}.cu" for n in tests_cu}}.items():
        so = d / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-U_FORTIFY_SOURCE", "-shared", "-Wno-unknown-pragmas",
             f"-I{d}", "-o", str(so),
             str(d / (src[:-3] + ".cpp"))],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        out[name] = ctypes.CDLL(str(so))
    return out


def _spec(wd):
    return tnet.make_spec(bound=1.0, **(WIDE if wd == 128 else {}))


def _weights(wd, seed):
    spec = _spec(wd)
    field = tnet.FieldMLP(spec, generator=torch.Generator().manual_seed(seed))
    return spec, tfk.pack_weights(field, spec, CPU)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _field_run(libs, spec, pw, x, d):
    """The emulated field kernel on [3, n] inputs (a grid of two resident
    blocks) -> out [4, n]: sigma, r, g, b."""
    n = x.shape[1]
    out = np.full((4, n), np.nan, np.float32)
    fn = libs["field"].pienerf_field_eval
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    assert fn(_ptr(x), _ptr(d), _ptr(pw.numpy()), _ptr(out), n, spec.bound,
              int(spec.compute_dtype == "bfloat16"), tfk.kernel_width(spec),
              2, None) == 0
    return out


def _points(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    d = rng.randn(3, n).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [64, 128])
def test_emulated_field_kernel_matches_plain(libs, wd, dtype):
    """A ragged N over a grid of two resident blocks (bf16: whole warps,
    the padding points' MMAs run and their stores are masked)."""
    spec, pw = _weights(wd, 1)
    spec = spec._replace(compute_dtype=dtype)
    x, d = _points(2, 300)
    out = _field_run(libs, spec, pw, x, d)
    sigma, rgb = tfk.field_eval_plain(pw, spec, torch.from_numpy(x),
                                      torch.from_numpy(d))
    # the host's sinf and torch.sin may differ by an ulp, which the
    # double-angle ladder multiplies by up to 2^(n_freqs - 1); in bf16 the
    # tensor-core summation order against torch's can flip an activation's
    # bf16 rounding (on the card chip_smoke.py holds the bf16 kernel to an
    # rgb PSNR of 70 dB and a mean sigma relative error of 2e-3)
    tol = (1e-4, 1e-5) if dtype == "float32" else (1e-2, 1e-3)
    np.testing.assert_allclose(out[0], sigma.numpy(), rtol=tol[0])
    np.testing.assert_allclose(out[1:], rgb.numpy(), atol=tol[1])


@pytest.mark.parametrize("n", [300, 77, 1500])
@pytest.mark.parametrize("wd", [64, 128])
def test_emulated_f32_field_kernel_equals_per_point_chains(libs, wd, n):
    """The register-blocked f32 field kernel against the per-point FMA
    chains it replaced (field_point, field_points_wide): every output is
    the same chain in the same order, so the two agree bit for bit. A
    ragged N (300), one smaller than a block's pass (77), and one that
    takes the grid's two blocks round more than once (1500)."""
    spec, pw = _weights(wd, 11)
    x, d = _points(12, n)
    out = _field_run(libs, spec, pw, x, d)
    ref = np.full((4, n), np.nan, np.float32)
    fn = libs["field_ref"].field_ref
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int]
    assert fn(_ptr(x), _ptr(d), _ptr(pw.numpy()), _ptr(ref), n, spec.bound,
              wd) == 0
    assert np.isfinite(ref).all()
    np.testing.assert_array_equal(out, ref)


def test_emulated_wide_f32_field_kernel_equals_64_on_embedded_weights(libs):
    """The 64-wide net embedded in the 128-wide student (test_torch_wide's
    embed_wide): the zero padding adds exact zeros to every chain, so the
    Wd 128 f32 field kernel equals the Wd 64 one bit for bit."""
    from test_torch_wide import embed_wide
    spec64 = _spec(64)
    rng = np.random.RandomState(13)
    dims = ([51, 64, 64, 64, 16], [31, 64, 64, 3])
    params = {k: [rng.uniform(-1, 1, (a, b)).astype(np.float32)
                  * np.float32(np.sqrt(3.0 / a)) for a, b in zip(d, d[1:])]
              for k, d in zip(("sigma_net", "color_net"), dims)}
    pw64 = tfk.pack_weights(field_from_numpy(params, spec64, CPU), spec64,
                            CPU)
    pw128 = tfk.pack_weights(field_from_numpy(embed_wide(params), _spec(128),
                                              CPU), _spec(128), CPU)
    x, d = _points(14, 300)
    o64 = _field_run(libs, spec64, pw64, x, d)
    o128 = _field_run(libs, _spec(128), pw128, x, d)
    assert np.isfinite(o64).all() and o64[0].std() > 0
    np.testing.assert_array_equal(o128, o64)


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
for _f in ("sinf", "cosf", "expf"):
    getattr(_LIBM, _f).restype = ctypes.c_float
    getattr(_LIBM, _f).argtypes = [ctypes.c_float]


def _libm(name, v):
    """A libm function elementwise: the emulated kernels' own sinf, cosf and
    expf, which torch's CPU versions miss by an ulp on about 1% of
    inputs."""
    fn = getattr(_LIBM, name)
    return np.array([fn(float(a)) for a in np.ravel(v)],
                    np.float32).reshape(np.shape(v))


def _kernel_encoding(x, nf, d):
    """field_mlp.cuh's encode and sh4 in float32, step for step (libm
    sinf / cosf), rounded to bf16: the kernel's layer inputs exactly.
    x [3, n] with bound 1, d [3, n] -> (enc [3(1 + 2 nf), n], sh [16, n])."""
    f32 = np.float32
    rows = []
    for a in range(3):
        cn = x[a].astype(f32)
        s = _libm("sinf", f32(np.pi) * cn)
        co = _libm("cosf", f32(np.pi) * cn)
        sins, coss = [s], [co]
        for _ in range(nf - 1):
            s, co = f32(2.0) * s * co, co * co - s * s
            sins.append(s)
            coss.append(co)
        rows += [cn] + sins + coss
    X, Y, Z = (d[i].astype(f32) for i in range(3))
    xy, xz, yz, x2, y2, z2 = X * Y, X * Z, Y * Z, X * X, Y * Y, Z * Z
    C0, C1 = f32(0.28209479177387814), f32(0.48860251190291987)
    C20, C21, C22, C23 = (f32(c) for c in (
        1.0925484305920792, 0.94617469575755997, 0.31539156525251999,
        0.54627421529603959))
    C30, C31, C32, C33, C34 = (f32(c) for c in (
        0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
        0.3731763325901154, 1.4453057213202769))
    sh = [np.full_like(X, C0), -C1 * Y, C1 * Z, -C1 * X, C20 * xy,
          -C20 * yz, C21 * z2 - C22, -C20 * xz, C23 * (x2 - y2),
          C30 * Y * (f32(-3.0) * x2 + y2), C31 * xy * Z,
          C32 * Y * (f32(1.0) - f32(5.0) * z2),
          C33 * Z * (f32(5.0) * z2 - f32(3.0)),
          C32 * X * (f32(1.0) - f32(5.0) * z2), C34 * Z * (x2 - y2),
          C30 * X * (-x2 + f32(3.0) * y2)]
    return (torch.from_numpy(np.stack(rows)).bfloat16(),
            torch.from_numpy(np.stack(sh)).bfloat16())


def _routing_weights(wd, enc_dim, rng):
    """0/1 weights that route every layer input to a distinct output:
    sigma from an encoding feature, the 15 geo features from 15 more, r
    from a geo input of color layer 0, g from an SH input, b from either.
    Every sum has one nonzero term."""
    def inj(n_in, n_out):
        return rng.permutation(n_out)[:n_in]
    p0, p1, p2 = inj(enc_dim, wd), inj(wd, wd), inj(wd, wd)
    p4, p5 = inj(31, wd), inj(wd, wd)
    src_s = rng.permutation(enc_dim)[:16]        # head column j <- src_s[j]
    src_c = [16 + rng.randint(15), rng.randint(16)]
    src_c.append(rng.choice([i for i in range(31) if i not in src_c]))
    w = [np.zeros(s, np.float32) for s in (
        (enc_dim, wd), (wd, wd), (wd, wd), (wd, 16), (31, wd), (wd, wd),
        (wd, 3))]
    for li, p in ((0, p0), (1, p1), (2, p2), (4, p4), (5, p5)):
        w[li][np.arange(len(p)), p] = 1.0
    w[3][p2[p1[p0[src_s]]], np.arange(16)] = 1.0
    w[6][p5[p4[src_c]], np.arange(3)] = 1.0
    return {"sigma_net": w[:4], "color_net": w[4:]}


@pytest.mark.parametrize("wd", [64, 128])
def test_emulated_mma_routing_is_exact(libs, wd):
    """The permutation test of the tensor-core path: with 0/1 routing
    weights every sum has one nonzero term and every layer input is a bf16
    value, so summation order cannot matter and the bf16 field kernel
    must equal the plain chain exactly; a fragment-index error shows as a
    wrong column. The plain chain gets the kernel's own encoding (libm's
    sinf / cosf) and is compared before the activations, which the kernel
    takes with libm's expf; mlp_plain's own outputs are those activations
    in torch's arithmetic."""
    spec = _spec(wd)._replace(compute_dtype="bfloat16")
    rng = np.random.RandomState(7)
    x, d = _points(8, 70)
    x = torch.from_numpy(x).bfloat16().float().numpy()  # bf16-exact inputs
    enc, sh = _kernel_encoding(x, spec.n_freqs, d)
    for _ in range(3):
        pw = tfk.pack_weights(_routing_weights(wd, enc.shape[0], rng), spec,
                              CPU)
        out = _field_run(libs, spec, pw, x, d)
        # the plain chain (mlp_plain's), up to the activations
        pre = []
        for first, n, h in ((0, 4, torch.cat([enc, torch.zeros(
                (wd - enc.shape[0], x.shape[1]), dtype=torch.bfloat16)])),
                            (4, 3, None)):
            if h is None:
                h = torch.cat([sh, pre[0][1:16], torch.zeros(
                    (wd - 31, x.shape[1]), dtype=torch.bfloat16)])
            for li in range(n):
                w = pw[first + li].bfloat16().float()
                h = (w.T @ h.float()).bfloat16()
                h = torch.relu(h) if li != n - 1 else h
            pre.append(h)
        s_pre = torch.clamp(pre[0][0].float(), -15.0, 15.0).numpy()
        c_pre = pre[1][:3].float().numpy()
        sigma, rgb = tfk.mlp_plain(pw, spec, enc, sh)
        np.testing.assert_array_equal(
            sigma.numpy(), torch.exp(torch.from_numpy(s_pre)).numpy())
        np.testing.assert_array_equal(
            rgb.numpy(), torch.sigmoid(torch.from_numpy(c_pre)).numpy())
        assert (c_pre != 0).mean() > 0.3 and (s_pre != 0).mean() > 0.3
        np.testing.assert_array_equal(out[0], _libm("expf", s_pre))
        np.testing.assert_array_equal(
            out[1:], np.float32(1) / (np.float32(1) + _libm("expf", -c_pre)))


def _staged_layers(flat, enc_dim):
    """What stage_mma_weights stages from the pack ``flat`` [7, Wd, Wd]:
    layer l as [in16, out8] bf16 values, zero past its real extent, color
    layer 0's rows 16..30 moved to 17..31 behind a zero row."""
    wd = flat.shape[-1]
    ins = [enc_dim, wd, wd, wd, 31, wd, wd]
    outs = [wd, wd, wd, 16, wd, wd, 4]
    in16 = [64, wd, wd, wd, 32, wd, wd]
    out8 = [wd, wd, wd, 16, wd, wd, 8]
    w = flat.bfloat16().float().numpy()
    layers = []
    for li in range(7):
        e = np.zeros((in16[li], out8[li]), np.float32)
        blk = w[li, :ins[li], :outs[li]]
        if li == 4:
            e[:16, :outs[li]] = blk[:16]
            e[17:32, :outs[li]] = blk[16:]
        else:
            e[:ins[li], :outs[li]] = blk
        layers.append(e)
    return layers


@pytest.mark.parametrize("wd,paired", [(64, False), (128, False),
                                       (64, True)])
def test_emulated_wgmma_reads_back_every_staged_layer(libs, wd, paired):
    """Every layer of Net64 and Net128 (and Net64 from the paired pack),
    staged as the bf16 kernels stage it and read back through the
    emulated descriptor one k16 step at a time, equals its weight block in
    bf16 with the kernels' zero padding and color layer 0's shifted rows:
    the staged layout and the descriptor's strides agree."""
    spec = _spec(wd)
    field = tnet.FieldMLP(spec, generator=torch.Generator().manual_seed(21))
    flat = tfk.pack_weights(field, spec, CPU)
    pw = tfk.pack_weights_paired(field, spec, CPU) if paired else flat
    out = np.full((7, 128, 128), np.nan, np.float32)
    fn = libs["wgmma_ref"].wg_read_back
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    assert fn(_ptr(pw.numpy()), _ptr(out), wd, int(paired)) == 0
    enc_dim = 3 * (1 + 2 * spec.n_freqs)
    for li, e in enumerate(_staged_layers(flat, enc_dim)):
        got = out[li, :e.shape[0], :e.shape[1]]
        assert (e != 0).mean() > 0.2
        np.testing.assert_array_equal(got, e, err_msg=f"layer {li}")


@pytest.mark.parametrize("fault", ["none", "misstaged", "read_before_wait",
                                   "missing_warp", "no_fence"])
def test_emulated_wgmma_fault_gives_wrong_or_poisoned_result(libs, fault):
    """The emulation can fail the warpgroup MMA's rules: with B staged as
    the MMA's layout and every rule kept, warp 0 reads B back exactly;
    B staged row-major (a mis-staged layout) reads back wrong; the
    accumulators read before wait_group are NaN; a warpgroup one warp
    short deadlocks at the MMA, where a card would hang, and the launch
    fails with nothing written; an MMA without a wgmma.fence lands NaN."""
    w = np.random.RandomState(22).randn(16, 64).astype(np.float32)
    ref = torch.from_numpy(w).bfloat16().float().numpy()
    out = np.full((16, 64), np.nan, np.float32)
    fn = libs["wgmma_ref"].wg_fault_run
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    rc = fn(_ptr(w), _ptr(out), ["none", "misstaged", "read_before_wait",
                                 "missing_warp", "no_fence"].index(fault))
    assert rc == (0 if fault != "missing_warp" else 719)
    if fault == "none":
        np.testing.assert_array_equal(out, ref)
    elif fault == "misstaged":
        assert np.isfinite(out).all() and (out != ref).mean() > 0.5
    else:
        assert np.isnan(out).all()

def _tile_run(libs, spec, pw, args, kw, block_tiles=1, timed=False):
    """The emulated tile kernel as ``kernels.tile.render_tiles`` launches
    it: the paired library for a paired pack, the tiles padded to a
    multiple of ``block_tiles``. ``timed``: the timed instantiation, as
    ``render_tiles_timed`` launches it -> (out, cycles)."""
    paired = tfk.is_paired(spec, pw)
    A0 = args[0].shape[0]
    tile_sc, bin_start, dirs, cand = ttk._pad_tiles(
        block_tiles, args[0], args[1], args[3], args[4])
    a = [t.contiguous().numpy() for t in
         (tile_sc, bin_start, args[2], dirs, cand)]
    A, P = a[4].shape[0], a[4].shape[1]
    out = np.full((A, 8, ttk.T2), np.nan, np.float32)
    cycles = np.zeros((A, ttk.T2 // 32, ttk.SPLIT_COLS), np.int64)
    fn = (libs["tile_timed"].pienerf_render_tiles_timed if timed
          else libs["tile_paired"].pienerf_render_tiles_paired if paired
          else libs["tile_block"].pienerf_render_tiles_block
          if block_tiles > 1 else libs["tile"].pienerf_render_tiles)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * (
            2 if timed else 1)
    rc = fn(*(_ptr(t) for t in a), _ptr(pw.numpy()), _ptr(out), A,
            block_tiles, a[1].shape[1], P, kw["K"], kw["Ks"], kw["Ksb"],
            kw["Wn"], kw["num_seek"], spec.bound,
            int(spec.compute_dtype == "bfloat16"), int(kw["deformed"]),
            int(kw["cut"]), tfk.kernel_width(spec),
            *((_ptr(cycles),) if timed else ()), None)
    assert rc == 0
    return (out[:A0], cycles[:A0]) if timed else out[:A0]


def _tile_inputs(mode):
    """A twisted IP ball seen by a 32x32 frame (4 tiles, K = 8, Wn = 16),
    the kernel's inputs as the frame's own prep makes them."""
    c = np.arange(-0.3, 0.3 + 1e-6, 0.08, dtype=np.float32)
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    p = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], 1)
    p = p[np.linalg.norm(p, axis=1) <= 0.34]
    ang = 0.5 * p[:, 1]
    ca, sa = np.cos(ang), np.sin(ang)
    p_def = np.stack([ca * p[:, 0] + sa * p[:, 2], p[:, 1],
                      -sa * p[:, 0] + ca * p[:, 2]], 1).astype(np.float32)
    n = p.shape[0]
    F = np.zeros((n, 3, 3), np.float32)
    F[:, 0, 0] = ca; F[:, 0, 2] = sa; F[:, 1, 1] = 1.0
    F[:, 2, 0] = -sa; F[:, 2, 2] = ca
    ta = tuple(torch.from_numpy(a) for a in
               (p_def, p, F, np.zeros((n, 3, 3, 3), np.float32)))
    st = tint.InteractiveSettings(
        spec=_spec(64), bend=tbb.BeamBendSettings(num_seek_ip=3, ip_dx=0.084,
                                                  ips_per_tile=64),
        samples=8, active_frac=1.0, tile_chunk=2, bend_window=16,
        deformed=mode != "static", cut=mode == "cut", bound=1.0)
    pose = torch.eye(4)
    pose[2, 3] = -2.5
    intr = (40.0, 40.0, 16.0, 16.0)
    (_, o, bbmin, bbmax, ids, mask, _, _) = tint.active_tiles(
        st, ta[0], pose, intr, 32, 32, 2)
    return tint.tile_kernel_inputs(
        st, tbb.pack_ip_data_fast(*ta), ta[0], o, pose, intr, 32, 32, ids,
        mask, bbmin, bbmax, deformed=st.deformed, cut=st.cut,
        cut_bounds=torch.tensor([0.0, 0.5, -0.5, 0.5, -0.5, 0.5]))[:2]


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["deformed", "static", "cut"])
@pytest.mark.parametrize("wd", [64, 128])
def test_emulated_tile_kernel_matches_plain(libs, wd, mode, dtype):
    spec, pw = _weights(wd, 3)
    spec = spec._replace(compute_dtype=dtype)
    args, kw = _tile_inputs(mode)
    out = _tile_run(libs, spec, pw, args, kw)
    ref = ttk.render_tiles_plain(spec, pw, *args, **kw).numpy()
    assert ref[:, 4].max() > 0.1                  # real coverage
    # f32 summation order in the MLP and composite, and the host's sinf;
    # bf16 (the tensor-core path) adds flips of an activation's bf16
    # rounding where the two f32 sums differ by an ulp: 2.5e-4 at most
    # here, 102-120 dB, against the card's 80 dB limit
    atol = 1e-4 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(out[:, 0:5], ref[:, 0:5], atol=atol)
    assert _psnr(out[:, 0:3], ref[:, 0:3]) >= 90.0
    np.testing.assert_array_equal(out[:, 5], ref[:, 5])


@pytest.mark.parametrize("kernel", ["field", "tile"])
def test_emulated_huge_sigma_raw_renders_as_plain(libs, kernel):
    """Sigma head column 0 made positive and scaled to overflow: sigma_raw
    rounds to +inf in bf16 on most samples. The tensor-core path feeds the
    head tile to color layer 0 against a zero row, and 0 x inf would be
    NaN: the kernel clamps sigma_raw to sigma's own [-15, 15] first, so
    sigma and the geo path render as the plain version's."""
    spec, pw = _weights(64, 3)
    spec = spec._replace(compute_dtype="bfloat16")
    pw = pw.clone()
    pw[3, :, 0] = pw[3, :, 0].abs() / pw[3, :, 0].abs().max() * 3e38
    x, d = _points(9, 96)
    enc = tfk.encode_rows(tuple(torch.from_numpy(x)), spec, torch.bfloat16)
    h = torch.cat([enc, torch.zeros((64 - enc.shape[0], 96),
                                    dtype=torch.bfloat16)])
    for li in range(4):
        h = (pw[li].bfloat16().float().T @ h.float()).bfloat16()
        h = torch.relu(h) if li < 3 else h
    assert torch.isinf(h[0]).float().mean() > 0.5
    if kernel == "field":
        out = _field_run(libs, spec, pw, x, d)
        sigma, rgb = tfk.field_eval_plain(pw, spec, torch.from_numpy(x),
                                          torch.from_numpy(d))
        ref = np.concatenate([sigma.numpy()[None], rgb.numpy()])
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(out[1:], ref[1:], atol=1e-3)
    else:
        args, kw = _tile_inputs("deformed")
        out = _tile_run(libs, spec, pw, args, kw)
        ref = ttk.render_tiles_plain(spec, pw, *args, **kw).numpy()
        assert np.isfinite(out).all() and ref[:, 4].max() > 0.1
        np.testing.assert_allclose(out[:, 0:5], ref[:, 0:5], atol=2e-3)


def test_emulated_wide_tile_kernel_equals_64_on_embedded_weights(libs):
    """The 64-wide net embedded in the wide architecture: every output's
    sum is one FMA chain in input order, so the zero padding adds exact
    zeros and the two instantiations agree bit for bit."""
    from test_torch_wide import embed_wide
    spec64 = _spec(64)
    rng = np.random.RandomState(4)
    dims = ([51, 64, 64, 64, 16], [31, 64, 64, 3])
    params = {k: [rng.uniform(-1, 1, (a, b)).astype(np.float32)
                  * np.float32(np.sqrt(3.0 / a)) for a, b in zip(d, d[1:])]
              for k, d in zip(("sigma_net", "color_net"), dims)}
    pw64 = tfk.pack_weights(field_from_numpy(params, spec64, CPU), spec64,
                            CPU)
    pw128 = tfk.pack_weights(field_from_numpy(embed_wide(params), _spec(128),
                                              CPU), _spec(128), CPU)
    args, kw = _tile_inputs("deformed")
    o64 = _tile_run(libs, spec64, pw64, args, kw)
    o128 = _tile_run(libs, _spec(128), pw128, args, kw)
    assert o64[:, 4].max() > 0.1
    np.testing.assert_array_equal(o128, o64)


@pytest.mark.parametrize("mode,dtype", [
    ("deformed", "float32"), ("static", "float32"), ("cut", "float32"),
    ("deformed", "bfloat16"), ("static", "bfloat16"), ("cut", "bfloat16")])
def test_emulated_paired_tile_kernel_equals_unpaired(libs, mode, dtype):
    """The paired instantiation reads the block-diagonal pack, runs each
    sample's sigma chain beside the previous sample's color chain and
    composites rgb one segment late; every sum keeps its order, so the
    output is the default schedule's bit for bit, and within the f32
    summation-order tolerance of the paired plain version. In bf16 each
    pass runs this sample's sigma chain and the pending sample's color
    chain through the same tensor-core layers as the default schedule."""
    spec = _spec(64)._replace(compute_dtype=dtype)
    field = tnet.FieldMLP(spec, generator=torch.Generator().manual_seed(3))
    pw = tfk.pack_weights(field, spec, CPU)
    pwp = tfk.pack_weights_paired(field, spec, CPU)
    args, kw = _tile_inputs(mode)
    ref = _tile_run(libs, spec, pw, args, kw)
    out = _tile_run(libs, spec, pwp, args, kw)
    assert ref[:, 4].max() > 0.1
    np.testing.assert_array_equal(out, ref)
    if dtype == "float32":
        plain = ttk.render_tiles_plain(spec, pwp, *args, **kw).numpy()
        np.testing.assert_allclose(out[:, 0:5], plain[:, 0:5], atol=1e-4)
        np.testing.assert_array_equal(out[:, 5], plain[:, 5])


@pytest.mark.parametrize("mode,wd,paired,dtype", [
    ("deformed", 64, False, "float32"), ("static", 128, False, "float32"),
    ("cut", 64, True, "float32"), ("deformed", 64, False, "bfloat16"),
    ("static", 128, False, "bfloat16"), ("cut", 64, True, "bfloat16")])
def test_emulated_block_tiles_equals_one_tile_per_block(libs, mode, wd,
                                                        paired, dtype):
    """B = 3 over 4 tiles (one padded slot, two blocks): each block
    re-zeroes its per-tile state and stages the weights once (f32: the
    64-wide net; bf16: either)."""
    spec = _spec(wd)._replace(compute_dtype=dtype)
    field = tnet.FieldMLP(spec, generator=torch.Generator().manual_seed(3))
    pw = (tfk.pack_weights_paired if paired else tfk.pack_weights)(
        field, spec, CPU)
    args, kw = _tile_inputs(mode)
    assert args[0].shape[0] % 3 != 0
    ref = _tile_run(libs, spec, pw, args, kw)
    out = _tile_run(libs, spec, pw, args, kw, block_tiles=3)
    assert ref[:, 4].max() > 0.1
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("schedule", ["default", "block"])
@pytest.mark.parametrize("mode", ["deformed", "static", "cut"])
@pytest.mark.parametrize("wd", [64, 128])
def test_emulated_f32_tile_kernel_equals_per_point_chains(libs, wd, mode,
                                                          schedule):
    """The f32 tile kernel's register-blocked MLP (f32_sample: one sample
    of each of the block's 256 rays a pass through field_f32.cuh's layers)
    against the per-point FMA chains it replaced (TILE_REF_KERNEL through
    PER_POINT_CUH's field_point and field_points_wide): every output is the
    same chain in the same order, so the two agree bit for bit, in every
    mode at both widths, one tile a block and three (block_tiles: Net64's
    weights staged once, Net128's chunks streamed on across the tiles, one
    slot padded)."""
    spec, pw = _weights(wd, 5)
    args, kw = _tile_inputs(mode)
    B = 3 if schedule == "block" else 1
    out = _tile_run(libs, spec, pw, args, kw, block_tiles=B)
    ref = _tile_ref_run(libs, spec, pw, args, kw, block_tiles=B)
    assert ref[:, 4].max() > 0.1 and np.isfinite(ref).all()
    np.testing.assert_array_equal(out, ref)


def _tile_ref_run(libs, spec, pw, args, kw, block_tiles=1):
    """The tile kernel before the one-pass scan (TILE_REF_KERNEL, commit
    db7d684), emulated, launched as
    ``_tile_run`` launches the kernel."""
    A0 = args[0].shape[0]
    tile_sc, bin_start, dirs, cand = ttk._pad_tiles(
        block_tiles, args[0], args[1], args[3], args[4])
    a = [t.contiguous().numpy() for t in
         (tile_sc, bin_start, args[2], dirs, cand)]
    A, P = a[4].shape[0], a[4].shape[1]
    out = np.full((A, 8, ttk.T2), np.nan, np.float32)
    fn = libs["tile_ref"].tile_ref
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + [ctypes.c_int] * 5
    assert fn(*(_ptr(t) for t in a), _ptr(pw.numpy()), _ptr(out), A,
              block_tiles, a[1].shape[1], P, kw["K"], kw["Ks"], kw["Ksb"],
              kw["Wn"], kw["num_seek"], spec.bound,
              int(spec.compute_dtype == "bfloat16"), int(kw["deformed"]),
              int(kw["cut"]), tfk.kernel_width(spec),
              int(tfk.is_paired(spec, pw))) == 0
    return out[:A0]


def _crafted_tile_inputs(feature, Wn, Ksb, num_seek, mode, seed):
    """Kernel inputs that make the window scan choose among rows on
    purpose: three tiles of 256 rays from (0, 0, -2.5) into the unit box, K
    = 8 samples a ray, P = 2 Wn candidates a tile scattered over the
    samples (not depth-sorted: rows outside a sub-segment's [lo, hi) lie as
    near as the rows inside), one Newton row each (p_ori, F^-1 near the
    identity), and bin counts drawn per ``feature``:

    ties      every odd row repeats the row before it (equal distances)
    invalid   a third of the rows invalid, interleaved with valid ones
    outside   0-2 candidates a bin: most staged rows outside [lo, hi)
    few       mostly empty bins: fewer rows in range than num_seek
    none      one tile with no candidate, one whose rows are all invalid,
              and a short reach (halo 1): sub-segments with nothing in range
    nan       a NaN direction on one ray (NaN sample positions), a NaN p_def
              on one valid row
    overflow  5-20 candidates a bin: [lo, hi) wider than Wn, the drops
              counted
    exit      a dense field and K = 16: tiles exit early, dropping the
              window issued for their next segment
    chunks    (Ksb 8) two window passes a sub-segment
    """
    rng = np.random.RandomState(seed)
    A, K = 3, 16 if feature == "exit" else 8
    Ks = max(4, Ksb)
    P = 2 * Wn
    uv = rng.uniform(-0.15, 0.15, (A, 2, ttk.T2)).astype(np.float32)
    d = np.concatenate([uv, np.ones((A, 1, ttk.T2), np.float32)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dirs = np.zeros((A, 8, ttk.T2), np.float32)
    dirs[:, :3] = d
    tile_sc = np.zeros((A, 8), np.float32)
    tile_sc[:, 0], tile_sc[:, 1], tile_sc[:, 2] = 2.0, 3.0, 1.0
    p_def = np.stack([rng.uniform(-0.45, 0.45, (A, P)),
                      rng.uniform(-0.45, 0.45, (A, P)),
                      rng.uniform(-0.55, 0.55, (A, P))], -1)
    if feature == "ties":
        p_def[:, 1::2] = p_def[:, 0::2]
    cand = np.zeros((A, P, 16), np.float32)
    cand[..., 0:3] = p_def
    cand[..., 3:6] = p_def + rng.normal(0.0, 0.02, (A, P, 3))
    cand[..., 6:15] = (np.eye(3).ravel()
                       + rng.normal(0.0, 0.05, (A, P, 9)))
    cand[..., 15] = 1.0
    if feature == "invalid":
        cand[..., 15] = rng.rand(A, P) >= 1.0 / 3.0
    hi_bin = {"outside": 3, "few": 2, "overflow": 21}.get(feature, 6)
    lo_bin = 5 if feature == "overflow" else 0
    counts = rng.randint(lo_bin, hi_bin, (A, K + 2))
    if feature == "few":
        counts *= rng.rand(A, K + 2) < 0.3
    bs = np.zeros((A, K + 4), np.int32)
    bs[:, 1:K + 3] = np.minimum(np.cumsum(counts, 1), P)
    bs[:, K + 3] = bs[:, K + 2]
    reach = 0.25
    if feature == "none":
        bs[0] = 0
        cand[1, :, 15] = 0.0
        reach = 0.1
    if feature == "nan":
        dirs[0, 0, 5] = np.nan
        cand[1, 3, 0:3] = np.nan
    params = np.zeros(24, np.float32)
    params[0:3] = (0.0, 0.0, -2.5)
    params[3:6], params[6:9] = -1.0, 1.0            # march bbox
    params[9] = 1e-4                                 # T_thresh
    params[10] = 1e3 if feature == "exit" else 0.02  # density scale
    params[11] = 0.2                                 # ip_dx
    params[12] = 0.05                                # min_near
    params[13:19] = (-0.1, 0.5, -0.5, 0.5, -0.3, 0.6)  # cut box
    params[19] = 0.5                                 # t_jitter
    params[20] = reach
    args = tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in
                 (tile_sc, bs, params, dirs, cand))
    kw = dict(K=K, Ks=Ks, Ksb=Ksb, Wn=Wn, num_seek=num_seek,
              deformed=mode != "static", cut=mode == "cut")
    return args, kw


@pytest.mark.parametrize("feature,num_seek,Ksb,Wn,mode,dtype,schedule,wd", [
    ("ties", 3, 4, 16, "deformed", "float32", "default", 64),
    ("ties", 2, 2, 64, "cut", "bfloat16", "paired", 64),
    ("invalid", 3, 4, 64, "deformed", "bfloat16", "default", 64),
    ("invalid", 1, 1, 16, "cut", "float32", "block", 64),
    ("outside", 2, 4, 16, "deformed", "bfloat16", "block", 128),
    ("outside", 3, 2, 64, "cut", "float32", "default", 64),
    ("few", 3, 4, 16, "deformed", "float32", "paired", 64),
    ("few", 2, 1, 64, "cut", "bfloat16", "default", 128),
    ("none", 3, 2, 16, "deformed", "bfloat16", "default", 64),
    ("none", 1, 4, 16, "cut", "float32", "paired", 64),
    ("nan", 3, 4, 16, "deformed", "float32", "default", 128),
    ("nan", 2, 4, 64, "cut", "bfloat16", "block", 64),
    ("overflow", 3, 4, 16, "deformed", "bfloat16", "paired", 64),
    ("overflow", 1, 2, 16, "cut", "float32", "default", 64),
    ("exit", 3, 4, 16, "deformed", "bfloat16", "block", 64),
    ("exit", 2, 2, 16, "cut", "float32", "paired", 64),
    ("chunks", 3, 8, 16, "deformed", "float32", "default", 64),
    ("chunks", 2, 8, 64, "cut", "bfloat16", "block", 128),
    ("outside", 3, 4, 16, "static", "bfloat16", "paired", 64),
])
def test_emulated_tile_scan_equals_argmin_passes(libs, feature, num_seek,
                                                 Ksb, Wn, mode, dtype,
                                                 schedule, wd):
    """The one-pass window scan against the num_seek argmin passes it
    replaced (TILE_REF_KERNEL) on crafted windows: bit for bit, every
    output row, in every mode, dtype and schedule (the static march, which
    has no scan, once)."""
    spec = _spec(wd)._replace(compute_dtype=dtype)
    field = tnet.FieldMLP(spec, generator=torch.Generator().manual_seed(3))
    pw = (tfk.pack_weights_paired if schedule == "paired"
          else tfk.pack_weights)(field, spec, CPU)
    args, kw = _crafted_tile_inputs(feature, Wn, Ksb, num_seek, mode,
                                    seed=num_seek * 100 + Ksb * 10 + Wn)
    B = 2 if schedule == "block" else 1
    out = _tile_run(libs, spec, pw, args, kw, block_tiles=B)
    ref = _tile_ref_run(libs, spec, pw, args, kw, block_tiles=B)
    np.testing.assert_array_equal(out, ref)
    assert np.isfinite(ref[:, 4]).any() and ref[:, 4].max() > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode,wd", [("deformed", 64), ("cut", 64),
                                     ("deformed", 128), ("cut", 128)])
def test_emulated_timed_tile_kernel_equals_untimed(libs, mode, wd, dtype):
    """The timed instantiation (either dtype) adds clock reads and nothing
    else: its output equals the untimed kernel's bit for bit. Every active
    tile's warps count cycles in every phase it ran (the emulated clock
    ticks once a read), the phases add up to no more than the tile's
    total, its global-timer span is positive, and inactive slots stay
    zero."""
    spec, pw = _weights(wd, 3)
    spec = spec._replace(compute_dtype=dtype)
    args, kw = _tile_inputs(mode)
    ref = _tile_run(libs, spec, pw, args, kw)
    out, cyc = _tile_run(libs, spec, pw, args, kw, timed=True)
    np.testing.assert_array_equal(out, ref)
    active = args[0][:, 2].numpy() > 0
    assert active.any()
    n_ph = len(ttk.SPLIT_PHASES)
    c = cyc[active]
    assert (c[..., :n_ph] > 0).all()
    assert (c[..., :n_ph].sum(-1) <= c[..., n_ph]).all()
    assert (c[..., n_ph + 2] > c[..., n_ph + 1]).all()
    assert not cyc[~active].any()


def _compaction_tile_inputs(mode, Ksb=4):
    """Seven tiles whose sample groups (up to 4 samples of every ray, the
    f32 kernel's unit of compaction) hold as many live samples as the
    compaction has cases, K = 16 in two segments, from (0, 0, -2.5) into
    the box [-1, 1]^3, every bin holding candidates, ip_dx 100 (every
    sample with a row in reach is found), T_thresh 0.5:

    0  every ray misses the box: no live slot, no MLP pass
    1  every ray in range and a short march (dt 0.005): every group full,
       1,024 live slots
    2  64 rays in range and one (ray 64) that leaves the box between its
       first and second sample: its first group 257 live slots (a second
       pass of one point), the rest miss
    3  a long march (dt 0.1125) at density scale 4: rays die in the middle
       of groups, their later groups not live
    4  every candidate row with p_ori +-3e38 and F^-1 0 (the bending modes'
       blend overflows: NaN and infinite bent positions, found) and a NaN
       direction on ray 7
    5  half the rays in range, half missing
    6  directions up to 0.6 off the axis: rays leave the box mid-march
    With block_tiles 3 the blocks hold tiles of different counts."""
    rng = np.random.RandomState(11)
    A, K, Wn = 7, 16, 16
    P = 2 * Wn
    inside = np.stack([rng.uniform(-0.1, 0.1, (A, ttk.T2)),
                       rng.uniform(-0.1, 0.1, (A, ttk.T2)),
                       np.ones((A, ttk.T2))], 1)
    away = np.stack([rng.uniform(-1, 1, (A, ttk.T2)),
                     rng.uniform(-1, 1, (A, ttk.T2)),
                     -np.ones((A, ttk.T2))], 1)
    d = inside.copy()
    d[0] = away[0]
    d[2, :, 65:] = away[2, :, 65:]
    d[2, :, 64] = (1 / 2.06, 0.0, np.sqrt(1 - (1 / 2.06) ** 2))
    d[5, :, 128:] = away[5, :, 128:]
    d[6, 0:2] = rng.uniform(-0.6, 0.6, (2, ttk.T2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dirs = np.zeros((A, 8, ttk.T2), np.float32)
    dirs[:, :3] = d
    dirs[4, :3, 7] = np.nan
    tile_sc = np.zeros((A, 8), np.float32)
    tile_sc[:, 0], tile_sc[:, 1], tile_sc[:, 2] = 1.6, 3.4, 1.0
    tile_sc[1, 0:2] = (2.0, 2.08)
    tile_sc[2, 0:2] = (2.0, 3.0)
    p_def = np.stack([rng.uniform(-0.3, 0.3, (A, P)),
                      rng.uniform(-0.3, 0.3, (A, P)),
                      rng.uniform(-0.9, 0.9, (A, P))], -1)
    cand = np.zeros((A, P, 16), np.float32)
    cand[..., 0:3] = p_def
    cand[..., 3:6] = p_def + rng.normal(0.0, 0.02, (A, P, 3))
    cand[..., 6:15] = np.eye(3).ravel()
    cand[..., 15] = 1.0
    cand[4, :, 3:6] = np.where(np.arange(P) % 2 == 0, 3e38, -3e38)[:, None]
    cand[4, :, 6:15] = 0.0
    counts = rng.randint(1, 4, (A, K + 2))
    bs = np.zeros((A, K + 4), np.int32)
    bs[:, 1:K + 3] = np.minimum(np.cumsum(counts, 1), P)
    bs[:, K + 3] = bs[:, K + 2]
    params = np.zeros(24, np.float32)
    params[0:3] = (0.0, 0.0, -2.5)
    params[3:6], params[6:9] = -1.0, 1.0            # march bbox
    params[9] = 0.5                                  # T_thresh
    params[10] = 4.0                                 # density scale
    params[11] = 100.0                               # ip_dx
    params[12] = 0.05                                # min_near
    params[13:19] = (-0.1, 0.5, -0.5, 0.5, -0.3, 0.6)  # cut box
    params[19] = 0.5                                 # t_jitter
    params[20] = 0.25                                # reach
    args = tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in
                 (tile_sc, bs, params, dirs, cand))
    kw = dict(K=K, Ks=8, Ksb=Ksb, Wn=Wn, num_seek=3,
              deformed=mode != "static", cut=mode == "cut")
    return args, kw


def _live_groups(spec, pw, args, kw, T_thresh=None):
    """The plain twin's count of each executed group's live samples:
    {(tile, first sample): n} and its stats; T_thresh 0 counts as if no
    ray died."""
    if T_thresh is not None:
        params = args[2].clone()
        params[9] = T_thresh
        args = args[:2] + (params,) + args[3:]
    st = {"groups": []}
    ttk.render_tiles_plain(spec, pw, *args, **kw, stats=st)
    return {(a, k): n for a, k, n in st.pop("groups")}, st


@pytest.mark.parametrize("schedule", ["default", "block"])
@pytest.mark.parametrize("mode", ["deformed", "static", "cut"])
@pytest.mark.parametrize("wd", [64, 128])
def test_emulated_f32_tile_compaction_equals_marching_every_sample(
        libs, wd, mode, schedule):
    """The f32 kernel runs only each group's live samples through the MLP,
    packed into passes of 256 points; marching every sample
    (TILE_REF_KERNEL) gives the same output bit for bit, in every mode at
    both widths, one tile a block and three, on crafted groups: none live
    (no pass, no deadlock), all 1,024 live, 257 live (a second pass of
    one point), rays that die inside a group, rays that miss the box, NaN
    and infinite bent positions, and blocks whose tiles differ in count."""
    spec, pw = _weights(wd, 5)
    args, kw = _compaction_tile_inputs(mode)
    B = 3 if schedule == "block" else 1
    out = _tile_run(libs, spec, pw, args, kw, block_tiles=B)
    ref = _tile_ref_run(libs, spec, pw, args, kw, block_tiles=B)
    np.testing.assert_array_equal(out, ref)
    # the groups are as crafted
    groups, _ = _live_groups(spec, pw, args, kw)
    per_tile = {a: [n for (t, _), n in groups.items() if t == a]
                for a in range(7)}
    assert per_tile[0] and not any(per_tile[0])
    assert per_tile[1] == [1024] * 4
    assert groups[2, 0] == 257
    undead, _ = _live_groups(spec, pw, args, kw, T_thresh=0.0)
    assert sum(per_tile[3]) < sum(n for (t, _), n in undead.items()
                                  if t == 3)
    assert 0 < sum(per_tile[5]) <= 512 * len(per_tile[5])
    # the non-finite bent positions go through the MLP (whose ReLU takes
    # NaN to 0) as the reference's do
    assert sum(per_tile[4]) > 0 and ref[:, 4].max() > 0.3


@pytest.mark.parametrize("inputs", ["frame", "crafted"])
@pytest.mark.parametrize("mode,wd", [("deformed", 64), ("cut", 64),
                                     ("deformed", 128), ("cut", 128)])
def test_emulated_timed_tile_kernel_counts_live_points(libs, mode, wd,
                                                       inputs):
    """The f32 timed instantiation's count of the points its MLP evaluated
    and the passes it ran, per tile (the same in every warp's record),
    against the plain twin's: a group's samples with vmask on a ray still
    alive at the group's start, summed over the executed groups, and
    ceil(n / 256) passes a group. bf16 counts nothing. The crafted tile of
    NaN bent positions is left out here: the plain twin's ReLU keeps a NaN
    that the kernel's fmaxf takes to 0, so the two disagree on when its
    rays die (the kernel's output on it is held to the reference's in
    test_emulated_f32_tile_compaction_equals_marching_every_sample)."""
    spec, pw = _weights(wd, 3)
    if inputs == "frame":
        args, kw = _tile_inputs(mode)
    else:
        args, kw = _compaction_tile_inputs(mode)
        keep = torch.tensor([0, 1, 2, 3, 5, 6])
        args = tuple(a if i == 2 else a[keep].contiguous()
                     for i, a in enumerate(args))
    _, cyc = _tile_run(libs, spec, pw, args, kw, timed=True)
    _, st = _live_groups(spec, pw, args, kw)
    col = len(ttk.SPLIT_PHASES) + 3
    assert (cyc[..., col:] == cyc[:, :1, col:]).all()
    assert st["points"] > 0
    assert int(cyc[:, 0, col].sum()) == st["points"]
    assert int(cyc[:, 0, col + 1].sum()) == st["passes"]
    _, cyc16 = _tile_run(libs, spec._replace(compute_dtype="bfloat16"), pw,
                         args, kw, timed=True)
    assert not cyc16[..., col:].any()


# A hash grid with the published net's 16 levels x 2 features at a size the
# emulation runs: levels 0-1 dense ((2 + 1)^3 and (4 + 1)^3 rows fit their
# 32 and 128), levels 2-15 hashed into 128 rows each. Its per-level scale
# is 2 (desired_resolution 2 x 2^15), so the levels' scales 2^(l + 1) - 1
# are odd integers and a coordinate at the box's centre lies on a cell
# face at every level.
GRID_KW = dict(num_levels=16, level_dim=2, base_resolution=2,
               log2_hashmap_size=7, desired_resolution=65536)


def _grid_weights(seed, bound=0.25):
    """A seeded hash-grid field (its table drawn in [-1, 1], so that the
    encoding matters) and its GridPack. At ``bound`` 0.25 the frame's IP
    ball (radius 0.34) reaches past the grid's box: some samples lie
    outside it."""
    from pienerf_tpu_torch.models import hash_encoder
    spec = tnet.make_spec(bound=bound, backbone="hashgrid")._replace(
        grid=hash_encoder.make_spec(**GRID_KW))
    gen = torch.Generator().manual_seed(seed)
    field = tnet.FieldMLP(spec, generator=gen)
    field.encoder.data = torch.rand(field.encoder.shape,
                                    generator=gen) * 2 - 1
    return spec, tfk.pack_weights(field, spec, CPU)


def _grid_inputs(mode):
    """``_tile_inputs``' frame with the first 8 rays of every tile along +z
    from the camera at (0, 0, -2.5): their unbent samples have x = y = 0,
    on a cell face of every level."""
    args, kw = _tile_inputs(mode)
    dirs = args[3].clone()
    dirs[:, 0:3, :8] = torch.tensor([0.0, 0.0, 1.0])[None, :, None]
    return args[:3] + (dirs,) + args[4:], kw


def _grid_run(libs, spec, pw, args, kw, counters=None):
    """The emulated hash-grid tile kernel as ``render_tiles`` launches it
    -> out [A, 8, 256]; ``counters`` (int64 [4]) is its counter buffer."""
    a = [t.contiguous().numpy() for t in args]
    A, P = a[4].shape[0], a[4].shape[1]
    out = np.full((A, 8, ttk.T2), np.nan, np.float32)
    fn = libs["tile_grid"].pienerf_render_tiles_grid
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    table = pw.table.contiguous().numpy()
    rc = fn(*(_ptr(t) for t in a), _ptr(pw.numpy()), _ptr(out), A, 1,
            a[1].shape[1], P, kw["K"], kw["Ks"], kw["Ksb"], kw["Wn"],
            kw["num_seek"], spec.bound, int(kw["deformed"]), int(kw["cut"]),
            _ptr(table), _ptr(ttk.grid_levels(spec.grid)),
            None if counters is None else _ptr(counters), None)
    assert rc == 0
    return out


def _round_mantissa(t, drop):
    """``t`` (f32) rounded to nearest with its low ``drop`` mantissa bits
    cleared: 16 leaves bf16's 7 bits, 13 TF32's 10."""
    i = t.contiguous().view(torch.int32)
    half = 1 << (drop - 1)
    return ((i + half) & ~((1 << drop) - 1)).view(torch.float32)


# the hash-grid kernel against its plain twin: the encoding is the same
# arithmetic in the same order (each product rounded before its sum, the
# 8 corners summed in corner order, as torch sums the plain version's
# stacked corners), so the gap is the f32 MLP's summation order (the
# kernel's FMA chains against torch's products): 1.2e-7 at most here.
# 2e-6 holds it with room; the same weights and table rounded to TF32
# (1.6e-5 or more here) or bf16 (1.6e-4) move the output by more (asserted)
GRID_ATOL = 2e-6


@pytest.mark.parametrize("mode", ["deformed", "static", "cut"])
def test_emulated_grid_tile_kernel_matches_plain(libs, mode):
    """torch-ngp's hash-grid net in the tile kernel (16 levels x 2
    features, dense and hashed levels, samples on cell faces and outside
    the grid's box) against ``render_tiles_plain``, which encodes with
    ``hash_encoder.encode``, in every mode."""
    spec, pw = _grid_weights(7)
    args, kw = _grid_inputs(mode)
    out = _grid_run(libs, spec, pw, args, kw)
    st = {}
    ref = ttk.render_tiles_plain(spec, pw, *args, **kw, stats=st).numpy()
    assert ref[:, 4].max() > 0.1                  # real coverage
    assert 0 < st["inside"] < st["points"]         # both sides of the box
    np.testing.assert_allclose(out[:, 0:5], ref[:, 0:5], atol=GRID_ATOL)
    np.testing.assert_array_equal(out[:, 5], ref[:, 5])
    for drop in (16, 13):                          # bf16, TF32
        rounded = tfk.GridPack(_round_mantissa(pw, drop),
                               _round_mantissa(pw.table, drop))
        ctl = ttk.render_tiles_plain(spec, rounded, *args, **kw).numpy()
        assert np.abs(ctl[:, 0:5] - ref[:, 0:5]).max() > GRID_ATOL, drop


@pytest.mark.parametrize("mode", ["deformed", "static"])
def test_emulated_grid_counters_count_the_encode(libs, mode):
    """With a counter buffer the hash-grid kernel adds, once per block, the
    samples it encoded (the points its MLP evaluated: the plain twin's
    ``points``), the table rows they read (16 levels x 8 corners for each
    inside the grid's box, none outside) and its warps' cycles in the
    encode stage and in the whole tile; its output is the one it gives
    without the buffer, bit for bit."""
    spec, pw = _grid_weights(7)
    args, kw = _grid_inputs(mode)
    ctr = np.zeros(4, np.int64)
    out = _grid_run(libs, spec, pw, args, kw, counters=ctr)
    np.testing.assert_array_equal(out, _grid_run(libs, spec, pw, args, kw))
    st = {}
    ttk.render_tiles_plain(spec, pw, *args, **kw, stats=st)
    enc, tile, samples, rows = ctr.tolist()
    assert samples == st["points"] > 0
    assert 0 < st["inside"] < samples
    assert rows == 16 * 8 * st["inside"]
    assert 0 < enc < tile


def _fetch_run(libs, which, table, idx):
    """The emulated fetch kernel ``which`` -> out [B, 128] (NaN where it
    wrote nothing)."""
    T, B = table.shape[0], idx.shape[0]
    out = np.full((B, tpr.ROW), np.nan, np.float32)
    fn = libs["probes"].pienerf_fetch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    nbytes = libs["probes"].pienerf_onehot_scratch_bytes
    nbytes.restype = ctypes.c_longlong
    nbytes.argtypes = [ctypes.c_int]
    scratch = np.full(nbytes(T), 0xff, np.uint8)
    assert fn(tpr.FETCHES.index(which), _ptr(table), _ptr(idx), _ptr(out),
              _ptr(scratch), T, B, 1, None) == 0
    return out


def _fetch_ref(table, idx):
    """fetch_plain, with zero rows for indices outside [0, T)."""
    ok = (idx >= 0) & (idx < table.shape[0])
    ref = np.zeros((idx.shape[0], tpr.ROW), np.float32)
    ref[ok] = tpr.fetch_plain(torch.from_numpy(table),
                              torch.from_numpy(idx[ok])).numpy()
    return ref


@pytest.mark.parametrize("which", tpr.FETCHES)
def test_emulated_fetch_kernels_equal_plain(libs, which):
    """All four fetch mechanisms run emulated (the dma arm's bulk copies
    landing at their mbarrier waits): exact rows, a table whose row count
    is no multiple of the one-hot chunk, and zero rows for indices outside
    it."""
    rng = np.random.RandomState(5)
    T, B = 300, 1024
    table = rng.randn(T, tpr.ROW).astype(np.float32)
    idx = rng.randint(0, T, B).astype(np.int32)
    idx[7], idx[600] = T, -1
    np.testing.assert_array_equal(_fetch_run(libs, which, table, idx),
                                  _fetch_ref(table, idx))


@pytest.mark.parametrize("B", [512, 1536])
@pytest.mark.parametrize("T", [1, 300, 4096])
@pytest.mark.parametrize("which", ["dma", "dynslice"])
def test_emulated_serial_fetches_equal_plain(libs, which, T, B):
    """The two serial arms over table sizes from one row to more rows than
    the block fetches, and one block or three: every warp's ring (dma)
    turns over its whole share, and indices outside [0, T) on each side
    give zero rows."""
    rng = np.random.RandomState(T + B)
    table = rng.randn(T, tpr.ROW).astype(np.float32)
    idx = rng.randint(0, T, B).astype(np.int32)
    idx[rng.randint(0, B, 9)] = np.array([T, -1, T + 5, 1 << 30, -7, T, -1,
                                          T, -1], np.int32)
    np.testing.assert_array_equal(_fetch_run(libs, which, table, idx),
                                  _fetch_ref(table, idx))


@pytest.mark.parametrize("which", tpr.FETCHES)
def test_emulated_fetch_block_all_outside_gives_zeros(libs, which):
    """A block whose 512 indices all lie outside [0, T) completes (no
    mbarrier phase is left waiting: every slot arrives without bytes) and
    writes zero rows; the next block fetches as usual."""
    rng = np.random.RandomState(16)
    T = 64
    table = rng.randn(T, tpr.ROW).astype(np.float32)
    idx = rng.randint(0, T, 1024).astype(np.int32)
    idx[:512] = np.where(rng.rand(512) < 0.5, -1 - rng.randint(0, 9, 512),
                         T + rng.randint(0, 9, 512))
    out = _fetch_run(libs, which, table, idx)
    assert not out[:512].any()
    np.testing.assert_array_equal(out, _fetch_ref(table, idx))


def test_emulated_tile_window_read_before_wait_sees_poison(libs):
    """The tile kernel's window goes on one bulk copy (window_issue): a
    read of the buffer before the wait on its mbarrier phase reads the NaN
    poison, and after it the candidate rows."""
    Wn = 16
    rows = np.random.RandomState(19).randn(Wn, 16).astype(np.float32)
    early = np.zeros((Wn, 16), np.float32)
    late = np.zeros((Wn, 16), np.float32)
    fn = libs["tile_ref"].window_read_run
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
    assert fn(_ptr(rows), Wn, _ptr(early), _ptr(late)) == 0
    assert np.isnan(early).all()
    np.testing.assert_array_equal(late, rows)


def test_emulated_mbarrier_read_before_wait_sees_poison(libs):
    """The emulation can fail a missing mbarrier wait: a slot read before
    the wait on its bulk load's phase reads the NaN poison, and after the
    wait the row."""
    row = np.random.RandomState(17).randn(tpr.ROW).astype(np.float32)
    early = np.zeros(tpr.ROW, np.float32)
    late = np.zeros(tpr.ROW, np.float32)
    fn = libs["mbar_ref"].mbar_read
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3
    assert fn(_ptr(row), _ptr(early), _ptr(late)) == 0
    assert np.isnan(early).all()
    np.testing.assert_array_equal(late, row)


@pytest.mark.parametrize("wait_read", [1, 0])
def test_emulated_bulk_store_reads_at_wait_read(libs, wait_read):
    """A bulk store reads its slot at the bulk_wait_read that retires its
    group: with the wait before the slot is overwritten it stores the row;
    without it the store reads at the thread's end and stores what
    overwrote the slot, so a slot reused too early shows."""
    row = np.random.RandomState(18).randn(tpr.ROW).astype(np.float32)
    out = np.full(tpr.ROW, np.nan, np.float32)
    fn = libs["mbar_ref"].bulk_store_overwrite
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    assert fn(_ptr(row), _ptr(out), wait_read) == 0
    np.testing.assert_array_equal(
        out, row if wait_read else np.full(tpr.ROW, -1.0, np.float32))


def test_emulated_onehot_split_is_exact_at_extreme_exponents(libs):
    """The tensor-core one-hot fetch splits every table value into three
    bf16 parts: exact for every finite value on bf16's grid. The table
    holds full 24-bit significands from 2^-110 to 2^127 (FLT_MAX, which
    a rounded top part would turn into inf, included), FLT_MIN, the f32
    subnormals on bf16's grid (multiples of 2^-133), signed zeros, and the
    row count is no multiple of the k16 tile."""
    rng = np.random.RandomState(15)
    T, B = 300, 1024
    sig = rng.randint(1 << 23, 1 << 24, (T, tpr.ROW)).astype(np.float64)
    exp = rng.randint(-110, 104, (T, tpr.ROW))
    table = (np.where(rng.rand(T, tpr.ROW) < 0.5, -1.0, 1.0) * sig
             * np.exp2(exp - 23.0)).astype(np.float32)
    f32 = np.finfo(np.float32)
    special = np.array([f32.max, -f32.max, f32.tiny, -f32.tiny,
                        np.float32(2.0 ** 127), 0.0, -0.0]
                       + [k * 2.0 ** -133 for k in (1, 3, 77, 127, -5)],
                       np.float32)
    table[rng.randint(0, T, special.size), rng.randint(0, tpr.ROW,
                                                       special.size)] = special
    assert (np.abs(table[table != 0]) < f32.tiny).any()   # subnormals
    assert np.isfinite(table).all()
    idx = rng.randint(0, T, B).astype(np.int32)
    rows = np.nonzero(np.isin(table, special).any(1))[0]
    idx[:rows.size] = rows                          # every special fetched
    out = np.full((B, tpr.ROW), np.nan, np.float32)
    fn = libs["probes"].pienerf_fetch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    nbytes = libs["probes"].pienerf_onehot_scratch_bytes
    nbytes.restype = ctypes.c_longlong
    nbytes.argtypes = [ctypes.c_int]
    scratch = np.full(nbytes(T), 0xff, np.uint8)
    assert fn(tpr.FETCHES.index("onehot"), _ptr(table), _ptr(idx), _ptr(out),
              _ptr(scratch), T, B, 1, None) == 0
    ref = table[idx]
    # bit for bit, signs of zeros aside (an accumulator adds -0 to +0)
    np.testing.assert_array_equal(out, ref)
    both = ref != 0
    np.testing.assert_array_equal(out[both].view(np.uint32),
                                  ref[both].view(np.uint32))


@pytest.mark.parametrize("arm", ["full", "no-bs", "no-cand", "no-dirs",
                                 "smem-only", "bs-int16"])
def test_emulated_floor_shell_equals_plain(libs, arm):
    from pienerf_tpu_torch.tools.micro_floor import arm_inputs
    A, B, BS, P = 10, 4, 134, 32                     # B does not divide A
    rng = np.random.RandomState(6)
    tile_sc = np.zeros((A, 8), np.float32)
    tile_sc[:, 2] = rng.randint(0, 2, A)
    sc, bs, dirs, cand = arm_inputs(arm, torch.from_numpy(tile_sc), BS, P)
    out = np.full((A, 8, tpr.T2), np.nan, np.float32)
    fn = libs["probes"].pienerf_floor_shell
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]

    def ptr(t):
        return None if t is None else _ptr(t.numpy())
    assert fn(_ptr(tile_sc), ptr(bs), ptr(dirs), ptr(cand), _ptr(out), A, B,
              BS, P, int(arm == "bs-int16"), float("nan"), None) == 0
    assert tile_sc[:, 2].min() == 0 and tile_sc[:, 2].max() == 1
    np.testing.assert_array_equal(out, tpr.floor_shell_plain(sc).numpy())
