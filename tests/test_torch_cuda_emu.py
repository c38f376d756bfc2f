"""The port's CUDA sources run on the CPU (no card, no nvcc): each ``.cu``
file of ``kernels/_build.py:SOURCES`` is compiled by the host C++ compiler
against a small header that emulates the CUDA subset the kernels use (one
fiber per CUDA thread of a block, all on one host thread, switched at
``__syncthreads`` and, per warp, at ``__syncwarp``; ``cp.async`` as an
immediate copy; blocks in turn), and its C entry point is held against the
plain PyTorch version on small inputs: the field kernel, the tile kernel in
every mode and schedule (default, paired, ``block_tiles``), f32 and bf16,
the four fetch probes and the shell. The tensor-core instruction of the
bf16 instantiations and of the one-hot fetch (``mma.cuh:mma_bf16_16816``)
is emulated at a warp barrier from the 32 lanes' fragments: bf16 products
exact in f32, added to the accumulator one by one in increasing k. The f32
field kernel is also held bit for bit against the per-point FMA chains it
replaced (``FIELD_REF_CU``). The fibers run in a fixed order
that reverses from pass to pass, so a missing barrier shows on every run.
Nothing here is left to the card alone for want of emulation: the probes
use no mbarrier and no bulk copy. This checks the kernels' indexing,
barriers and control flow; the card's compiler, timing and rounding are
checked by ``chip_smoke.py``."""

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
#include <memory>
#include <vector>
#include <math.h>
#include <setjmp.h>
#include <ucontext.h>
#define PIENERF_EMU_MMA 1
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
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
// Blocks run in turn. Each CUDA thread of a block is a fiber on the calling
// host thread (entered with setcontext on a stack of its own, then switched
// with _setjmp / _longjmp, which save no signal mask and so make no system
// call); the scheduler resumes the fibers round robin, each
// until it ends or waits at a barrier, and alternates the direction of its
// passes, so that a read missing its barrier meets the write in one order
// or the other. The last member to arrive at a barrier runs its completion
// step, if any, and releases the others. A pass in which every unfinished
// thread waits is a deadlock (threads of a block or a warp at different
// barriers): the emulation aborts.
struct EmuBarrier {
  int expected = 0, count = 0;
  unsigned gen = 0;
};
struct EmuFiber {
  ucontext_t start;                         // its first entry
  jmp_buf env;                              // where it waits
  const EmuBarrier* wait = nullptr;
  unsigned wait_gen = 0;
  bool started = false, done = false;
  int gen = 0;                              // __syncthreads_or's slot
};
inline jmp_buf emu_sched;
inline std::vector<EmuFiber> emu_fibers;
inline std::function<void()> emu_body;
inline EmuBarrier emu_block_bar;
inline EmuBarrier emu_warp_bar[32];
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
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
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
inline void emu_fiber_entry() {
  emu_body();
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
    std::memset(pienerf::smem4, 0xff, smem);   // no zeros to lean on
    emu_block_bar = EmuBarrier{threads};
    for (int w = 0; w < (threads + 31) / 32; ++w)
      emu_warp_bar[w] = EmuBarrier{std::min(32, threads - 32 * w)};
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
        if (f.done || (f.wait != nullptr && f.wait->gen == f.wait_gen))
          continue;
        f.wait = nullptr;
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
        std::fprintf(stderr, "emulated block %lld: deadlock at a barrier\n",
                     b);
        std::abort();
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

# The f32 field kernel as it was before the register-blocked MLP: one
# point a thread through field_point (Net64) and 128 points a pass, two
# threads a point, through field_points_wide (Net128), both still in
# field_mlp.cuh (the tile kernel's f32 path). The field kernel must equal
# it bit for bit.
FIELD_REF_CU = r"""
#include "field_mlp.cuh"
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
    # kern<<<grid, block, smem, stream>>>(args) -> emu_launch(...), in the
    # headers too
    for src in os.listdir(CSRC):
        with open(os.path.join(CSRC, src)) as f:
            code = f.read()
        code = re.sub(r"(\w+)<<<(.*?),\s*(\w+)>>>\(",
                      r"emu_launch(\1, \2, (cudaStream_t)\3, ", code)
        if src.endswith(".cu"):
            code += "\nnamespace pienerf { float4 smem4[232448 / 16]; }\n"
            src = src[:-3] + ".cpp"
        (d / src).write_text(code)
    (d / "field_ref.cpp").write_text(
        FIELD_REF_CU + "\nnamespace pienerf { float4 smem4[232448 / 16]; }\n")
    procs = {}
    # all compilers at once; without _FORTIFY_SOURCE, whose checked
    # longjmp refuses a jump to another stack (a fiber's)
    for name, src in {**_build.SOURCES, "field_ref": "field_ref.cu"}.items():
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


def _tile_run(libs, spec, pw, args, kw, block_tiles=1):
    """The emulated tile kernel as ``kernels.tile.render_tiles`` launches
    it: the paired library for a paired pack, the tiles padded to a
    multiple of ``block_tiles``."""
    paired = tfk.is_paired(spec, pw)
    A0 = args[0].shape[0]
    tile_sc, bin_start, dirs, cand = ttk._pad_tiles(
        block_tiles, args[0], args[1], args[3], args[4])
    a = [t.contiguous().numpy() for t in
         (tile_sc, bin_start, args[2], dirs, cand)]
    A, P = a[4].shape[0], a[4].shape[1]
    out = np.full((A, 8, ttk.T2), np.nan, np.float32)
    fn = (libs["tile_paired"].pienerf_render_tiles_paired if paired
          else libs["tile_block"].pienerf_render_tiles_block
          if block_tiles > 1 else libs["tile"].pienerf_render_tiles)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    rc = fn(*(_ptr(t) for t in a), _ptr(pw.numpy()), _ptr(out), A,
            block_tiles, a[1].shape[1], P, kw["K"], kw["Ks"], kw["Ksb"],
            kw["Wn"], kw["num_seek"], spec.bound,
            int(spec.compute_dtype == "bfloat16"), int(kw["deformed"]),
            int(kw["cut"]), tfk.kernel_width(spec), None)
    assert rc == 0
    return out[:A0]


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


@pytest.mark.parametrize("which", tpr.FETCHES)
def test_emulated_fetch_kernels_equal_plain(libs, which):
    """All four fetch mechanisms run emulated (the asynchronous copies of
    the dma arm as immediate ones): exact rows, a table whose row count is
    no multiple of the one-hot chunk, and zero rows for indices outside
    it."""
    rng = np.random.RandomState(5)
    T, B = 300, 1024
    table = rng.randn(T, tpr.ROW).astype(np.float32)
    idx = rng.randint(0, T, B).astype(np.int32)
    idx[7], idx[600] = T, -1
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
    ok = (idx >= 0) & (idx < T)
    ref = np.zeros_like(out)
    ref[ok] = tpr.fetch_plain(torch.from_numpy(table),
                              torch.from_numpy(idx[ok])).numpy()
    np.testing.assert_array_equal(out, ref)


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
