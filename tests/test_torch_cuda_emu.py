"""The port's CUDA sources run on the CPU (no card, no nvcc): each ``.cu``
file of ``kernels/_build.py:SOURCES`` is compiled by the host C++ compiler
against a small header that emulates the CUDA subset the kernels use (one
``std::thread`` per CUDA thread of a block, ``std::barrier`` for
``__syncthreads``, ``cp.async`` as an immediate copy, blocks in turn), and
its C entry point is held against the plain PyTorch version on small
inputs: the field kernel, the tile kernel in every mode and schedule
(default, paired, ``block_tiles``), the four fetch probes and the shell.
Nothing here is left to the card alone for want of emulation: the probes
use no mbarrier and no bulk copy. This checks the kernels' indexing,
barriers and control flow; the card's compiler, timing and rounding are
checked by ``chip_smoke.py``."""

import ctypes
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
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#include <math.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(x)
#define __shared__
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_bar = nullptr;
inline int emu_or[2];
inline thread_local int emu_gen = 0;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  const int g = emu_gen;
  emu_gen ^= 1;
  if (p) __atomic_store_n(&emu_or[g], 1, __ATOMIC_RELAXED);
  emu_bar->arrive_and_wait();
  const int r = __atomic_load_n(&emu_or[g], __ATOMIC_RELAXED);
  emu_bar->arrive_and_wait();
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
template <class K, class... A>
void emu_launch(K k, long long grid, int threads, size_t smem, cudaStream_t,
                A... args) {
  if (smem > kEmuSmem) { emu_err = cudaErrorInvalidValue; return; }
  gridDim.x = (unsigned)grid;
  blockDim.x = threads;
  for (long long b = 0; b < grid; ++b) {
    blockIdx.x = (unsigned)b;
    std::memset(pienerf::smem4, 0xff, smem);   // no zeros to lean on
    std::barrier<> bar(threads);
    emu_bar = &bar;
    emu_or[0] = emu_or[1] = 0;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; emu_gen = 0; k(args...); });
    for (auto& t : ts) t.join();
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
    procs = {}
    for name, src in _build.SOURCES.items():      # all compilers at once
        so = d / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-Wno-unknown-pragmas", f"-I{d}", "-o", str(so),
             str(d / (src[:-3] + ".cpp")), "-lpthread"],
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


@pytest.mark.parametrize("wd", [64, 128])
def test_emulated_field_kernel_matches_plain(libs, wd):
    """A ragged N over a grid of two resident blocks."""
    spec, pw = _weights(wd, 1)
    rng = np.random.RandomState(2)
    n = 300
    x = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    d = rng.randn(3, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    out = np.zeros((4, n), np.float32)
    fn = libs["field"].pienerf_field_eval
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    assert fn(_ptr(x), _ptr(d), _ptr(pw.numpy()), _ptr(out), n, 1.0, 0, wd,
              2, None) == 0
    sigma, rgb = tfk.field_eval_plain(pw, spec, torch.from_numpy(x),
                                      torch.from_numpy(d))
    # the host's sinf and torch.sin may differ by an ulp, which the
    # double-angle ladder multiplies by up to 2^(n_freqs - 1)
    np.testing.assert_allclose(out[0], sigma.numpy(), rtol=1e-4)
    np.testing.assert_allclose(out[1:], rgb.numpy(), atol=1e-5)


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


@pytest.mark.parametrize("mode", ["deformed", "static", "cut"])
@pytest.mark.parametrize("wd", [64, 128])
def test_emulated_tile_kernel_matches_plain(libs, wd, mode):
    spec, pw = _weights(wd, 3)
    args, kw = _tile_inputs(mode)
    out = _tile_run(libs, spec, pw, args, kw)
    ref = ttk.render_tiles_plain(spec, pw, *args, **kw).numpy()
    assert ref[:, 4].max() > 0.1                  # real coverage
    # f32 summation order in the MLP and composite, and the host's sinf
    np.testing.assert_allclose(out[:, 0:5], ref[:, 0:5], atol=1e-4)
    np.testing.assert_array_equal(out[:, 5], ref[:, 5])


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
    ("deformed", "bfloat16")])
def test_emulated_paired_tile_kernel_equals_unpaired(libs, mode, dtype):
    """The paired instantiation reads the block-diagonal pack, runs each
    sample's sigma chain beside the previous sample's color chain and
    composites rgb one segment late; every sum keeps its order, so the
    output is the default schedule's bit for bit, and within the f32
    summation-order tolerance of the paired plain version."""
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


@pytest.mark.parametrize("mode,wd,paired", [
    ("deformed", 64, False), ("static", 128, False), ("cut", 64, True)])
def test_emulated_block_tiles_equals_one_tile_per_block(libs, mode, wd,
                                                        paired):
    """B = 3 over 4 tiles (one padded slot, two blocks): each block
    re-zeroes its per-tile state and stages the 64-wide weights once."""
    spec = _spec(wd)
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
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert fn(tpr.FETCHES.index(which), _ptr(table), _ptr(idx), _ptr(out), T,
              B, 1, None) == 0
    ok = (idx >= 0) & (idx < T)
    ref = np.zeros_like(out)
    ref[ok] = tpr.fetch_plain(torch.from_numpy(table),
                              torch.from_numpy(idx[ok])).numpy()
    np.testing.assert_array_equal(out, ref)


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
