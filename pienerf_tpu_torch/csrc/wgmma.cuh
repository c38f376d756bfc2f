// Hopper's warpgroup MMA (wgmma.mma_async, sm_90a only), as the bf16 field
// MLP (mma_mlp.cuh) issues it: bf16 A from registers, bf16 B from shared
// memory through a matrix descriptor, f32 accumulators in registers. This
// header is the only place the instructions appear, so the CPU emulation
// (tests/test_torch_cuda_emu.py, PIENERF_EMU_WGMMA) swaps exactly these
// functions, as it swaps mma.cuh's and bulk.cuh's.
//
// One instruction is a [64 x 16] . [16 x N] product of the warpgroup's four
// warps (threads 128 w .. 128 w + 127), each warp holding 16 of the 64 rows:
// warp q of the group rows 16 q .. 16 q + 15. A warp's A fragment and its
// accumulators are laid out as mma.sync m16n8k16's (mma.cuh), the
// accumulators repeated over the N / 8 column tiles: d[j][i] is C
// register i of the m16n8 tile j. The products run asynchronously:
//   wg_fence() before the first MMA that reads registers written since (its
//     A fragments, or accumulators the thread touched);
//   wgmma_bf16<N>() issues one product; consecutive products into the same
//     accumulators chain in order without a fence;
//   wg_commit() closes the issued products into a group, wg_wait<K>()
//     returns once all but the newest K groups are done, and
//     wg_fence_operand() then keeps the compiler from moving an accumulator
//     read above the wait.
// Every thread of the warpgroup executes each of them, converged
// (`.sync.aligned`), or the card hangs.
//
// B layout (K-major, no swizzle, the PTX ISA's "interleaved" mode): core
// matrices of 8 columns n x 8 rows k, each 128 contiguous bytes (column n's
// 8 k values in 16 bytes); the two core matrices of the k16 step `lbo`
// bytes apart, consecutive n8 groups `sbo` bytes apart. Start addresses
// are 16-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"

namespace pienerf {

// The matrix descriptor of a B tile at p (PTX ISA, "matrix descriptor"):
// bits 0-13 the shared-memory address >> 4, 16-29 lbo >> 4, 32-45 sbo >> 4,
// 49-51 the base offset (0) and 62-63 the swizzle mode (0: none).
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
#ifdef PIENERF_EMU_WGMMA
  const uint32_t addr = emu_smem_addr(p);
#else
  const uint32_t addr = smem_u32(p);
#endif
  return (uint64_t)((addr >> 4) & 0x3fffu) |
         (uint64_t)((lbo >> 4) & 0x3fffu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fffu) << 32;
}

__device__ __forceinline__ void wg_fence() {
#ifdef PIENERF_EMU_WGMMA
  emu_wg_fence();
#else
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#endif
}

__device__ __forceinline__ void wg_commit() {
#ifdef PIENERF_EMU_WGMMA
  emu_wg_commit();
#else
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#endif
}

template <int K>
__device__ __forceinline__ void wg_wait() {
#ifdef PIENERF_EMU_WGMMA
  emu_wg_wait(K);
#else
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(K) : "memory");
#endif
}

template <int T>
__device__ __forceinline__ void wg_fence_operand(float (&d)[T][4]) {
#ifndef PIENERF_EMU_WGMMA
#pragma unroll
  for (int j = 0; j < T; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i]) :: "memory");
  }
#endif
}

// d = a . B (+ d if scale_d): m64nNk16, bf16 in, f32 accumulators
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

#ifdef PIENERF_EMU_WGMMA
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  emu_wgmma_bf16(&d[0][0], N, a, desc, scale_d);
}
#else
#define PIENERF_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define PIENERF_AB "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), \
                   "r"(scale_d)
#define PIENERF_WGMMA(shape) \
  "wgmma.mma_async.sync.aligned." shape ".f32.bf16.bf16 "

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[1][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n" PIENERF_WGMMA("m64n8k16")
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : PIENERF_D4(0)
      : PIENERF_AB);
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[2][4],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" PIENERF_WGMMA("m64n16k16")
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : PIENERF_D4(0), PIENERF_D4(1)
      : PIENERF_AB);
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[8][4],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" PIENERF_WGMMA("m64n64k16")
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : PIENERF_D4(0), PIENERF_D4(1), PIENERF_D4(2), PIENERF_D4(3),
        PIENERF_D4(4), PIENERF_D4(5), PIENERF_D4(6), PIENERF_D4(7)
      : PIENERF_AB);
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[16][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" PIENERF_WGMMA("m64n128k16")
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : PIENERF_D4(0), PIENERF_D4(1), PIENERF_D4(2), PIENERF_D4(3),
        PIENERF_D4(4), PIENERF_D4(5), PIENERF_D4(6), PIENERF_D4(7),
        PIENERF_D4(8), PIENERF_D4(9), PIENERF_D4(10), PIENERF_D4(11),
        PIENERF_D4(12), PIENERF_D4(13), PIENERF_D4(14), PIENERF_D4(15)
      : PIENERF_AB);
}

#undef PIENERF_D4
#undef PIENERF_AB
#undef PIENERF_WGMMA
#endif

}  // namespace pienerf
