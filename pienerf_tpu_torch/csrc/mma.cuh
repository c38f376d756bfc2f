// The warp-level tensor-core instruction of the one-hot fetch probe
// (probe_kernels.cu; the field MLP issues warpgroup MMAs, wgmma.cuh): the
// only place it appears, so the CPU emulation
// (tests/test_torch_cuda_emu.py, PIENERF_EMU_MMA) swaps exactly one
// function.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pienerf {

// d = a . b + c for one 16x8 tile, k = 16, bf16 inputs and f32
// accumulators (fragments as the PTX ISA lays out m16n8k16 .bf16: lane
// l = 4 g + t holds A rows g, g + 8 at columns 2t, 2t + 1, 2t + 8, 2t + 9;
// B column g at rows 2t, 2t + 1, 2t + 8, 2t + 9; C rows g, g + 8 at
// columns 2t, 2t + 1; in each 32-bit register the lower column or row in
// the low half). Every lane of the warp calls it, converged.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2],
                                               const float (&c)[4]) {
#ifdef PIENERF_EMU_MMA
  emu_mma_bf16_16816(d, a, b, c);
#else
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
#endif
}

}  // namespace pienerf
