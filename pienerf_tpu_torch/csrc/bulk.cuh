// Hopper's bulk asynchronous copies (the Tensor Memory Accelerator's
// non-tensor form, cp.async.bulk) and the mbarriers that count their
// bytes. This header is the only place these instructions appear, so the
// CPU emulation (tests/test_torch_cuda_emu.py, PIENERF_EMU_BULK) swaps
// exactly these functions, as it swaps mma.cuh's.
//
// A bulk load global -> shared completes on an mbarrier: the issuing thread
// adds the bytes it expects to the barrier's phase (mbar_arrive_expect_tx),
// the copy takes them off as it lands, and the phase completes when every
// expected arrival has come and no byte is left. A consumer waits on the
// phase by its parity. A bulk store shared -> global belongs to the issuing
// thread's bulk groups: bulk_commit closes a group, and
// bulk_wait_read<N>() returns once every group but the newest N has read
// its shared memory, after which the slot may be written again. Addresses
// and sizes must be multiples of 16 bytes.
//
// The copies run in the async proxy. A generic write to shared memory that
// a bulk store then reads, or that a bulk load then overwrites, needs
// fence_proxy_async() between the two; so does an mbarrier's init before a
// bulk copy completes on it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pienerf {

#ifndef PIENERF_EMU_BULK
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

// `count` arrivals complete a phase; the phase count starts at 0
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
#ifdef PIENERF_EMU_BULK
  emu_mbar_init(bar, count);
#else
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
#endif
}

// one arrival, no bytes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
#ifdef PIENERF_EMU_BULK
  emu_mbar_arrive(bar);
#else
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
#endif
}

// one arrival, and `bytes` more that copies must bring before the phase
// completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
#ifdef PIENERF_EMU_BULK
  emu_mbar_arrive_expect_tx(bar, bytes);
#else
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
#endif
}

// returns once the phase of this parity has completed (phase k has parity
// k & 1); what its copies brought is then visible to the caller
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
#ifdef PIENERF_EMU_BULK
  emu_mbar_wait(bar, parity);
#else
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
#endif
}

// bytes global -> shared, completed on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
#ifdef PIENERF_EMU_BULK
  emu_bulk_load(dst, src, bytes, bar);
#else
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
#endif
}

// bytes shared -> global, in the thread's open bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
#ifdef PIENERF_EMU_BULK
  emu_bulk_store(dst, src, bytes);
#else
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
#endif
}

__device__ __forceinline__ void bulk_commit() {
#ifdef PIENERF_EMU_BULK
  emu_bulk_commit();
#else
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
#endif
}

// every bulk group of this thread but the newest N has read its source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
#ifdef PIENERF_EMU_BULK
  emu_bulk_wait_read(N);
#else
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
#endif
}

// orders this thread's generic shared-memory accesses before its later
// async-proxy ones (bulk copies, mbarrier completion by a copy)
__device__ __forceinline__ void fence_proxy_async() {
#ifndef PIENERF_EMU_BULK
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
}

}  // namespace pienerf
