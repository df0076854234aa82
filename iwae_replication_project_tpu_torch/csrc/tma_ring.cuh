// The dtype-free parts of the weight rings fed by TMA bulk copies: the PTX
// wrappers for cp.async, mbarriers and cp.async.bulk, shared by the bf16
// tensor-core kernels (tc_bf16.cuh: B1, B2, whose ring keeps its own slot
// bookkeeping: moved here, it made B1 3-8% slower on the card, PERF.md) and
// the 3xTF32 ones (tc_tf32.cuh: B3, B4), and PipeRing, the 3xTF32 kernels'
// producer/consumer ring.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes to shared memory of which the first `src_bytes` (0..16) come from
// `src` and the rest are zero
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes to shared memory, from `src` if `src_bytes` is 4, else zero
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// a barrier whose phase completes after `count` arrivals
__device__ __forceinline__ void mbar_init_count(uint64_t* bar,
                                                uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival on `bar` (no transaction bytes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// one TMA bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, its completion counted on `bar`, which expects it
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A ring whose slots are handed over by mbarriers alone, with no CTA-wide
// barrier per tile: `full[s]` completes when slot s's copy has landed,
// `empty[s]` when all `consumers` warps have released it. One producer
// thread issues the copies (produce), each consumer warp waits for a tile
// (wait) and releases it once its reads are done (release), so warps drift
// apart by up to NS - 1 tiles instead of meeting at every tile. The
// constructor (every thread of the CTA) initialises the barriers; the caller
// puts one __syncthreads between it and the first wait or produce.
template <class Tiles, int NS>
struct PipeRing {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  size_t slot_bytes;
  Tiles tiles;
  int total;

  __device__ PipeRing(void* slots_, uint64_t* bars_, size_t slot_bytes_,
                      const Tiles& tiles_, int total_, int consumers)
      : slots(static_cast<unsigned char*>(slots_)), full(bars_),
        empty(bars_ + NS), slot_bytes(slot_bytes_), tiles(tiles_),
        total(total_) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NS; ++i) {
        mbar_init(full + i);
        mbar_init_count(empty + i, consumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  // Copy tile i into its slot once the slot's previous tile is released
  // (one thread).
  __device__ void produce(int i) {
    if (i >= NS) mbar_wait(empty + i % NS, (i / NS - 1) & 1);
    const void* src;
    uint32_t bytes;
    tiles(i, src, bytes);
    // the slot's last readers released it; order their reads before the
    // async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_copy(slots + (size_t)(i % NS) * slot_bytes, src, bytes,
              full + i % NS);
  }
  __device__ const unsigned char* wait(int i) {
    mbar_wait(full + i % NS, (i / NS) & 1);
    return slots + (size_t)(i % NS) * slot_bytes;
  }
  // every lane of a consumer warp calls this once its reads of tile i are
  // done
  __device__ void release(int i) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + i % NS);
  }
};

}  // namespace tma
}  // namespace
