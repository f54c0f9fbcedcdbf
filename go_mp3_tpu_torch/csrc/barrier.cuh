// Named barriers: a barrier over a group of a block's warps, so that two
// groups of one block can each sync among themselves and hand work to each
// other without stopping the whole block (the granule chain, chain.cu).
//
// bar_sync(id, n): wait until n threads (a multiple of 32, whole warps)
// have reached barrier `id` in this phase, arriving with the calling
// thread; bar_arrive(id, n): arrive without waiting. Id 0 is
// __syncthreads()'s. Every thread that arrives sees, once the phase
// completes, the shared-memory writes that each participant made before it
// arrived (PTX bar.sync / bar.arrive). A thread must not arrive twice in
// one phase, and every phase a kernel starts must complete before it ends.
//
// Under the CPU emulation (tests/cuda_emu/cuda_runtime.h defines
// GOMP3_CUDA_EMU) each id is a std::barrier of n threads, made at its first
// use in the block.
#pragma once

#include <cuda_runtime.h>

namespace gomp3 {

__device__ __forceinline__ void bar_sync(int id, int n) {
#ifdef GOMP3_CUDA_EMU
  emu_named_barrier(id, n).arrive_and_wait();
#else
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
#endif
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
#ifdef GOMP3_CUDA_EMU
  (void)emu_named_barrier(id, n).arrive();
#else
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
#endif
}

// The barrier that a tile body (requant_tile.cuh) calls between its steps:
// the whole block's, or named barrier kId over kCount threads.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
template <int kId, int kCount>
struct GroupSync {
  __device__ __forceinline__ void operator()() const { bar_sync(kId, kCount); }
};

}  // namespace gomp3
