// A CPU emulation of the parts of the CUDA runtime and device language that
// go_mp3_tpu_torch/csrc uses, for running the kernels' indexing, barriers
// and arithmetic order on a machine without a GPU (emulate.py builds the
// sources against it with g++). Not a model of the card's timing or of its
// float rounding in exp2f/log2f.
//
// One std::thread per CUDA thread, a std::barrier per block and per warp
// and one per named barrier id (csrc/barrier.cuh), blocks one after
// another. Static __shared__ arrays become function-local
// statics (blocks never overlap); dynamic shared memory starts as NaN, so a
// read of a value never written shows in the output.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define GOMP3_CUDA_EMU 1  // csrc/barrier.cuh: named barriers below

struct uint3_ {
  unsigned x, y, z;
};
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ blockDim;
inline thread_local float* emu_dyn_smem;
inline std::barrier<>* emu_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
// named barriers (bar.sync / bar.arrive): id -> its thread count, its
// arrivals and its barrier, made at first use in a block. A use with
// another count, or a block that ends with a phase open, aborts: the card
// takes one count per id and phase, and leaves an open phase undefined.
struct EmuNamed {
  int n = 0;
  long arrivals = 0;
  std::unique_ptr<std::barrier<>> bar;
};
inline std::mutex emu_named_mutex;
inline std::map<int, EmuNamed> emu_named;
inline std::barrier<>& emu_named_barrier(int id, int n) {
  std::lock_guard<std::mutex> lock(emu_named_mutex);
  EmuNamed& b = emu_named[id];
  if (!b.bar) b.n = n, b.bar = std::make_unique<std::barrier<>>(n);
  if (id <= 0 || id > 15 || n % 32 || b.n != n) {
    std::fprintf(stderr, "named barrier %d used with %d threads (first %d)\n", id, n, b.n);
    std::abort();
  }
  b.arrivals++;
  return *b.bar;
}
inline void emu_named_check_closed() {
  for (auto& [id, b] : emu_named) {
    if (b.arrivals % b.n) {
      std::fprintf(stderr, "named barrier %d: a block ended with %ld of %d arrivals\n", id,
                   b.arrivals % b.n, b.n);
      std::abort();
    }
  }
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp() { emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
template <class T>
T __ldg(const T* p) { return *p; }
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned s) {
  const uint64_t x = ((uint64_t)b << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; i++) r |= (unsigned)((x >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
using std::max;
using std::min;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaMemcpyDeviceToDevice = 3,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
template <class T>
cudaError_t cudaMemcpyToSymbol(T& sym, const void* src, size_t n, size_t off = 0) {
  std::memcpy(reinterpret_cast<char*>(&sym) + off, src, n);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n, int, cudaStream_t) {
  std::memcpy(d, s, n);
  return 0;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;  // blocks run one after another here
  return 0;
}

// kernel<<<grid, block, smem, stream>>>(args) becomes (emulate.py rewrites
// it) emu_launch(dim3(grid), dim3(block), smem, [=] { kernel(args); }).
inline void emu_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> body) {
  const unsigned n = block.x;
  blockDim = {n, 1, 1};
  std::vector<float> dyn(smem / 4 + 4, NAN);
  for (unsigned by = 0; by < grid.y; by++) {
    for (unsigned bx = 0; bx < grid.x; bx++) {
      std::barrier<> bar(n);
      emu_block_barrier = &bar;
      emu_warp_barriers.clear();
      for (unsigned w = 0; w < (n + 31) / 32; w++)
        emu_warp_barriers.emplace_back(new std::barrier<>(std::min(32u, n - 32 * w)));
      std::fill(dyn.begin(), dyn.end(), NAN);
      emu_named.clear();
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < n; t++)
        ts.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, 0};
          emu_dyn_smem = dyn.data();
          body();
        });
      for (auto& t : ts) t.join();
      emu_named_check_closed();
    }
  }
}
