// Energy: per stream, the int32 sum of |int32(pcm)| over its chunk of PCM,
// wrapping as XLA's int32 sum wraps.
//
// Replaces: the energy step of bench.py's corpus program, computed inside
// the body of its lax.scan over chunks (bench.py:416-418,
// `jnp.sum(jnp.abs(pcm.astype(jnp.int32)), axis=(1, 2))`). Plain version:
// energy_ref in go_mp3_tpu_torch/ops/granule.py. The bench launches it after
// each chunk decode (go_mp3_tpu_torch/parallel/corpus_scan.py), so that no
// PCM leaves the card: its [C, S] energies are what the bench fetches.
//
// Output: out i32 [S], out[s] = sum over pcm[s] of |sample| mod 2^32. The sum
// is taken in uint32 and reinterpreted: a sum mod 2^32 does not depend on
// its order, so the result equals XLA's wrapping int32 sum bit for bit,
// where a signed accumulator would overflow, which C++ leaves undefined
// (240 granules x 1152 samples x 32,768 > 2^31). |-32768| = 32768 is taken
// in int, not in int16.
//
// What bounds it on an H100: memory. One abs and one add a sample, two
// bytes read: at S = 64, T = 240, 35.4 MB, 0.0106 ms at 3.35 TB/s.
//
// Design: one block per stream (the corpus has 48 + 16 lanes a chunk, so one
// block an SM), 1024 threads, each keeping four 16-byte loads (8 samples
// each) in flight before it adds them, 64 KB in flight a block; the block's
// 1024 partial sums meet in a tree in shared memory (warp shuffles would do
// the last steps in registers, but the CPU emulation of tests/cuda_emu/ has
// no __shfl_*_sync). Rows are read as whole 16-byte words: the wrapper
// passes 16-byte aligned rows of a multiple of 8 samples (a granule is
// 1152 samples).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

// |lo| + |hi| of the two int16 samples of a 32-bit word
__device__ __forceinline__ uint32_t abs_pair(uint32_t w) {
  const int lo = (int)(int16_t)(w & 0xffffu), hi = (int)(int16_t)(w >> 16);
  return (uint32_t)(lo < 0 ? -lo : lo) + (uint32_t)(hi < 0 ? -hi : hi);
}

__global__ void __launch_bounds__(kThreads)
    energy_kernel(const uint4* pcm, int32_t* out, long long words) {
  __shared__ uint32_t part[kThreads];
  const uint4* row = pcm + (long long)blockIdx.x * words;
  uint32_t acc = 0;
  for (long long base = threadIdx.x; base < words; base += (long long)kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      const long long i = base + (long long)u * kThreads;
      v[u] = i < words ? __ldg(row + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; u++)
      acc += abs_pair(v[u].x) + abs_pair(v[u].y) + abs_pair(v[u].z) + abs_pair(v[u].w);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = (int32_t)part[0];
}

}  // namespace

extern "C" {

// pcm i16 [S][n] (16-byte aligned, n a multiple of 8) -> out i32 [S]. n == 0
// writes zeros. S == 0 launches nothing.
int gomp3_energy(int device, const int16_t* pcm, int32_t* out, int S, long long n,
                 void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (S < 0 || n < 0 || n % 8 || ((uintptr_t)pcm & 15)) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  energy_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(pcm), out, n / 8);
  return (int)cudaGetLastError();
}

}  // extern "C"
