// K3: polyphase synthesis -> int16 PCM, and the v FIFO after `valid`.
//
// Replaces: the XLA program of _polyphase and the tail of decode_chunk_impl
// in go_mp3_tpu/ops/granule.py (:423-549): x32767, clip, truncation to int16,
// the [T*576, 2] interleave, mono granules' ch0 copied to ch1, and the
// one-hot extraction of the new v FIFO. (The retired Pallas kernel
// polyphase_pallas, git show 0e15dec^:go_mp3_tpu/ops/pallas_synth.py, did the
// same two steps with v kept in VMEM.) Plain version: synth_ref in
// go_mp3_tpu_torch/ops/granule.py.
//
// What bounds it on an H100: memory. Matrixing is a 32 -> 64 product per
// (row, channel): 2,048 FMA per 128 bytes of input, well under the card's
// ratio of FLOPs to bytes once the 8 KB matrix sits in shared memory; its
// cost is writing v (256 bytes per row and channel) and reading it back
// sixteen times in the FIR (from L1/L2). The FIR reads 16 taps per output.
//
// Design: two kernels.
//  1. matrix_kernel: one block per granule; the granule's 2 x 32 x 18
//     inputs and the transposed 32 x 64 matrix go to shared memory, and
//     each thread forms v[row][i] = sum over sb = 0..31 in order, written to
//     a scratch v [S][2][T*18][64] (coalesced along i).
//  2. fir_kernel: one thread per (stream, row, column j) computes both
//     channels: acc = sum over taps k = 0..15 in order of
//     vh[row + 16 - k][(k odd ? 32 : 0) + j] * D[32k + j], where vh rows
//     below 16 come from the incoming FIFO and the rest from the scratch.
//     It clips and truncates, copies ch0 to ch1 on mono granules, and
//     stores the two int16 samples as one 32-bit word. Threads of rows
//     0..15 also copy the FIFO out: rows valid*18 .. valid*18+15, newest
//     first.
// Every sum runs in a fixed order that depends neither on T nor on the
// row's place in the chunk (the hazard the JAX chain fought at
// granule.py:394-398 and :455-468), so splitting a stream into chunks at
// other boundaries gives bit-identical PCM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

__constant__ float c_nwin[64][32];  // SYNTH_N_WIN
__constant__ float c_dtbl[512];     // SYNTH_DTBL

constexpr int kMatThreads = 256;

__global__ void __launch_bounds__(kMatThreads)
matrix_kernel(const float* __restrict__ x18, float* __restrict__ vs, int T) {
  const int g = blockIdx.x;  // stream * T + t
  const int s = g / T, t = g % T;
  __shared__ float xs[2][32][18];
  __shared__ float nt[32][64];  // transposed: nt[sb][i] = N[i][sb]
  for (int k = threadIdx.x; k < 2 * 576; k += kMatThreads)
    (&xs[0][0][0])[k] = x18[(size_t)g * 1152 + k];
  for (int k = threadIdx.x; k < 64 * 32; k += kMatThreads) {
    const int i = k / 32, sb = k % 32;
    nt[sb][i] = c_nwin[i][sb];
  }
  __syncthreads();
  const int i = threadIdx.x & 63;
  for (int cj = threadIdx.x >> 6; cj < 36; cj += kMatThreads / 64) {
    const int c = cj / 18, j = cj % 18;
    float acc = 0.0f;
#pragma unroll
    for (int sb = 0; sb < 32; sb++) acc += xs[c][sb][j] * nt[sb][i];
    vs[(((size_t)s * 2 + c) * T * 18 + t * 18 + j) * 64 + i] = acc;
  }
}

__device__ __forceinline__ int16_t to_pcm(float acc) {
  const float samp = fminf(fmaxf(acc * 32767.0f, -32767.0f), 32767.0f);
  return (int16_t)(int)samp;  // truncation toward zero
}

__global__ void __launch_bounds__(256)
fir_kernel(const float* __restrict__ vs, const float* __restrict__ fifo_in,
           const int32_t* __restrict__ ginfo, const int32_t* __restrict__ valid,
           int16_t* __restrict__ pcm, float* __restrict__ fifo_out, int T) {
  __shared__ float d[512];
  for (int k = threadIdx.x; k < 512; k += blockDim.x) d[k] = c_dtbl[k];
  __syncthreads();
  const int s = blockIdx.y;
  const int rows = T * 18;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int j = threadIdx.x & 31;
  if (row >= rows) return;

  int16_t out[2];
#pragma unroll
  for (int c = 0; c < 2; c++) {
    const float* fifo = fifo_in + ((size_t)s * 2 + c) * 16 * 64;
    const float* v = vs + ((size_t)s * 2 + c) * rows * 64;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; k++) {
      const int r = row + 16 - k;  // vh row; vh = 16 FIFO rows oldest first, then v
      const float* src = r < 16 ? fifo + (15 - r) * 64 : v + (size_t)(r - 16) * 64;
      acc += src[(k & 1) * 32 + j] * d[32 * k + j];
    }
    out[c] = to_pcm(acc);
  }
  if ((ginfo[(size_t)s * T + row / 18] >> 8) & 1) out[1] = out[0];
  const uint32_t word = (uint16_t)out[0] | ((uint32_t)(uint16_t)out[1] << 16);
  reinterpret_cast<uint32_t*>(pcm)[(size_t)s * rows * 32 + (size_t)row * 32 + j] = word;

  if (row < 16) {
    const int nv = min(max(valid[s], 0), T);
    const int r = nv * 18 + 15 - row;  // FIFO slot `row`, 0 = newest
#pragma unroll
    for (int c = 0; c < 2; c++) {
      const float* src = r < 16
          ? fifo_in + (((size_t)s * 2 + c) * 16 + (15 - r)) * 64
          : vs + (((size_t)s * 2 + c) * rows + (r - 16)) * 64;
      float* dst = fifo_out + (((size_t)s * 2 + c) * 16 + row) * 64;
      dst[j] = src[j];
      dst[j + 32] = src[j + 32];
    }
  }
}

}  // namespace

extern "C" {

// nwin f32[64][32], dtbl f32[512].
int gomp3_synth_init(int device, const float* nwin, const float* dtbl) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaMemcpyToSymbol(c_nwin, nwin, sizeof(float) * 64 * 32);
  cudaMemcpyToSymbol(c_dtbl, dtbl, sizeof(float) * 512);
  return (int)cudaGetLastError();
}

// x18 f32 [S][T][2][32][18], ginfo i32 [S][T], fifo_in f32 [S][2][16][64],
// valid i32 [S], scratch vs f32 [S][2][T*18][64] -> pcm i16 [S][T*576][2],
// fifo_out f32 [S][2][16][64].
int gomp3_synth(int device, const float* x18, const int32_t* ginfo,
                const float* fifo_in, const int32_t* valid, float* vs,
                int16_t* pcm, float* fifo_out, int S, int T, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (S > 0 && T > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    matrix_kernel<<<S * T, kMatThreads, 0, st>>>(x18, vs, T);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T * 18 + 7) / 8, S);
    fir_kernel<<<grid, 256, 0, st>>>(vs, fifo_in, ginfo, valid, pcm, fifo_out, T);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
