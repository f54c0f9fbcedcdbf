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
// (row, channel), but only 34 of the 64 v values need a sum of their own
// (N's rows 32 - i are the negatives of rows i, rows 96 - i equal rows i,
// exactly in float32), 1,088 FMA against 128 bytes of input; the FIR adds
// 16 FMA per output sample. At 64 streams x 240 granules that is 0.88 G FMA
// against 107 MB in and out: ~8 FMA per byte, under the card's ~10. This
// kernel forms all 64 v values (1.42 G FMA, ~13 per byte), which makes FP32
// issue its own floor.
//
// Design: one fused kernel, one block per (stream, run of G granules),
// both channels; v never reaches device memory. The block computes the
// R + 15 v rows its R = 18*G output rows read into shared memory: the 15
// halo rows from granule t0-1's last 15 time slots, or from the incoming
// FIFO when t0 = 0, then its own granules' rows. The x18 of granules t0-1
// .. t1-1 is staged first, in one pass whose loads are all in flight
// together (a pass per granule left each load's latency exposed), and
// transposed to [granule][channel][slot][subband] so a thread reads four
// subbands in one load. The product is tiled in registers: a thread forms
// 4 columns x 6 (slot, channel) rows, reading N from a shared copy of the
// [sb][i] table uploaded at init, so each 16-byte load feeds 4 to 6 times
// more multiply-adds than a thread per column did. It runs on FP32 cores
// (no TF32, no tensor cores: they would change the arithmetic). The FIR
// reads v from shared memory in chains of three rows that share their
// taps' v values, clips, truncates, copies ch0 to ch1 on mono granules and
// stores one 32-bit word per sample pair, coalesced. The
// block holding granule valid-1 writes the FIFO (rows valid*18 .. +15 of
// the v history, newest first); with valid = 0 the block at t0 = 0
// copies the incoming FIFO.
//
// Arithmetic: v sums sb = 0..31 in order, the FIR sums taps k = 0..15 in
// order, each as an explicit fused multiply-add from 0.0f, so no output
// depends on G, on T or on where a chunk was split. The staging, the
// matrixing tile, the FIR and the FIFO's way in and out are
// synth_tile.cuh's, which the granule chain (chain.cu) shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "synth_tile.cuh"

namespace {

constexpr int kThreads = 384;  // matrixing: 4 granules x 96; FIR: 12 warps of 32 columns
constexpr int kMaxG = 4;       // granules per block at most

__host__ __device__ constexpr size_t smem_bytes(int G) {  // N, G + 1 staged granules, v
  return sizeof(float) * (32 * 64 + (G + 1) * kXsFloats + 2 * v_rows(G) * 64);
}

__global__ void __launch_bounds__(kThreads, 2)
synth_kernel(const float* __restrict__ x18, const int32_t* __restrict__ ginfo,
             const float* __restrict__ fifo_in, const int32_t* __restrict__ valid,
             int16_t* __restrict__ pcm, float* __restrict__ fifo_out, int T, int G) {
  extern __shared__ __align__(16) float smem[];
  float* nt = smem;                       // [sb][i]
  float* xs = nt + 32 * 64;               // [G + 1][2][18][kXsStride]: t0-1 .. t1-1
  float* v = xs + (G + 1) * kXsFloats;    // [2][vrows][64]; local row l = v row - (t0*18 - 15)
  const int vrows = v_rows(G);
  const int s = blockIdx.y;
  const int t0 = blockIdx.x * G, t1 = min(t0 + G, T), ng = t1 - t0;
  const int nv = min(max(valid[s], 0), T);
  const int tid = threadIdx.x;
  const int halo = t0 > 0 ? 1 : 0;  // granule t0-1 is staged and matrixed too

  for (int k = tid; k < 32 * 64 / 4; k += kThreads)
    reinterpret_cast<float4*>(nt)[k] = reinterpret_cast<const float4*>(g_nt)[k];
  // stage granules t0-1 (the halo's, where t0 > 0) .. t1-1 in one pass
  stage_granules<kThreads>(xs + (1 - halo) * kXsFloats, x18, s, T, t0 - halo, ng + halo);
  if (!halo) fifo_to_halo<kThreads>(v, vrows, fifo_in, s, tid);
  __syncthreads();
  // matrixing, four granules at a time: item w < halo is granule t0-1,
  // item w >= halo granule t0 + w - halo
  for (int w = tid / kTile; w < ng + halo; w += kThreads / kTile) {
    if (w < halo)
      matrix_tile(xs, nt, v, vrows, -3, 3, tid % kTile);  // granule t0-1's slots 3..17
    else
      matrix_tile(xs + (w - halo + 1) * kXsFloats, nt, v, vrows, 15 + (w - halo) * 18, 0,
                  tid % kTile);
  }
  __syncthreads();
  fir_to_pcm<kThreads>(v, vrows, ginfo + (size_t)s * T + t0, pcm, s, T, t0, ng, tid);
  write_fifo<kThreads>(v, vrows, fifo_in, fifo_out, s, t0, t1, nv, tid);
}

}  // namespace

extern "C" {

// nt f32[32][64] (SYNTH_N_WIN transposed), dtbl f32[512].
int gomp3_synth_init(int device, const float* nt, const float* dtbl) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  synth_upload_tables(nt, dtbl);
  cudaFuncSetAttribute(synth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes(kMaxG));
  return (int)cudaGetLastError();
}

// x18 f32 [S][T][2][32][18] (16-byte aligned), ginfo i32 [S][T], fifo_in
// f32 [S][2][16][64], valid i32 [S] -> pcm i16 [S][T*576][2], fifo_out f32
// [S][2][16][64]. G granules per block, 1..4. T == 0 launches nothing and
// copies fifo_in to fifo_out on the stream.
int gomp3_synth(int device, const float* x18, const int32_t* ginfo,
                const float* fifo_in, const int32_t* valid, int16_t* pcm,
                float* fifo_out, int S, int T, int G, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (S > 0 && T > 0) {
    dim3 grid((T + G - 1) / G, S);
    synth_kernel<<<grid, kThreads, smem_bytes(G), static_cast<cudaStream_t>(stream)>>>(
        x18, ginfo, fifo_in, valid, pcm, fifo_out, T, G);
  } else if (S > 0) {
    cudaMemcpyAsync(fifo_out, fifo_in, sizeof(float) * S * 2 * 16 * 64,
                    cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
