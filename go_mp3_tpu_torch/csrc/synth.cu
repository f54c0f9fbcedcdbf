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
// depends on G, on T or on where a chunk was split.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 384;  // matrixing: 4 granules x 96; FIR: 12 warps of 32 columns
constexpr int kMaxG = 4;       // granules per block at most
constexpr int kXsStride = 36;  // staged x18: [2][18][36] (subbands padded)
constexpr int kXsFloats = 2 * 18 * kXsStride;
constexpr int kTile = 96;      // threads a granule's matrixing: 6 slot groups x 16 column groups

__device__ __align__(16) float g_nt[32 * 64];  // SYNTH_N_WIN transposed: [sb][i]
__device__ float g_dtbl[512];    // SYNTH_DTBL

__host__ __device__ constexpr int v_rows(int G) { return G * 18 + 15; }
__host__ __device__ constexpr size_t smem_bytes(int G) {  // N, G + 1 staged granules, v
  return sizeof(float) * (32 * 64 + (G + 1) * kXsFloats + 2 * v_rows(G) * 64);
}

__device__ __forceinline__ int16_t to_pcm(float acc) {
  const float samp = fminf(fmaxf(__fmul_rn(acc, 32767.0f), -32767.0f), 32767.0f);
  return (int16_t)(int)samp;  // truncation toward zero
}

// x18 of granules (s, t .. t + count - 1) -> xs[g][c][slot][sb]. Thread
// (g, c, sb) moves one subband's 18 slots, 8 bytes a load, every load
// issued before its first store, so the loads of the pass overlap.
__device__ __forceinline__ void stage_granules(float* __restrict__ xs,
                                               const float* __restrict__ x18, int s,
                                               int T, int t, int count) {
  for (int u = threadIdx.x; u < count * 64; u += kThreads) {
    const int g = u >> 6, c = (u >> 5) & 1, sb = u & 31;
    const float2* src = reinterpret_cast<const float2*>(
        x18 + (((size_t)s * T + t + g) * 2 + c) * 576 + sb * 18);
    float2 e[9];
#pragma unroll
    for (int k = 0; k < 9; k++) e[k] = src[k];
    float* dst = xs + g * kXsFloats + c * 18 * kXsStride + sb;
#pragma unroll
    for (int k = 0; k < 9; k++) {
      dst[(2 * k) * kXsStride] = e[k].x;
      dst[(2 * k + 1) * kXsStride] = e[k].y;
    }
  }
}

// v rows of the staged granule's slots slot_lo..17, both channels, into
// v[c][l0 + slot][i]. Thread `unit` of the granule's kTile, (slot group pg,
// column group cg), forms slots pg, pg + 6 and pg + 12 of both channels for
// columns 4cg .. 4cg + 3: 24 sums in registers, each over sb = 0..31 in
// order. A step of 4 subbands loads 4 rows of N (its 4 columns) and 6 rows
// of x (broadcast to the 16 threads of a slot group), 16 bytes each, for 96
// multiply-adds.
__device__ __forceinline__ void matrix_tile(const float* __restrict__ xs,
                                            const float* __restrict__ nt,
                                            float* __restrict__ v, int vrows, int l0,
                                            int slot_lo, int unit) {
  const int pg = unit >> 4, cg = unit & 15;
  float acc[3][2][4] = {};
#pragma unroll
  for (int sb = 0; sb < 32; sb += 4) {
    float nn[4][4];  // N[sb + u][4cg + k]
#pragma unroll
    for (int u = 0; u < 4; u++) {
      const float4 r = *reinterpret_cast<const float4*>(nt + (sb + u) * 64 + 4 * cg);
      nn[u][0] = r.x, nn[u][1] = r.y, nn[u][2] = r.z, nn[u][3] = r.w;
    }
#pragma unroll
    for (int q = 0; q < 3; q++) {
#pragma unroll
      for (int c = 0; c < 2; c++) {
        const float4 a = *reinterpret_cast<const float4*>(
            xs + (c * 18 + pg + 6 * q) * kXsStride + sb);
#pragma unroll
        for (int k = 0; k < 4; k++) {
          float t = acc[q][c][k];
          t = __fmaf_rn(a.x, nn[0][k], t);
          t = __fmaf_rn(a.y, nn[1][k], t);
          t = __fmaf_rn(a.z, nn[2][k], t);
          acc[q][c][k] = __fmaf_rn(a.w, nn[3][k], t);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 3; q++) {
    const int slot = pg + 6 * q;
    if (slot < slot_lo) continue;
#pragma unroll
    for (int c = 0; c < 2; c++)
      *reinterpret_cast<float4*>(v + ((size_t)c * vrows + l0 + slot) * 64 + 4 * cg) =
          make_float4(acc[q][c][0], acc[q][c][1], acc[q][c][2], acc[q][c][3]);
  }
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
  stage_granules(xs + (1 - halo) * kXsFloats, x18, s, T, t0 - halo, ng + halo);
  if (!halo) {  // the 15 halo rows: v row m < 0 is FIFO slot -1 - m (slot 0 newest)
    for (int k = tid; k < 2 * 15 * 64; k += kThreads) {
      const int c = k / (15 * 64), l = (k / 64) % 15, i = k % 64;
      v[((size_t)c * vrows + l) * 64 + i] =
          fifo_in[(((size_t)s * 2 + c) * 16 + (14 - l)) * 64 + i];
    }
  }
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

  // FIR: warp c forms chain c, rows r0, r0 + 2, r0 + 4 of one parity, lane
  // j column j. Row r0 + 2i takes v row m as its tap q - 4 + 2i (q = r0 +
  // 19 - m), so the three rows share 12 of their 16 v values: 20 loads a
  // channel for 48 multiply-adds, each row still summed over taps k =
  // 0..15 in order from 0.0f.
  const int j = tid & 31;
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; k++) d[k] = g_dtbl[32 * k + j];
  const int rows = T * 18;
  for (int c = tid >> 5; c < 6 * ng; c += kThreads / 32) {
    const int r0 = (c & 1) + 6 * (c >> 1);
    float acc[2][3] = {};
#pragma unroll
    for (int q = 0; q < 20; q++) {
      const int m = r0 + 19 - q, col = (q & 1) * 32 + j;
      const float a0 = v[(size_t)m * 64 + col], a1 = v[((size_t)vrows + m) * 64 + col];
#pragma unroll
      for (int i = 0; i < 3; i++) {
        const int k = q - 4 + 2 * i;
        if (k >= 0 && k < 16) {
          acc[0][i] = __fmaf_rn(a0, d[k], acc[0][i]);
          acc[1][i] = __fmaf_rn(a1, d[k], acc[1][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 3; i++) {
      const int row = t0 * 18 + r0 + 2 * i;
      const int16_t o0 = to_pcm(acc[0][i]);
      const int16_t o1 = ((ginfo[(size_t)s * T + row / 18] >> 8) & 1) ? o0 : to_pcm(acc[1][i]);
      const uint32_t word = (uint16_t)o0 | ((uint32_t)(uint16_t)o1 << 16);
      reinterpret_cast<uint32_t*>(pcm)[((size_t)s * rows + row) * 32 + j] = word;
    }
  }

  // the FIFO: slot q (0 newest) is v row nv*18 - 1 - q
  if (nv > 0 && t0 <= nv - 1 && nv - 1 < t1) {
    for (int k = tid; k < 2 * 16 * 64; k += kThreads) {
      const int c = k / (16 * 64), q = (k / 64) % 16, i = k % 64;
      const int l = nv * 18 - 1 - q - (t0 * 18 - 15);
      fifo_out[(((size_t)s * 2 + c) * 16 + q) * 64 + i] =
          v[((size_t)c * vrows + l) * 64 + i];
    }
  } else if (nv == 0 && t0 == 0) {
    for (int k = tid; k < 2 * 16 * 64; k += kThreads)
      fifo_out[(size_t)s * 2 * 16 * 64 + k] = fifo_in[(size_t)s * 2 * 16 * 64 + k];
  }
}

}  // namespace

extern "C" {

// nt f32[32][64] (SYNTH_N_WIN transposed), dtbl f32[512].
int gomp3_synth_init(int device, const float* nt, const float* dtbl) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaMemcpyToSymbol(g_nt, nt, sizeof(float) * 32 * 64);
  cudaMemcpyToSymbol(g_dtbl, dtbl, sizeof(float) * 512);
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
