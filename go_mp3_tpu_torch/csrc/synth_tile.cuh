// K3's device functions and tables: the x18 staging, the matrixing tile,
// the FIR with the int16 conversion and the v FIFO's way in and out, shared
// by K3's own kernel (synth.cu) and the granule chain (chain.cu), so that
// both get the bits of one source. The design notes are synth.cu's.
//
// v rows live in shared memory as [2][vrows][kVStride] (64 columns; K3's
// own kernel 64 apart, for its 16-byte stores), local row l = v row -
// (t0 * 18 - 15) for a block whose first granule is t0: rows 0..14 are the
// 15 rows before the block's first (granule t0-1's slots 3..17, or the
// incoming FIFO at t0 = 0).
//
// Everything here sits in an anonymous namespace: each kernel source that
// includes it gets its own copy of the tables (uploaded by its own init
// entry point through synth_upload_tables).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kXsStride = 36;  // staged x18: [2][18][36] (subbands padded)
constexpr int kXsFloats = 2 * 18 * kXsStride;
constexpr int kTile = 96;      // threads a granule's matrixing: 6 slot groups x 16 column groups

// The independent v columns: SYNTH_N_WIN's rows 32 - i (i = 1..15) are the
// negatives of rows i and rows 96 - i (i = 33..63) equal rows i, exactly in
// float32, so rows 0..16 and 32..48 give the other 30 by a sign or a copy.
// A fused multiply-add chain over negated operands is the negated chain
// (round to nearest is symmetric), so those 30 are K3's values: only the
// sign of an exact zero can differ, and no later operation sees it.
constexpr int kSymCols = 36;   // the 34 independent columns, padded to 9 float4
constexpr int kSymTile = 54;   // threads a granule's symmetric matrixing: 6 slot groups x 9
__host__ __device__ constexpr int sym_row(int k) { return k < 17 ? k : k + 15; }

__device__ __align__(16) float g_nt[32 * 64];  // SYNTH_N_WIN transposed: [sb][i]
__device__ __align__(16) float g_ntc[32 * kSymCols];  // [sb][k]: N row sym_row(k), 0 past 33
__device__ float g_dtbl[512];    // SYNTH_DTBL

__host__ __device__ constexpr int v_rows(int G) { return G * 18 + 15; }

// nt f32[32][64] (SYNTH_N_WIN transposed), dtbl f32[512] (host) -> the
// tables above on the current device.
inline cudaError_t synth_upload_tables(const float* nt, const float* dtbl) {
  float ntc[32][kSymCols];
  for (int sb = 0; sb < 32; sb++)
    for (int k = 0; k < kSymCols; k++) ntc[sb][k] = k < 34 ? nt[sb * 64 + sym_row(k)] : 0.0f;
  cudaMemcpyToSymbol(g_nt, nt, sizeof(float) * 32 * 64);
  cudaMemcpyToSymbol(g_ntc, ntc, sizeof(ntc));
  cudaMemcpyToSymbol(g_dtbl, dtbl, sizeof(float) * 512);
  return cudaGetLastError();
}

// Whether nt (as above) has the symmetries that matrix_tile_sym rests on.
inline bool synth_symmetric(const float* nt) {
  for (int sb = 0; sb < 32; sb++) {
    const float* r = nt + sb * 64;
    for (int i = 1; i <= 15; i++)
      if (r[32 - i] != -r[i]) return false;
    for (int i = 33; i <= 63; i++)
      if (r[96 - i] != r[i]) return false;
  }
  return true;
}

__device__ __forceinline__ int16_t to_pcm(float acc) {
  const float samp = fminf(fmaxf(__fmul_rn(acc, 32767.0f), -32767.0f), 32767.0f);
  return (int16_t)(int)samp;  // truncation toward zero
}

// x18 of granules (s, t .. t + count - 1) -> xs[g][c][slot][sb]. Thread
// (g, c, sb) moves one subband's 18 slots, 8 bytes a load, every load
// issued before its first store, so the loads of the pass overlap.
template <int kThreads>
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

// matrix_tile's v rows from the 34 independent columns only (the granule
// chain's; K3's own kernel keeps the 64-column tile). Thread `unit` of the
// granule's kSymTile, (slot group pg, column group cg), forms slots pg,
// pg + 6 and pg + 12 of both channels for columns 4cg .. 4cg + 3 of ntc
// ([sb][k], shared), each sum over sb = 0..31 in matrix_tile's order, and
// writes each to its v row and to the row it gives by a sign or a copy,
// one float a store: rows kVStride = 65 apart keep those stores off each
// other's banks. (A tile of 2 slots on 81 threads, which keeps more of a
// 512-thread block busy, was 2-3% slower on an H100.)
template <int kVStride>
__device__ __forceinline__ void matrix_tile_sym(const float* __restrict__ xs,
                                                const float* __restrict__ ntc,
                                                float* __restrict__ v, int vrows, int l0,
                                                int slot_lo, int unit) {
  const int pg = unit / 9, cg = unit % 9;
  float acc[3][2][4] = {};
#pragma unroll
  for (int sb = 0; sb < 32; sb += 4) {
    float nn[4][4];  // N[sym_row(4cg + k)][sb + u]
#pragma unroll
    for (int u = 0; u < 4; u++) {
      const float4 r = *reinterpret_cast<const float4*>(ntc + (sb + u) * kSymCols + 4 * cg);
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
    for (int c = 0; c < 2; c++) {
      float* row = v + ((size_t)c * vrows + l0 + slot) * kVStride;
#pragma unroll
      for (int k = 0; k < 4; k++) {
        if (4 * cg + k >= 34) continue;
        const int i = sym_row(4 * cg + k);
        const float a = acc[q][c][k];
        row[i] = a;
        if (i >= 1 && i <= 15) row[32 - i] = -a;
        if (i >= 33 && i <= 47) row[96 - i] = a;
      }
    }
  }
}

// The 15 rows before the first of a block at t0 = 0: v row m < 0 is FIFO
// slot -1 - m (slot 0 newest).
template <int kThreads, int kVStride = 64>
__device__ __forceinline__ void fifo_to_halo(float* __restrict__ v, int vrows,
                                             const float* __restrict__ fifo_in, int s,
                                             int tid) {
  for (int k = tid; k < 2 * 15 * 64; k += kThreads) {
    const int c = k / (15 * 64), l = (k / 64) % 15, i = k % 64;
    v[((size_t)c * vrows + l) * kVStride + i] =
        fifo_in[(((size_t)s * 2 + c) * 16 + (14 - l)) * 64 + i];
  }
}

// FIR over the v rows of the block's ng granules t0 .. t0+ng-1 -> pcm rows
// (int16 [S][T*576][2]); ginfo_t0[j] is granule t0 + j's ginfo word (mono
// granules copy ch0 to ch1). Warp c forms chain c, rows r0, r0 + 2, r0 + 4
// of one parity, lane j column j. Row r0 + 2i takes v row m as its tap q -
// 4 + 2i (q = r0 + 19 - m), so the three rows share 12 of their 16 v
// values: 20 loads a channel for 48 multiply-adds, each row still summed
// over taps k = 0..15 in order from 0.0f. Stores one 32-bit word per
// sample pair, coalesced.
template <int kThreads, int kVStride = 64>
__device__ __forceinline__ void fir_to_pcm(const float* __restrict__ v, int vrows,
                                           const int32_t* __restrict__ ginfo_t0,
                                           int16_t* __restrict__ pcm, int s, int T, int t0,
                                           int ng, int tid) {
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
      const float a0 = v[(size_t)m * kVStride + col];
      const float a1 = v[((size_t)vrows + m) * kVStride + col];
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
      const int16_t o1 = ((ginfo_t0[(r0 + 2 * i) / 18] >> 8) & 1) ? o0 : to_pcm(acc[1][i]);
      const uint32_t word = (uint16_t)o0 | ((uint32_t)(uint16_t)o1 << 16);
      reinterpret_cast<uint32_t*>(pcm)[((size_t)s * rows + row) * 32 + j] = word;
    }
  }
}

// The FIFO after nv granules, from the block holding granule nv-1 (slot q,
// 0 newest, is v row nv*18 - 1 - q); with nv = 0 the block at t0 = 0
// copies the incoming FIFO.
template <int kThreads, int kVStride = 64>
__device__ __forceinline__ void write_fifo(const float* __restrict__ v, int vrows,
                                           const float* __restrict__ fifo_in,
                                           float* __restrict__ fifo_out, int s, int t0,
                                           int t1, int nv, int tid) {
  if (nv > 0 && t0 <= nv - 1 && nv - 1 < t1) {
    for (int k = tid; k < 2 * 16 * 64; k += kThreads) {
      const int c = k / (16 * 64), q = (k / 64) % 16, i = k % 64;
      const int l = nv * 18 - 1 - q - (t0 * 18 - 15);
      fifo_out[(((size_t)s * 2 + c) * 16 + q) * 64 + i] =
          v[((size_t)c * vrows + l) * kVStride + i];
    }
  } else if (nv == 0 && t0 == 0) {
    for (int k = tid; k < 2 * 16 * 64; k += kThreads)
      fifo_out[(size_t)s * 2 * 16 * 64 + k] = fifo_in[(size_t)s * 2 * 16 * 64 + k];
  }
}

}  // namespace
