// K2's device functions and tables: the antialias butterflies and the
// 18-term IMDCT dot product, shared by K2's own kernel (hybrid.cu) and the
// granule chain (chain.cu), so that both get the bits of one source.
//
// Everything here sits in an anonymous namespace: each kernel source that
// includes it gets its own copy of the tables (uploaded by its own init
// entry point through hybrid_upload_tables).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 576;  // lines of one granule and channel
constexpr int kJ = 20;     // a coefficient row: j = 0..17, padded to 5 float4
constexpr int kHybridTabFloats = 2 * 36 * kJ;

// The IMDCT matrices as rows [output p][j] (cos36 and the composed
// short-block m3, 36 rows each), padded with zeros to kJ.
__device__ __align__(16) float g_tab[2][36][kJ];
__device__ __align__(16) float g_win[4 * 36];
__device__ __align__(16) float g_cs[8];
__device__ __align__(16) float g_ca[8];

// cs/ca f32[8], cos36 f32[18][36], m3 f32[18][36], win f32[4][36] (host)
// -> the tables above on the current device.
inline cudaError_t hybrid_upload_tables(const float* cs, const float* ca, const float* cos36,
                                        const float* m3, const float* win) {
  cudaMemcpyToSymbol(g_cs, cs, sizeof(float) * 8);
  cudaMemcpyToSymbol(g_ca, ca, sizeof(float) * 8);
  float tab[2][36][kJ];  // [matrix][p][j], zero past j = 17
  for (int p = 0; p < 36; p++) {
    for (int j = 0; j < kJ; j++) {
      tab[0][p][j] = j < 18 ? cos36[j * 36 + p] : 0.0f;
      tab[1][p][j] = j < 18 ? m3[j * 36 + p] : 0.0f;
    }
  }
  cudaMemcpyToSymbol(g_tab, tab, sizeof(tab));
  cudaMemcpyToSymbol(g_win, win, sizeof(float) * 4 * 36);
  return cudaGetLastError();
}

// Subband sb's 18 lines of the staged row, with the butterflies of its
// two boundaries where the block class has them (long: all 31, mixed:
// boundary 0 only). The butterflies read the unmodified staged lines.
__device__ __forceinline__ void antialias(const float* __restrict__ xs, int sb,
                                          int cls, const float* __restrict__ cs,
                                          const float* __restrict__ ca,
                                          float (&y)[18]) {
#pragma unroll
  for (int i = 0; i < 18; i++) y[i] = xs[sb * 18 + i];
  if (sb >= 1 && (cls == 0 || (cls == 2 && sb == 1))) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const float up = xs[sb * 18 + i], lo = xs[sb * 18 - 1 - i];
      y[i] = __fmaf_rn(up, cs[i], __fmul_rn(lo, ca[i]));
    }
  }
  if (sb <= 30 && (cls == 0 || (cls == 2 && sb == 0))) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
      const float lo = xs[sb * 18 + 17 - i], up = xs[(sb + 1) * 18 + i];
      y[17 - i] = __fmaf_rn(lo, cs[i], -__fmul_rn(up, ca[i]));
    }
  }
}

// sum over j = 0..17 of y[j] * row[j], from 0.0f, j in order, each step an
// explicit fused multiply-add; the row is read in 16-byte pieces, the same
// address in every lane (a broadcast).
__device__ __forceinline__ float dot18(const float (&y)[18], const float* __restrict__ row) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const float4 c = r[q];
    acc = __fmaf_rn(y[4 * q], c.x, acc);
    acc = __fmaf_rn(y[4 * q + 1], c.y, acc);
    acc = __fmaf_rn(y[4 * q + 2], c.z, acc);
    acc = __fmaf_rn(y[4 * q + 3], c.w, acc);
  }
  const float4 c = r[4];
  acc = __fmaf_rn(y[16], c.x, acc);
  return __fmaf_rn(y[17], c.y, acc);
}

}  // namespace
