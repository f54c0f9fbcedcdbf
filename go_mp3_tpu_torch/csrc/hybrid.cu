// K2: antialias + IMDCT + overlap-add + frequency inversion.
//
// Replaces: the XLA program of _antialias, _imdct, _overlap_fold and the
// _FREQ_INV multiply in go_mp3_tpu/ops/granule.py (:361-420, :512), and the
// one-hot extraction of the new `store` (:540-542). Plain version:
// hybrid_ref in go_mp3_tpu_torch/ops/granule.py.
//
// What bounds it on an H100: the sequential overlap-add. Each subband's
// output at granule t needs granule t-1's upper IMDCT half, so this design
// walks the T granules of a chunk in order, and its parallelism is one
// thread per (stream, channel, subband): 4,096 threads at 64 streams. The
// arithmetic (648 FMA per subband-granule) and the bytes (4,608 in, 4,608
// out per granule) are small beside that latency chain.
//
// Design: block = the 32 subbands of one (stream, channel). Each thread
// loads its subband's 18 lines, applies the butterflies of its two
// boundaries (reading the 8 neighbouring lines on each side from the same
// granule row, still in L1), runs the 18 -> 36 product against the
// cosine/window tables in constant memory (every thread of a warp reads the
// same entry, so the constant cache broadcasts it), adds the carried store
// held in registers, and writes the frequency-inverted 18 outputs. The
// store after granule valid-1 is written out; with valid == 0 it is the
// input store. The TPU chain's time shift over a whole chunk becomes this
// in-register carry; no output depends on T or on the granule's place in
// the chunk, so chunk boundaries cannot change a bit of it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

__constant__ float c_cs[8];
__constant__ float c_ca[8];
__constant__ float c_cos36[18][36];
__constant__ float c_m3[18][36];     // composed short-block matrix
__constant__ float c_win[4][36];

__global__ void __launch_bounds__(32)
hybrid_kernel(const float* __restrict__ x, const int32_t* __restrict__ ginfo,
              const float* __restrict__ store_in, const int32_t* __restrict__ valid,
              float* __restrict__ x18, float* __restrict__ store_out, int T) {
  const int s = blockIdx.x >> 1, c = blockIdx.x & 1;
  const int sb = threadIdx.x;
  const int nv = min(max(valid[s], 0), T);
  const size_t st_off = (((size_t)s * 2 + c) * 32 + sb) * 18;

  float store[18];
#pragma unroll
  for (int i = 0; i < 18; i++) store[i] = store_in[st_off + i];
  if (nv == 0) {
#pragma unroll
    for (int i = 0; i < 18; i++) store_out[st_off + i] = store[i];
  }

  for (int t = 0; t < T; t++) {
    const size_t row = ((size_t)s * T + t) * 2 + c;
    const float* xg = x + row * 576;
    const int gi = ginfo[(size_t)s * T + t];
    const int bt = (gi >> (2 * c)) & 3;
    const int cls = (gi >> (4 + 2 * c)) & 3;

    float y[18];
#pragma unroll
    for (int i = 0; i < 18; i++) y[i] = xg[sb * 18 + i];
    // butterflies: long blocks all 31 boundaries, mixed boundary 0 only
    if (sb >= 1 && (cls == 0 || (cls == 2 && sb == 1))) {
#pragma unroll
      for (int i = 0; i < 8; i++) {
        const float up = xg[sb * 18 + i], lo = xg[sb * 18 - 1 - i];
        y[i] = up * c_cs[i] + lo * c_ca[i];
      }
    }
    if (sb <= 30 && (cls == 0 || (cls == 2 && sb == 0))) {
#pragma unroll
      for (int i = 0; i < 8; i++) {
        const float lo = xg[sb * 18 + 17 - i], up = xg[(sb + 1) * 18 + i];
        y[17 - i] = lo * c_cs[i] - up * c_ca[i];
      }
    }

    const int bt_eff = (cls == 2 && sb < 2) ? 0 : bt;
    float* o = x18 + row * 576 + sb * 18;
    const bool odd = sb & 1;
    if (bt_eff == 2) {
#pragma unroll
      for (int p = 0; p < 18; p++) {
        float lo = 0.0f, hi = 0.0f;
#pragma unroll
        for (int j = 0; j < 18; j++) {
          lo += y[j] * c_m3[j][p];
          hi += y[j] * c_m3[j][p + 18];
        }
        const float out = lo + store[p];
        store[p] = hi;
        o[p] = (odd && (p & 1)) ? -out : out;
      }
    } else {
#pragma unroll
      for (int p = 0; p < 18; p++) {
        float lo = 0.0f, hi = 0.0f;
#pragma unroll
        for (int j = 0; j < 18; j++) {
          lo += y[j] * c_cos36[j][p];
          hi += y[j] * c_cos36[j][p + 18];
        }
        const float out = lo * c_win[bt_eff][p] + store[p];
        store[p] = hi * c_win[bt_eff][p + 18];
        o[p] = (odd && (p & 1)) ? -out : out;
      }
    }
    if (t == nv - 1) {
#pragma unroll
      for (int i = 0; i < 18; i++) store_out[st_off + i] = store[i];
    }
  }
}

}  // namespace

extern "C" {

// cs/ca f32[8], cos36 f32[18][36], m3 f32[18][36], win f32[4][36].
int gomp3_hybrid_init(int device, const float* cs, const float* ca,
                      const float* cos36, const float* m3, const float* win) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaMemcpyToSymbol(c_cs, cs, sizeof(float) * 8);
  cudaMemcpyToSymbol(c_ca, ca, sizeof(float) * 8);
  cudaMemcpyToSymbol(c_cos36, cos36, sizeof(float) * 18 * 36);
  cudaMemcpyToSymbol(c_m3, m3, sizeof(float) * 18 * 36);
  cudaMemcpyToSymbol(c_win, win, sizeof(float) * 4 * 36);
  return (int)cudaGetLastError();
}

// x f32 [S][T][2][576], ginfo i32 [S][T], store_in f32 [S][2][32][18],
// valid i32 [S] -> x18 f32 [S][T][2][32][18], store_out f32 [S][2][32][18].
int gomp3_hybrid(int device, const float* x, const int32_t* ginfo,
                 const float* store_in, const int32_t* valid, float* x18,
                 float* store_out, int S, int T, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (S > 0 && T > 0)
    hybrid_kernel<<<S * 2, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        x, ginfo, store_in, valid, x18, store_out, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
