// K2: antialias + IMDCT + overlap-add + frequency inversion.
//
// Replaces: the XLA program of _antialias, _imdct, _overlap_fold and the
// _FREQ_INV multiply in go_mp3_tpu/ops/granule.py (:361-420, :512), and the
// one-hot extraction of the new `store` (:540-542). Plain version:
// hybrid_ref in go_mp3_tpu_torch/ops/granule.py.
//
// The overlap-add is a shift, not a recurrence: out[t] = raw[t][:18] +
// raw[t-1][18:], with raw[-1][18:] = the incoming store (_overlap_fold).
// Granule t's output needs its own lines and granule t-1's upper IMDCT
// half, nothing older, so every granule is independent work.
//
// What bounds it on an H100: memory. Per granule and channel it reads
// 2,304 bytes and writes 2,304, and does 20,736 FMA (648 per subband):
// 4.5 FMA per byte, under the card's ~10 FP32 FMA per byte of HBM.
//
// Design: one warp per (stream, channel, run of G consecutive granules),
// lane = subband, up to four warps a block. At the start of a run the warp
// computes granule t0-1's upper half (antialias, the upper 18 IMDCT
// outputs, the window), or takes the incoming store at t0 = 0; inside the
// run the upper half carries in registers. Each 576-float granule row is
// staged through shared memory with coalesced 16-byte loads, and each
// output row leaves the same way, so no lane makes 18 strided accesses to
// device memory. Every table sits in shared memory: the windows and
// butterfly constants (a mixed block's lanes index the windows by their own
// block type), and the cosine and short-block matrices as [output][j] rows
// that every lane of a warp reads at the same address, 16 bytes at a time.
// (In constant memory, as FMA operands, the matrices' 5.2 KB outgrew the
// SM's constant cache and the kernel stalled on it: 0.50 ms a chunk against
// ~0.03 ms of issued instructions.) The wrapper picks G (4, 2 or 1) so
// that a chunk of 64 streams and a single stream both spread over the card.
//
// Arithmetic: each output is summed as before, lo and hi over j = 0..17
// from 0.0f, then the window, then + store, then the sign, with every
// multiply-add written as an explicit fused or unfused operation, so the
// predecessor's upper half is bit-identical to the one a run carries and
// no output depends on G, on T or on where a chunk was split. The
// butterflies, the dot product and the tables are hybrid_tile.cuh's, which
// the granule chain (chain.cu) shares.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "hybrid_tile.cuh"

namespace {

constexpr int kMaxWarps = 4;  // (stream, channel, run) units per block

// One 576-float row, device memory -> shared memory, 16 bytes a lane.
__device__ __forceinline__ void copy_row(float* __restrict__ dst,
                                         const float* __restrict__ src, int lane) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int k = lane; k < kRow / 4; k += 32) d[k] = s[k];
}

__global__ void __launch_bounds__(kMaxWarps * 32)
hybrid_kernel(const float* __restrict__ x, const int32_t* __restrict__ ginfo,
              const float* __restrict__ store_in, const int32_t* __restrict__ valid,
              float* __restrict__ x18, float* __restrict__ store_out, int S, int T,
              int G) {
  __shared__ __align__(16) float s_tab[kHybridTabFloats];
  __shared__ float s_win[4 * 36];
  __shared__ float s_cs[8], s_ca[8];
  __shared__ __align__(16) float s_in[kMaxWarps][kRow];
  __shared__ __align__(16) float s_out[kMaxWarps][kRow];
  {
    const float4* src = reinterpret_cast<const float4*>(&g_tab[0][0][0]);
    float4* dst = reinterpret_cast<float4*>(s_tab);
    for (int k = threadIdx.x; k < kHybridTabFloats / 4; k += blockDim.x) dst[k] = src[k];
  }
  for (int k = threadIdx.x; k < 4 * 36; k += blockDim.x) s_win[k] = g_win[k];
  if (threadIdx.x < 8) {
    s_cs[threadIdx.x] = g_cs[threadIdx.x];
    s_ca[threadIdx.x] = g_ca[threadIdx.x];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, sb = threadIdx.x & 31;
  const int runs = (T + G - 1) / G;
  const long long unit = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (unit >= (long long)S * 2 * runs) return;
  const int run = (int)(unit % runs);
  const int sc = (int)(unit / runs);  // stream * 2 + channel
  const int s = sc >> 1, c = sc & 1;
  const int t0 = run * G, t1 = min(t0 + G, T);
  const int nv = min(max(valid[s], 0), T);
  const size_t st_off = ((size_t)sc * 32 + sb) * 18;
  float* xs = s_in[warp];
  float* os = s_out[warp];
  const bool odd = sb & 1;

  float store[18];
  float y[18];
  if (t0 == 0) {
#pragma unroll
    for (int i = 0; i < 18; i++) store[i] = store_in[st_off + i];
    if (nv == 0) {
#pragma unroll
      for (int i = 0; i < 18; i++) store_out[st_off + i] = store[i];
    }
  } else {  // granule t0-1's upper half: what the run before this one carries out
    copy_row(xs, x + (((size_t)s * T + t0 - 1) * 2 + c) * kRow, sb);
    __syncwarp();
    const int gi = ginfo[(size_t)s * T + t0 - 1];
    const int bt = (gi >> (2 * c)) & 3, cls = (gi >> (4 + 2 * c)) & 3;
    antialias(xs, sb, cls, s_cs, s_ca, y);
    const int bt_eff = (cls == 2 && sb < 2) ? 0 : bt;
    if (bt_eff == 2) {
      const float* m3 = s_tab + 36 * kJ;
#pragma unroll
      for (int p = 0; p < 18; p++) store[p] = dot18(y, m3 + (p + 18) * kJ);
    } else {
      const float* w = s_win + bt_eff * 36;
#pragma unroll
      for (int p = 0; p < 18; p++)
        store[p] = __fmul_rn(dot18(y, s_tab + (p + 18) * kJ), w[p + 18]);
    }
  }

  for (int t = t0; t < t1; t++) {
    const size_t row = ((size_t)s * T + t) * 2 + c;
    __syncwarp();  // the previous granule's reads of xs and os are done
    copy_row(xs, x + row * kRow, sb);
    __syncwarp();
    const int gi = ginfo[(size_t)s * T + t];
    const int bt = (gi >> (2 * c)) & 3, cls = (gi >> (4 + 2 * c)) & 3;
    antialias(xs, sb, cls, s_cs, s_ca, y);
    const int bt_eff = (cls == 2 && sb < 2) ? 0 : bt;
    float* o = os + sb * 18;
    if (bt_eff == 2) {
      const float* m3 = s_tab + 36 * kJ;
#pragma unroll
      for (int p = 0; p < 18; p++) {
        const float lo = dot18(y, m3 + p * kJ), hi = dot18(y, m3 + (p + 18) * kJ);
        const float out = __fadd_rn(lo, store[p]);
        store[p] = hi;
        o[p] = (odd && (p & 1)) ? -out : out;
      }
    } else {
      const float* w = s_win + bt_eff * 36;
#pragma unroll
      for (int p = 0; p < 18; p++) {
        const float lo = dot18(y, s_tab + p * kJ), hi = dot18(y, s_tab + (p + 18) * kJ);
        const float out = __fmaf_rn(lo, w[p], store[p]);
        store[p] = __fmul_rn(hi, w[p + 18]);
        o[p] = (odd && (p & 1)) ? -out : out;
      }
    }
    __syncwarp();
    {
      const float4* src = reinterpret_cast<const float4*>(os);
      float4* dst = reinterpret_cast<float4*>(x18 + row * kRow);
      for (int k = sb; k < kRow / 4; k += 32) dst[k] = src[k];
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
  return (int)hybrid_upload_tables(cs, ca, cos36, m3, win);
}

// x f32 [S][T][2][576], ginfo i32 [S][T], store_in f32 [S][2][32][18],
// valid i32 [S] -> x18 f32 [S][T][2][32][18], store_out f32 [S][2][32][18].
// G granules per warp, `warps` warps per block (1..4); x and x18 16-byte
// aligned. T == 0 launches nothing and copies store_in to store_out on the
// stream.
int gomp3_hybrid(int device, const float* x, const int32_t* ginfo,
                 const float* store_in, const int32_t* valid, float* x18,
                 float* store_out, int S, int T, int G, int warps, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (G < 1 || warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  if (S > 0 && T > 0) {
    const long long units = (long long)S * 2 * ((T + G - 1) / G);
    const long long blocks = (units + warps - 1) / warps;
    hybrid_kernel<<<(unsigned)blocks, warps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        x, ginfo, store_in, valid, x18, store_out, S, T, G);
  } else if (S > 0) {
    cudaMemcpyAsync(store_out, store_in, sizeof(float) * S * 2 * 32 * 18,
                    cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
