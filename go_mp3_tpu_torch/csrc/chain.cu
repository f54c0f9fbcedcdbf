// K5: the granule chain, K1 -> K2 -> K3 in one kernel, x and x18 kept on
// chip.
//
// Replaces: decode_chunk_impl (go_mp3_tpu/ops/granule.py:493-549), the one
// compiled program that the TPU runs per chunk, through
// decode_chunk_fused_batch_impl / decode_chunk_fused_mono_batch_impl
// (:726-741) as scan_fused scans it (go_mp3_tpu/parallel/corpus.py:566-603),
// and through decode_chunk_packed(8)_impl as scan_corpus and the Decoder
// run it. The port ran it as three launches, K1 (requant_stereo.cu) -> K2
// (hybrid.cu) -> K3 (synth.cu), whose x and x18 (f32, 4,608 bytes a granule
// each) went out to device memory and back. Plain version:
// decode_chunk_ref in go_mp3_tpu_torch/ops/granule.py (on the wire, after
// requant_stereo_fused_ref's unpack).
//
// What bounds it on an H100: float32 issue. What must move is the input
// (~2.6 KB a granule on the int8 interface and the wire), the PCM (2,304
// bytes) and the state; the operations the function needs are ~168 K a
// granule (K1's requantize and stereo, K2's 18 independent IMDCT outputs
// of each subband, K3's 34 independent v rows and the 16-tap FIR): 2.58
// GFLOP against 75 MB a [64, 240] chunk, 0.038 ms at 67 TFLOP/s. This
// design runs at ~7.5x that: its stages follow each other between
// barriers, two blocks an SM (shared memory and 64 registers a thread cap
// it there), so each stage waits on its own latency. clock64 stamps per
// block (tests/chain_probe.py) put K1 at ~34% of a block's time (most of
// it the per-band values and the exp2f/log2f lines), the matrixing at ~34%
// and K2 at ~24% (PERF.md).
//
// Design. A block owns a run of G consecutive granules t0 .. t1-1 of one
// stream (G = 1, 2 or 4, picked by the wrapper so that the chunk spreads
// over the card; no output depends on it), 512 threads, and runs the three
// stages one after another in shared memory:
//  K1  requant_tile.cuh's tile body on granules t0-2 .. t1-1 (clamped at 0)
//      -> x [granule][channel][576], and each granule's ginfo word. Blocks
//      run in parallel, so each one recomputes a halo of two granules: t0-2
//      gives the upper IMDCT half that granule t0-1 overlaps with, t0-1 its
//      x18, whose slots 3..17 give K3's 15 v rows before the run.
//  K2  one thread per (granule, channel, subband), every granule at once:
//      the overlap-add is a shift (hybrid.cu), so pass 1 writes each
//      granule's unwindowed lower IMDCT half into the x18 buffer and its
//      windowed upper half beside it, and after a barrier pass 2 forms
//      out = fma(lo, w, hi_prev) (short blocks: lo + hi_prev) and the
//      frequency inversion in place: hybrid.cu's operations in its order.
//      Long blocks form 18 of the 36 IMDCT outputs (COS_N36's columns
//      17 - i are the negatives of columns i and 35 - i equal 18 + i,
//      exactly in float32) and short blocks the 24 that are not 0 (m3's
//      columns 0..5 and 30..35 are zero: a zero row's dot18 is +0).
//  K3  synth_tile.cuh: the 34 independent v rows of each x18 slot
//      (matrix_tile_sym, the other 30 by a sign or a copy) into v, which
//      takes the place of x once K2 is done; the 15 rows before the run from
//      granule t0-1 or, at t0 = 0, the incoming FIFO; then the FIR, the
//      int16 PCM in 32-bit words, and the FIFO after `valid` granules.
// The block holding granule valid-1 writes the new store and FIFO; with
// valid = 0 the block at t0 = 0 copies both. The tables (K2's matrices and
// window, the 34 matrixing columns) sit in shared memory: in constant
// memory K2's stalled (hybrid.cu). FP32 only: no TF32, no tensor cores.
//
// Arithmetic: every float expression is K1's, K2's and K3's own, from
// their shared headers, so the PCM and the state are K1 -> K2 -> K3's bit
// for bit (a value taken by a sign from its mirror may differ from K2's or
// K3's only in the sign of an exact zero, which no later operation and no
// int16 sample sees).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda_pipeline.h>

#include "device_guard.cuh"
#include "fused_tile.cuh"
#include "hybrid_tile.cuh"
#include "requant_tile.cuh"
#include "synth_tile.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kHalo = 2;     // granules recomputed before a run
constexpr int kSpan = 4;     // K1's lines an item
constexpr int kSubFloats = 2 * 18 * 32;  // one granule's [channel][p][sb] upper halves
constexpr int kVStride = 65;  // v's row stride: the symmetric matrixing's stores, a float each
// K1's wire tail is staged from the multiple of 4 at or below its first
// granule t0-2 (t0 a multiple of G), so that its loads stay 4 bytes wide
__host__ __device__ constexpr int staged(int G) { return G + kHalo + (G % 2 ? 3 : 2); }

// Shared memory, in floats: the tables, the ginfo words, the x18 slots of
// granules t0-1 .. t1-1, then one region that holds K1's x and K2's upper
// halves (K1's scratch where the upper halves go later) and, once K2 is
// done, K3's v.
constexpr int kTabFloats = kHybridTabFloats + 4 * 36 + 8 + 8 + 32 * kSymCols;
constexpr int kGinfoFloats = 8;
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
template <int G>
__host__ __device__ constexpr int region_floats() {
  return imax((G + kHalo) * 2 * kRow +
                  imax((G + kHalo - 1) * kSubFloats,
                       (int)(sizeof(RequantSmem<kFused, G + kHalo, staged(G)>) + 15) / 16 * 4),
              2 * v_rows(G) * kVStride);
}
template <int G>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (kTabFloats + kGinfoFloats + (G + 1) * kXsFloats + region_floats<G>());
}

// The tables into shared memory: the float4s of K2's tables and of the 34
// matrixing columns, in their order there, by cp.async, so that the copy
// overlaps K1's loads.
__device__ __forceinline__ void tables_async(float* __restrict__ dst, int tid) {
  const float4* srcs[5] = {reinterpret_cast<const float4*>(&g_tab[0][0][0]),
                           reinterpret_cast<const float4*>(g_win),
                           reinterpret_cast<const float4*>(g_cs),
                           reinterpret_cast<const float4*>(g_ca),
                           reinterpret_cast<const float4*>(g_ntc)};
  const int counts[5] = {kHybridTabFloats / 4, 4 * 36 / 4, 2, 2, 32 * kSymCols / 4};
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int t = 0; t < 5; t++) {
    for (int k = tid; k < counts[t]; k += kThreads)
      __pipeline_memcpy_async(d + k, srcs[t] + k, sizeof(float4));
    d += counts[t];
  }
  __pipeline_commit();
}

template <int kLayout, int G>
__global__ void __launch_bounds__(kThreads, 2)
chain_kernel(const Inputs in, const gomp3::Wire w, const float* __restrict__ store_in,
             const float* __restrict__ fifo_in, const int32_t* __restrict__ valid,
             int16_t* __restrict__ pcm, float* __restrict__ store_out,
             float* __restrict__ fifo_out, int T, size_t granules) {
  constexpr int NG = G + kHalo;  // K1's granules at most
  using Scratch = RequantSmem<kLayout, NG, staged(G)>;
  static_assert(sizeof(Scratch) <= sizeof(RequantSmem<kFused, NG, staged(G)>), "");
  extern __shared__ __align__(16) float smem[];
  float* s_tab = smem;                            // K2's matrices [2][36][kJ]
  float* s_win = s_tab + kHybridTabFloats;        // [4][36]
  float* s_cs = s_win + 4 * 36;
  float* s_ca = s_cs + 8;
  float* ntc = s_ca + 8;                          // [sb][kSymCols]
  int32_t* ginfo = reinterpret_cast<int32_t*>(ntc + 32 * kSymCols);  // [NG]
  float* xs = ntc + 32 * kSymCols + kGinfoFloats;  // x18 [G + 1][2][18][kXsStride]
  float* x = xs + (G + 1) * kXsFloats;            // K1's x [NG][2][576]
  float* hi = x + NG * 2 * kRow;                  // K2's upper halves [NG - 1][2][18][32]
  float* v = x;                                   // K3's v [2][vrows][kVStride], after K2
  auto& rq = *reinterpret_cast<Scratch*>(hi);     // K1's scratch

  const int s = blockIdx.y, tid = threadIdx.x;
  const int t0 = blockIdx.x * G, t1 = min(t0 + G, T), ng = t1 - t0;
  const int h = min(t0, kHalo);     // halo granules
  const int first = t0 - h;         // K1's first granule
  const int nv = min(max(valid[s], 0), T);
  const int vrows = v_rows(G);
  tables_async(smem, tid);

  // -- K1: granules first .. t1-1 -> x, ginfo ---------------------------------
  requant_tile<kLayout, NG, kThreads, kSpan, staged(G)>(
      in, w, s, first, h + ng, (size_t)s * T + first, 1, granules, x, ginfo, first & ~3, rq,
      tid);
  __pipeline_wait_prior(0);  // the tables
  __syncthreads();

  // -- K2, pass 1: thread (granule, channel, subband) -------------------------
  for (int u = tid; u < (h + ng) * 64; u += kThreads) {
    const int g = u >> 6, c = (u >> 5) & 1, sb = u & 31;
    const int tg = first + g;
    const int li = tg - t0 + 1;  // its x18 slot; -1: granule t0-2, upper half only
    const bool need_up = tg < t1 - 1 || tg == nv - 1;
    const int gi = ginfo[g];
    const int bt = (gi >> (2 * c)) & 3, cls = (gi >> (4 + 2 * c)) & 3;
    float y[18];
    antialias(x + (g * 2 + c) * kRow, sb, cls, s_cs, s_ca, y);
    const int bt_eff = (cls == 2 && sb < 2) ? 0 : bt;
    float* lo = xs + max(li, 0) * kXsFloats + c * 18 * kXsStride + sb;  // lo[p * kXsStride]
    float up[18];
    if (bt_eff == 2) {
      const float* m3 = s_tab + 36 * kJ;
      if (li >= 0) {
#pragma unroll
        for (int p = 0; p < 18; p++) lo[p * kXsStride] = p < 6 ? 0.0f : dot18(y, m3 + p * kJ);
      }
      if (need_up) {
#pragma unroll
        for (int q = 0; q < 18; q++) up[q] = q < 12 ? dot18(y, m3 + (q + 18) * kJ) : 0.0f;
      }
    } else {
      if (li >= 0) {
#pragma unroll
        for (int i = 0; i < 9; i++) {
          const float r = dot18(y, s_tab + i * kJ);
          lo[i * kXsStride] = r;
          lo[(17 - i) * kXsStride] = -r;
        }
      }
      if (need_up) {
        const float* wn = s_win + bt_eff * 36;
#pragma unroll
        for (int i = 0; i < 9; i++) {
          const float r = dot18(y, s_tab + (18 + i) * kJ);
          up[i] = __fmul_rn(r, wn[18 + i]);
          up[17 - i] = __fmul_rn(r, wn[35 - i]);
        }
      }
    }
    if (tg < t1 - 1) {
#pragma unroll
      for (int p = 0; p < 18; p++) hi[((g * 2 + c) * 18 + p) * 32 + sb] = up[p];
    }
    if (tg == nv - 1) {
#pragma unroll
      for (int p = 0; p < 18; p++) store_out[(((size_t)s * 2 + c) * 32 + sb) * 18 + p] = up[p];
    }
  }
  __syncthreads();

  // -- K2, pass 2: overlap-add and frequency inversion of granules
  // max(t0-1, 0) .. t1-1, in place --------------------------------------------
  const int l_first = t0 - min(t0, 1);
  for (int u = tid; u < (t1 - l_first) * 64; u += kThreads) {
    const int tg = l_first + (u >> 6), c = (u >> 5) & 1, sb = u & 31;
    const int g = tg - first;
    const int gi = ginfo[g];
    const int bt = (gi >> (2 * c)) & 3, cls = (gi >> (4 + 2 * c)) & 3;
    const int bt_eff = (cls == 2 && sb < 2) ? 0 : bt;
    const float* wn = s_win + bt_eff * 36;
    const bool odd = sb & 1;
    float* o = xs + (tg - t0 + 1) * kXsFloats + c * 18 * kXsStride + sb;
#pragma unroll
    for (int p = 0; p < 18; p++) {
      const float prev = tg == 0 ? store_in[(((size_t)s * 2 + c) * 32 + sb) * 18 + p]
                                 : hi[(((g - 1) * 2 + c) * 18 + p) * 32 + sb];
      const float lo = o[p * kXsStride];
      const float out = bt_eff == 2 ? __fadd_rn(lo, prev) : __fmaf_rn(lo, wn[p], prev);
      o[p * kXsStride] = (odd && (p & 1)) ? -out : out;
    }
  }
  __syncthreads();

  // -- K3: matrixing of granules t0-1 (its slots 3..17) .. t1-1 into v ------
  const int halo = t0 > 0 ? 1 : 0;
  if (!halo) fifo_to_halo<kThreads, kVStride>(v, vrows, fifo_in, s, tid);
  constexpr int kItemsAtOnce = kThreads / kSymTile;
  if (tid < kItemsAtOnce * kSymTile) {
    for (int it = tid / kSymTile; it < ng + halo; it += kItemsAtOnce) {
      if (it < halo)
        matrix_tile_sym<kVStride>(xs, ntc, v, vrows, -3, 3, tid % kSymTile);
      else
        matrix_tile_sym<kVStride>(xs + (it - halo + 1) * kXsFloats, ntc, v, vrows,
                                  15 + (it - halo) * 18, 0, tid % kSymTile);
    }
  }
  __syncthreads();
  fir_to_pcm<kThreads, kVStride>(v, vrows, ginfo + h, pcm, s, T, t0, ng, tid);
  write_fifo<kThreads, kVStride>(v, vrows, fifo_in, fifo_out, s, t0, t1, nv, tid);
  if (nv == 0 && t0 == 0) {
    for (int k = tid; k < kSubFloats; k += kThreads)
      store_out[(size_t)s * kSubFloats + k] = store_in[(size_t)s * kSubFloats + k];
  }
}

template <int kLayout, int G>
cudaError_t launch(const Inputs& in, const gomp3::Wire& w, const float* store_in,
                   const float* fifo_in, const int32_t* valid, int16_t* pcm,
                   float* store_out, float* fifo_out, int S, int T, cudaStream_t st) {
  dim3 grid((T + G - 1) / G, S);
  chain_kernel<kLayout, G><<<grid, kThreads, smem_bytes<G>(), st>>>(
      in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, T, (size_t)S * T);
  return cudaGetLastError();
}

template <int kLayout>
cudaError_t launch_run(int G, const Inputs& in, const gomp3::Wire& w, const float* store_in,
                       const float* fifo_in, const int32_t* valid, int16_t* pcm,
                       float* store_out, float* fifo_out, int S, int T, cudaStream_t st) {
  switch (G) {
    case 1: return launch<kLayout, 1>(in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, st);
    case 2: return launch<kLayout, 2>(in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, st);
    case 4: return launch<kLayout, 4>(in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int kLayout>
void allow_smem() {
  cudaFuncSetAttribute(chain_kernel<kLayout, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes<1>());
  cudaFuncSetAttribute(chain_kernel<kLayout, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes<2>());
  cudaFuncSetAttribute(chain_kernel<kLayout, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes<4>());
}

// Whether cos36 ([18 j][36 p]) and m3 have the structure K2's part of the
// chain rests on: cos36's columns 17 - i the negatives of columns i and
// columns 35 - i equal to 18 + i; m3's columns 0..5 and 30..35 zero.
bool hybrid_structured(const float* cos36, const float* m3) {
  for (int j = 0; j < 18; j++) {
    const float* c = cos36 + j * 36;
    const float* m = m3 + j * 36;
    for (int i = 0; i < 18; i++) {
      if (c[17 - i] != -c[i] || c[35 - i] != c[18 + i]) return false;
      if ((i < 6 && m[i] != 0.0f) || (i < 6 && m[30 + i] != 0.0f)) return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Upload every table of the chain to `device` (once per device before the
// first launch): K1's (as gomp3_requant_stereo_init takes them), K2's
// (cs/ca f32[8], cos36 f32[18][36], m3 f32[18][36], win f32[4][36]) and
// K3's (nt f32[32][64], SYNTH_N_WIN transposed; dtbl f32[512]). Returns
// cudaErrorInvalidValue if cos36, m3 or nt lack the symmetries above.
int gomp3_chain_init(int device, const float* pretab, const float* is_l, const float* is_r,
                     const int32_t* long_start, const int32_t* short_start3,
                     const uint8_t* long_sfb, const uint8_t* req_short,
                     const uint8_t* is_short, const float* cs, const float* ca,
                     const float* cos36, const float* m3, const float* win, const float* nt,
                     const float* dtbl) {
  if (!hybrid_structured(cos36, m3) || !synth_symmetric(nt))
    return (int)cudaErrorInvalidValue;
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  requant_upload_tables(pretab, is_l, is_r, long_start, short_start3, long_sfb, req_short,
                        is_short);
  hybrid_upload_tables(cs, ca, cos36, m3, win);
  synth_upload_tables(nt, dtbl);
  allow_smem<kInt16>();
  allow_smem<kInt8>();
  allow_smem<kBatch>();
  allow_smem<kFused>();
  return (int)cudaGetLastError();
}

// layout and inputs: as gomp3_requant_stereo takes them (tail_lines and nch
// read only by the fused layout). store_in f32 [S][2][32][18], fifo_in f32
// [S][2][16][64], valid i32 [S] -> pcm i16 [S][T*576][2] (4-byte aligned),
// store_out, fifo_out: the state after each stream's valid granules. G
// granules a block: 1, 2 or 4. T == 0 launches nothing and copies the
// state on the stream.
int gomp3_chain(int device, int layout, const void* const* inputs, const float* store_in,
                const float* fifo_in, const int32_t* valid, int16_t* pcm, float* store_out,
                float* fifo_out, int S, int T, int G, int tail_lines, int nch, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int count = input_count(layout);
  if (count == 0 || S < 0 || T < 0 || (G != 1 && G != 2 && G != 4))
    return (int)cudaErrorInvalidValue;
  if (layout == kFused && (tail_lines < 0 || tail_lines > kTailLines || (nch != 1 && nch != 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0) return (int)cudaGetLastError();
  if (T == 0) {
    cudaMemcpyAsync(store_out, store_in, sizeof(float) * S * kSubFloats,
                    cudaMemcpyDeviceToDevice, st);
    cudaMemcpyAsync(fifo_out, fifo_in, sizeof(float) * S * 2 * 16 * 64,
                    cudaMemcpyDeviceToDevice, st);
    return (int)cudaGetLastError();
  }
  Inputs in = {};
  for (int i = 0; i < count; i++) in.p[i] = inputs[i];
  gomp3::Wire w = {static_cast<const uint8_t*>(in.p[0]),
                   gomp3::wire_row_bytes(T, tail_lines, nch), T, tail_lines, nch};
  switch (layout) {
    case kInt16:
      return (int)launch_run<kInt16>(G, in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, st);
    case kInt8:
      return (int)launch_run<kInt8>(G, in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, st);
    case kBatch:
      return (int)launch_run<kBatch>(G, in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, st);
    default:
      return (int)launch_run<kFused>(G, in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, st);
  }
}

}  // extern "C"
