// K5: the granule chain, K1 -> K2 -> K3 in one kernel, x and x18 kept on
// chip, a block walking a segment of runs with the state carried on chip.
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
// GFLOP against 75 MB a [64, 240] chunk, 0.038 ms at 67 TFLOP/s. A block
// of one run that ran K1, K2 and K3 between block-wide barriers, and
// recomputed two granules before its run, took ~7.5x that bound; this
// design takes ~7x. Its K1 group is the slower of the two (~29 K cycles a
// run of 4 granules against ~27 K for K2 and K3, tests/chain_probe.py),
// and one block an SM with no register spills runs at the same rate: the
// SM's shared issue, not a stage's latency, holds it there (PERF.md).
//
// Design. A block owns a segment of L consecutive runs of G granules of
// one stream (granules T0 .. T1-1; G = 1, 2 or 4, L >= 1, picked by the
// wrapper so that the chunk fills the card; no output depends on either)
// and walks it run by run, 512 threads in two groups of 256:
//  - the K1 group runs requant_tile.cuh's tile body on one run after
//    another into x [G][2][576] (shared), each granule's ginfo word into
//    one of three slots, its own barrier a named one (barrier.cuh);
//  - the K2/K3 group takes each run from x: K2 pass 1, a thread per
//    (granule, channel, subband), writes the unwindowed lower IMDCT half
//    into the run's x18 slots and the windowed upper half beside it; pass
//    2 forms out = fma(lo, w, hi_prev) (short blocks: lo + hi_prev) and the
//    frequency inversion in place (hybrid.cu's operations in its order,
//    the overlap-add a shift); K3 (synth_tile.cuh) forms the 34
//    independent v rows of each slot into v, the FIR, the int16 PCM in
//    32-bit words and, in the run holding granule valid-1, the FIFO.
// The groups hand a run over through two named barriers: FULL (the K1
// group arrives once x holds run r; the K2/K3 group waits) and EMPTY (the
// K2/K3 group arrives once K2's pass 1 has read x; the K1 group waits
// before its last step writes x). So K1 of run r+1 runs while run r's
// pass 2, matrixing and FIR do; K1's loads and per-band values for run
// r+1 overlap run r's pass 1 too.
// What a run needs of the one before it stays on chip: the windowed upper
// halves of its last granule ([2][18][32], `carry`) and its last 15 v
// rows (copied to rows 0..14 of v). Only the segment's start recomputes:
// the first steps of the walk are K1 and K2 of granules T0-2 and T0-1
// (the halo, clamped at 0), whose upper halves and slots 3..17 give the
// carry and v rows 0..14 (at T0 = 0: the incoming store and FIFO).
// L = 1 runs the one-run-a-block kernel (chain_kernel_run1 below): a halo
// before every run, in the run's own passes, all 512 threads on each stage.
//
// Shared memory (floats): the tables (K2's matrices and window, the 34
// matrixing columns: by cp.async, which overlaps K1's first loads; in
// constant memory K2 stalled, hybrid.cu), three ginfo slots, the carry,
// the run's x18 slots, x, K1's scratch, then v [2][18G + 15][65]. The
// upper halves of the run's granules live in channel 0's rows 15.. of v
// until pass 2 has read them (the matrixing writes there after). At G = 4
// a block takes ~108 KB on the wire: two blocks an SM.
//
// One thread group that ran each stage in turn, with the next run's input
// rows copied into shared memory by cp.async meanwhile, was 9-75% slower
// than the two overlapped groups on an H100 (PERF.md).
//
// Arithmetic: every float expression is K1's, K2's and K3's own, from
// their shared headers and in their order, so the PCM and the state are
// K1 -> K2 -> K3's bit for bit, and a carried value is the recomputed
// halo's (a value taken by a sign from its mirror may differ from K2's or
// K3's only in the sign of an exact zero, which no later operation and no
// int16 sample sees). FP32 only: no TF32, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda_pipeline.h>

#include "barrier.cuh"
#include "device_guard.cuh"
#include "fused_tile.cuh"
#include "hybrid_tile.cuh"
#include "requant_tile.cuh"
#include "synth_tile.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kK23 = 256;    // the walk's K2/K3 threads (whole warps)
constexpr int kK1 = kThreads - kK23;  // and its K1 threads
constexpr int kHalo = 2;     // granules recomputed before a segment
constexpr int kSpan = 4;     // K1's lines an item
constexpr int kSubFloats = 2 * 18 * 32;  // one granule's [channel][p][sb] upper halves
constexpr int kVStride = 65;  // v's row stride: the symmetric matrixing's stores, a float each
enum Bar : int { kBarK1 = 1, kBarK23 = 2, kBarFull = 3, kBarEmpty = 4 };
// K1's wire tail is staged from the multiple of 4 at or below a step's
// first granule: run starts are multiples of G (<= 4), the halo starts at
// T0-2, so a step's granules lie within 4 of it
constexpr int kStaged = 4;

constexpr int kTabFloats = kHybridTabFloats + 4 * 36 + 8 + 8 + 32 * kSymCols;
constexpr int kGinfoFloats = 3 * 8;  // three slots: K1 writes run r+1's while the FIR reads r-1's
template <int kLayout, int G>
__host__ __device__ constexpr int scratch_floats() {
  return (int)(sizeof(RequantSmem<kLayout, G, kStaged>) + 15) / 16 * 4;
}
template <int kLayout, int G>
__host__ __device__ constexpr int smem_floats() {
  return kTabFloats + kGinfoFloats + kSubFloats + G * kXsFloats + G * 2 * kRow +
         scratch_floats<kLayout, G>() + 2 * v_rows(G) * kVStride;
}
template <int kLayout, int G>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * smem_floats<kLayout, G>();
}

template <int kLayout, int G>
struct Smem {
  float *tab, *win, *cs, *ca, *ntc;
  int32_t* ginfo;  // [3][8]
  float* carry;    // upper halves of the granule before the step [2][18][32]
  float* xs;       // x18 [G][2][18][kXsStride]
  float* x;        // K1's x [G][2][576]
  RequantSmem<kLayout, G, kStaged>* rq;
  float* v;        // [2][v_rows(G)][kVStride]

  __device__ __forceinline__ explicit Smem(float* base) {
    tab = base;
    win = tab + kHybridTabFloats;
    cs = win + 4 * 36;
    ca = cs + 8;
    ntc = ca + 8;
    ginfo = reinterpret_cast<int32_t*>(ntc + 32 * kSymCols);
    carry = ntc + 32 * kSymCols + kGinfoFloats;
    xs = carry + kSubFloats;
    x = xs + G * kXsFloats;
    rq = reinterpret_cast<RequantSmem<kLayout, G, kStaged>*>(x + G * 2 * kRow);
    v = x + G * 2 * kRow + scratch_floats<kLayout, G>();
  }
  // the upper halves of the step's granule j - 1 (j = 1 .. G), in channel
  // 0's v rows 15 + 18 (j - 1) .. (1,152 floats in 18 rows of 65)
  __device__ __forceinline__ float* hi(int j) const { return v + (15 + 18 * (j - 1)) * kVStride; }
};

// A block's segment and its walk: steps 0 .. nh-1 are the halo, granules
// T0-h .. T0-1 at most G a step; then a step per run of G granules.
struct Seg {
  int T0, T1, h, nh, nsteps, nv, G;
  __device__ __forceinline__ Seg(int seg, int L, int g, int T, int valid) : G(g) {
    T0 = seg * L * G;
    T1 = min(T0 + L * G, T);
    h = min(T0, kHalo);
    nh = (h + G - 1) / G;
    nsteps = nh + (T1 - T0 + G - 1) / G;
    nv = min(max(valid, 0), T);
  }
  // step k: granules a .. a+n-1
  __device__ __forceinline__ void step(int k, int& a, int& n) const {
    if (k < nh) {
      a = T0 - h + k * G;
      n = min(G, T0 - a);
    } else {
      a = T0 + (k - nh) * G;
      n = min(G, T1 - a);
    }
  }
};

// The tables into shared memory: the float4s of K2's tables and of the 34
// matrixing columns, in their order there, by cp.async (kN threads).
template <int kN>
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
    for (int k = tid; k < counts[t]; k += kN)
      __pipeline_memcpy_async(d + k, srcs[t] + k, sizeof(float4));
    d += counts[t];
  }
  __pipeline_commit();
}

// K1 of step k (kN threads) -> x, ginfo slot k % 3
template <int kLayout, int G, int kN, class Sync, class BeforeC>
__device__ __forceinline__ void k1_step(const Inputs& in, const gomp3::Wire& w, int s, int T,
                                        size_t granules, const Seg& sg, int k,
                                        const Smem<kLayout, G>& m, int tid, Sync sync,
                                        BeforeC before_c) {
  int a, n;
  sg.step(k, a, n);
  requant_tile<kLayout, G, kN, kSpan, kStaged>(in, w, s, a, n, (size_t)s * T + a, 1,
                                                 granules, m.x, m.ginfo + (k % 3) * 8,
                                                 a & ~3, *m.rq, tid, sync, before_c);
}

// Before the walk (K2/K3's threads): the tables, and at the stream's start
// the incoming store as the carry and the FIFO as v rows 0..14; with
// valid = 0 the block at T0 = 0 copies the store (write_fifo the FIFO).
template <int kLayout, int G, int kN>
__device__ __forceinline__ void k23_prologue(const Smem<kLayout, G>& m, const Seg& sg, int s,
                                             const float* __restrict__ store_in,
                                             const float* __restrict__ fifo_in,
                                             float* __restrict__ store_out, int tid) {
  tables_async<kN>(m.tab, tid);
  if (sg.T0 - sg.h == 0) {
    for (int k = tid; k < kSubFloats; k += kN) {
      const int c = k / 576, p = (k / 32) % 18, sb = k % 32;
      m.carry[k] = store_in[(((size_t)s * 2 + c) * 32 + sb) * 18 + p];
    }
  }
  if (sg.T0 == 0) fifo_to_halo<kN, kVStride>(m.v, v_rows(G), fifo_in, s, tid);
  if (sg.T0 == 0 && sg.nv == 0) {
    for (int k = tid; k < kSubFloats; k += kN)
      store_out[(size_t)s * kSubFloats + k] = store_in[(size_t)s * kSubFloats + k];
  }
  __pipeline_wait_prior(0);  // the caller's next barrier makes the tables visible
}

// K2 and K3 of step k (kN threads, x and ginfo slot k % 3 ready). After
// pass 1 has read x, after_pass1(more) (more: a step follows).
template <int kLayout, int G, int kN, class Sync, class AfterPass1>
__device__ __forceinline__ void k23_step(const Smem<kLayout, G>& m, const Seg& sg, int k, int s,
                                         int T, const float* __restrict__ fifo_in,
                                         int16_t* __restrict__ pcm,
                                         float* __restrict__ store_out,
                                         float* __restrict__ fifo_out, int tid, Sync sync,
                                         AfterPass1 after_pass1) {
  int a, n;
  sg.step(k, a, n);
  const int32_t* gi = m.ginfo + (k % 3) * 8;
  const bool more = k + 1 < sg.nsteps;
  const int vrows = v_rows(G);

  // -- K2, pass 1: thread (granule, channel, subband) -------------------------
  for (int u = tid; u < n * 64; u += kN) {
    const int g = u >> 6, c = (u >> 5) & 1, sb = u & 31;
    const int tg = a + g;
    const bool need_lo = tg >= sg.T0 - 1;  // its x18: not granule T0-2's
    const bool need_up = tg < sg.T1 - 1 || tg == sg.nv - 1;
    const int gw = gi[g];
    const int bt = (gw >> (2 * c)) & 3, cls = (gw >> (4 + 2 * c)) & 3;
    float y[18];
    antialias(m.x + (g * 2 + c) * kRow, sb, cls, m.cs, m.ca, y);
    const int bt_eff = (cls == 2 && sb < 2) ? 0 : bt;
    float* lo = m.xs + g * kXsFloats + c * 18 * kXsStride + sb;  // lo[p * kXsStride]
    float up[18];
    if (bt_eff == 2) {
      const float* m3 = m.tab + 36 * kJ;
      if (need_lo) {
#pragma unroll
        for (int p = 0; p < 18; p++) lo[p * kXsStride] = p < 6 ? 0.0f : dot18(y, m3 + p * kJ);
      }
      if (need_up) {
#pragma unroll
        for (int q = 0; q < 18; q++) up[q] = q < 12 ? dot18(y, m3 + (q + 18) * kJ) : 0.0f;
      }
    } else {
      if (need_lo) {
#pragma unroll
        for (int i = 0; i < 9; i++) {
          const float r = dot18(y, m.tab + i * kJ);
          lo[i * kXsStride] = r;
          lo[(17 - i) * kXsStride] = -r;
        }
      }
      if (need_up) {
        const float* wn = m.win + bt_eff * 36;
#pragma unroll
        for (int i = 0; i < 9; i++) {
          const float r = dot18(y, m.tab + (18 + i) * kJ);
          up[i] = __fmul_rn(r, wn[18 + i]);
          up[17 - i] = __fmul_rn(r, wn[35 - i]);
        }
      }
    }
    if (tg < sg.T1 - 1) {  // granule T0-2 feeds only the carry
      float* dst = (tg == sg.T0 - 2 ? m.carry : m.hi(g + 1)) + c * 18 * 32 + sb;
#pragma unroll
      for (int p = 0; p < 18; p++) dst[p * 32] = up[p];
    }
    if (tg == sg.nv - 1 && tg >= sg.T0) {
#pragma unroll
      for (int p = 0; p < 18; p++) store_out[(((size_t)s * 2 + c) * 32 + sb) * 18 + p] = up[p];
    }
  }
  after_pass1(more);
  sync();

  // -- K2, pass 2: overlap-add and frequency inversion of the step's granules
  // from max(T0-1, 0), in place; the first of them overlaps the carry, which
  // its thread then replaces by the step's last upper halves ------------------
  const int g0 = max(0, sg.T0 - 1 - a);
  for (int u = tid; u < (n - g0) * 64; u += kN) {
    const int g = g0 + (u >> 6), c = (u >> 5) & 1, sb = u & 31;
    const int gw = gi[g];
    const int bt = (gw >> (2 * c)) & 3, cls = (gw >> (4 + 2 * c)) & 3;
    const int bt_eff = (cls == 2 && sb < 2) ? 0 : bt;
    const float* wn = m.win + bt_eff * 36;
    const bool odd = sb & 1;
    float* o = m.xs + g * kXsFloats + c * 18 * kXsStride + sb;
    const float* prev = (g == g0 ? m.carry : m.hi(g)) + c * 18 * 32 + sb;
#pragma unroll
    for (int p = 0; p < 18; p++) {
      const float lo = o[p * kXsStride];
      const float out = bt_eff == 2 ? __fadd_rn(lo, prev[p * 32])
                                    : __fmaf_rn(lo, wn[p], prev[p * 32]);
      o[p * kXsStride] = (odd && (p & 1)) ? -out : out;
    }
    if (g == g0 && more) {
      const float* src = m.hi(n) + c * 18 * 32 + sb;
      float* dst = m.carry + c * 18 * 32 + sb;
#pragma unroll
      for (int p = 0; p < 18; p++) dst[p * 32] = src[p * 32];
    }
  }
  sync();

  // -- K3 ----------------------------------------------------------------------
  if (k < sg.nh) {  // the halo: granule T0-1's slots 3..17 -> v rows 0..14
    if (k == sg.nh - 1 && tid < kSymTile)
      matrix_tile_sym<kVStride>(m.xs + (n - 1) * kXsFloats, m.ntc, m.v, vrows, -3, 3, tid);
    return;  // the next step's barriers order these rows before their use
  }
  constexpr int kItemsAtOnce = kN / kSymTile;
  if (tid < kItemsAtOnce * kSymTile) {
    for (int it = tid / kSymTile; it < n; it += kItemsAtOnce)
      matrix_tile_sym<kVStride>(m.xs + it * kXsFloats, m.ntc, m.v, vrows, 15 + 18 * it, 0,
                                tid % kSymTile);
  }
  sync();
  fir_to_pcm<kN, kVStride>(m.v, vrows, gi, pcm, s, T, a, n, tid);
  write_fifo<kN, kVStride>(m.v, vrows, fifo_in, fifo_out, s, a, a + n, sg.nv, tid);
  if (more) {  // the run's last 15 v rows become the next run's first
    sync();
    for (int q = tid; q < 2 * 15 * kVStride; q += kN) {
      const int c = q / (15 * kVStride), r = q % (15 * kVStride);
      m.v[c * vrows * kVStride + r] = m.v[(c * vrows + 18 * n) * kVStride + r];
    }
  }
}

// the K1 group's wait before it writes x (not before the first step's)
struct WaitForX {
  bool wait;
  __device__ __forceinline__ void operator()() const {
    if (wait) gomp3::bar_sync(kBarEmpty, kThreads);
  }
};
// the K2/K3 group's release of x once pass 1 has read it
struct ReleaseX {
  __device__ __forceinline__ void operator()(bool more) const {
    if (more) gomp3::bar_arrive(kBarEmpty, kThreads);
  }
};

// L = 1: the one-run-a-block kernel (a block per run of G granules, all
// 512 threads on each stage in turn, the halo's K1 and K2 in the run's
// own passes). A walk of one run hands the halo from step to step and
// leaves half the threads idle in each: it took 1.4-1.6x this kernel's
// time on an H100 at [1, 128], [64, 37] and [64, 240] (PERF.md), the
// shapes where the wrapper picks L = 1. Shared memory, in floats: the tables, the
// ginfo words, the x18 slots of granules t0-1 .. t1-1, then one region
// that holds K1's x and K2's upper halves (K1's scratch where the upper
// halves go later) and, once K2 is done, K3's v.
// K1's wire tail is staged from the multiple of 4 at or below its first
// granule t0-2 (t0 a multiple of G), so that its loads stay 4 bytes wide
__host__ __device__ constexpr int run_staged(int G) { return G + kHalo + (G % 2 ? 3 : 2); }
constexpr int kRunGinfoFloats = 8;
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
template <int G>
__host__ __device__ constexpr int run_region_floats() {
  return imax((G + kHalo) * 2 * kRow +
                  imax((G + kHalo - 1) * kSubFloats,
                       (int)(sizeof(RequantSmem<kFused, G + kHalo, run_staged(G)>) + 15) / 16 * 4),
              2 * v_rows(G) * kVStride);
}
template <int G>
__host__ __device__ constexpr size_t run_smem_bytes() {
  return sizeof(float) *
         (kTabFloats + kRunGinfoFloats + (G + 1) * kXsFloats + run_region_floats<G>());
}

template <int kLayout, int G>
__global__ void __launch_bounds__(kThreads, 2)
chain_kernel_run1(const Inputs in, const gomp3::Wire w, const float* __restrict__ store_in,
                  const float* __restrict__ fifo_in, const int32_t* __restrict__ valid,
                  int16_t* __restrict__ pcm, float* __restrict__ store_out,
                  float* __restrict__ fifo_out, int T, size_t granules) {
  constexpr int NG = G + kHalo;  // K1's granules at most
  using Scratch = RequantSmem<kLayout, NG, run_staged(G)>;
  static_assert(sizeof(Scratch) <= sizeof(RequantSmem<kFused, NG, run_staged(G)>), "");
  extern __shared__ __align__(16) float smem[];
  float* s_tab = smem;                            // K2's matrices [2][36][kJ]
  float* s_win = s_tab + kHybridTabFloats;        // [4][36]
  float* s_cs = s_win + 4 * 36;
  float* s_ca = s_cs + 8;
  float* ntc = s_ca + 8;                          // [sb][kSymCols]
  int32_t* ginfo = reinterpret_cast<int32_t*>(ntc + 32 * kSymCols);  // [NG]
  float* xs = ntc + 32 * kSymCols + kRunGinfoFloats;  // x18 [G + 1][2][18][kXsStride]
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
  tables_async<kThreads>(smem, tid);

  // -- K1: granules first .. t1-1 -> x, ginfo ---------------------------------
  requant_tile<kLayout, NG, kThreads, kSpan, run_staged(G)>(
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

// The segment walk: threads 0 .. kK23-1 run K2/K3, kK23 .. 511 K1.
template <int kLayout, int G>
__global__ void __launch_bounds__(kThreads, 2)
chain_kernel(const Inputs in, const gomp3::Wire w, const float* __restrict__ store_in,
             const float* __restrict__ fifo_in, const int32_t* __restrict__ valid,
             int16_t* __restrict__ pcm, float* __restrict__ store_out,
             float* __restrict__ fifo_out, int T, int L, size_t granules) {
  extern __shared__ __align__(16) float smem[];
  const Smem<kLayout, G> m(smem);
  const int s = blockIdx.y, tid = threadIdx.x;
  const Seg sg(blockIdx.x, L, G, T, valid[s]);
  if (tid >= kK23) {
    for (int k = 0; k < sg.nsteps; k++) {
      if (k > 0) gomp3::bar_sync(kBarK1, kK1);  // step k-1's C has read K1's scratch
      k1_step<kLayout, G, kK1>(in, w, s, T, granules, sg, k, m, tid - kK23,
                               gomp3::GroupSync<kBarK1, kK1>{}, WaitForX{k > 0});
      gomp3::bar_arrive(kBarFull, kThreads);
    }
    return;
  }
  k23_prologue<kLayout, G, kK23>(m, sg, s, store_in, fifo_in, store_out, tid);
  for (int k = 0; k < sg.nsteps; k++) {
    gomp3::bar_sync(kBarFull, kThreads);
    k23_step<kLayout, G, kK23>(m, sg, k, s, T, fifo_in, pcm, store_out, fifo_out, tid,
                               gomp3::GroupSync<kBarK23, kK23>{}, ReleaseX{});
  }
}

template <int kLayout, int G>
cudaError_t launch(const Inputs& in, const gomp3::Wire& w, const float* store_in,
                   const float* fifo_in, const int32_t* valid, int16_t* pcm,
                   float* store_out, float* fifo_out, int S, int T, int L, cudaStream_t st) {
  dim3 grid((T + G * L - 1) / (G * L), S);
  if (L == 1) {
    const size_t bytes = run_smem_bytes<G>();
    chain_kernel_run1<kLayout, G><<<grid, kThreads, bytes, st>>>(
        in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, T, (size_t)S * T);
    return cudaGetLastError();
  }
  const size_t bytes = smem_bytes<kLayout, G>();
  chain_kernel<kLayout, G><<<grid, kThreads, bytes, st>>>(
      in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, T, L, (size_t)S * T);
  return cudaGetLastError();
}

template <int kLayout>
cudaError_t launch_run(int G, const Inputs& in, const gomp3::Wire& w,
                       const float* store_in, const float* fifo_in, const int32_t* valid,
                       int16_t* pcm, float* store_out, float* fifo_out, int S, int T, int L,
                       cudaStream_t st) {
  switch (G) {
    case 1: return launch<kLayout, 1>(in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, L, st);
    case 2: return launch<kLayout, 2>(in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, L, st);
    case 4: return launch<kLayout, 4>(in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, L, st);
    default: return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of a block and the blocks an SM can hold, by
// input layout, G and L (1: the one-run-a-block kernel)
template <int kLayout, int G>
cudaError_t occupancy(int L, int* bytes, int* blocks) {
  if (L == 1) {
    *bytes = (int)run_smem_bytes<G>();
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, chain_kernel_run1<kLayout, G>,
                                                         kThreads, *bytes);
  }
  *bytes = (int)smem_bytes<kLayout, G>();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, chain_kernel<kLayout, G>,
                                                       kThreads, *bytes);
}

template <int kLayout>
cudaError_t occupancy_run(int G, int L, int* bytes, int* blocks) {
  switch (G) {
    case 1: return occupancy<kLayout, 1>(L, bytes, blocks);
    case 2: return occupancy<kLayout, 2>(L, bytes, blocks);
    case 4: return occupancy<kLayout, 4>(L, bytes, blocks);
    default: return cudaErrorInvalidValue;
  }
}

template <int kLayout>
void allow_smem() {
  constexpr auto kMax = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaFuncSetAttribute(chain_kernel_run1<kLayout, 1>, kMax, (int)run_smem_bytes<1>());
  cudaFuncSetAttribute(chain_kernel_run1<kLayout, 2>, kMax, (int)run_smem_bytes<2>());
  cudaFuncSetAttribute(chain_kernel_run1<kLayout, 4>, kMax, (int)run_smem_bytes<4>());
  cudaFuncSetAttribute(chain_kernel<kLayout, 1>, kMax, (int)smem_bytes<kLayout, 1>());
  cudaFuncSetAttribute(chain_kernel<kLayout, 2>, kMax, (int)smem_bytes<kLayout, 2>());
  cudaFuncSetAttribute(chain_kernel<kLayout, 4>, kMax, (int)smem_bytes<kLayout, 4>());
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
// store_out, fifo_out: the state after each stream's valid granules. A
// block walks L >= 1 runs of G granules (G = 1, 2 or 4; L = 1: one run a
// block). T == 0 launches nothing and copies the state on the stream.
int gomp3_chain(int device, int layout, const void* const* inputs, const float* store_in,
                const float* fifo_in, const int32_t* valid, int16_t* pcm, float* store_out,
                float* fifo_out, int S, int T, int G, int L, int tail_lines,
                int nch, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int count = input_count(layout);
  if (count == 0 || S < 0 || T < 0 || (G != 1 && G != 2 && G != 4) || L < 1)
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
  L = min(L, (T + G - 1) / G);
  Inputs in = {};
  for (int i = 0; i < count; i++) in.p[i] = inputs[i];
  gomp3::Wire w = {static_cast<const uint8_t*>(in.p[0]),
                   gomp3::wire_row_bytes(T, tail_lines, nch), T, tail_lines, nch};
  switch (layout) {
    case kInt16:
      return (int)launch_run<kInt16>(G, in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, L, st);
    case kInt8:
      return (int)launch_run<kInt8>(G, in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, L, st);
    case kBatch:
      return (int)launch_run<kBatch>(G, in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, L, st);
    default:
      return (int)launch_run<kFused>(G, in, w, store_in, fifo_in, valid, pcm, store_out, fifo_out, S, T, L, st);
  }
}

// The dynamic shared memory a block of the chain kernel takes (bytes) and
// the blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// for a layout, G and L, on `device`.
int gomp3_chain_occupancy(int device, int layout, int G, int L, int* smem, int* blocks) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (L < 1) return (int)cudaErrorInvalidValue;
  switch (layout) {
    case kInt16: return (int)occupancy_run<kInt16>(G, L, smem, blocks);
    case kInt8: return (int)occupancy_run<kInt8>(G, L, smem, blocks);
    case kBatch: return (int)occupancy_run<kBatch>(G, L, smem, blocks);
    case kFused: return (int)occupancy_run<kFused>(G, L, smem, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
