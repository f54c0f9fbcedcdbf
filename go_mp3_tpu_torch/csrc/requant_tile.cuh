// K1's tile body: unpack + requantize + MS/intensity stereo of a tile of
// consecutive granules of one stream, shared by K1's own kernel
// (requant_stereo.cu) and the granule chain (chain.cu), so that both get
// the bits of one source. The design notes are requant_stereo.cu's.
//
// Everything here sits in an anonymous namespace: each kernel source that
// includes it gets its own copy of the band tables (uploaded by its own
// init entry point through requant_upload_tables).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "barrier.cuh"
#include "fused_tile.cuh"

namespace {

using gomp3::kHeadLines;
using gomp3::kSide8;
using gomp3::kTailLines;
using gomp3::kTailWords;

constexpr int kLines = 576;
constexpr int kSideWords = 144;

// input layouts; the pointers in Inputs.p, in order:
enum Layout : int {
  kInt16 = 0,  // spectra i16 [n][1152], side i16 [n][144]
  kInt8 = 1,   // tail8 i8 [n][1024], head16 i16 [n][128], side8 u8 [n][168]
  kBatch = 2,  // the GranuleBatch fields in their order: spectra i16
               // [n][2][576], scalefac_l i32 [n][2][22], scalefac_s i32
               // [n][2][13][3], global_gain, scalefac_scale, preflag i32
               // [n][2], subblock_gain i32 [n][2][3], block_type,
               // block_class i32 [n][2], variant i32 [n], ms_flag, is_flag
               // bool [n], count1_r i32 [n], mono bool [n]
  kFused = 3,  // the wire rows u8 [S][row_bytes] (fused_tile.cuh)
};
constexpr int kMaxInputs = 14;
struct Inputs {
  const void* p[kMaxInputs];
};

// the device pointers of a layout's inputs
inline int input_count(int layout) {
  return layout == kInt16 ? 2 : layout == kInt8 ? 3
       : layout == kBatch ? kMaxInputs : layout == kFused ? 1 : 0;
}

// a GranuleBatch field's element i: an int32, or a bool (of n in the
// field) read through the aligned 4-byte word that holds it, so that every
// lane of a warp issues the same load. Where that word reaches past either
// end of the field's n bytes (a field at an unaligned address, or the last
// bytes of one whose size is not a multiple of 4), the bool is read alone:
// no load leaves the tensor
__device__ __forceinline__ int field_at(const void* p, size_t i, bool is_bool, size_t n) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(p);
  const uintptr_t a = base + (is_bool ? i : 4 * i);
  const uintptr_t word = a & ~(uintptr_t)3;
  if (is_bool && (word < base || word + 4 > base + n))
    return *reinterpret_cast<const uint8_t*>(a) != 0;
  const uint32_t w = *reinterpret_cast<const uint32_t*>(word);
  return is_bool ? ((w >> (8 * (a & 3))) & 0xff) != 0 : (int)w;
}

__constant__ float c_pretab[22];
__constant__ float c_is_l[7];
__constant__ float c_is_r[7];
__constant__ int c_long_start[6][22];
__constant__ int c_short_start3[6][13];
// per-line maps [map][variant][line]: long band; sfb*3+win (requantize);
// sfb*3+win (intensity)
__device__ __align__(16) uint8_t g_maps[3][6][kLines];

// Upload the band tables (host arrays: pretab f32[22], is_l/is_r f32[7],
// long_start i32[6][22], short_start3 i32[6][13], three u8[6][576] per-line
// maps) to the current device.
inline cudaError_t requant_upload_tables(const float* pretab, const float* is_l,
                                         const float* is_r, const int32_t* long_start,
                                         const int32_t* short_start3,
                                         const uint8_t* long_sfb, const uint8_t* req_short,
                                         const uint8_t* is_short) {
  cudaMemcpyToSymbol(c_pretab, pretab, sizeof(float) * 22);
  cudaMemcpyToSymbol(c_is_l, is_l, sizeof(float) * 7);
  cudaMemcpyToSymbol(c_is_r, is_r, sizeof(float) * 7);
  cudaMemcpyToSymbol(c_long_start, long_start, sizeof(int32_t) * 6 * 22);
  cudaMemcpyToSymbol(c_short_start3, short_start3, sizeof(int32_t) * 6 * 13);
  cudaMemcpyToSymbol(g_maps, long_sfb, 6 * kLines, 0);
  cudaMemcpyToSymbol(g_maps, req_short, 6 * kLines, 6 * kLines);
  cudaMemcpyToSymbol(g_maps, is_short, 6 * kLines, 2 * 6 * kLines);
  return cudaGetLastError();
}

// side word `wd` of a granule whose sidecar bytes start at s8 (int8
// interface and wire: 22 little-endian meta words, then one byte each)
__device__ __forceinline__ int side8_word(const uint8_t* s8, int wd) {
  return wd < 22 ? s8[2 * wd] | (s8[2 * wd + 1] << 8) : s8[44 + wd - 22];
}

// N = 1, 2, 4 or 8 bytes at p (N-byte aligned), little-endian, in the
// low bytes of .x, then .y
template <int N>
__device__ __forceinline__ uint2 load_n(const void* p) {
  if constexpr (N == 8) return *static_cast<const uint2*>(p);
  else if constexpr (N == 4) return make_uint2(*static_cast<const uint32_t*>(p), 0);
  else if constexpr (N == 2) return make_uint2(*static_cast<const uint16_t*>(p), 0);
  else return make_uint2(*static_cast<const uint8_t*>(p), 0);
}

// the same at any address: one load where p is aligned, else narrower ones
template <int N>
__device__ __forceinline__ uint2 load_n_any(const uint8_t* p) {
  if (!((uintptr_t)p & (N - 1))) return load_n<N>(p);
  return make_uint2(gomp3::load4(p, N < 4 ? N : 4), N == 8 ? gomp3::load4(p + 4, 4) : 0);
}

// a granule's flags word (bit 0 MS, bit 1 intensity, bit 2 mono); the
// GranuleBatch route keeps the three in words 1, 3 and 20, which the DSP
// does not read otherwise
template <int kLayout>
__device__ __forceinline__ int flags_of(const int* sd) {
  return kLayout == kBatch ? sd[1] | sd[3] << 1 | sd[20] << 2 : sd[1];
}

// The shared memory of a tile of G granules whose wire tail is staged
// kStaged granules at a time (fused layout).
template <int kLayout, int G, int kStaged = G>
struct RequantSmem {
  int side[G][kSideWords];
  float a_long[G][2][22];
  float a_short[G][2][39];
  float d_long[G][2][22];  // intensity multiplier - 1, [left/right]
  float d_short[G][2][39];
  uint32_t stail[kLayout == kFused ? kStaged * 2 * kTailWords : 1];  // the wire's tail
};

// Granules t0 .. t0+nv-1 (nv <= G) of stream s, whose flat index is g0 =
// s * T + t0, by kThreads threads (tid) in items of kSpan lines of both
// channels -> x_out[(j * 2 + c) * 576 + line] and ginfo_out[j] for granule
// t0 + j (global or shared memory). On the wire the tail is staged from
// granule tail_t0 (t0 - kStaged + G <= tail_t0 <= t0; a multiple of 4 keeps
// its loads 4 bytes wide). Three steps, a barrier after A and after B
// (`sync`: the block's, or a named barrier over the kThreads threads that
// run the tile); B writes ginfo_out, C x_out, and `before_c`, called by
// every thread after B's barrier, may wait until x_out is free. The caller
// syncs before it reads the outputs.
struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};
template <int kLayout, int G, int kThreads, int kSpan, int kStaged = G,
          class Sync = gomp3::BlockSync, class BeforeC = NoWait>
__device__ __forceinline__ void requant_tile(const Inputs& in, const gomp3::Wire& w, int s,
                                             int t0, int nv, size_t g0, int stereo,
                                             size_t granules, float* __restrict__ x_out,
                                             int32_t* __restrict__ ginfo_out, int tail_t0,
                                             RequantSmem<kLayout, G, kStaged>& sm, int tid,
                                             Sync sync = {}, BeforeC before_c = {}) {
  constexpr int kPer = kLines / kSpan;  // items of a granule
  constexpr int kItems = (G * kPer + kThreads - 1) / kThreads;  // items of a thread
  auto& side = sm.side;
  auto& a_long = sm.a_long;
  auto& a_short = sm.a_short;
  auto& d_long = sm.d_long;
  auto& d_short = sm.d_short;

  // -- A: every load of the tile --------------------------------------------
#pragma unroll
  for (int k = 0; k < G * kSideWords / kThreads + (G * kSideWords % kThreads != 0); k++) {
    const int it = tid + k * kThreads;
    const int j = it / kSideWords, wd = it % kSideWords;
    if (it >= G * kSideWords || j >= nv) continue;
    const size_t g = g0 + j;
    int val;
    if (kLayout == kInt8) {
      val = side8_word(static_cast<const uint8_t*>(in.p[2]) + g * kSide8, wd);
    } else if (kLayout == kFused) {
      val = side8_word(w.side(s, t0 + j), wd);
    } else if (kLayout == kInt16) {
      val = static_cast<const int16_t*>(in.p[1])[g * kSideWords + wd];
    } else {
      // the side words of native/lib.py (SIDE_* / META_*), each from its
      // field. The field is picked by predicated moves in word order, with
      // no branch for a warp to diverge on, so the warp reaches its one
      // load at once (a divergent if-chain made the Decoder-sized chunk
      // wait on it). The three flags land in words 1, 3 and 20 (flags_of),
      // read like the int32 fields (field_at); word 21 is not read.
      const void* src = nullptr;
      int n = 1, lo = 0;  // the field's elements a granule, its first word
      bool flag = false;
      if (wd == 0) src = in.p[9];
      if (wd == 1) src = in.p[10], lo = 1, flag = true;  // ms_flag
      if (wd == 2) src = in.p[12], lo = 2;
      if (wd == 3) src = in.p[11], lo = 3, flag = true;  // is_flag
      if (wd >= 4) src = in.p[3], n = 2, lo = 4;
      if (wd >= 6) src = in.p[4], lo = 6;
      if (wd >= 8) src = in.p[5], lo = 8;
      if (wd >= 10) src = in.p[7], lo = 10;
      if (wd >= 12) src = in.p[8], lo = 12;
      if (wd >= 14) src = in.p[6], n = 6, lo = 14;
      if (wd == 20) src = in.p[13], n = 1, lo = 20, flag = true;  // mono
      if (wd == 21) src = nullptr;
      if (wd >= 22) src = in.p[1], n = 44, lo = 22;
      if (wd >= 66) src = in.p[2], n = 78, lo = 66;
      // (a bool field holds one byte a granule: `granules`, S * T, bytes)
      val = src ? field_at(src, g * n + wd - lo, flag, granules) : 0;
    }
    side[j][wd] = val;
  }
  // the spectra of this thread's items: raw[k][c] holds the item's lines
  // of channel c, int16 values (.x, then .y) or, on a tail item of the
  // int8 interface and the wire, int8 values (.x). An item past the tile
  // (it >= G * kPer, where kThreads does not divide it) has j >= G >= nv.
  uint2 raw[kItems][2];
#pragma unroll
  for (int k = 0; k < kItems; k++) {
    const int it = tid + k * kThreads;
    const int j = it / kPer, l0 = it % kPer * kSpan;  // granule, first line
    const size_t g = g0 + j;
#pragma unroll
    for (int c = 0; c < 2; c++) {
      raw[k][c] = make_uint2(0, 0);
      if (j >= nv) continue;
      if (kLayout == kInt16 || kLayout == kBatch) {
        raw[k][c] = load_n<2 * kSpan>(static_cast<const int16_t*>(in.p[0]) +
                                      (g * 2 + c) * kLines + l0);
      } else if (kLayout == kInt8) {
        raw[k][c] = l0 < kHeadLines
            ? load_n<2 * kSpan>(static_cast<const int16_t*>(in.p[1]) +
                                (g * 2 + c) * kHeadLines + l0)
            : load_n<kSpan>(static_cast<const int8_t*>(in.p[0]) +
                            (g * 2 + c) * kTailLines + l0 - kHeadLines);
      } else if (l0 < kHeadLines && c < w.nch) {  // the wire's head pairs
        raw[k][c] = load_n_any<2 * kSpan>(w.head(s, t0 + j) + (c * kHeadLines + l0) * 2);
      }
    }
  }
  if (kLayout == kFused)
    gomp3::stage_tail<kStaged, kThreads>(w, s, tail_t0, sm.stail, tid, t0 - tail_t0 + nv);
  sync();

  // each item's band indices (L1-resident maps), loaded here so that they
  // arrive while B runs
  uint32_t maps[kItems][3];
#pragma unroll
  for (int k = 0; k < kItems; k++) {
    const int it = tid + k * kThreads;
    const int j = it / kPer, l0 = it % kPer * kSpan;
    const int v = j < nv ? min(max(side[j][0], 0), 5) : 0;
#pragma unroll
    for (int m = 0; m < 3; m++)
      maps[k][m] = load_n<kSpan>(&g_maps[m][v][l0]).x;
  }

  // -- B: per-band values and ginfo -----------------------------------------
  for (int it = tid; it < nv * 245; it += kThreads) {
    const int j = it / 245, l = it % 245;
    const int* sd = side[j];
    const int v = min(max(sd[0], 0), 5);
    const int flags = flags_of<kLayout>(sd);
    const bool mono = flags & 4;
    const int cls0 = sd[12];
    if (l < 44) {
      const int c = l / 22, k = l % 22;
      const float sf_mult = sd[6 + c] != 0 ? 1.0f : 0.5f;
      const float gain = 0.25f * ((float)sd[4 + c] - 210.0f);
      a_long[j][c][k] = -(sf_mult * ((float)sd[22 + 22 * c + k] +
                                     (float)sd[8 + c] * c_pretab[k])) + gain;
    } else if (l < 122) {
      const int c = (l - 44) / 39, k = (l - 44) % 39;
      const float sf_mult = sd[6 + c] != 0 ? 1.0f : 0.5f;
      const float gain = 0.25f * ((float)sd[4 + c] - 210.0f);
      a_short[j][c][k] = -(sf_mult * (float)sd[66 + 39 * c + k]) + gain -
                         2.0f * (float)sd[14 + 3 * c + k % 3];
    } else if (l < 166) {
      // long intensity bands (channel 0's geometry): 0..20 long, 0..7 mixed
      const int c = (l - 122) / 22, k = (l - 122) % 22;
      const int is_pos = sd[22 + k];
      const int cap = cls0 == 0 ? 20 : (cls0 == 2 ? 7 : -1);
      const bool apply = (flags & 2) && !mono && c_long_start[v][k] >= sd[2] &&
                         k <= cap && is_pos < 7;
      const int ip = max(is_pos, 0);
      d_long[j][c][k] = (apply ? (c == 0 ? c_is_l[ip] : c_is_r[ip]) : 1.0f) - 1.0f;
    } else if (l < 244) {
      // short intensity bands: 0..11 short, 3..11 mixed
      const int c = (l - 166) / 39, k = (l - 166) % 39, sfb = k / 3;
      const int is_pos = sd[66 + k];
      const int lo = cls0 == 1 ? 0 : (cls0 == 2 ? 3 : 13);
      const bool apply = (flags & 2) && !mono &&
                         c_short_start3[v][sfb] >= sd[2] && sfb >= lo &&
                         sfb <= 11 && is_pos < 7;
      const int ip = max(is_pos, 0);
      d_short[j][c][k] = (apply ? (c == 0 ? c_is_l[ip] : c_is_r[ip]) : 1.0f) - 1.0f;
    } else {
      ginfo_out[j] = (sd[10] & 3) | (sd[11] & 3) << 2 | (sd[12] & 3) << 4 |
                     (sd[13] & 3) << 6 | (mono ? 1 << 8 : 0);
    }
  }
  sync();
  before_c();

  // -- C: kSpan lines x 2 channels an item ------------------------------------
#pragma unroll
  for (int k = 0; k < kItems; k++) {
    const int it = tid + k * kThreads;
    const int j = it / kPer, l0 = it % kPer * kSpan;
    if (j >= nv) continue;
    const int* sd = side[j];
    const int flags = flags_of<kLayout>(sd);
    const bool mono = flags & 4;
    const uint32_t lmap = maps[k][0], smap = maps[k][1], imap = maps[k][2];
    const bool tail8 = (kLayout == kInt8 || kLayout == kFused) && l0 >= kHeadLines;
    float x[2][kSpan];
#pragma unroll
    for (int c = 0; c < 2; c++) {
      uint2 r = raw[k][c];
      if (kLayout == kFused && tail8)
        r = load_n<kSpan>(reinterpret_cast<const uint8_t*>(sm.stail) +
                          ((j + t0 - tail_t0) * 2 + c) * kTailLines + l0 - kHeadLines);
      const int cls = sd[12 + c];
#pragma unroll
      for (int i = 0; i < kSpan; i++) {
        const int l = l0 + i;
        const int qv = tail8 ? (int)(int8_t)(r.x >> (8 * i))
                             : (int)(int16_t)((i < 2 ? r.x : r.y) >> (16 * (i & 1)));
        const int lsfb = (lmap >> (8 * i)) & 0xff;
        const int ssfb = (smap >> (8 * i)) & 0xff;
        const bool is_long = cls == 0 || (cls == 2 && l < 36);
        const float a = is_long ? a_long[j][c][lsfb] : a_short[j][c][ssfb];
        // sign * |x|^(4/3) * 2^a. For q == 0 the expression gives
        // 0 * exp2f(-inf) = +0, which is what the branch skips to: the
        // zero lines of a granule cost no exp2f/log2f
        float mag = 0.0f;
        if (qv != 0) mag = exp2f(a + (4.0f / 3.0f) * log2f(fabsf((float)qv)));
        x[c][i] = (qv > 0 ? 1.0f : (qv < 0 ? -1.0f : 0.0f)) * mag;
      }
    }
    if (stereo) {
#pragma unroll
      for (int i = 0; i < kSpan; i++) {
        if ((flags & 1) && !mono) {
          const float inv_sqrt2 = 0.70710677f;
          const float xl = x[0][i], xr = x[1][i];
          x[0][i] = (xl + xr) * inv_sqrt2;
          x[1][i] = (xl - xr) * inv_sqrt2;
        }
        // without intensity stereo every delta is +0 and the product is
        // exactly 1: skipped
        if ((flags & 2) && !mono) {
          const int lsfb = (lmap >> (8 * i)) & 0xff;
          const int isfb = (imap >> (8 * i)) & 0xff;
#pragma unroll
          for (int c = 0; c < 2; c++)
            x[c][i] *= (1.0f + d_long[j][c][lsfb]) * (1.0f + d_short[j][c][isfb]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; c++) {
      float* o = x_out + (j * 2 + c) * kLines + l0;
      if constexpr (kSpan == 4)
        *reinterpret_cast<float4*>(o) = make_float4(x[c][0], x[c][1], x[c][2], x[c][3]);
      else if constexpr (kSpan == 2)
        *reinterpret_cast<float2*>(o) = make_float2(x[c][0], x[c][1]);
      else
        *o = x[c][0];
    }
  }
}

}  // namespace
