// The fused one-buffer chunk wire, read a tile of granules at a time: the
// loader that K1's fused route (requant_stereo.cu) and K4 (unpack_fused.cu)
// share.
//
// One row per stream, row_bytes apart (host builder: ops/wire.py), nch = 2
// (stereo) or 1 (mono):
//   tail  int8 [nch][L][T], channel-major and line-major: tail line l
//         (spectral line 64 + l) of every granule, for l < L;
//   head  [T][nch * 64] int16 values as little-endian byte pairs;
//   side  [T][168] bytes.
// A mono row is odd-sized when L and T are both odd, so the head and side
// regions can start at any address: nothing here reads them wider than
// their alignment allows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gomp3 {

constexpr int kTailLines = 512;  // per-channel tail lines (576 - 64)
constexpr int kHeadLines = 64;   // per-channel int16 head lines
constexpr int kSide8 = 168;      // sidecar bytes per granule
constexpr int kTailWords = kTailLines / 4;  // one word = 4 lines of a channel

struct Wire {
  const uint8_t* buf;
  size_t row_bytes;
  int T, L, nch;

  __device__ __forceinline__ const uint8_t* tail(int s, int c) const {
    return buf + (size_t)s * row_bytes + (size_t)c * L * T;
  }
  __device__ __forceinline__ const uint8_t* head(int s, int t) const {
    return buf + (size_t)s * row_bytes + (size_t)nch * L * T + (size_t)t * nch * 2 * kHeadLines;
  }
  __device__ __forceinline__ const uint8_t* side(int s, int t) const {
    return buf + (size_t)s * row_bytes + (size_t)nch * L * T +
           (size_t)T * nch * 2 * kHeadLines + (size_t)t * kSide8;
  }
};

inline size_t wire_row_bytes(int T, int L, int nch) {
  return (size_t)nch * L * T + (size_t)T * nch * 2 * kHeadLines + (size_t)T * kSide8;
}

// 4 bytes at p, little-endian, of which only the first `n` (0..4) exist
// (the rest read as 0): one 4-byte load where p is aligned and all four
// exist, else byte loads.
__device__ __forceinline__ uint32_t load4(const uint8_t* p, int n) {
  if (n >= 4 && !((uintptr_t)p & 3)) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
  for (int k = 0; k < 4 && k < n; k++) v |= (uint32_t)__ldg(p + k) << (8 * k);
  return v;
}

// The tail of granules t0 .. t0+G-1 of stream s, transposed on chip:
// stail[(j * 2 + c) * kTailWords + w] holds tail lines 4w..4w+3 of channel c
// of granule t0 + j, one line a byte, little-endian: the granule-major
// layout of the int8 interface's tail8 rows. A work unit is 4 lines x 4
// granules of one channel: four 4-byte loads (one per line, across the
// granules), transposed in registers with __byte_perm into one word per
// granule. Lines >= L, channel 1 of a mono row and granules >= T are zero,
// and are never read. kThreads threads, each with a fixed unit count, so
// that every load of the thread is in flight before the first store. Only
// the quads that hold one of the first n granules (n <= G) are loaded.
template <int G, int kThreads>
__device__ __forceinline__ void stage_tail(const Wire& w, int s, int t0,
                                           uint32_t* __restrict__ stail, int tid,
                                           int n = G) {
  constexpr int kQuads = (G + 3) / 4;               // granule quads of the tile
  constexpr int kUnits = 2 * kTailWords * kQuads;   // (channel, word, quad)
  constexpr int kIters = (kUnits + kThreads - 1) / kThreads;
  uint32_t v[kIters][4];
#pragma unroll
  for (int k = 0; k < kIters; k++) {
    const int u = tid + k * kThreads;
    const int gq = u % kQuads, wd = (u / kQuads) % kTailWords, c = u / (kQuads * kTailWords);
    const int t = t0 + 4 * gq;
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int l = 4 * wd + i;
      v[k][i] = (u < kUnits && c < w.nch && l < w.L && 4 * gq < n)
                    ? load4(w.tail(s, c) + (size_t)l * w.T + t, w.T - t)
                    : 0u;
    }
  }
#pragma unroll
  for (int k = 0; k < kIters; k++) {
    const int u = tid + k * kThreads;
    if (u >= kUnits) break;
    const int gq = u % kQuads, wd = (u / kQuads) % kTailWords, c = u / (kQuads * kTailWords);
#pragma unroll
    for (int b = 0; b < 4; b++) {  // granule 4 gq + b: byte b of each line's word
      const int j = 4 * gq + b;
      if (j >= G) break;
      const uint32_t sel = b | (b + 4) << 4;
      const uint32_t lo = __byte_perm(v[k][0], v[k][1], sel);
      const uint32_t hi = __byte_perm(v[k][2], v[k][3], sel);
      stail[(j * 2 + c) * kTailWords + wd] = __byte_perm(lo, hi, 0x5410);
    }
  }
}

}  // namespace gomp3
