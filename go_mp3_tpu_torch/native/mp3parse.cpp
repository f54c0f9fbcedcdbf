// Native host-side MP3 bitstream parser for the TPU decode framework.
//
// Covers the inherently serial layers (tag skip, frame-header sync, side
// info, bit-reservoir assembly, scalefactors, Huffman spectral decode) at
// native speed and emits fixed-shape granule-batch arrays that feed the
// batched device DSP. Semantics mirror go_mp3_tpu_torch/bitstream/*.py, which in
// turn match the reference decoder (see file:line citations there).
//
// Exposed as a small C ABI consumed via ctypes (go_mp3_tpu_torch/native/lib.py).
//
// Build: native/lib.py, at first use, with g++  ->  libmp3parse.so

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__SSE2__) || defined(_M_X64)
#include <emmintrin.h>
#define GOMP3_SSE2 1
#endif

// 256-bit AVX2 emission path (the build uses -march=native, so these
// macros reflect the build host; the .so is rebuilt on import when stale,
// so a different execution host recompiles for its own ISA). Deliberately
// ymm, NOT zmm: a zmm variant of the same emission measured ~8% slower
// WHOLE-parse on this Xeon — the 512-bit license downclock taxes the
// dominant scalar Huffman loop far more than the 2x-wider stores save.
#if defined(__AVX2__)
#include <immintrin.h>
#define GOMP3_AVX2 1
#endif

#include "huffman_data.h"

namespace gomp3 {

// ---------------------------------------------------------------------------
// Constants (ISO 11172-3; same tables as go_mp3_tpu_torch/consts.py)
// ---------------------------------------------------------------------------

constexpr int kSamplesPerGr = 576;
constexpr int64_t kMaxSyncSearchBytes = 64 * 1024;

constexpr int kBitrates[2][16] = {
    // MPEG-1 Layer III
    {0, 32000, 40000, 48000, 56000, 64000, 80000, 96000, 112000, 128000,
     160000, 192000, 224000, 256000, 320000, 0},
    // MPEG-2 Layer III
    {0, 8000, 16000, 24000, 32000, 40000, 48000, 56000, 64000, 80000, 96000,
     112000, 128000, 144000, 160000, 0},
};

// Long/short scalefactor band boundaries [lsf][sfreq]
constexpr int kBandLong[2][3][23] = {
    {{0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134, 162,
      196, 238, 288, 342, 418, 576},
     {0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128, 156,
      190, 230, 276, 330, 384, 576},
     {0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156, 194,
      240, 296, 364, 448, 550, 576}},
    {{0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
      284, 336, 396, 464, 522, 576},
     {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194, 232,
      278, 332, 394, 464, 540, 576},
     {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238,
      284, 336, 396, 464, 522, 576}},
};

// Short scalefactor band boundaries [lsf][sfreq]
constexpr int kBandShort[2][3][14] = {
    {{0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192},
     {0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192},
     {0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192}},
    {{0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192},
     {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192},
     {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192}},
};

// Short-block reorder permutations (frame.go:257-302): applied on host so
// the device path consumes post-reorder spectra with no TPU gather.
// kind 0 = pure short (all bands), kind 1 = mixed (bands 3+ only).
struct ReorderPerms {
  int16_t perm[2][3][2][kSamplesPerGr];
  ReorderPerms() {
    for (int lsf = 0; lsf < 2; lsf++)
      for (int sf = 0; sf < 3; sf++)
        for (int kind = 0; kind < 2; kind++) {
          int16_t* p = perm[lsf][sf][kind];
          for (int l = 0; l < kSamplesPerGr; l++) p[l] = int16_t(l);
          int first = kind == 1 ? 3 : 0;
          const int* bands = kBandShort[lsf][sf];
          for (int sfb = first; sfb < 13; sfb++) {
            int start3 = 3 * bands[sfb];
            int wl = bands[sfb + 1] - bands[sfb];
            for (int win = 0; win < 3; win++)
              for (int j = 0; j < wl; j++)
                p[start3 + j * 3 + win] = int16_t(start3 + win * wl + j);
          }
        }
  }
};
static const ReorderPerms kReorder;

constexpr int kScalefacSizesMpeg1[16][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {3, 0}, {1, 1}, {1, 2}, {1, 3},
    {2, 1}, {2, 2}, {2, 3}, {3, 1}, {3, 2}, {3, 3}, {4, 2}, {4, 3}};

constexpr int kScalefacSizesMpeg2[3][6][4] = {
    {{6, 5, 5, 5}, {6, 5, 7, 3}, {11, 10, 0, 0},
     {7, 7, 7, 0}, {6, 6, 6, 3}, {8, 8, 5, 0}},
    {{9, 9, 9, 9}, {9, 9, 12, 6}, {18, 18, 0, 0},
     {12, 12, 12, 0}, {12, 9, 9, 6}, {15, 12, 9, 0}},
    {{6, 9, 9, 9}, {6, 9, 12, 6}, {15, 18, 0, 0},
     {6, 15, 12, 0}, {6, 12, 9, 6}, {6, 18, 9, 0}}};

// MPEG-2 packed slen table (mirrors maindata.py N_SLEN2)
struct NSlen2 {
  int v[512];
  constexpr NSlen2() : v() {
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 3; j++)
        v[j + i * 3 + 500] = i | (j << 3) | (2 << 12) | (1 << 15);
    for (int i = 0; i < 5; i++)
      for (int j = 0; j < 5; j++)
        for (int k = 0; k < 4; k++)
          for (int l = 0; l < 4; l++)
            v[l + k * 4 + j * 16 + i * 80] = i | (j << 3) | (k << 6) | (l << 9);
    for (int i = 0; i < 5; i++)
      for (int j = 0; j < 5; j++)
        for (int k = 0; k < 4; k++)
          v[k + j * 4 + i * 20 + 400] = i | (j << 3) | (k << 6) | (1 << 12);
  }
};
constexpr NSlen2 kNSlen2;

// ---------------------------------------------------------------------------
// Huffman peek-LUTs (built once from the canonical codebooks)
// ---------------------------------------------------------------------------

struct HuffLut {
  int maxlen = 0;
  std::vector<uint32_t> lut;  // entry = len<<8 | x<<4 | y
};

struct HuffLuts {
  HuffLut by_table[34];
  HuffLuts() {
    // distinct books share built LUTs
    for (int t = 0; t < 34; t++) {
      const TableRef& ref = kTables[t];
      if (!ref.book) continue;
      // check if an earlier table used the same book
      int prev = -1;
      for (int u = 0; u < t; u++)
        if (kTables[u].book == ref.book) { prev = u; break; }
      if (prev >= 0) { by_table[t] = by_table[prev]; continue; }
      int maxlen = 0;
      for (int i = 0; i < ref.size; i++)
        if (ref.book[i].len > maxlen) maxlen = ref.book[i].len;
      HuffLut& h = by_table[t];
      h.maxlen = maxlen;
      h.lut.assign(size_t(1) << maxlen, 0);
      for (int i = 0; i < ref.size; i++) {
        const HuffEntry& e = ref.book[i];
        uint32_t val = (uint32_t(e.len) << 8) | (uint32_t(e.x) << 4) | e.y;
        size_t lo = size_t(e.code) << (maxlen - e.len);
        size_t hi = size_t(e.code + 1) << (maxlen - e.len);
        for (size_t w = lo; w < hi; w++) h.lut[w] = val;
      }
    }
  }
};

static const HuffLuts& huff_luts() {
  static HuffLuts luts;
  return luts;
}

// ---------------------------------------------------------------------------
// Fast two-level pair LUTs + sign-baked quad LUTs (the hot decode path).
//
// Primary tables are 1<<kPrimBits entries (2 KiB) so they stay L1-resident;
// codewords longer than kPrimBits (rare by construction — long codes are
// low-probability symbols) chain to a secondary table. Entry format:
//   bit 15      escape to secondary
//   bits 8..12  codeword length (<= 19)
//   bits 4..7   x
//   bits 0..3   y
// Escape entries: bits 0..14 = base index into `sec`; the next
// (maxlen - prim_bits) window bits are added to it.
// ---------------------------------------------------------------------------

constexpr int kPrimBits = 10;

struct PairLut {
  int prim_bits = 0;
  int sec_shift = 0;  // maxlen - prim_bits (0 when single-level)
  std::vector<uint16_t> prim;
  std::vector<uint16_t> sec;
};

struct QuadLut {
  int bits = 0;  // maxlen + 4 (codeword + up to 4 sign bits)
  std::vector<uint16_t> lut;  // adv<<8 | v<<6 | w<<4 | x<<2 | y (2-bit signed)
};

// Sign-baked pair LUT: the index covers codeword + sign bits, so the common
// case is one load per symbol with no separate sign handling, and the
// advance (codeword + sign bits) comes out of the same entry — the next
// symbol's window position depends on a single L1 load. Entry format:
//   bit 15      slow: escape codes (linbits), codes whose codeword+signs
//               exceed the index width, or junk windows
//   bit 14      (with bit 15) direct: the codeword itself fits the index,
//               so the entry carries (len, |x|, |y|) and the slow path
//               skips the two-level lookup — bits 8..11 len, 4..7 x, 0..3 y.
//               Escape-heavy tables (24..30, linbits) have maxlen <= 12, so
//               ALL their slow symbols decode this way: one L1 load plus
//               branchless linbits/sign, no dependent prim->sec chain.
//   bits 10..13 advance in bits (codeword + sign bits, <= index width)
//   bits 5..9   x + 15   (signed value in -15..15)
//   bits 0..4   y + 15
// Index width is min(12, maxlen + 2): 12 keeps each LUT at 8 KiB (u16) so
// two or three region tables plus the quad LUT stay cache-resident.
struct SignedPairLut {
  int bits = 0;
  std::vector<uint16_t> lut;
};

struct FastLuts {
  PairLut pair_by_table[34];
  SignedPairLut signed_by_table[34];
  QuadLut quad[2];  // tables 32, 33

  static void build_pair(const HuffEntry* book, int size, PairLut* out) {
    int maxlen = 0;
    for (int i = 0; i < size; i++)
      if (book[i].len > maxlen) maxlen = book[i].len;
    int pb = maxlen < kPrimBits ? maxlen : kPrimBits;
    out->prim_bits = pb;
    out->prim.assign(size_t(1) << pb, 0);
    out->sec_shift = maxlen > pb ? maxlen - pb : 0;

    // assign secondary base indices per long-code prefix
    std::vector<int> prefix_base(size_t(1) << pb, -1);
    int n_esc = 0;
    for (int i = 0; i < size; i++) {
      if (book[i].len <= pb) continue;
      uint32_t pre = book[i].code >> (book[i].len - pb);
      if (prefix_base[pre] < 0) prefix_base[pre] = n_esc++;
    }
    out->sec.assign(size_t(n_esc) << out->sec_shift, 0);
    // escape base indices must fit the 15 payload bits of a prim entry
    if ((size_t(n_esc) << out->sec_shift) > 0x7FFF) __builtin_trap();

    for (int i = 0; i < size; i++) {
      const HuffEntry& e = book[i];
      uint16_t val =
          uint16_t((uint32_t(e.len) << 8) | (uint32_t(e.x) << 4) | e.y);
      if (e.len <= pb) {
        size_t lo = size_t(e.code) << (pb - e.len);
        size_t hi = size_t(e.code + 1) << (pb - e.len);
        for (size_t w = lo; w < hi; w++) out->prim[w] = val;
      } else {
        uint32_t pre = e.code >> (e.len - pb);
        size_t base = size_t(prefix_base[pre]) << out->sec_shift;
        uint32_t rem = e.code & ((1u << (e.len - pb)) - 1);
        size_t lo = base + (size_t(rem) << (maxlen - e.len));
        size_t hi = base + (size_t(rem + 1) << (maxlen - e.len));
        for (size_t w = lo; w < hi; w++) out->sec[w] = val;
      }
    }
    // mark escape prefixes
    for (size_t pre = 0; pre < (size_t(1) << pb); pre++)
      if (prefix_base[pre] >= 0)
        out->prim[pre] = uint16_t(
            0x8000u | (uint32_t(prefix_base[pre]) << out->sec_shift));
  }

  static void build_signed(const HuffEntry* book, int size, bool has_linbits,
                           SignedPairLut* out) {
    int maxlen = 0;
    for (int i = 0; i < size; i++)
      if (book[i].len > maxlen) maxlen = book[i].len;
// Width cap for the sign-baked LUT index. 12 is a measured optimum
// (round 5, interleaved A/B): 11 bits (4 KiB/table) is +4% whole-parse
// and 10 bits (2 KiB) +12% — the extra slow-direct hits cost more than
// the halved footprint saves, so L1 capacity is NOT the binding
// constraint at 48 KiB L1d. Widening past 12 has no headroom either:
// ~88% of slow hits are t24-t30 linbits escapes that no index width can
// make fast (prof-stats histogram).
#ifndef GOMP3_SIGNED_LUT_BITS
#define GOMP3_SIGNED_LUT_BITS 12
#endif
    int pb = maxlen + 2 < GOMP3_SIGNED_LUT_BITS ? maxlen + 2
                                                : GOMP3_SIGNED_LUT_BITS;
    out->bits = pb;
    // default every index to slow; only fully-baked codes overwrite (long
    // codes' prefixes are never a complete shorter codeword, so their
    // indices keep the default)
    out->lut.assign(size_t(1) << pb, 0x8000u);
    for (int i = 0; i < size; i++) {
      const HuffEntry& e = book[i];
      bool esc = has_linbits && (e.x == 15 || e.y == 15);
      int nsign = (e.x != 0) + (e.y != 0);
      int adv = e.len + nsign;
      if (esc || adv > pb) {  // slow; bake a direct entry when possible
        if (e.len <= pb) {
          uint16_t val = uint16_t(0xC000u | (uint32_t(e.len) << 8) |
                                  (uint32_t(e.x) << 4) | e.y);
          size_t lo = size_t(e.code) << (pb - e.len);
          size_t hi = size_t(e.code + 1) << (pb - e.len);
          for (size_t w = lo; w < hi; w++) out->lut[w] = val;
        }
        continue;
      }
      for (int s = 0; s < (1 << nsign); s++) {
        int sx = e.x, sy = e.y;
        int bit = nsign - 1;  // first sign bit after the code is x's
        if (e.x) {
          if ((s >> bit) & 1) sx = -sx;
          bit--;
        }
        if (e.y && ((s >> bit) & 1)) sy = -sy;
        uint16_t val = uint16_t((adv << 10) | ((sx + 15) << 5) | (sy + 15));
        size_t lo = (size_t(e.code) << nsign | unsigned(s)) << (pb - adv);
        size_t hi = lo + (size_t(1) << (pb - adv));
        for (size_t w = lo; w < hi; w++) out->lut[w] = val;
      }
    }
  }

  static void build_quad(const HuffEntry* book, int size, QuadLut* out) {
    int maxlen = 0;
    for (int i = 0; i < size; i++)
      if (book[i].len > maxlen) maxlen = book[i].len;
    int bits = maxlen + 4;
    out->bits = bits;
    out->lut.assign(size_t(1) << bits, 0);
    auto enc2 = [](int v) -> uint16_t { return uint16_t(v & 3); };
    for (int i = 0; i < size; i++) {
      const HuffEntry& e = book[i];
      int vals[4] = {(e.y >> 3) & 1, (e.y >> 2) & 1, (e.y >> 1) & 1, e.y & 1};
      int nz = vals[0] + vals[1] + vals[2] + vals[3];
      for (int s = 0; s < (1 << nz); s++) {
        int sv[4];
        int bit = nz - 1;  // first sign bit is the MSB of s
        for (int k = 0; k < 4; k++) {
          sv[k] = vals[k];
          if (vals[k]) {
            if ((s >> bit) & 1) sv[k] = -sv[k];
            bit--;
          }
        }
        int adv = e.len + nz;
        uint16_t entry = uint16_t((adv << 8) | (enc2(sv[0]) << 6) |
                                  (enc2(sv[1]) << 4) | (enc2(sv[2]) << 2) |
                                  enc2(sv[3]));
        size_t lo = ((size_t(e.code) << nz) | unsigned(s)) << (bits - adv);
        size_t hi = lo + (size_t(1) << (bits - adv));
        for (size_t w = lo; w < hi; w++) out->lut[w] = entry;
      }
    }
  }

  FastLuts() {
    for (int t = 0; t < 32; t++) {
      const TableRef& ref = kTables[t];
      if (!ref.book) continue;
      int prev = -1;
      for (int u = 0; u < t; u++)
        if (kTables[u].book == ref.book &&
            (kTables[u].linbits > 0) == (ref.linbits > 0)) {
          prev = u;
          break;
        }
      if (prev >= 0) {
        pair_by_table[t] = pair_by_table[prev];
        signed_by_table[t] = signed_by_table[prev];
        continue;
      }
      build_pair(ref.book, ref.size, &pair_by_table[t]);
      build_signed(ref.book, ref.size, ref.linbits > 0, &signed_by_table[t]);
    }
    build_quad(kTables[32].book, kTables[32].size, &quad[0]);
    build_quad(kTables[33].book, kTables[33].size, &quad[1]);
  }
};

static const FastLuts& fast_luts() {
  static FastLuts luts;
  return luts;
}

// ---------------------------------------------------------------------------
// Bit reader (semantics of bitstream/bits.py: sticky error, non-advancing
// reads past the end)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* vec = nullptr;
  int64_t nbytes = 0;
  int64_t pos = 0;  // in bits
  bool err = false;

  int64_t total_bits() const { return nbytes << 3; }

  int bit() {
    if ((pos >> 3) >= nbytes) { err = true; return 0; }
    int b = (vec[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }

  static uint64_t be64(const uint8_t* p) {
    uint64_t w;
    memcpy(&w, p, 8);
    return __builtin_bswap64(w);
  }

  uint32_t bits(int num) {
    if (num == 0) return 0;
    if (pos + num > total_bits()) { err = true; return 0; }
    int64_t bp = pos >> 3;
    if (bp + 8 <= nbytes) {  // fast path: unaligned 64-bit window
      uint64_t w = be64(vec + bp) << (pos & 7);
      pos += num;
      return uint32_t(w >> (64 - num));
    }
    uint32_t tmp = 0;
    for (int i = 0; i < 4; i++)
      tmp = (tmp << 8) | (bp + i < nbytes ? vec[bp + i] : 0);
    tmp <<= (pos & 7);
    uint32_t out = tmp >> (32 - num);
    pos += num;
    return out;
  }

  uint32_t peek_padded(int num) const {
    int64_t bp = pos >> 3;
    if (bp + 8 <= nbytes) {  // fast path (num <= 19 + 7 offset < 64)
      uint64_t w = be64(vec + bp) << (pos & 7);
      return uint32_t(w >> (64 - num));
    }
    uint64_t tmp = 0;
    for (int i = 0; i < 5; i++)
      tmp = (tmp << 8) | (bp + i < nbytes ? vec[bp + i] : 0);
    tmp <<= (pos & 7);
    tmp &= 0xFFFFFFFFFFull;  // keep 40 bits
    return uint32_t(tmp >> (40 - num));
  }
};

#ifdef GOMP3_PROF_STATS
// Single-threaded profiling builds ONLY: the counters are one non-atomic
// global, so attributing a threaded parse (BatchParser lo/hi workers)
// with this build races and silently corrupts the histograms — profile
// with n_threads=1 / the serial many-call.
struct ProfStats {
  uint64_t frames = 0, lanes = 0, lane_steps = 0, pair_fast = 0,
           pair_slow_direct = 0, pair_slow_two = 0, quad_steps = 0,
           quads = 0, seg_checks = 0, drain_len[5] = {};
  uint64_t pair_by_tno[34] = {}, slow_by_tno[34] = {};
};
static ProfStats g_stats;
extern "C" void gmp_prof_stats(uint64_t* out, int cap) {
  uint64_t flat[9 + 5 + 68];
  flat[0] = g_stats.frames; flat[1] = g_stats.lanes;
  flat[2] = g_stats.lane_steps; flat[3] = g_stats.pair_fast;
  flat[4] = g_stats.pair_slow_direct; flat[5] = g_stats.pair_slow_two;
  flat[6] = g_stats.quad_steps; flat[7] = g_stats.quads;
  flat[8] = g_stats.seg_checks;
  for (int i = 0; i < 5; i++) flat[9 + i] = g_stats.drain_len[i];
  for (int i = 0; i < 34; i++) flat[14 + i] = g_stats.pair_by_tno[i];
  for (int i = 0; i < 34; i++) flat[48 + i] = g_stats.slow_by_tno[i];
  for (int i = 0; i < cap && i < 82; i++) out[i] = flat[i];
}
#define PSTAT(expr) ((void)(expr))
#else
#define PSTAT(expr) ((void)0)
#endif

// Decode one codeword (mirrors bitstream/huffman.py decode()).
static inline void huff_decode(BitReader& m, int table_num, int* x, int* y,
                               int* v, int* w) {
  *x = *y = *v = *w = 0;
  const HuffLut& h = huff_luts().by_table[table_num];
  if (h.maxlen == 0) return;
  uint32_t window = m.peek_padded(h.maxlen);
  uint32_t packed = h.lut[window];
  int length = int(packed >> 8);
  int64_t remaining = m.total_bits() - m.pos;
  if (length > remaining) {
    m.pos = m.total_bits();
    m.err = true;
  } else {
    m.pos += length;
  }
  int xx = int((packed >> 4) & 0xF);
  int yy = int(packed & 0xF);

  if (table_num > 31) {
    int vv = (yy >> 3) & 1, ww = (yy >> 2) & 1;
    xx = (yy >> 1) & 1;
    yy &= 1;
    if (vv && m.bit() == 1) vv = -vv;
    if (ww && m.bit() == 1) ww = -ww;
    if (xx && m.bit() == 1) xx = -xx;
    if (yy && m.bit() == 1) yy = -yy;
    *v = vv; *w = ww; *x = xx; *y = yy;
    return;
  }
  int linbits = kTables[table_num].linbits;
  if (linbits && xx == 15) xx += int(m.bits(linbits));
  if (xx && m.bit() == 1) xx = -xx;
  if (linbits && yy == 15) yy += int(m.bits(linbits));
  if (yy && m.bit() == 1) yy = -yy;
  *x = xx; *y = yy;
}

// ---------------------------------------------------------------------------
// Frame header
// ---------------------------------------------------------------------------

struct Header {
  uint32_t word = 0;
  int version() const { return int((word >> 19) & 3); }
  int layer() const { return int((word >> 17) & 3); }
  int protection_bit() const { return int((word >> 16) & 1); }
  int bitrate_index() const { return int((word >> 12) & 0xF); }
  int sfreq() const { return int((word >> 10) & 3); }
  int padding() const { return int((word >> 9) & 1); }
  int mode() const { return int((word >> 6) & 3); }
  int mode_ext() const { return int((word >> 4) & 3); }
  int emphasis() const { return int(word & 3); }
  int lsf() const { return version() == 3 ? 0 : 1; }
  bool mono() const { return mode() == 3; }
  int nch() const { return mono() ? 1 : 2; }
  int granules() const { return 2 >> lsf(); }
  bool ms_stereo() const { return mode() == 1 && (mode_ext() & 2); }
  bool is_stereo() const { return mode() == 1 && (mode_ext() & 1); }
  int sample_rate() const {
    static const int base[3] = {44100, 48000, 32000};
    return base[sfreq()] >> lsf();
  }
  int bitrate() const { return kBitrates[lsf()][bitrate_index()]; }
  int frame_size() const {
    return ((144 * bitrate()) / sample_rate() + padding()) >> lsf();
  }
  int side_info_size() const {
    if (lsf() == 1) return mono() ? 9 : 17;
    return mono() ? 17 : 32;
  }
  bool is_valid() const {
    if ((word & 0xFFE00000u) != 0xFFE00000u) return false;
    if (version() == 1) return false;      // reserved
    if (bitrate_index() == 15) return false;
    if (sfreq() == 3) return false;        // reserved
    if (layer() != 1) return false;        // Layer III only
    if (emphasis() == 2) return false;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Side info
// ---------------------------------------------------------------------------

struct SideInfo {
  int main_data_begin = 0;
  int scfsi[2][4] = {};
  int part2_3_length[2][2] = {};
  int big_values[2][2] = {};
  int global_gain[2][2] = {};
  int scalefac_compress[2][2] = {};
  int win_switch[2][2] = {};
  int block_type[2][2] = {};
  int mixed_flag[2][2] = {};
  int table_select[2][2][3] = {};
  int subblock_gain[2][2][3] = {};
  int region0[2][2] = {};
  int region1[2][2] = {};
  int preflag[2][2] = {};
  int sf_scale[2][2] = {};
  int count1_table[2][2] = {};
  int count1[2][2] = {};
};

// ---------------------------------------------------------------------------
// Parser
// ---------------------------------------------------------------------------

enum Status {
  OK = 0,
  END_OF_AUDIO = 1,   // clean EOF / trailing junk / sync limit
  HARD_ERROR = 2,     // malformed stream (framesize caps, MPEG-2.5, ...)
};

struct Parser {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;

  // streaming (chunked-feed) mode: the parser owns a compacting buffer fed
  // incrementally (pipe/socket-style sources, source.go:99-122 semantics);
  // base_consumed keeps gmp_pos global across compactions
  bool streaming = false;
  bool fed_eof = false;
  bool tags_done = false;
  bool terminal = false;   // sync-search cap hit with a full window: the
                           // stream is dead (reference semantics) — stop
                           // retrying/buffering on further feeds
  int64_t tag_skip_left = 0;  // streaming: bytes of a leading tag still to
                              // consume incrementally across feeds
  int64_t base_consumed = 0;
  std::vector<uint8_t> owned;

  bool packed8_overflow = false;     // a granule exceeded kEscSlots
  // set by gmp_parse_packed8: its emission writes mono ch1 zeros itself,
  // so parse_frame can skip zeroing the (unread) local ch1 records
  bool skip_mono_ch1 = false;
  std::vector<uint8_t> reservoir;       // previous assembled main-data buf
  int64_t reservoir_len = 0;            // logical bytes (buffer carries
                                        // zero padding past this for the
                                        // fast windowed Huffman path)
  std::vector<uint8_t> scratch;         // reused assembly buffer
  bool has_prev = false;
  int sample_rate = 0;
  const char* error = "";

  Parser(const uint8_t* d, int64_t n) : data(d), len(n) {
    skip_tags();
    tags_done = true;
  }

  Parser() : data(nullptr), len(0), streaming(true) {}

  void feed(const uint8_t* d, int64_t n, bool eof) {
    if (terminal) {  // dead stream: don't buffer further bytes
      if (eof) fed_eof = true;
      return;
    }
    // compact: drop consumed bytes, then append
    if (pos > 0) {
      owned.erase(owned.begin(), owned.begin() + pos);
      base_consumed += pos;
      pos = 0;
    }
    if (n > 0) owned.insert(owned.end(), d, d + n);
    if (eof) fed_eof = true;
    data = owned.data();
    len = int64_t(owned.size());
  }

  // Retry-safe tag skip for streaming mode: returns false when more bytes
  // are needed to make progress (same consumption rules as skip_tags once
  // the data is available / eof is known). Large tags (ID3v2 can carry
  // tens of MB of album art) are consumed INCREMENTALLY via tag_skip_left
  // so the fed buffer compacts instead of accumulating the whole tag.
  bool skip_tags_streaming() {
    for (;;) {
      if (tag_skip_left > 0) {
        int64_t take = remaining() < tag_skip_left ? remaining()
                                                   : tag_skip_left;
        pos += take;
        tag_skip_left -= take;
        if (tag_skip_left > 0) return fed_eof;  // consume more next feed
        continue;
      }
      if (remaining() < 3) return fed_eof;  // can't identify a tag yet
      if (memcmp(data + pos, "TAG", 3) == 0) {
        tag_skip_left = 128;
      } else if (memcmp(data + pos, "ID3", 3) == 0) {
        if (remaining() < 10) {
          if (!fed_eof) return false;
          pos = len;
          return true;
        }
        uint32_t size = (uint32_t(data[pos + 6]) << 21) |
                        (uint32_t(data[pos + 7]) << 14) |
                        (uint32_t(data[pos + 8]) << 7) |
                        uint32_t(data[pos + 9]);
        tag_skip_left = int64_t(10) + size;
      } else {
        return true;
      }
    }
  }

  // --- byte-level helpers -------------------------------------------------
  int64_t remaining() const { return len - pos; }

  void skip_tags() {
    for (;;) {
      if (remaining() < 3) return;
      if (memcmp(data + pos, "TAG", 3) == 0) {
        if (remaining() < 128) { pos = len; return; }
        pos += 128;
      } else if (memcmp(data + pos, "ID3", 3) == 0) {
        if (remaining() < 10) { pos = len; return; }
        // Syncsafe size; like the Python/reference path, the top bits are
        // not masked (a well-formed tag keeps every byte < 0x80).
        uint32_t size = (uint32_t(data[pos + 6]) << 21) |
                        (uint32_t(data[pos + 7]) << 14) |
                        (uint32_t(data[pos + 8]) << 7) |
                        uint32_t(data[pos + 9]);
        if (remaining() < int64_t(10) + size) { pos = len; return; }
        pos += 10 + size;
      } else {
        return;
      }
    }
  }

  Status read_header(Header* h) {
    if (remaining() == 0) return END_OF_AUDIO;
    if (remaining() < 4) return END_OF_AUDIO;  // UnexpectedEOF -> end
    uint32_t word = (uint32_t(data[pos]) << 24) | (uint32_t(data[pos + 1]) << 16) |
                    (uint32_t(data[pos + 2]) << 8) | uint32_t(data[pos + 3]);
    int64_t searched = 4;
    int64_t p = pos + 4;
    Header hh{word};
    while (!hh.is_valid()) {
      if (searched >= kMaxSyncSearchBytes) {
        // sync limit with a FULL search window available: terminal for the
        // stream (frameheader.go:263 semantics) — streaming callers must
        // not rewind-and-refeed this forever (unbounded buffering)
        terminal = true;
        return END_OF_AUDIO;
      }
      if (p >= len) return END_OF_AUDIO;                         // UnexpectedEOF
      word = (word << 8) | data[p];
      hh.word = word;
      p++; searched++;
    }
    if (hh.bitrate_index() == 0) { error = "free bitrate"; return HARD_ERROR; }
    pos = p;
    *h = hh;
    return OK;
  }

  // Side info is at most 32 bytes and its field reads never cross the
  // size (the layouts sum to exactly size*8 bits or less), so a reader
  // over 5 preloaded big-endian words is exactly equivalent to BitReader
  // (no error path can trigger) at a fraction of the per-call cost —
  // read_side_info makes ~65 bit-field reads per frame.
  struct SmallBits {
    uint64_t w[5];
    int pos = 0;
    explicit SmallBits(const uint8_t* p, int size) {
      uint8_t buf[40] = {0};
      memcpy(buf, p, size_t(size));
      for (int i = 0; i < 5; i++) w[i] = BitReader::be64(buf + 8 * i);
    }
    inline uint32_t bits(int n) {  // 1 <= n <= 12; pos + n <= 256
      int idx = pos >> 6, off = pos & 63;
      uint64_t v = w[idx] << off;
      if (off > 64 - n) v |= w[idx + 1] >> (64 - off);
      pos += n;
      return uint32_t(v >> (64 - n));
    }
    inline int bit() { return int(bits(1)); }
  };

  Status read_side_info(const Header& h, SideInfo* si) {
    if (h.frame_size() > 2000) { error = "framesize"; return HARD_ERROR; }
    int size = h.side_info_size();
    if (remaining() < size) return END_OF_AUDIO;
    SmallBits s(data + pos, size);
    pos += size;

    int lsf = h.lsf();
    int nch = h.nch();
    static const int btr[2][4] = {{9, 5, 3, 4}, {8, 1, 2, 9}};
    si->main_data_begin = int(s.bits(btr[lsf][0]));
    s.bits(h.mono() ? btr[lsf][1] : btr[lsf][2]);  // private bits
    if (lsf == 0)
      for (int ch = 0; ch < nch; ch++)
        for (int b = 0; b < 4; b++) si->scfsi[ch][b] = s.bit();
    for (int gr = 0; gr < h.granules(); gr++) {
      for (int ch = 0; ch < nch; ch++) {
        si->part2_3_length[gr][ch] = int(s.bits(12));
        si->big_values[gr][ch] = int(s.bits(9));
        si->global_gain[gr][ch] = int(s.bits(8));
        si->scalefac_compress[gr][ch] = int(s.bits(btr[lsf][3]));
        si->win_switch[gr][ch] = s.bit();
        if (si->win_switch[gr][ch] == 1) {
          si->block_type[gr][ch] = int(s.bits(2));
          si->mixed_flag[gr][ch] = s.bit();
          for (int r = 0; r < 2; r++) si->table_select[gr][ch][r] = int(s.bits(5));
          for (int w = 0; w < 3; w++) si->subblock_gain[gr][ch][w] = int(s.bits(3));
          si->region0[gr][ch] =
              (si->block_type[gr][ch] == 2 && si->mixed_flag[gr][ch] == 0) ? 8 : 7;
          si->region1[gr][ch] = 20 - si->region0[gr][ch];
        } else {
          for (int r = 0; r < 3; r++) si->table_select[gr][ch][r] = int(s.bits(5));
          si->region0[gr][ch] = int(s.bits(4));
          si->region1[gr][ch] = int(s.bits(3));
          si->block_type[gr][ch] = 0;
          si->mixed_flag[gr][ch] = 0;
        }
        if (lsf == 0) si->preflag[gr][ch] = s.bit();
        si->sf_scale[gr][ch] = s.bit();
        si->count1_table[gr][ch] = s.bit();
      }
    }
    return OK;
  }

  // -------------------------------------------------------------------------
  // Huffman spectral decode (mirrors bitstream/maindata.py _read_huffman).
  //
  // Up to 4 granule-channel regions per frame are decoded as independent
  // LANES run round-robin in one loop: each region's bit start is known from
  // the part2_3_length cumsum, so their serial LUT-walk dependency chains
  // can overlap in the out-of-order core (the decode is latency-bound on
  // window-load -> LUT-load -> length). Fast steps read one 64-bit window
  // per symbol (codeword + linbits + signs <= 47 bits; >= 57 valid): the
  // assembled buffer carries >= 16 zero padding bytes so loads stay in
  // allocated memory and windows past the logical end see zeros, matching
  // peek_padded. Lanes that near the buffer tail fall back to the exact
  // scalar path (huff_decode), which replicates the reference's pin-at-end
  // + sticky-error semantics.
  // -------------------------------------------------------------------------

  struct HuffLane {
    int16_t* out = nullptr;
    int gr = 0, ch = 0;
    int64_t bit_pos_end = 0;
    int64_t pos = 0;
    bool err = false;
    int is_pos = 0;
    int seg = 0;  // 0..2 = big-value regions, 3 = count1
    int seg_end[3] = {0, 0, 0};
    const PairLut* lut[3] = {nullptr, nullptr, nullptr};
    const SignedPairLut* slut[3] = {nullptr, nullptr, nullptr};
    int tno[3] = {0, 0, 0};
    int lb[3] = {0, 0, 0};
    const QuadLut* qlut = nullptr;
    int qtno = 0;
    bool active = false;
    bool scalar = false;  // hit the tail guard: finish on the exact path
  };

  // Region setup; m.pos must be at the lane's first Huffman bit.
  Status prepare_lane(const BitReader& m, const Header& h, const SideInfo* si,
                      int gr, int ch, int64_t part2_start, int16_t* is_out,
                      HuffLane* L) {
    int region1_start, region2_start;
    if (si->win_switch[gr][ch] == 1 && si->block_type[gr][ch] == 2) {
      region1_start = 36;
      region2_start = kSamplesPerGr;
    } else {
      const int* bands = kBandLong[h.lsf()][h.sfreq()];
      int i = si->region0[gr][ch] + 1;
      if (i < 0 || i >= 23) { error = "region index"; return HARD_ERROR; }
      region1_start = bands[i];
      int j = si->region0[gr][ch] + si->region1[gr][ch] + 2;
      region2_start = (j >= 23) ? kSamplesPerGr : bands[j];
    }
    int big2 = si->big_values[gr][ch] * 2;
    if (big2 > kSamplesPerGr) { error = "is_pos too big"; return HARD_ERROR; }

    const FastLuts& fl = fast_luts();
    L->out = is_out;
    L->gr = gr;
    L->ch = ch;
    L->bit_pos_end = part2_start + si->part2_3_length[gr][ch] - 1;
    L->pos = m.pos;
    L->err = m.err;
    L->is_pos = 0;
    L->seg = 0;
    L->seg_end[0] = region1_start < big2 ? region1_start : big2;
    L->seg_end[1] = region2_start < big2 ? region2_start : big2;
    if (L->seg_end[0] > L->seg_end[1]) L->seg_end[0] = L->seg_end[1];
    L->seg_end[2] = big2;
    for (int r = 0; r < 3; r++) {
      L->tno[r] = si->table_select[gr][ch][r];
      const TableRef& ref = kTables[L->tno[r]];
      L->lut[r] = ref.book ? &fl.pair_by_table[L->tno[r]] : nullptr;
      L->slut[r] = ref.book ? &fl.signed_by_table[L->tno[r]] : nullptr;
      L->lb[r] = ref.linbits;
    }
    L->qtno = si->count1_table[gr][ch] + 32;
    L->qlut = &fl.quad[si->count1_table[gr][ch]];
    L->active = true;
    L->scalar = false;
    return OK;
  }

  // Rollback + rzero fill + count1 bookkeeping (tail of the reference's
  // readHuffman).
  void lane_finalize(HuffLane& L, SideInfo* si) {
    int is_pos = L.is_pos;
    if (L.pos > L.bit_pos_end + 1) is_pos -= 4;
    if (is_pos < 0) is_pos = 0;
    si->count1[L.gr][L.ch] = is_pos;
    if (is_pos < kSamplesPerGr)
      memset(L.out + is_pos, 0,
             size_t(kSamplesPerGr - is_pos) * sizeof(int16_t));
    L.active = false;
  }

  // Linbits/sign tail shared by the slow decodes: `rest` is the window
  // shifted past the codeword, `pos` the bit position after it.
  static inline void finish_pair(HuffLane& L, uint64_t rest, int64_t pos,
                                 int x, int y, int lb) {
    if (lb) {
      if (x == 15) {
        x += int(rest >> (64 - lb));
        rest <<= lb;
        pos += lb;
      }
      int nx = x != 0;
      int sx = -(int(rest >> 63) & nx);
      x = (x ^ sx) - sx;
      rest <<= nx;
      pos += nx;
      if (y == 15) {
        y += int(rest >> (64 - lb));
        rest <<= lb;
        pos += lb;
      }
      int ny = y != 0;
      int sy = -(int(rest >> 63) & ny);
      y = (y ^ sy) - sy;
      pos += ny;
    } else {
      int nx = x != 0;
      int sx = -(int(rest >> 63) & nx);
      x = (x ^ sx) - sx;
      rest <<= nx;
      pos += nx;
      int ny = y != 0;
      int sy = -(int(rest >> 63) & ny);
      y = (y ^ sy) - sy;
      pos += ny;
    }
    L.pos = pos;
    L.out[L.is_pos] = int16_t(x);
    L.out[L.is_pos + 1] = int16_t(y);
    L.is_pos += 2;
  }

  // Exact single-symbol decode through the two-level LUT, for codes the
  // sign-baked table marks slow without a direct entry (codewords longer
  // than the 12-bit index, junk windows).
  static void decode_pair_slow(HuffLane& L, uint64_t w64) {
    const PairLut& tl = *L.lut[L.seg];
    uint16_t e = tl.prim[w64 >> (64 - tl.prim_bits)];
    if (e & 0x8000u)
      e = tl.sec[(e & 0x7FFFu) +
                 uint32_t((w64 << tl.prim_bits) >> (64 - tl.sec_shift))];
    int len = (e >> 8) & 0x1F;
    finish_pair(L, w64 << len, L.pos + len, (e >> 4) & 0xF, e & 0xF,
                L.lb[L.seg]);
  }

  // One fast decode step for a lane: up to TWO symbols from one 64-bit
  // window via the sign-baked LUT (common case: one L1 load per symbol,
  // advance from the same entry), or segment bookkeeping.
  // NOTE (round 5, measured): forcing this inline into run_lanes and/or
  // building with -fvisibility-inlines-hidden (direct call instead of PLT)
  // are both NEUTRAL in interleaved pairwise A/Bs — the OoO core absorbs
  // the call; don't re-litigate the outlined-call shape.
  static inline void lane_step(HuffLane& L, const uint8_t* buf,
                               int64_t total) {
    if (L.seg < 3) {
      int end = L.seg_end[L.seg];
      if (__builtin_expect(L.is_pos >= end || !L.lut[L.seg], 0)) {
        // advance segments, zero-filling null-book regions (tables 0/4/14:
        // zero pairs, no bits consumed)
        while (L.seg < 3) {
          end = L.seg_end[L.seg];
          if (L.is_pos < end) {
            if (L.lut[L.seg]) return;  // next call decodes
            memset(L.out + L.is_pos, 0,
                   size_t(end - L.is_pos) * sizeof(int16_t));
            L.is_pos = end;
          }
          L.seg++;
        }
        return;  // count1 starts next call
      }
      // window guard: the slow path's worst symbol is 19 code + 2*13
      // linbits + 2 sign bits = 47, and the fast drain's four symbols
      // can index up to bit 47 past the window base — 48 guarantees no
      // fast lookup ever indexes a bit at/past the logical end (they
      // are zero padding, so the old 47 was value-safe; 48 makes it
      // safe by construction). Lanes near the tail finish on the exact
      // scalar path.
      if (__builtin_expect(L.pos + 48 > total, 0)) {
        L.scalar = true;
        L.active = false;
        return;
      }
      const SignedPairLut& sl = *L.slut[L.seg];
      const int sbits = sl.bits;
      const uint16_t* lut = sl.lut.data();
      uint64_t w64 = BitReader::be64(buf + (L.pos >> 3)) << (L.pos & 7);
      uint32_t e = lut[w64 >> (64 - sbits)];
      PSTAT(g_stats.lane_steps++);
      if (__builtin_expect(e & 0x8000u, 0)) {
        if (e & 0x4000u) {  // direct: (len, |x|, |y|) from this same load
          PSTAT(g_stats.pair_slow_direct++);
          PSTAT(g_stats.slow_by_tno[L.tno[L.seg]]++);
          int len = int(e >> 8) & 0xF;
          finish_pair(L, w64 << len, L.pos + len, int(e >> 4) & 0xF,
                      int(e) & 0xF, L.lb[L.seg]);
        } else {
          PSTAT(g_stats.pair_slow_two++);
          PSTAT(g_stats.slow_by_tno[L.tno[L.seg]]++);
          decode_pair_slow(L, w64);
        }
        return;
      }
      PSTAT(g_stats.pair_fast++);
      PSTAT(g_stats.pair_by_tno[L.tno[L.seg]]++);
      uint32_t adv = e >> 10;
      L.out[L.is_pos] = int16_t(((e >> 5) & 0x1F) - 15);
      L.out[L.is_pos + 1] = int16_t((e & 0x1F) - 15);
      L.is_pos += 2;
      L.pos += adv;
      // up to 3 more symbols from the same window (4 x 12 bits fits the
      // >= 57 valid window bits; the guard above keeps loads in-buffer)
      for (int rep = 0; rep < 3; rep++) {
        if (L.is_pos >= end) return;
        uint32_t e2 = lut[(w64 << adv) >> (64 - sbits)];
        if (__builtin_expect(e2 & 0x8000u, 0)) return;  // next call, slow
        PSTAT(g_stats.pair_fast++);
        PSTAT(g_stats.drain_len[rep + 1]++);
        PSTAT(g_stats.pair_by_tno[L.tno[L.seg]]++);
        L.out[L.is_pos] = int16_t(((e2 >> 5) & 0x1F) - 15);
        L.out[L.is_pos + 1] = int16_t((e2 & 0x1F) - 15);
        L.is_pos += 2;
        adv += e2 >> 10;
        L.pos += e2 >> 10;
      }
      return;
    }
    // count1 quadruples, up to four per window (4 x <=10 index bits fit
    // the >= 57 valid window bits; measured ~4-7% whole-parse on mono
    // low-rate streams, neutral on 4-lane frames)
    if (L.is_pos > 572 || L.pos > L.bit_pos_end) {
      L.active = false;  // natural end: caller runs lane_finalize
      return;
    }
    if (__builtin_expect(L.pos + 4 * L.qlut->bits > total, 0)) {
      L.scalar = true;
      L.active = false;
      return;
    }
    static const int8_t dec2[4] = {0, 1, 0, -1};
    PSTAT(g_stats.quad_steps++);
    const int qbits = L.qlut->bits;
    const uint16_t* qlut = L.qlut->lut.data();
    uint64_t w64 = BitReader::be64(buf + (L.pos >> 3)) << (L.pos & 7);
    uint16_t e = qlut[w64 >> (64 - qbits)];
    uint32_t adv = e >> 8;
    L.pos += adv;
    // guard (is_pos <= 572) makes all four writes in-bounds, so the
    // reference's per-write break checks can never fire — write all 4
    L.out[L.is_pos] = dec2[(e >> 6) & 3];
    L.out[L.is_pos + 1] = dec2[(e >> 4) & 3];
    L.out[L.is_pos + 2] = dec2[(e >> 2) & 3];
    L.out[L.is_pos + 3] = dec2[e & 3];
    L.is_pos += 4;
    // quads 2..4 from the same window: same end-of-region checks as the
    // loop head
    PSTAT(g_stats.quads++);
    for (int rep = 0; rep < 3; rep++) {
      if (L.is_pos > 572 || L.pos > L.bit_pos_end) return;
      PSTAT(g_stats.quads++);
      uint16_t f = qlut[(w64 << adv) >> (64 - qbits)];
      adv += f >> 8;
      L.pos += f >> 8;
      L.out[L.is_pos] = dec2[(f >> 6) & 3];
      L.out[L.is_pos + 1] = dec2[(f >> 4) & 3];
      L.out[L.is_pos + 2] = dec2[(f >> 2) & 3];
      L.out[L.is_pos + 3] = dec2[f & 3];
      L.is_pos += 4;
    }
  }

  // Exact scalar continuation from a lane's saved state (bit-for-bit the
  // reference semantics via huff_decode), then finalize.
  void lane_scalar_finish(HuffLane& L, BitReader& m, SideInfo* si) {
    m.pos = L.pos;
    m.err = L.err;
    int is_pos = L.is_pos;
    int x, y, v, w;
    for (int r = L.seg; r < 3; r++) {
      int end = L.seg_end[r];
      if (is_pos >= end) continue;
      if (!L.lut[r]) {
        memset(L.out + is_pos, 0, size_t(end - is_pos) * sizeof(int16_t));
        is_pos = end;
        continue;
      }
      while (is_pos < end) {
        huff_decode(m, L.tno[r], &x, &y, &v, &w);
        L.out[is_pos++] = int16_t(x);
        L.out[is_pos++] = int16_t(y);
      }
    }
    while (is_pos <= 572 && m.pos <= L.bit_pos_end) {
      huff_decode(m, L.qtno, &x, &y, &v, &w);
      L.out[is_pos] = int16_t(v);
      L.out[is_pos + 1] = int16_t(w);
      L.out[is_pos + 2] = int16_t(x);
      L.out[is_pos + 3] = int16_t(y);
      is_pos += 4;
    }
    L.pos = m.pos;
    L.is_pos = is_pos;
    lane_finalize(L, si);
  }

  // Run all lanes round-robin, then finish stragglers exactly.
  // Negative results (interleaved A/B on this host, keep for posterity):
  //  - a swap-remove active list measured 20% SLOWER than these
  //    predictable per-lane flag checks (indirection defeats the BP);
  //  - decoding 2-3 FRAMES' lanes together (8-12 lanes, frame group
  //    pipelining with reservoir rollback) measured ~10% slower than the
  //    4 within-frame lanes — the OoO core saturates at 4 chains and the
  //    extra lanes just add L1 pressure;
  //  - round 4: a TWO-PAIRS-PER-LOOKUP LUT for the small no-linbits
  //    tables (values <= 3; four 3-bit signed fields + 4-bit advance in
  //    u16; ~27% of pair decodes on classic_lame) measured 5-15% SLOWER
  //    whole-parse at both 12-bit (8 KB/table) and 10-bit (2 KB/table)
  //    widths — the added per-step branch + L1 pressure beat the saved
  //    serial lookups. Same lesson as the drain experiments below.
  //  - round 3: extending the in-window pair drain past 4 symbols
  //    (dynamic `adv + sbits <= valid-bits` loop: 0.84x; static 6-symbol
  //    unroll + validity check: 0.94x), draining count1 quads past 4
  //    (0.97x), and continuing the drain through direct slow entries to
  //    save the per-escape dispatch round trip (0.99x) ALL measured
  //    slower on MPEG-1 music despite fewer window reloads — the 4-lane
  //    x 4-symbol shape keeps each lane burst inside the OoO window so
  //    cross-lane loads overlap; longer bursts serialize the LUT-load
  //    dependency chains and any added per-symbol branch beats the
  //    round-trip saving. The 4/4 shape is a measured local optimum.
  void run_lanes(HuffLane* lanes, int nl, BitReader& m, SideInfo* si) {
    const uint8_t* buf = m.vec;
    const int64_t total = m.total_bits();
#ifdef GOMP3_PROF_NO_LANES  // stage-attribution build: skip the decode loop
    (void)buf; (void)total;
    for (int i = 0; i < nl; i++) lane_finalize(lanes[i], si);
    return;
#endif
    PSTAT(g_stats.frames++);
    PSTAT(g_stats.lanes += nl);
    for (;;) {
      bool any = false;
      for (int i = 0; i < nl; i++)
        if (lanes[i].active) {
          lane_step(lanes[i], buf, total);
          any = true;
        }
      if (!any) break;
    }
    for (int i = 0; i < nl; i++) {
      if (lanes[i].scalar)
        lane_scalar_finish(lanes[i], m, si);
      else
        lane_finalize(lanes[i], si);
    }
  }

  // NOTE (round 5, measured): a windowed scalefactor reader (one 64-bit
  // load serving ~14 slen fields, byte-identical output) measured NEUTRAL
  // to +0.7% in interleaved pairwise A/Bs — m.bits() is already ~6
  // cycles/call and the whole scalefactor stage is only ~4% of parse
  // (stage-skip attribution: lanes ~80%, emission ~12% and fully
  // NT-store-bound, scalefactors ~4%, sync+header+side+reservoir ~5%).
  // Don't re-fold without new evidence.

  // Lane setup shared by both scalefactor readers: either the zero-length
  // fast-out (reference quirk: scalefactor bits stay consumed, m.pos is NOT
  // jumped) or a prepared lane + jump to the next region start.
  Status setup_lane_or_skip(BitReader& m, const Header& h, SideInfo* si,
                            int gr, int ch, int64_t part2_start,
                            int16_t* is_out, HuffLane* lanes, int* nl) {
    if (si->part2_3_length[gr][ch] == 0) {
      memset(is_out, 0, kSamplesPerGr * sizeof(int16_t));
      si->count1[gr][ch] = 0;
      return OK;
    }
    Status st = prepare_lane(m, h, si, gr, ch, part2_start, is_out,
                             &lanes[(*nl)]);
    if (st != OK) return st;
    (*nl)++;
    m.pos = part2_start + si->part2_3_length[gr][ch];
    m.err = false;
    return OK;
  }

  // Scalefactor + spectral decode (MPEG-1), writing straight into the
  // output arrays for granule records g0/g0+1. All scalefactors are read
  // first (their positions only depend on the part2_3_length cumsum), then
  // all granule-channel Huffman regions decode as interleaved lanes.
  Status scalefactors_mpeg1(BitReader& m, const Header& h, SideInfo* si,
                            int32_t* sfl, int32_t* sfs, int16_t* spectra) {
    int nch = h.nch();
    HuffLane lanes[4];
    int nl = 0;
    // sfl layout per granule record: [2][22]; sfs: [2][13*3]
    for (int gr = 0; gr < 2; gr++) {
      int32_t* sfl_g = sfl + gr * 2 * 22;
      int32_t* sfs_g = sfs + gr * 2 * 39;
      for (int ch = 0; ch < nch; ch++) {
        int64_t part2_start = m.pos;
        int slen1 = kScalefacSizesMpeg1[si->scalefac_compress[gr][ch]][0];
        int slen2 = kScalefacSizesMpeg1[si->scalefac_compress[gr][ch]][1];
#ifdef GOMP3_PROF_NO_SF  // stage-attribution build: skip scalefactor reads
        (void)slen1; (void)slen2; (void)sfs_g; (void)sfl_g;
#endif
#ifndef GOMP3_PROF_NO_SF
        if (si->win_switch[gr][ch] == 1 && si->block_type[gr][ch] == 2) {
          if (si->mixed_flag[gr][ch]) {
            for (int sfb = 0; sfb < 8; sfb++)
              sfl_g[ch * 22 + sfb] = int(m.bits(slen1));
            for (int sfb = 3; sfb < 12; sfb++) {
              int nbits = sfb < 6 ? slen1 : slen2;
              for (int win = 0; win < 3; win++)
                sfs_g[ch * 39 + sfb * 3 + win] = int(m.bits(nbits));
            }
          } else {
            for (int sfb = 0; sfb < 12; sfb++) {
              int nbits = sfb < 6 ? slen1 : slen2;
              for (int win = 0; win < 3; win++)
                sfs_g[ch * 39 + sfb * 3 + win] = int(m.bits(nbits));
            }
          }
        } else {
          static const int lo[4] = {0, 6, 11, 16};
          static const int hi[4] = {6, 11, 16, 21};
          const int slen[4] = {slen1, slen1, slen2, slen2};
          int32_t* sfl_g0 = sfl + 0 * 2 * 22;  // granule 0 record
          for (int band = 0; band < 4; band++) {
            if (si->scfsi[ch][band] == 0 || gr == 0) {
              for (int sfb = lo[band]; sfb < hi[band]; sfb++)
                sfl_g[ch * 22 + sfb] = int(m.bits(slen[band]));
            } else if (si->scfsi[ch][band] == 1 && gr == 1) {
              for (int sfb = lo[band]; sfb < hi[band]; sfb++)
                sfl_g[ch * 22 + sfb] = sfl_g0[ch * 22 + sfb];
            }
          }
        }
#endif  // GOMP3_PROF_NO_SF
        Status st = setup_lane_or_skip(
            m, h, si, gr, ch, part2_start,
            spectra + (gr * 2 + ch) * kSamplesPerGr, lanes, &nl);
        if (st != OK) return st;
      }
    }
    int64_t end_pos = m.pos;
    run_lanes(lanes, nl, m, si);
    m.pos = end_pos;
    m.err = false;
    return OK;
  }

  Status scalefactors_mpeg2(BitReader& m, const Header& h, SideInfo* si,
                            int32_t* sfl, int32_t* sfs, int16_t* spectra) {
    int nch = h.nch();
    HuffLane lanes[2];
    int nl = 0;
    for (int ch = 0; ch < nch; ch++) {
      int64_t part2_start = m.pos;
      int slen = kNSlen2.v[si->scalefac_compress[0][ch]];
      si->preflag[0][ch] = (slen >> 15) & 1;
      int n = 0;
      if (si->block_type[0][ch] == 2) {
        n++;
        if (si->mixed_flag[0][ch]) n++;
      }
      int d = (slen >> 12) & 7;
      int sf[40];
      int cnt = 0;
      for (int i = 0; i < 4; i++) {
        int num = slen & 7;
        slen >>= 3;
        int c = kScalefacSizesMpeg2[n][d][i];
#ifdef GOMP3_PROF_NO_SF  // stage-attribution build: skip scalefactor reads
        for (int k = 0; k < c; k++) sf[cnt++] = 0;
        (void)num;
#else
        if (num > 0)
          for (int k = 0; k < c; k++) sf[cnt++] = int(m.bits(num));
        else
          for (int k = 0; k < c; k++) sf[cnt++] = 0;
#endif
      }
      int pad = (n << 1) + 1;
      for (int k = 0; k < pad; k++) sf[cnt++] = 0;

      if (cnt == 22) {
        for (int i = 0; i < 22; i++) sfl[ch * 22 + i] = sf[i];
      } else {
        for (int i = 0; i < 39; i++) sfs[ch * 39 + i] = sf[i];
      }
      Status st = setup_lane_or_skip(m, h, si, 0, ch, part2_start,
                                     spectra + ch * kSamplesPerGr, lanes, &nl);
      if (st != OK) return st;
    }
    int64_t end_pos = m.pos;
    run_lanes(lanes, nl, m, si);
    m.pos = end_pos;
    m.err = false;
    return OK;
  }

  // Parse one frame; on success append its granules to the output arrays.
  // Writes at offsets g (granule index) into caller arrays.
  Status parse_frame(int16_t* spectra, int32_t* sfl, int32_t* sfs,
                     int32_t* meta, int* granules_out, int64_t* frame_pos) {
    Header h;
    Status st = read_header(&h);
    if (st != OK) return st;
    *frame_pos = pos - 4;
    if (h.protection_bit() == 0) {
      if (remaining() < 2) return END_OF_AUDIO;
      pos += 2;  // CRC value ignored
    }
    if (h.version() == 0) { error = "MPEG-2.5 not supported"; return HARD_ERROR; }
    // layer check already in is_valid()

    SideInfo si;
    st = read_side_info(h, &si);
    if (st != OK) return st;

    // ---- bit reservoir assembly (mirrors maindata.py) ----
    int frame_size = h.frame_size();
    int main_size = frame_size - h.side_info_size() - 4;
    if (h.protection_bit() == 0) main_size -= 2;
    if (main_size > 1500) { error = "main size"; return HARD_ERROR; }
    if (main_size < 0) { error = "negative main size"; return HARD_ERROR; }
    if (remaining() < main_size) return END_OF_AUDIO;

    std::vector<uint8_t>& assembled = scratch;
    assembled.clear();
    int offset = si.main_data_begin;
    if (has_prev && offset > int(reservoir_len)) {
      // underfilled reservoir: decode anyway from full prev + new bytes
      assembled.insert(assembled.end(), reservoir.begin(),
                       reservoir.begin() + reservoir_len);
    } else {
      if (has_prev && offset > 0)
        assembled.insert(assembled.end(),
                         reservoir.begin() + (reservoir_len - offset),
                         reservoir.begin() + reservoir_len);
    }
    assembled.insert(assembled.end(), data + pos, data + pos + main_size);
    pos += main_size;
    int64_t logical_size = int64_t(assembled.size());
    // zero padding so the windowed Huffman fast path never loads out of
    // allocated memory and windows past the end read zeros (= peek_padded)
    assembled.resize(assembled.size() + 16, 0);

    BitReader m{assembled.data(), logical_size};

    int ngr = h.granules();
    // zero the records read_huffman won't cover (mono ch1) + scalefactors
    if (h.nch() == 1 && !skip_mono_ch1)
      for (int gr = 0; gr < ngr; gr++)
        memset(spectra + (gr * 2 + 1) * kSamplesPerGr, 0,
               kSamplesPerGr * sizeof(int16_t));
    memset(sfl, 0, ngr * 2 * 22 * sizeof(int32_t));
    memset(sfs, 0, ngr * 2 * 39 * sizeof(int32_t));

    if (h.lsf() == 1)
      st = scalefactors_mpeg2(m, h, &si, sfl, sfs, spectra);
    else
      st = scalefactors_mpeg1(m, h, &si, sfl, sfs, spectra);
    if (st != OK) return st;

    // host-side short-block reorder (device consumes post-reorder layout)
#ifndef GOMP3_PROF_NO_REORDER  // stage-attribution build: skip reorder
    for (int gr = 0; gr < ngr; gr++) {
      for (int ch = 0; ch < h.nch(); ch++) {
        if (!(si.win_switch[gr][ch] == 1 && si.block_type[gr][ch] == 2))
          continue;
        int kind = si.mixed_flag[gr][ch] ? 1 : 0;
        const int16_t* p = kReorder.perm[h.lsf()][h.sfreq()][kind];
        int16_t* s = spectra + (gr * 2 + ch) * kSamplesPerGr;
        int16_t tmp[kSamplesPerGr];
        for (int l = 0; l < kSamplesPerGr; l++) tmp[l] = s[p[l]];
        memcpy(s, tmp, sizeof(tmp));
      }
    }
#endif

    // keep the full assembled buffer as the next frame's reservoir source
    reservoir.swap(assembled);  // scratch now holds the old reservoir
    reservoir_len = logical_size;
    has_prev = true;
    if (sample_rate == 0) sample_rate = h.sample_rate();

    // ---- emit per-granule meta ----
    int variant = h.lsf() * 3 + h.sfreq();
    for (int gr = 0; gr < ngr; gr++) {
      int32_t* mg = meta + gr * 24;
      mg[0] = variant;
      mg[1] = (h.ms_stereo() ? 1 : 0) | (h.is_stereo() ? 2 : 0) |
              (h.mono() ? 4 : 0);
      mg[2] = h.mono() ? si.count1[gr][0] : si.count1[gr][1];
      mg[3] = 0;  // frame index filled by caller if wanted
      for (int ch = 0; ch < 2; ch++) {
        int c = h.mono() ? 0 : ch;  // mono: duplicate is NOT done; ch1 zeros
        bool real = ch < h.nch();
        mg[4 + ch] = real ? si.global_gain[gr][c] : 0;
        mg[6 + ch] = real ? si.sf_scale[gr][c] : 0;
        mg[8 + ch] = real ? si.preflag[gr][c] : 0;
        mg[10 + ch] = real ? si.block_type[gr][c] : 0;
        int cls = 0;
        if (real && si.win_switch[gr][c] == 1 && si.block_type[gr][c] == 2)
          cls = si.mixed_flag[gr][c] ? 2 : 1;
        mg[12 + ch] = cls;
        for (int w = 0; w < 3; w++)
          mg[14 + ch * 3 + w] = real ? si.subblock_gain[gr][c][w] : 0;
        mg[20 + ch] = real ? si.count1[gr][c] : 0;
      }
      mg[22] = gr;
      mg[23] = 0;
    }
    *granules_out = ngr;
    return OK;
  }
};

}  // namespace gomp3

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

using gomp3::Parser;

void* gmp_create(const uint8_t* data, int64_t len) {
  return new Parser(data, len);
}

void gmp_destroy(void* p) { delete static_cast<Parser*>(p); }

// Chunked-feed (streaming) parser: create empty, then gmp_feed bytes as
// they arrive (eof=1 marks the end). The gmp_parse* functions return 0
// both on "need more data" and on true end of audio; callers distinguish
// by whether eof has been fed. Consumed bytes are compacted away, so a
// pipe/socket-style source parses in bounded memory.
void* gmp_create_stream() { return new Parser(); }

void gmp_feed(void* pv, const uint8_t* data, int64_t len, int eof) {
  static_cast<Parser*>(pv)->feed(data, len, eof != 0);
}

// 1 when the stream can produce no more audio (sync-search cap hit):
// streaming callers should stop feeding (further bytes would buffer
// without bound while parses keep returning 0).
int gmp_terminal(void* pv) {
  return static_cast<Parser*>(pv)->terminal ? 1 : 0;
}

int gmp_sample_rate(void* p) { return static_cast<Parser*>(p)->sample_rate; }

const char* gmp_error(void* p) { return static_cast<Parser*>(p)->error; }

// Checkpoint/resume support: byte position within the creation buffer and
// the bit-reservoir contents (the previous frame's assembled main-data
// buffer; its tail feeds the next frame's main_data_begin backreference).
int64_t gmp_pos(void* pv) {
  Parser* p = static_cast<Parser*>(pv);
  return p->base_consumed + p->pos;
}

int gmp_get_reservoir(void* pv, uint8_t* out, int cap) {
  Parser* p = static_cast<Parser*>(pv);
  if (!p->has_prev) return 0;
  int n = int(p->reservoir_len);
  if (n > cap) n = cap;
  // keep the TAIL (only the last <=511 bytes are ever referenced)
  memcpy(out, p->reservoir.data() + (p->reservoir_len - n), n);
  return n;
}

void gmp_set_reservoir(void* pv, const uint8_t* data, int len) {
  Parser* p = static_cast<Parser*>(pv);
  p->reservoir.assign(data, data + len);
  p->reservoir_len = len;
  p->has_prev = len > 0;
}

// Parse up to `cap` granules into the caller-provided arrays:
//   spectra [cap][2][576] i32, sfl [cap][2][22] i32, sfs [cap][2][39] i32,
//   meta [cap][24] i32.
// Returns granules produced (0 = end of audio), or -1 on hard error.
// Streaming-mode helper: returns false when the parse loop should stop
// because tags can't be skipped yet (need more fed bytes).
static bool stream_ready(Parser* p) {
  if (p->terminal) return false;  // sync-limit death: stop parsing/buffering
  if (!p->streaming || p->tags_done) return true;
  if (!p->skip_tags_streaming()) return false;
  p->tags_done = true;
  return true;
}

int gmp_parse(void* pv, int cap, int16_t* spectra, int32_t* sfl, int32_t* sfs,
              int32_t* meta) {
  Parser* p = static_cast<Parser*>(pv);
  if (!stream_ready(p)) return 0;
  p->skip_mono_ch1 = false;
  int g = 0;
  // a frame yields up to 2 granules, so keep 2 slots free
  while (cap - g >= 2) {
    int produced = 0;
    int64_t fpos = 0;
    int64_t save_pos = p->pos;
    gomp3::Status st = p->parse_frame(
        spectra + g * 2 * 576, sfl + g * 2 * 22, sfs + g * 2 * 39,
        meta + g * 24, &produced, &fpos);
    if (st == gomp3::END_OF_AUDIO) {
      // in streaming mode a short read may become a full frame after the
      // next feed; rewind so the retry re-parses from the frame start
      if (p->streaming && !p->fed_eof && !p->terminal) p->pos = save_pos;
      break;
    }
    if (st == gomp3::HARD_ERROR) return g > 0 ? g : -1;
    g += produced;
  }
  return g;
}

// Parse up to `cap` granules into the packed device-interface layout:
//   spectra [cap][1152] i16  (post-reorder, [2][576] flattened)
//   side    [cap][144] i16   (all per-granule metadata + scalefactors):
//     [0] variant  [1] flags(ms|is<<1|mono<<2)  [2] count1_r  [3] gr_index
//     [4+ch] global_gain  [6+ch] sf_scale  [8+ch] preflag  [10+ch] block_type
//     [12+ch] block_class  [14+3ch+w] subblock_gain  [20+ch] count1
//     [22+22ch+sfb] scalefac_l  [66+39ch+i] scalefac_s
// Two flat, tile-friendly arrays = one cheap H2D transfer each; the device
// unpacks (go_mp3_tpu_torch/ops/granule.py batch_from_packed).
// Returns granules produced (0 = end of audio), or -1 on hard error.
int gmp_parse_packed(void* pv, int cap, int16_t* spectra, int16_t* side) {
  Parser* p = static_cast<Parser*>(pv);
  if (!stream_ready(p)) return 0;
  p->skip_mono_ch1 = false;
  int g = 0;
  int32_t sfl[2 * 2 * 22];
  int32_t sfs[2 * 2 * 39];
  int32_t meta[2 * 24];
  while (cap - g >= 2) {
    int produced = 0;
    int64_t fpos = 0;
    int64_t save_pos = p->pos;
    gomp3::Status st = p->parse_frame(spectra + g * 1152, sfl, sfs, meta,
                                      &produced, &fpos);
    if (st == gomp3::END_OF_AUDIO) {
      // in streaming mode a short read may become a full frame after the
      // next feed; rewind so the retry re-parses from the frame start
      if (p->streaming && !p->fed_eof && !p->terminal) p->pos = save_pos;
      break;
    }
    if (st == gomp3::HARD_ERROR) return g > 0 ? g : -1;
    for (int gr = 0; gr < produced; gr++) {
      const int32_t* mg = meta + gr * 24;
      int16_t* sd = side + (g + gr) * 144;
      sd[0] = int16_t(mg[0]);
      sd[1] = int16_t(mg[1]);
      sd[2] = int16_t(mg[2]);
      sd[3] = int16_t(mg[22]);
      for (int ch = 0; ch < 2; ch++) {
        sd[4 + ch] = int16_t(mg[4 + ch]);
        sd[6 + ch] = int16_t(mg[6 + ch]);
        sd[8 + ch] = int16_t(mg[8 + ch]);
        sd[10 + ch] = int16_t(mg[10 + ch]);
        sd[12 + ch] = int16_t(mg[12 + ch]);
        for (int w = 0; w < 3; w++)
          sd[14 + ch * 3 + w] = int16_t(mg[14 + ch * 3 + w]);
        sd[20 + ch] = int16_t(mg[20 + ch]);
      }
      const int32_t* sfl_g = sfl + gr * 2 * 22;
      const int32_t* sfs_g = sfs + gr * 2 * 39;
      for (int i = 0; i < 44; i++) sd[22 + i] = int16_t(sfl_g[i]);
      for (int i = 0; i < 78; i++) sd[66 + i] = int16_t(sfs_g[i]);
    }
    g += produced;
  }
  return g;
}

// Parse up to `cap` granules into the int8-quantized device layout — the
// minimum-byte H2D interface (Huffman magnitudes are < 128 for all but a
// handful of LOW lines per granule — big spectral values live near DC):
//   head16 [cap][128] i16  per-channel lines 0..63, exact (the dense head
//                          replaces a scatter-applied escape list: device
//                          unpack is a pure concatenate, no gather/scatter)
//   tail8  [cap][1024] i8  per-channel lines 64..575
//   side8  [cap][168] u8   bytes 0..43 = the 22 meta words (LE int16,
//                          all non-negative), 44..87 = scalefac_l i8,
//                          88..165 = scalefac_s i8, 166..167 pad
// If any tail line has |value| > 127 (never observed on real streams —
// escapes cluster at low lines; pathological inputs only) a sticky
// overflow flag is set; the overflowed granules were emitted with CLIPPED
// values and the position has advanced past them, so callers must
// re-parse the stream from the start with gmp_parse_packed and discard
// this parser. Returns granules produced (0 = end of audio), or -1 on
// hard error.
constexpr int kHeadLines = 64;
constexpr int kTailLines = 576 - kHeadLines;

#ifdef GOMP3_AVX2
// 32 int32 -> 32 uint8 by two pack stages (values known 0..255; the
// 0xD8 qword permutes undo each pack's lane interleave)
static inline void narrow32_avx2(const int32_t* s, uint8_t* d) {
  __m256i a = _mm256_loadu_si256((const __m256i*)s);
  __m256i b = _mm256_loadu_si256((const __m256i*)(s + 8));
  __m256i c = _mm256_loadu_si256((const __m256i*)(s + 16));
  __m256i e = _mm256_loadu_si256((const __m256i*)(s + 24));
  __m256i ab = _mm256_permute4x64_epi64(_mm256_packs_epi32(a, b), 0xD8);
  __m256i ce = _mm256_permute4x64_epi64(_mm256_packs_epi32(c, e), 0xD8);
  __m256i r = _mm256_permute4x64_epi64(_mm256_packus_epi16(ab, ce), 0xD8);
  _mm256_storeu_si256((__m256i*)d, r);
}
#endif

int gmp_parse_packed8(void* pv, int cap, int8_t* tail8, int16_t* head16,
                      uint8_t* side8) {
  Parser* p = static_cast<Parser*>(pv);
  if (!stream_ready(p)) return 0;
  p->skip_mono_ch1 = true;  // this interface emits mono ch1 zeros itself
#ifdef GOMP3_SSE2
  // Non-temporal stores for the bulk planes when 16-aligned AND the
  // request is corpus-sized: large chunk buffers are write-only during
  // the parse and far bigger than cache, so regular stores pay a
  // read-for-ownership per line — NT stores skip it (the emission
  // writes ~1.3 KB/granule; a fleet chunk streams ~29 MB of them;
  // measured +2.1% on a cold 64-stream probe). Small requests (the
  // streaming Decoder's 128-granule chunks) keep cached stores: their
  // buffers are re-read immediately and fit L2 (cached stores measured
  // ~1.5% better there). Per-granule strides (1024 / 256 B) preserve
  // the base alignment.
  const bool nt = cap >= 192 &&
                  ((reinterpret_cast<uintptr_t>(tail8) |
                    reinterpret_cast<uintptr_t>(head16)) & 15) == 0;
#endif
#ifdef GOMP3_AVX2
  // 32B-wide NT stores: the per-granule strides (1024 B tail, 256 B head)
  // are multiples of 32, so base alignment is preserved per granule. Pool
  // buffers are page-aligned numpy allocations; anything else falls back
  // to the SSE path below.
  const bool nt256 = cap >= 192 &&
                     ((reinterpret_cast<uintptr_t>(tail8) |
                       reinterpret_cast<uintptr_t>(head16)) & 31) == 0;
#endif
  int g = 0;
  int16_t sp[2 * 1152];
  int32_t sfl[2 * 2 * 22];
  int32_t sfs[2 * 2 * 39];
  int32_t meta[2 * 24];
  while (cap - g >= 2) {
    int produced = 0;
    int64_t fpos = 0;
    int64_t save_pos = p->pos;
    gomp3::Status st = p->parse_frame(sp, sfl, sfs, meta, &produced, &fpos);
    if (st == gomp3::END_OF_AUDIO) {
      if (p->streaming && !p->fed_eof && !p->terminal) p->pos = save_pos;
      break;
    }
    if (st == gomp3::HARD_ERROR) {
#ifdef GOMP3_SSE2
      // fence the NT stores of the g granules already emitted — every
      // exit must flow through a fence before the caller hands the
      // buffers to another thread (e.g. a jax transfer thread)
      _mm_sfence();
#endif
      return g > 0 ? g : -1;
    }
    for (int gr = 0; gr < produced; gr++) {
#ifdef GOMP3_PROF_NO_EMIT  // stage-attribution build: skip emission
      continue;
#endif
      const int16_t* src = sp + gr * 1152;
      int16_t* dh = head16 + (g + gr) * (2 * kHeadLines);
      int8_t* d8 = tail8 + (g + gr) * (2 * kTailLines);
      // mono frames: ch1 is all-zero by contract (meta bit 2) — emit the
      // zeros directly instead of packing 576 zero lines through the SSE
      // narrow (the device unpack reads the same zeros either way)
      const int nch_emit = (meta[gr * 24 + 1] & 4) ? 1 : 2;
      // Attribution build: same NT stores, no loads/pack. Measured (round
      // 5) IDENTICAL to full emission in interleaved A/Bs — emission is
      // entirely NT-store-bound, so extent-capped packing or other ALU
      // savings in this loop cannot help; only storing fewer bytes would
      // (and the device consumes full-width rows, so there are none to
      // drop host-side).
#ifdef GOMP3_PROF_EMIT_ZEROS
      if (nt256) {
        const __m256i z = _mm256_setzero_si256();
        for (int i = 0; i < 2 * kHeadLines; i += 16)
          _mm256_stream_si256((__m256i*)(dh + i), z);
        for (int i = 0; i < 2 * kTailLines; i += 32)
          _mm256_stream_si256((__m256i*)(d8 + i), z);
        goto emit_sidecar;
      }
#endif
#ifdef GOMP3_AVX2
      if (nt256) {
        // one 32B NT store per 32 tail lines: two 16x16-bit loads ->
        // saturating pack (lane-interleaved) -> qword permute to restore
        // order. Range check accumulates min/max and tests once per
        // channel (same contract as the SSE path: clipped values emit,
        // sticky overflow flags the fallback).
        if (nch_emit == 1) {
          const __m256i z = _mm256_setzero_si256();
          for (int i = 0; i < kHeadLines; i += 16)
            _mm256_stream_si256((__m256i*)(dh + kHeadLines + i), z);
          for (int i = 0; i < kTailLines; i += 32)
            _mm256_stream_si256((__m256i*)(d8 + kTailLines + i), z);
        }
        for (int ch = 0; ch < nch_emit; ch++) {
          const int16_t* h = src + ch * 576;
          int16_t* dhc = dh + ch * kHeadLines;
          for (int i = 0; i < kHeadLines; i += 16)
            _mm256_stream_si256(
                (__m256i*)(dhc + i),
                _mm256_loadu_si256((const __m256i*)(h + i)));
          const int16_t* t = src + ch * 576 + kHeadLines;
          int8_t* d = d8 + ch * kTailLines;
          __m256i amin = _mm256_setzero_si256();
          __m256i amax = _mm256_setzero_si256();
          for (int i = 0; i < kTailLines; i += 32) {
            __m256i a = _mm256_loadu_si256((const __m256i*)(t + i));
            __m256i b = _mm256_loadu_si256((const __m256i*)(t + i + 16));
            __m256i pk = _mm256_permute4x64_epi64(
                _mm256_packs_epi16(a, b), 0xD8);
            _mm256_stream_si256((__m256i*)(d + i), pk);
            amin = _mm256_min_epi16(amin, _mm256_min_epi16(a, b));
            amax = _mm256_max_epi16(amax, _mm256_max_epi16(a, b));
          }
          int bad = _mm256_movemask_epi8(_mm256_or_si256(
              _mm256_cmpgt_epi16(_mm256_set1_epi16(-128), amin),
              _mm256_cmpgt_epi16(amax, _mm256_set1_epi16(127))));
          if (__builtin_expect(bad != 0, 0)) p->packed8_overflow = true;
        }
        goto emit_sidecar;
      }
#endif
#ifdef GOMP3_SSE2
      if (nt) {
        if (nch_emit == 1) {
          const __m128i z = _mm_setzero_si128();
          for (int i = 0; i < kHeadLines; i += 8)
            _mm_stream_si128((__m128i*)(dh + kHeadLines + i), z);
          for (int i = 0; i < kTailLines; i += 16)
            _mm_stream_si128((__m128i*)(d8 + kTailLines + i), z);
        }
        for (int ch = 0; ch < nch_emit; ch++) {
          const int16_t* h = src + ch * 576;
          int16_t* dhc = dh + ch * kHeadLines;
          for (int i = 0; i < kHeadLines; i += 8)
            _mm_stream_si128(
                (__m128i*)(dhc + i),
                _mm_loadu_si128((const __m128i*)(h + i)));
          const int16_t* t = src + ch * 576 + kHeadLines;
          int8_t* d = d8 + ch * kTailLines;
          __m128i amin = _mm_setzero_si128(), amax = _mm_setzero_si128();
          for (int i = 0; i < kTailLines; i += 16) {
            __m128i a = _mm_loadu_si128((const __m128i*)(t + i));
            __m128i b = _mm_loadu_si128((const __m128i*)(t + i + 8));
            _mm_stream_si128((__m128i*)(d + i), _mm_packs_epi16(a, b));
            amin = _mm_min_epi16(amin, _mm_min_epi16(a, b));
            amax = _mm_max_epi16(amax, _mm_max_epi16(a, b));
          }
          int bad = _mm_movemask_epi8(_mm_or_si128(
              _mm_cmplt_epi16(amin, _mm_set1_epi16(-128)),
              _mm_cmpgt_epi16(amax, _mm_set1_epi16(127))));
          if (__builtin_expect(bad != 0, 0)) p->packed8_overflow = true;
        }
        goto emit_sidecar;
      }
#endif
      if (nch_emit == 1) {
        memset(dh + kHeadLines, 0, kHeadLines * sizeof(int16_t));
        memset(d8 + kTailLines, 0, kTailLines);
      }
      for (int ch = 0; ch < nch_emit; ch++) {
        memcpy(dh + ch * kHeadLines, src + ch * 576,
               kHeadLines * sizeof(int16_t));
        const int16_t* t = src + ch * 576 + kHeadLines;
        int8_t* d = d8 + ch * kTailLines;
#ifdef GOMP3_SSE2
        // saturating narrow 16 values at a time; range-accumulate and do
        // ONE out-of-range check per channel (any clipped tail line flips
        // the sticky overflow and callers fall back to int16). Measured
        // ~9% faster whole-parse than the per-iteration widen-and-compare
        // it replaces (4 min/max ops per 16 values vs 8 widen/cmp/pack).
        __m128i amin = _mm_setzero_si128(), amax = _mm_setzero_si128();
        for (int i = 0; i < kTailLines; i += 16) {
          __m128i a = _mm_loadu_si128((const __m128i*)(t + i));
          __m128i b = _mm_loadu_si128((const __m128i*)(t + i + 8));
          _mm_storeu_si128((__m128i*)(d + i), _mm_packs_epi16(a, b));
          amin = _mm_min_epi16(amin, _mm_min_epi16(a, b));
          amax = _mm_max_epi16(amax, _mm_max_epi16(a, b));
        }
        int bad = _mm_movemask_epi8(_mm_or_si128(
            _mm_cmplt_epi16(amin, _mm_set1_epi16(-128)),
            _mm_cmpgt_epi16(amax, _mm_set1_epi16(127))));
        if (__builtin_expect(bad != 0, 0)) p->packed8_overflow = true;
#else
        for (int i = 0; i < kTailLines; i++) {
          int v = t[i];
          int c = v > 127 ? 127 : (v < -128 ? -128 : v);
          d[i] = int8_t(c);
          if (__builtin_expect(v != c, 0)) p->packed8_overflow = true;
        }
#endif
      }
#ifdef GOMP3_SSE2
    emit_sidecar:;
#endif
      const int32_t* mg = meta + gr * 24;
      uint8_t* sd = side8 + (g + gr) * 168;
      int16_t w[22];
      w[0] = int16_t(mg[0]);
      w[1] = int16_t(mg[1]);
      w[2] = int16_t(mg[2]);
      w[3] = int16_t(mg[22]);
      for (int ch = 0; ch < 2; ch++) {
        w[4 + ch] = int16_t(mg[4 + ch]);
        w[6 + ch] = int16_t(mg[6 + ch]);
        w[8 + ch] = int16_t(mg[8 + ch]);
        w[10 + ch] = int16_t(mg[10 + ch]);
        w[12 + ch] = int16_t(mg[12 + ch]);
        for (int k = 0; k < 3; k++)
          w[14 + ch * 3 + k] = int16_t(mg[14 + ch * 3 + k]);
        w[20 + ch] = int16_t(mg[20 + ch]);
      }
      memcpy(sd, w, 44);
      const int32_t* sfl_g = sfl + gr * 2 * 22;
      const int32_t* sfs_g = sfs + gr * 2 * 39;
#ifdef GOMP3_AVX2
      // packed int32->u8 narrowing, 32 scalefactors per store (values are
      // 0..15, so saturating packs == the scalar uint8_t cast). In-bounds:
      // the 32-wide loads stay inside the gr=1 slice of the local arrays.
      narrow32_avx2(sfl_g, sd + 44);
      for (int i = 32; i < 44; i++) sd[44 + i] = uint8_t(sfl_g[i]);
      narrow32_avx2(sfs_g, sd + 88);
      narrow32_avx2(sfs_g + 32, sd + 120);
      for (int i = 64; i < 78; i++) sd[88 + i] = uint8_t(sfs_g[i]);
#else
      for (int i = 0; i < 44; i++) sd[44 + i] = uint8_t(sfl_g[i]);
      for (int i = 0; i < 78; i++) sd[88 + i] = uint8_t(sfs_g[i]);
#endif
      sd[166] = sd[167] = 0;
    }
    g += produced;
  }
#ifdef GOMP3_SSE2
  _mm_sfence();  // order the non-temporal stores before the caller reads
#endif
  return g;
}

int gmp_packed8_overflow(void* pv) {
  return static_cast<Parser*>(pv)->packed8_overflow ? 1 : 0;
}

// Parse ONE chunk for MANY streams in a single call: per stream s, up to
// `cap` granules into row block s of the [n_streams, cap, ...] arrays,
// with rows past the produced count zero-filled here (C memset, not
// numpy). Saves the per-stream ctypes dispatch + numpy view/padding
// overhead of the Python chunk loop (~12 us x streams x chunks, ~2-3% of
// a 64-stream corpus parse). valids[s] = granules produced for stream s.
// Returns the max granule count across streams (0 = corpus exhausted),
// -1 on hard error, -2 on int8 overflow; *err_stream then names the
// offending stream.
int gmp_parse_packed8_many(void** pv, int n_streams, int cap, int8_t* tail8,
                           int16_t* head16, uint8_t* side8, int32_t* valids,
                           int32_t* err_stream) {
  const size_t tail_row = size_t(cap) * (2 * kTailLines);
  const size_t head_row = size_t(cap) * (2 * kHeadLines);
  const size_t side_row = size_t(cap) * 168;
  int mx = 0;
  for (int s = 0; s < n_streams; s++) {
    Parser* p = static_cast<Parser*>(pv[s]);
    int n = gmp_parse_packed8(p, cap, tail8 + s * tail_row,
                              head16 + s * head_row, side8 + s * side_row);
    if (n < 0) {
      *err_stream = s;
      return -1;
    }
    if (p->packed8_overflow) {
      *err_stream = s;
      return -2;
    }
    valids[s] = n;
    if (n < cap) {
      memset(tail8 + s * tail_row + size_t(n) * (2 * kTailLines), 0,
             size_t(cap - n) * (2 * kTailLines));
      memset(head16 + s * head_row + size_t(n) * (2 * kHeadLines), 0,
             size_t(cap - n) * (2 * kHeadLines) * sizeof(int16_t));
      memset(side8 + s * side_row + size_t(n) * 168, 0,
             size_t(cap - n) * 168);
    }
    if (n > mx) mx = n;
  }
  return mx;
}

// Pack the fused transfer buffer's TAIL region: [S, T, 1024] granule-major
// parser output -> [S, 2, l, T] channel-major line-major (the relay-
// compression-friendly wire layout), shipping only the first `l` tail
// lines per channel. This is a [T, 512] -> [l, T] byte transpose per
// (stream, channel); numpy's strided-assignment version runs ~1.5 GB/s
// (dest-order iteration misses cache on every source element), the
// 16x16-blocked kernel here runs several times faster. Head/side regions
// are plain row copies and stay in numpy.
static void transpose_block16(const int8_t* src, size_t sstride, int8_t* dst,
                              size_t dstride, int rows, int cols) {
  // generic tile (<=16x16): src[r, c] -> dst[c, r]
  for (int r = 0; r < rows; r++)
    for (int c = 0; c < cols; c++)
      dst[size_t(c) * dstride + r] = src[size_t(r) * sstride + c];
}

#ifdef GOMP3_SSE2
// full 16x16 byte transpose: 4 rounds of unpacklo/hi at doubling element
// widths, pairing stride = element width within blocks of twice that,
// outputs written as (lo, hi) in pair order — this network leaves the
// transposed rows in IDENTITY order (derived by simulation; validated
// byte-for-byte against the scalar tile by the build_fused_chunk
// equality tests)
static inline void transpose16x16_sse(const int8_t* src, size_t sstride,
                                      int8_t* dst, size_t dstride) {
  __m128i a[16], b[16];
  for (int i = 0; i < 16; i++)
    a[i] = _mm_loadu_si128((const __m128i*)(src + i * sstride));
#define GOMP3_T16_STAGE(dstv, srcv, unlo, unhi, stride)              \
  {                                                                  \
    int k = 0;                                                       \
    for (int base = 0; base < 16; base += 2 * (stride))              \
      for (int i = 0; i < (stride); i++, k++) {                      \
        dstv[2 * k] = unlo(srcv[base + i], srcv[base + i + (stride)]); \
        dstv[2 * k + 1] =                                            \
            unhi(srcv[base + i], srcv[base + i + (stride)]);         \
      }                                                              \
  }
  GOMP3_T16_STAGE(b, a, _mm_unpacklo_epi8, _mm_unpackhi_epi8, 1)
  GOMP3_T16_STAGE(a, b, _mm_unpacklo_epi16, _mm_unpackhi_epi16, 2)
  GOMP3_T16_STAGE(b, a, _mm_unpacklo_epi32, _mm_unpackhi_epi32, 4)
  GOMP3_T16_STAGE(a, b, _mm_unpacklo_epi64, _mm_unpackhi_epi64, 8)
#undef GOMP3_T16_STAGE
  for (int j = 0; j < 16; j++)
    _mm_storeu_si128((__m128i*)(dst + size_t(j) * dstride), a[j]);
}
#endif

void gmp_pack_fused_tail_nch(const int8_t* sp, int8_t* dst, int n_streams,
                             int t, int l, int64_t dst_stream_stride,
                             int nch) {
  // dst points at stream 0's tail region inside the fused buffer; rows of
  // that buffer are dst_stream_stride bytes apart (the tail region is a
  // strided view of [S, stream_bytes], not a dense [S,nch,l,T] array).
  // nch=1 packs only channel 0 (the mono-lane half-width wire layout;
  // ch1 of a mono granule is all-zero by the parser's contract and is
  // reconstructed as zeros on device). Defensive bound: the source
  // layout is [.., 2, 512] per granule row — l > 512 would read across
  // granule/channel boundaries (the Python wrapper validates too; this
  // keeps the C ABI safe on its own).
  if (l <= 0 || l > 512 || t <= 0 || nch < 1 || nch > 2) return;
  constexpr int B = 16;
  for (int s = 0; s < n_streams; s++) {
    for (int ch = 0; ch < nch; ch++) {
      const int8_t* src = sp + (size_t(s) * t) * 1024 + ch * 512;
      int8_t* d = dst + size_t(s) * dst_stream_stride +
                  size_t(ch) * l * t;
      // src matrix: [t rows, l cols] with row stride 1024; dst: [l, t]
      for (int c0 = 0; c0 < l; c0 += B) {
        int cb = l - c0 < B ? l - c0 : B;
        for (int r0 = 0; r0 < t; r0 += B) {
          int rb = t - r0 < B ? t - r0 : B;
#ifdef GOMP3_SSE2
          if (rb == B && cb == B) {
            transpose16x16_sse(src + size_t(r0) * 1024 + c0, 1024,
                               d + size_t(c0) * t + r0, t);
            continue;
          }
#endif
          transpose_block16(src + size_t(r0) * 1024 + c0, 1024,
                            d + size_t(c0) * t + r0, t, rb, cb);
        }
      }
    }
  }
}

void gmp_pack_fused_tail(const int8_t* sp, int8_t* dst, int n_streams, int t,
                         int l, int64_t dst_stream_stride) {
  gmp_pack_fused_tail_nch(sp, dst, n_streams, t, l, dst_stream_stride, 2);
}

// Whole-file header-only index scan (mirrors decoder.py
// _ensure_frame_starts_and_length). Fills starts[cap]; returns frame count
// (may exceed cap — call again with a bigger buffer), and outputs
// bytes_per_frame and sample_rate of the stream.
int64_t gmp_index(const uint8_t* data, int64_t len, int64_t* starts,
                  int64_t cap, int32_t* bytes_per_frame,
                  int32_t* sample_rate) {
  Parser p(data, len);
  int64_t count = 0;
  *bytes_per_frame = 0;
  *sample_rate = 0;
  for (;;) {
    gomp3::Header h;
    gomp3::Status st = p.read_header(&h);
    if (st != gomp3::OK) break;
    if (starts && count < cap) starts[count] = p.pos - 4;
    count++;
    *bytes_per_frame = 576 * h.granules() * 4;
    if (*sample_rate == 0) *sample_rate = h.sample_rate();
    int64_t skip = h.frame_size() - 4;
    if (skip < 0) break;
    p.pos += skip;
    if (p.pos > p.len) break;
  }
  return count;
}

}  // extern "C"
