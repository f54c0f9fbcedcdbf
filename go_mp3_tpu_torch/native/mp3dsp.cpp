// Exact-arithmetic granule DSP in C++ — the framework's bit-exact mode and
// CPU fallback path.
//
// Replicates the reference DSP's float32 operation order exactly
// (frame.go:121-688): float64 requantization products cast to f32,
// sequential f32 accumulation in the IMDCT and the polyphase synthesis,
// truncating int16 conversion. Consumes the native parser's granule records
// (post-reorder spectra; requantization is per-line multiplicative, so
// requantize/reorder commute bit-exactly with the permutation-composed band
// maps used here).
//
// Compiled into libmp3parse.so next to the parser (native/lib.py).

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__SSE2__) || defined(_M_X64)
#include <emmintrin.h>
#define GOMP3_DSP_SSE2 1
#endif

namespace gomp3 {

constexpr int kSamplesPerGr = 576;

// meta layout (must match mp3parse.cpp / native/lib.py)
enum {
  M_VARIANT = 0,
  M_FLAGS = 1,
  M_COUNT1_R = 2,
  M_GG = 4,
  M_SFSCALE = 6,
  M_PREFLAG = 8,
  M_BLOCKTYPE = 10,
  M_CLASS = 12,
  M_SBG = 14,
  M_COUNT1 = 20,
  M_WIDTH = 24,
};
enum { CLS_LONG = 0, CLS_SHORT = 1, CLS_MIXED = 2 };

extern const int kBandLong2[2][3][23];
extern const int kBandShort2[2][3][14];

// duplicated from mp3parse.cpp tables (kept in one TU each for simplicity)
const int kBandLong2[2][3][23] = {
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
const int kBandShort2[2][3][14] = {
    {{0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192},
     {0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192},
     {0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192}},
    {{0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192},
     {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192},
     {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192}},
};

// ---------------------------------------------------------------------------
// Init-time tables (same construction as the reference init()s)
// ---------------------------------------------------------------------------

struct DspTables {
  double pow43[8207];
  // exp2 of quarter-integers: every requantize exponent is an exact
  // multiple of 0.25 in a bounded range, so exp2q[k+400] == std::exp2(k/4)
  // bit-for-bit (same library call on the same input, made at init)
  double exp2q[501];
  double pretab[22] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                       1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0};
  float is_ratio_l[7], is_ratio_r[7];
  float cs[8], ca[8];
  float imdct_win[4][36];
  float cos_n12[6][12];
  float cos_n36[18][36];
  float synth_nwin[64][32];
  float synth_nwin_t[32][64];  // transposed copy for the vectorized matrixing
  float synth_dtbl[512];
  // per (lsf, sfreq): composed requantize band maps over post-reorder layout
  int16_t req_long_sfb[2][3][kSamplesPerGr];
  int16_t req_short_sfb[2][3][kSamplesPerGr];
  int16_t req_short_win[2][3][kSamplesPerGr];
  // intensity maps (win-major positions over reordered data)
  int16_t is_short_sfb[2][3][kSamplesPerGr];
  int16_t is_short_win[2][3][kSamplesPerGr];

  DspTables();
};

extern const int32_t kSynthDNumerators[512];

DspTables::DspTables() {
  for (int i = 0; i < 8207; i++) pow43[i] = std::pow(double(i), 4.0 / 3.0);
  for (int k = -400; k <= 100; k++) exp2q[k + 400] = std::exp2(k * 0.25);
  static const float isr[6] = {0.000000f, 0.267949f, 0.577350f,
                               1.000000f, 1.732051f, 3.732051f};
  for (int k = 0; k < 6; k++) {
    is_ratio_l[k] = isr[k] / (1.0f + isr[k]);
    is_ratio_r[k] = 1.0f / (1.0f + isr[k]);
  }
  is_ratio_l[6] = 1.0f;
  is_ratio_r[6] = 0.0f;
  static const float cs_[8] = {0.857493f, 0.881742f, 0.949629f, 0.983315f,
                               0.995518f, 0.999161f, 0.999899f, 0.999993f};
  static const float ca_[8] = {-0.514496f, -0.471732f, -0.313377f, -0.181913f,
                               -0.094574f, -0.040966f, -0.014199f, -0.003700f};
  memcpy(cs, cs_, sizeof(cs));
  memcpy(ca, ca_, sizeof(ca));

  const double pi = 3.14159265358979323846;
  for (int i = 0; i < 36; i++)
    imdct_win[0][i] = float(std::sin(pi / 36 * (i + 0.5)));
  for (int i = 0; i < 18; i++)
    imdct_win[1][i] = float(std::sin(pi / 36 * (i + 0.5)));
  for (int i = 18; i < 24; i++) imdct_win[1][i] = 1.0f;
  for (int i = 24; i < 30; i++)
    imdct_win[1][i] = float(std::sin(pi / 12 * (i + 0.5 - 18.0)));
  for (int i = 30; i < 36; i++) imdct_win[1][i] = 0.0f;
  for (int i = 0; i < 12; i++)
    imdct_win[2][i] = float(std::sin(pi / 12 * (i + 0.5)));
  for (int i = 12; i < 36; i++) imdct_win[2][i] = 0.0f;
  for (int i = 0; i < 6; i++) imdct_win[3][i] = 0.0f;
  for (int i = 6; i < 12; i++)
    imdct_win[3][i] = float(std::sin(pi / 12 * (i + 0.5 - 6.0)));
  for (int i = 12; i < 18; i++) imdct_win[3][i] = 1.0f;
  for (int i = 18; i < 36; i++)
    imdct_win[3][i] = float(std::sin(pi / 36 * (i + 0.5)));

  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 12; j++)
      cos_n12[i][j] = float(std::cos(pi / 24 * (2 * j + 1 + 6) * (2 * i + 1)));
  for (int i = 0; i < 18; i++)
    for (int j = 0; j < 36; j++)
      cos_n36[i][j] = float(std::cos(pi / 72 * (2 * j + 1 + 18) * (2 * i + 1)));
  for (int i = 0; i < 64; i++)
    for (int j = 0; j < 32; j++)
      synth_nwin[i][j] = float(std::cos(double((16 + i) * (2 * j + 1)) * (pi / 64.0)));
  for (int i = 0; i < 64; i++)
    for (int j = 0; j < 32; j++) synth_nwin_t[j][i] = synth_nwin[i][j];
  for (int i = 0; i < 512; i++)
    synth_dtbl[i] = float(double(kSynthDNumerators[i]) / 65536.0);

  // band maps composed with the short-block reorder permutation
  for (int lsf = 0; lsf < 2; lsf++)
    for (int sf = 0; sf < 3; sf++) {
      const int* lb = kBandLong2[lsf][sf];
      const int* sb = kBandShort2[lsf][sf];
      int16_t sfb_of[kSamplesPerGr], win_of[kSamplesPerGr];
      int16_t perm[kSamplesPerGr];
      for (int b = 0; b < 22; b++)
        for (int l = lb[b]; l < lb[b + 1]; l++)
          req_long_sfb[lsf][sf][l] = int16_t(b);
      for (int b = 0; b < 13; b++) {
        int start3 = 3 * sb[b];
        int wl = sb[b + 1] - sb[b];
        for (int w = 0; w < 3; w++)
          for (int j = 0; j < wl; j++) {
            int l = start3 + w * wl + j;
            sfb_of[l] = int16_t(b);
            win_of[l] = int16_t(w);
            perm[start3 + j * 3 + w] = int16_t(l);
          }
      }
      for (int l = 0; l < kSamplesPerGr; l++) {
        req_short_sfb[lsf][sf][l] = sfb_of[perm[l]];
        req_short_win[lsf][sf][l] = win_of[perm[l]];
        is_short_sfb[lsf][sf][l] = sfb_of[l];
        is_short_win[lsf][sf][l] = win_of[l];
      }
    }
}

static const DspTables& tables() {
  static DspTables t;
  return t;
}

// ---------------------------------------------------------------------------
// Per-stream DSP state
// ---------------------------------------------------------------------------

struct DspState {
  float store[2][32][18] = {};
  float v_vec[2][1024] = {};
};

// ---------------------------------------------------------------------------
// Granule chain (float32 discipline identical to the reference)
// ---------------------------------------------------------------------------

static inline double exp2_quarter(const DspTables& t, double e) {
  double q = e * 4.0;
  int k = int(q);
  if (double(k) == q && k >= -400 && k <= 100) return t.exp2q[k + 400];
  return std::exp2(e);  // out-of-range/non-quarter safety net
}

static void requantize(const int16_t* spectra, const int32_t* sfl,
                       const int32_t* sfs, const int32_t* meta, int ch,
                       int lsf, int sfreq, float* out) {
  const DspTables& t = tables();
  int cls = meta[M_CLASS + ch];
  double sf_mult = meta[M_SFSCALE + ch] != 0 ? 1.0 : 0.5;
  double gg = 0.25 * (double(meta[M_GG + ch]) - 210.0);
  double pre = double(meta[M_PREFLAG + ch]);
  const int16_t* lsfb = t.req_long_sfb[lsf][sfreq];
  const int16_t* ssfb = t.req_short_sfb[lsf][sfreq];
  const int16_t* swin = t.req_short_win[lsf][sfreq];

  // exp2(idx) depends only on the band (and window), not the line: hoist
  // the ~460 per-line exp2 calls to <=61 per-band ones. Identical doubles,
  // identical products — bit-exact with the per-line form.
  double t1l[22], t1s[39];
  for (int b = 0; b < 22; b++)
    t1l[b] = exp2_quarter(
        t, -(sf_mult * (double(sfl[ch * 22 + b]) + pre * t.pretab[b])) + gg);
  for (int b = 0; b < 13; b++)
    for (int w = 0; w < 3; w++)
      t1s[b * 3 + w] = exp2_quarter(
          t, -(sf_mult * double(sfs[ch * 39 + b * 3 + w])) + gg -
                 0.25 * 8.0 * double(meta[M_SBG + ch * 3 + w]));

  // branchless over zero lines (~60% of a typical granule — a data-
  // dependent branch mispredicts constantly): pow43[0] == 0, and tmp1 is
  // always finite/positive (quarter-exponents are bounded), so the
  // multiply yields exactly the 0.0f the early-out produced.
  for (int l = 0; l < kSamplesPerGr; l++) {
    int32_t raw = spectra[l];
    bool is_long = cls == CLS_LONG || (cls == CLS_MIXED && l < 36);
    double tmp1 =
        is_long ? t1l[lsfb[l]] : t1s[ssfb[l] * 3 + swin[l]];
    double tmp2 = raw < 0 ? -t.pow43[-raw] : t.pow43[raw];
    out[l] = float(tmp1 * tmp2);
  }
}

static void stereo(float* left, float* right, const int32_t* sfl,
                   const int32_t* sfs, const int32_t* meta, int lsf,
                   int sfreq) {
  const DspTables& t = tables();
  int flags = meta[M_FLAGS];
  bool ms = flags & 1, intensity = flags & 2;
  if (ms) {
    const float inv_sqrt2 = float(1.4142135623730951 / 2.0);
    for (int l = 0; l < kSamplesPerGr; l++) {
      float nl = (left[l] + right[l]) * inv_sqrt2;
      float nr = (left[l] - right[l]) * inv_sqrt2;
      left[l] = nl;
      right[l] = nr;
    }
  }
  if (!intensity) return;
  const int* lb = kBandLong2[lsf][sfreq];
  const int* sb = kBandShort2[lsf][sfreq];
  int c1r = meta[M_COUNT1_R];
  int cls0 = meta[M_CLASS + 0];

  auto long_band = [&](int sfb) {
    int pos = sfl[0 * 22 + sfb];
    if (pos >= 7) return;
    for (int l = lb[sfb]; l < lb[sfb + 1]; l++) {
      left[l] *= t.is_ratio_l[pos];
      right[l] *= t.is_ratio_r[pos];
    }
  };
  auto short_band = [&](int sfb) {
    int wl = sb[sfb + 1] - sb[sfb];
    for (int w = 0; w < 3; w++) {
      int pos = sfs[0 * 39 + sfb * 3 + w];
      if (pos >= 7) continue;
      int lo = sb[sfb] * 3 + wl * w;
      for (int l = lo; l < lo + wl; l++) {
        left[l] *= t.is_ratio_l[pos];
        right[l] *= t.is_ratio_r[pos];
      }
    }
  };
  if (cls0 == CLS_SHORT) {
    for (int sfb = 0; sfb < 12; sfb++)
      if (sb[sfb] * 3 >= c1r) short_band(sfb);
  } else if (cls0 == CLS_MIXED) {
    for (int sfb = 0; sfb < 8; sfb++)
      if (lb[sfb] >= c1r) long_band(sfb);
    for (int sfb = 3; sfb < 12; sfb++)
      if (sb[sfb] * 3 >= c1r) short_band(sfb);
  } else {
    for (int sfb = 0; sfb < 21; sfb++)
      if (lb[sfb] >= c1r) long_band(sfb);
  }
}

static void antialias(float* x, int cls) {
  const DspTables& t = tables();
  if (cls == CLS_SHORT) return;
  int sblim = cls == CLS_MIXED ? 2 : 32;
  for (int sbnd = 1; sbnd < sblim; sbnd++) {
    for (int i = 0; i < 8; i++) {
      int li = 18 * sbnd - 1 - i;
      int ui = 18 * sbnd + i;
      float lb = x[li] * t.cs[i] - x[ui] * t.ca[i];
      float ub = x[ui] * t.cs[i] + x[li] * t.ca[i];
      x[li] = lb;
      x[ui] = ub;
    }
  }
}

static void imdct_win(const float* in, int bt, float* out36) {
  const DspTables& t = tables();
  memset(out36, 0, 36 * sizeof(float));
#ifdef GOMP3_DSP_SSE2
  // Vectorized ACROSS output points: each point's adds stay in the
  // reference's m-ascending order, with explicit mul-then-add (never
  // FMA-contracted) — bit-identical to the scalar loops per output.
  if (bt == 2) {
    for (int i = 0; i < 3; i++) {
      __m128 a0 = _mm_setzero_ps(), a1 = _mm_setzero_ps(),
             a2 = _mm_setzero_ps();
      for (int m = 0; m < 6; m++) {
        __m128 im = _mm_set1_ps(in[i + 3 * m]);
        const float* c = t.cos_n12[m];
        a0 = _mm_add_ps(a0, _mm_mul_ps(im, _mm_loadu_ps(c)));
        a1 = _mm_add_ps(a1, _mm_mul_ps(im, _mm_loadu_ps(c + 4)));
        a2 = _mm_add_ps(a2, _mm_mul_ps(im, _mm_loadu_ps(c + 8)));
      }
      float* o = out36 + 6 * i + 6;
      const float* w = t.imdct_win[2];
      __m128 r0 = _mm_add_ps(_mm_loadu_ps(o),
                             _mm_mul_ps(a0, _mm_loadu_ps(w)));
      __m128 r1 = _mm_add_ps(_mm_loadu_ps(o + 4),
                             _mm_mul_ps(a1, _mm_loadu_ps(w + 4)));
      __m128 r2 = _mm_add_ps(_mm_loadu_ps(o + 8),
                             _mm_mul_ps(a2, _mm_loadu_ps(w + 8)));
      _mm_storeu_ps(o, r0);
      _mm_storeu_ps(o + 4, r1);
      _mm_storeu_ps(o + 8, r2);
    }
    return;
  }
  for (int p = 0; p < 36; p += 12) {
    __m128 a0 = _mm_setzero_ps(), a1 = _mm_setzero_ps(),
           a2 = _mm_setzero_ps();
    for (int m = 0; m < 18; m++) {
      __m128 im = _mm_set1_ps(in[m]);
      const float* c = &t.cos_n36[m][p];
      a0 = _mm_add_ps(a0, _mm_mul_ps(im, _mm_loadu_ps(c)));
      a1 = _mm_add_ps(a1, _mm_mul_ps(im, _mm_loadu_ps(c + 4)));
      a2 = _mm_add_ps(a2, _mm_mul_ps(im, _mm_loadu_ps(c + 8)));
    }
    const float* w = &t.imdct_win[bt][p];
    _mm_storeu_ps(out36 + p, _mm_mul_ps(a0, _mm_loadu_ps(w)));
    _mm_storeu_ps(out36 + p + 4, _mm_mul_ps(a1, _mm_loadu_ps(w + 4)));
    _mm_storeu_ps(out36 + p + 8, _mm_mul_ps(a2, _mm_loadu_ps(w + 8)));
  }
#else
  if (bt == 2) {
    for (int i = 0; i < 3; i++) {
      for (int p = 0; p < 12; p++) {
        float sum = 0.0f;
        for (int m = 0; m < 6; m++) sum += in[i + 3 * m] * t.cos_n12[m][p];
        out36[6 * i + p + 6] += sum * t.imdct_win[2][p];
      }
    }
    return;
  }
  for (int p = 0; p < 36; p++) {
    float sum = 0.0f;
    for (int m = 0; m < 18; m++) sum += in[m] * t.cos_n36[m][p];
    out36[p] = sum * t.imdct_win[bt][p];
  }
#endif
}

static void hybrid_and_freqinv(float* x, DspState* st, int ch, int cls,
                               int bt_gr) {
  float rawout[36];
  for (int sbnd = 0; sbnd < 32; sbnd++) {
    int bt = (cls == CLS_MIXED && sbnd < 2) ? 0 : bt_gr;
    imdct_win(x + sbnd * 18, bt, rawout);
    float* blk = x + sbnd * 18;
    float* store = st->store[ch][sbnd];
    for (int i = 0; i < 18; i++) {
      blk[i] = rawout[i] + store[i];
      store[i] = rawout[i + 18];
    }
  }
  for (int sbnd = 1; sbnd < 32; sbnd += 2)
    for (int i = 1; i < 18; i += 2) x[sbnd * 18 + i] = -x[sbnd * 18 + i];
}

static void subband_synth(const float* x, DspState* st, int ch, int nch,
                          int16_t* pcm_lr /* interleaved stereo */) {
  const DspTables& t = tables();
  // Sliding scratch instead of the reference's per-step 960-float memmove
  // (~106 MB of copying per decoded file): step ss's logical v-vector is
  // the contiguous window sw[(17-ss)*64 .. +1024), new blocks are written
  // leftward, and the state round-trips once per granule. Pure data
  // movement — bit-exact by construction.
  float sw[18 * 64 + 1024];
  memcpy(sw + 18 * 64, st->v_vec[ch], 1024 * sizeof(float));
  float u[512], s[32];
  for (int ss = 0; ss < 18; ss++) {
    float* v = sw + (17 - ss) * 64;
    for (int i = 0; i < 32; i++) s[i] = x[i * 18 + ss];
#ifdef GOMP3_DSP_SSE2
    // Vectorized ACROSS outputs: each lane's adds stay in the reference's
    // j = 0..31 order, and explicit mul-then-add intrinsics can never be
    // contracted into FMA — bit-identical to the scalar loop per output.
    for (int i = 0; i < 64; i += 16) {
      __m128 v0 = _mm_setzero_ps(), v1 = _mm_setzero_ps();
      __m128 v2 = _mm_setzero_ps(), v3 = _mm_setzero_ps();
      for (int j = 0; j < 32; j++) {
        __m128 sj = _mm_set1_ps(s[j]);
        const float* w = &t.synth_nwin_t[j][i];
        v0 = _mm_add_ps(v0, _mm_mul_ps(_mm_loadu_ps(w), sj));
        v1 = _mm_add_ps(v1, _mm_mul_ps(_mm_loadu_ps(w + 4), sj));
        v2 = _mm_add_ps(v2, _mm_mul_ps(_mm_loadu_ps(w + 8), sj));
        v3 = _mm_add_ps(v3, _mm_mul_ps(_mm_loadu_ps(w + 12), sj));
      }
      _mm_storeu_ps(v + i, v0);
      _mm_storeu_ps(v + i + 4, v1);
      _mm_storeu_ps(v + i + 8, v2);
      _mm_storeu_ps(v + i + 12, v3);
    }
#else
    for (int i = 0; i < 64; i++) {
      float sum = 0.0f;
      for (int j = 0; j < 32; j++) sum += t.synth_nwin[i][j] * s[j];
      v[i] = sum;
    }
#endif
    for (int i = 0; i < 512; i += 64) {
      memcpy(u + i, v + (i << 1), 32 * sizeof(float));
      memcpy(u + i + 32, v + (i << 1) + 96, 32 * sizeof(float));
    }
    for (int i = 0; i < 512; i++) u[i] *= t.synth_dtbl[i];
#ifdef GOMP3_DSP_SSE2
    // 16-tap window sums, vectorized across the 32 outputs (per-output add
    // order preserved: j ascending, exactly as the scalar loop)
    float sums[32];
    for (int i = 0; i < 32; i += 4) {
      __m128 acc = _mm_setzero_ps();
      for (int j = 0; j < 512; j += 32)
        acc = _mm_add_ps(acc, _mm_loadu_ps(u + j + i));
      _mm_storeu_ps(sums + i, acc);
    }
    for (int i = 0; i < 32; i++) {
      int samp = int(sums[i] * 32767.0f);
#else
    for (int i = 0; i < 32; i++) {
      float sum = 0.0f;
      for (int j = 0; j < 512; j += 32) sum += u[j + i];
      int samp = int(sum * 32767.0f);
#endif
      if (samp > 32767) samp = 32767;
      if (samp < -32767) samp = -32767;
      int16_t sv = int16_t(samp);
      int idx = 2 * (32 * ss + i);
      if (nch == 1) {
        pcm_lr[idx] = sv;
        pcm_lr[idx + 1] = sv;
      } else {
        pcm_lr[idx + ch] = sv;
      }
    }
  }
  memcpy(st->v_vec[ch], sw, 1024 * sizeof(float));
}

}  // namespace gomp3

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

using namespace gomp3;

void* gmp_dsp_create() { return new DspState(); }
void gmp_dsp_destroy(void* s) { delete static_cast<DspState*>(s); }
void gmp_dsp_reset(void* s) { *static_cast<DspState*>(s) = DspState(); }

// Checkpoint/resume: expose the DSP state (store [2*32*18] f32 and the
// polyphase vVec [2*1024] f32) for sample-exact decode resumption.
void gmp_dsp_get_state(void* sv, float* store, float* vvec) {
  DspState* st = static_cast<DspState*>(sv);
  memcpy(store, st->store, sizeof(st->store));
  memcpy(vvec, st->v_vec, sizeof(st->v_vec));
}
void gmp_dsp_set_state(void* sv, const float* store, const float* vvec) {
  DspState* st = static_cast<DspState*>(sv);
  memcpy(st->store, store, sizeof(st->store));
  memcpy(st->v_vec, vvec, sizeof(st->v_vec));
}

// Decode `n` granule records (from gmp_parse) to interleaved s16le stereo
// PCM. pcm must hold n*576*2 int16.
void gmp_dsp_decode(void* sv, int n, const int16_t* spectra,
                    const int32_t* sfl, const int32_t* sfs,
                    const int32_t* meta, int16_t* pcm) {
  DspState* st = static_cast<DspState*>(sv);
  float x[2][kSamplesPerGr];
  for (int g = 0; g < n; g++) {
    const int16_t* sp = spectra + g * 2 * kSamplesPerGr;
    const int32_t* fl = sfl + g * 2 * 22;
    const int32_t* fs = sfs + g * 2 * 39;
    const int32_t* mg = meta + g * M_WIDTH;
    int16_t* out = pcm + g * kSamplesPerGr * 2;
    int variant = mg[M_VARIANT];
    int lsf = variant / 3, sfreq = variant % 3;
    bool mono = mg[M_FLAGS] & 4;
    int nch = mono ? 1 : 2;

    for (int ch = 0; ch < nch; ch++)
      requantize(sp + ch * kSamplesPerGr, fl, fs, mg, ch, lsf, sfreq, x[ch]);
    if (nch == 2) stereo(x[0], x[1], fl, fs, mg, lsf, sfreq);
    for (int ch = 0; ch < nch; ch++) {
      antialias(x[ch], mg[M_CLASS + ch]);
      hybrid_and_freqinv(x[ch], st, ch, mg[M_CLASS + ch],
                         mg[M_BLOCKTYPE + ch]);
      subband_synth(x[ch], st, ch, nch, out);
    }
  }
}

}  // extern "C"
