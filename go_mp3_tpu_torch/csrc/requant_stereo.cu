// K1: unpack + requantize + MS/intensity stereo, one granule per block.
//
// Replaces: the XLA program of _requantize, _stereo and the loads in front
// of them in go_mp3_tpu/ops/granule.py (:242-358): the packed unpacks
// (batch_from_packed / batch_from_packed8, :560-608) and the GranuleBatch
// that decode_chunk_impl takes as it is (:77-93, :493). Plain version:
// requant_stereo_ref in go_mp3_tpu_torch/ops/granule.py.
//
// What bounds it on an H100: memory. Per granule it reads 1,152 spectral
// values (2,624 bytes on the int8 interface, 2,592 on int16, 2,867 as a
// GranuleBatch) and writes 4,608 bytes of f32, for ~2 exp2f/log2f per line;
// the card moves bytes far slower than it does that arithmetic.
//
// Design: one block of 576 threads per granule, thread = line, both
// channels in one thread (MS and intensity stereo mix the channels of a
// line). The block first loads the granule's side words into shared memory
// and turns them into per-band values there: the requantize exponents (22
// long + 39 short per channel) and the intensity multipliers as deltas
// from 1. Each line then reads its band through the per-line band maps
// (global memory, one coalesced byte per thread) -- the index the TPU chain
// built as one-hot matmuls. Only the load differs between the three input
// layouts (template parameter): the int16 side words, the int8 interface's
// byte side words, or the GranuleBatch's 13 side fields, each read in its
// own dtype and assembled into the same side words; spectra are read
// straight from the arrays the caller holds (int8 tail + int16 head, or
// int16), so no unpacked copy exists. Output stores are coalesced along the
// line axis. exp2f/log2f are the accurate ones: the build has no
// --use_fast_math. The block also writes the granule's ginfo word (block
// types, classes, mono), which K2 and K3 read instead of the side words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kLines = 576;
constexpr int kHead = 64;               // per-channel int16 head lines
constexpr int kTail = kLines - kHead;   // per-channel int8 tail lines
constexpr int kSideWords = 144;
constexpr int kSide8 = 168;
constexpr int kFlagThread = 160;  // first thread of the warp after the side words

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
};
constexpr int kMaxInputs = 14;
struct Inputs {
  const void* p[kMaxInputs];
};

__device__ __forceinline__ int i32_at(const void* p, size_t i) {
  return static_cast<const int32_t*>(p)[i];
}
__device__ __forceinline__ int flag_at(const void* p, int g) {
  return static_cast<const uint8_t*>(p)[g] != 0;
}

__constant__ float c_pretab[22];
__constant__ float c_is_l[7];
__constant__ float c_is_r[7];
__constant__ int c_long_start[6][22];
__constant__ int c_short_start3[6][13];
__device__ uint8_t g_long_sfb[6][kLines];   // line -> long band
__device__ uint8_t g_req_short[6][kLines];  // line -> sfb*3+win (requantize)
__device__ uint8_t g_is_short[6][kLines];   // line -> sfb*3+win (intensity)

template <int kLayout>
__global__ void __launch_bounds__(kLines)
requant_stereo_kernel(const Inputs in, float* __restrict__ out,
                      int32_t* __restrict__ ginfo, int stereo) {
  const int g = blockIdx.x;   // granule: stream * T + t
  const int l = threadIdx.x;  // line
  __shared__ int side[kSideWords];
  __shared__ float a_long[2][22];
  __shared__ float a_short[2][39];
  __shared__ float d_long[2][22];   // intensity multiplier - 1, [left/right]
  __shared__ float d_short[2][39];

  if (kLayout == kInt8) {
    const uint8_t* s8 = static_cast<const uint8_t*>(in.p[2]) + (size_t)g * kSide8;
    if (l < 22) side[l] = s8[2 * l] | (s8[2 * l + 1] << 8);
    else if (l < kSideWords) side[l] = s8[44 + l - 22];
  } else if (kLayout == kInt16) {
    const int16_t* s16 = static_cast<const int16_t*>(in.p[1]) + (size_t)g * kSideWords;
    if (l < kSideWords) side[l] = s16[l];
  } else {
    // the side words of native/lib.py (SIDE_* / META_*), each from its
    // field. Each thread picks its source first and loads after the branches
    // have merged: one load instruction per warp, so a warp waits on memory
    // once (a load in each branch would wait once per branch taken).
    const size_t g2 = (size_t)g * 2;
    const void* src = nullptr;  // null: a word the DSP does not read (3, 20, 21)
    size_t i = 0;
    if (l == 0) src = in.p[9], i = g;
    else if (l == 2) src = in.p[12], i = g;
    else if (l < 4) {}
    else if (l < 6) src = in.p[3], i = g2 + l - 4;
    else if (l < 8) src = in.p[4], i = g2 + l - 6;
    else if (l < 10) src = in.p[5], i = g2 + l - 8;
    else if (l < 12) src = in.p[7], i = g2 + l - 10;
    else if (l < 14) src = in.p[8], i = g2 + l - 12;
    else if (l < 20) src = in.p[6], i = (size_t)g * 6 + l - 14;
    else if (l < 22) {}
    else if (l < 66) src = in.p[1], i = (size_t)g * 44 + l - 22;
    else if (l < kSideWords) src = in.p[2], i = (size_t)g * 78 + l - 66;
    if (l < kSideWords && l != 1) side[l] = src ? i32_at(src, i) : 0;
    // word 1, the flags, from a warp that loads nothing else
    if (l == kFlagThread)
      side[1] = flag_at(in.p[10], g) | flag_at(in.p[11], g) << 1 | flag_at(in.p[13], g) << 2;
  }
  __syncthreads();

  const int v = min(max(side[0], 0), 5);
  const int flags = side[1];
  const bool mono = flags & 4;
  const int cls0 = side[12];
  if (l < 44) {
    const int c = l / 22, k = l % 22;
    const float sf_mult = side[6 + c] != 0 ? 1.0f : 0.5f;
    const float gain = 0.25f * ((float)side[4 + c] - 210.0f);
    a_long[c][k] = -(sf_mult * ((float)side[22 + 22 * c + k] +
                                (float)side[8 + c] * c_pretab[k])) + gain;
  } else if (l < 122) {
    const int c = (l - 44) / 39, k = (l - 44) % 39;
    const float sf_mult = side[6 + c] != 0 ? 1.0f : 0.5f;
    const float gain = 0.25f * ((float)side[4 + c] - 210.0f);
    a_short[c][k] = -(sf_mult * (float)side[66 + 39 * c + k]) + gain -
                    2.0f * (float)side[14 + 3 * c + k % 3];
  } else if (l < 166) {
    // long intensity bands (channel 0's geometry): 0..20 long, 0..7 mixed
    const int c = (l - 122) / 22, k = (l - 122) % 22;
    const int is_pos = side[22 + k];
    const int cap = cls0 == 0 ? 20 : (cls0 == 2 ? 7 : -1);
    const bool apply = (flags & 2) && !mono && c_long_start[v][k] >= side[2] &&
                       k <= cap && is_pos < 7;
    const int ip = max(is_pos, 0);
    d_long[c][k] = (apply ? (c == 0 ? c_is_l[ip] : c_is_r[ip]) : 1.0f) - 1.0f;
  } else if (l < 244) {
    // short intensity bands: 0..11 short, 3..11 mixed
    const int c = (l - 166) / 39, k = (l - 166) % 39, sfb = k / 3;
    const int is_pos = side[66 + k];
    const int lo = cls0 == 1 ? 0 : (cls0 == 2 ? 3 : 13);
    const bool apply = (flags & 2) && !mono &&
                       c_short_start3[v][sfb] >= side[2] && sfb >= lo &&
                       sfb <= 11 && is_pos < 7;
    const int ip = max(is_pos, 0);
    d_short[c][k] = (apply ? (c == 0 ? c_is_l[ip] : c_is_r[ip]) : 1.0f) - 1.0f;
  } else if (l == 244) {
    ginfo[g] = (side[10] & 3) | (side[11] & 3) << 2 | (side[12] & 3) << 4 |
               (side[13] & 3) << 6 | (mono ? 1 << 8 : 0);
  }
  __syncthreads();

  const int lsfb = g_long_sfb[v][l];
  const int ssfb = g_req_short[v][l];
  float x[2];
#pragma unroll
  for (int c = 0; c < 2; c++) {
    int q;
    if (kLayout == kInt8) {
      q = l < kHead
              ? static_cast<const int16_t*>(in.p[1])[(size_t)g * 2 * kHead + c * kHead + l]
              : static_cast<const int8_t*>(in.p[0])[(size_t)g * 2 * kTail + c * kTail + l - kHead];
    } else {  // int16 spectra [n][2][576], in both other layouts
      q = static_cast<const int16_t*>(in.p[0])[(size_t)g * 2 * kLines + c * kLines + l];
    }
    const int cls = side[12 + c];
    const bool is_long = cls == 0 || (cls == 2 && l < 36);
    const float a = is_long ? a_long[c][lsfb] : a_short[c][ssfb];
    // |x|^(4/3) * 2^a; q == 0 gives log2f(0) = -inf and exp2f(-inf) = 0
    const float mag = exp2f(a + (4.0f / 3.0f) * log2f(fabsf((float)q)));
    x[c] = (q > 0 ? 1.0f : (q < 0 ? -1.0f : 0.0f)) * mag;
  }
  if (stereo) {
    if ((flags & 1) && !mono) {
      const float inv_sqrt2 = 0.70710677f;
      const float l0 = x[0], r0 = x[1];
      x[0] = (l0 + r0) * inv_sqrt2;
      x[1] = (l0 - r0) * inv_sqrt2;
    }
    const int isfb = g_is_short[v][l];
#pragma unroll
    for (int c = 0; c < 2; c++)
      x[c] *= (1.0f + d_long[c][lsfb]) * (1.0f + d_short[c][isfb]);
  }
  out[((size_t)g * 2 + 0) * kLines + l] = x[0];
  out[((size_t)g * 2 + 1) * kLines + l] = x[1];
}

}  // namespace

extern "C" {

// Upload the band tables to `device` (once per device before the first
// launch). Host arrays: pretab f32[22], is_l/is_r f32[7], long_start
// i32[6][22], short_start3 i32[6][13], three u8[6][576] per-line maps.
int gomp3_requant_stereo_init(int device, const float* pretab, const float* is_l,
                              const float* is_r, const int32_t* long_start,
                              const int32_t* short_start3, const uint8_t* long_sfb,
                              const uint8_t* req_short, const uint8_t* is_short) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaMemcpyToSymbol(c_pretab, pretab, sizeof(float) * 22);
  cudaMemcpyToSymbol(c_is_l, is_l, sizeof(float) * 7);
  cudaMemcpyToSymbol(c_is_r, is_r, sizeof(float) * 7);
  cudaMemcpyToSymbol(c_long_start, long_start, sizeof(int32_t) * 6 * 22);
  cudaMemcpyToSymbol(c_short_start3, short_start3, sizeof(int32_t) * 6 * 13);
  cudaMemcpyToSymbol(g_long_sfb, long_sfb, 6 * kLines);
  cudaMemcpyToSymbol(g_req_short, req_short, 6 * kLines);
  cudaMemcpyToSymbol(g_is_short, is_short, 6 * kLines);
  return (int)cudaGetLastError();
}

// layout: a Layout; inputs: host array of the layout's device pointers
// (2, 3 or 14, in the order above). out f32 [n][2][576], ginfo i32 [n];
// n = S * T granules.
int gomp3_requant_stereo(int device, int layout, const void* const* inputs,
                         float* out, int32_t* ginfo, int n_granules, int stereo,
                         void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int count = layout == kInt16 ? 2 : layout == kInt8 ? 3 : layout == kBatch ? kMaxInputs : 0;
  if (count == 0) return (int)cudaErrorInvalidValue;
  if (n_granules > 0) {
    Inputs in = {};
    for (int i = 0; i < count; i++) in.p[i] = inputs[i];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (layout == kInt16)
      requant_stereo_kernel<kInt16><<<n_granules, kLines, 0, s>>>(in, out, ginfo, stereo);
    else if (layout == kInt8)
      requant_stereo_kernel<kInt8><<<n_granules, kLines, 0, s>>>(in, out, ginfo, stereo);
    else
      requant_stereo_kernel<kBatch><<<n_granules, kLines, 0, s>>>(in, out, ginfo, stereo);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
