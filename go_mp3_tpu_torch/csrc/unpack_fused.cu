// K4: the fused one-buffer chunk wire -> the three packed8 arrays K1 reads.
//
// Replaces: the XLA programs of unpack_fused and unpack_fused_mono in
// go_mp3_tpu/ops/granule.py (:661-683, :696-723). Plain version:
// unpack_fused_ref / unpack_fused_mono_ref in go_mp3_tpu_torch/ops/granule.py.
// Host builder of the wire: go_mp3_tpu_torch/ops/wire.py.
//
// Input, one row per stream (row_bytes apart), nch = 2 (stereo) or 1 (mono):
//   tail  int8 [nch][L][T], channel-major and line-major;
//   head  [T][nch * 64] int16 values as little-endian byte pairs;
//   side  [T][168] bytes.
// Output: tail8 i8 [S][T][1024] (per-channel tail lines, zero for lines >= L
// and for all of channel 1 on a mono row), head16 i16 [S][T][128] (channel 1
// zero on a mono row), side8 u8 [S][T][168].
//
// What bounds it on an H100: memory. Nothing is computed; at S = 64, T = 240,
// L = 512 a stereo chunk is ~22 MB in and ~24 MB out.
//
// Design: two kernels.
//  1. tail_kernel: the [L, T] -> [T, 512] byte transpose per (stream,
//     channel), through a 32 x 32 byte tile in shared memory padded to 33
//     columns, so that a warp reads 32 neighbouring granules of one line and
//     writes 32 neighbouring lines of one granule: both coalesced. Tiles past
//     L, and channel 1 of a mono row, write zeros without reading: the
//     outputs come from torch.empty, so every byte is written here.
//  2. head_side_kernel: one block per granule assembles each head value from
//     its two bytes and sign-extends it (a mono row is odd-sized when L and T
//     are both odd, so the head region can start at an odd address and is
//     never read as int16), and copies the sidecar bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kTail = 512;   // per-channel tail lines
constexpr int kHead = 64;    // per-channel head lines
constexpr int kSide8 = 168;
constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // block = 32 x 8 threads

__global__ void __launch_bounds__(kTile * kRowsPerPass)
tail_kernel(const uint8_t* __restrict__ buf, int8_t* __restrict__ tail8, int T,
            int L, int nch, size_t row_bytes) {
  __shared__ uint8_t tile[kTile][kTile + 1];  // [line][granule]
  const int s = blockIdx.z >> 1, c = blockIdx.z & 1;
  const int t0 = blockIdx.x * kTile, l0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool load = c < nch && l0 < L;
  if (load) {
    const uint8_t* src = buf + (size_t)s * row_bytes + (size_t)c * L * T;
    for (int i = ty; i < kTile; i += kRowsPerPass) {
      const int l = l0 + i, t = t0 + tx;
      tile[i][tx] = (l < L && t < T) ? src[(size_t)l * T + t] : 0;
    }
    __syncthreads();
  }
  for (int i = ty; i < kTile; i += kRowsPerPass) {
    const int t = t0 + i, l = l0 + tx;
    if (t < T)
      tail8[((size_t)s * T + t) * (2 * kTail) + c * kTail + l] =
          load ? (int8_t)tile[tx][i] : 0;
  }
}

__global__ void __launch_bounds__(256)
head_side_kernel(const uint8_t* __restrict__ buf, int16_t* __restrict__ head16,
                 uint8_t* __restrict__ side8, int T, int L, int nch,
                 size_t row_bytes) {
  const int g = blockIdx.x;  // stream * T + t
  const int s = g / T, t = g % T;
  const int head_w = nch * kHead;  // head values shipped per granule
  const uint8_t* row = buf + (size_t)s * row_bytes;
  const uint8_t* hb = row + (size_t)nch * L * T + (size_t)t * head_w * 2;
  const uint8_t* sb = row + (size_t)nch * L * T + (size_t)T * head_w * 2 +
                      (size_t)t * kSide8;
  for (int i = threadIdx.x; i < 2 * kHead + kSide8; i += blockDim.x) {
    if (i < 2 * kHead) {
      int16_t v = 0;
      if (i < head_w) v = (int16_t)(uint16_t)(hb[2 * i] | (hb[2 * i + 1] << 8));
      head16[(size_t)g * 2 * kHead + i] = v;
    } else {
      const int k = i - 2 * kHead;
      side8[(size_t)g * kSide8 + k] = sb[k];
    }
  }
}

}  // namespace

extern "C" {

// buf u8 [S][row_bytes] with row_bytes = nch*L*T + T*nch*64*2 + T*168
// -> tail8 i8 [S][T][1024], head16 i16 [S][T][128], side8 u8 [S][T][168].
// 0 <= L <= 512, nch in {1, 2}. S == 0 or T == 0 launches nothing.
int gomp3_unpack_fused(int device, const uint8_t* buf, int8_t* tail8,
                       int16_t* head16, uint8_t* side8, int S, int T, int L,
                       int nch, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (S <= 0 || T <= 0) return (int)cudaGetLastError();
  if (L < 0 || L > kTail || (nch != 1 && nch != 2) || 2 * S > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)nch * L * T + (size_t)T * nch * kHead * 2 +
                           (size_t)T * kSide8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((T + kTile - 1) / kTile, kTail / kTile, 2 * S);
  tail_kernel<<<grid, dim3(kTile, kRowsPerPass), 0, st>>>(buf, tail8, T, L, nch,
                                                          row_bytes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_side_kernel<<<S * T, 256, 0, st>>>(buf, head16, side8, T, L, nch, row_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
