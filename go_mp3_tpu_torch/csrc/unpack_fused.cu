// K4: the fused one-buffer chunk wire -> the three packed8 arrays of K1's
// int8 interface, in one launch.
//
// Replaces: the XLA programs of unpack_fused and unpack_fused_mono in
// go_mp3_tpu/ops/granule.py (:661-683, :696-723). Plain version:
// unpack_fused_ref / unpack_fused_mono_ref in go_mp3_tpu_torch/ops/granule.py.
// Host builder of the wire: go_mp3_tpu_torch/ops/wire.py; layout:
// fused_tile.cuh. The corpus path no longer runs it: K1 reads the wire
// itself (requant_stereo.cu, fused layout). It stays as the counterpart of
// the public unpack_fused.
//
// Output: tail8 i8 [S][T][1024] (per-channel tail lines, zero for lines >= L
// and for all of channel 1 on a mono row), head16 i16 [S][T][128] (channel 1
// zero on a mono row), side8 u8 [S][T][168].
//
// What bounds it on an H100: memory. Nothing is computed; at S = 64, T = 240,
// L = 512 a stereo chunk is 22.2 MB in and 22.2 MB out: 44.5 MB, 0.0133 ms.
//
// Design: a block per tile of kTile consecutive granules of one stream. The
// tail goes through fused_tile.cuh's loader (4 lines x 4 granules a
// thread, 4-byte loads, transposed with __byte_perm into shared memory) and
// leaves as the tile's contiguous tail8 rows in 16-byte stores. The head
// and the sidecar need no transpose: a stereo tile's head pairs are its
// head16 rows byte for byte, a mono tile's are their first halves, and its
// sidecar bytes are its side8 rows; each is copied in the widest words
// that the two addresses and the length allow (16, 8, 4, 2 or 1 bytes: a
// mono row is odd-sized when L and T are both odd, so its head can start
// at an odd address). Every output byte is written: the outputs come from
// torch.empty.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "fused_tile.cuh"

namespace {

using gomp3::kHeadLines;
using gomp3::kSide8;
using gomp3::kTailLines;
using gomp3::kTailWords;

constexpr int kThreads = 256;
constexpr int kTile = 16;  // granules a block: the fastest of 4, 8 and 16
                           // at S = 64, T = 240 on an H100

// `rows` rows of n bytes, src and dst rows spitch and dpitch bytes apart
// (device memory), copied by the whole block in words of W
template <typename W>
__device__ __forceinline__ void copy_rows_as(uint8_t* dst, size_t dpitch,
                                             const uint8_t* src, size_t spitch,
                                             int rows, size_t n, int tid) {
  const size_t per_row = n / sizeof(W);
  for (size_t i = tid; i < rows * per_row; i += kThreads) {
    const size_t r = i / per_row, k = i % per_row;
    reinterpret_cast<W*>(dst + r * dpitch)[k] =
        reinterpret_cast<const W*>(src + r * spitch)[k];
  }
}

// the same in the widest words that the addresses, pitches and n allow
__device__ __forceinline__ void copy_rows(uint8_t* dst, size_t dpitch,
                                          const uint8_t* src, size_t spitch,
                                          int rows, size_t n, int tid) {
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src | dpitch | spitch | n;
  if (!(a & 15)) copy_rows_as<uint4>(dst, dpitch, src, spitch, rows, n, tid);
  else if (!(a & 7)) copy_rows_as<uint2>(dst, dpitch, src, spitch, rows, n, tid);
  else if (!(a & 3)) copy_rows_as<uint32_t>(dst, dpitch, src, spitch, rows, n, tid);
  else if (!(a & 1)) copy_rows_as<uint16_t>(dst, dpitch, src, spitch, rows, n, tid);
  else copy_rows_as<uint8_t>(dst, dpitch, src, spitch, rows, n, tid);
}

__global__ void __launch_bounds__(kThreads)
unpack_fused_kernel(const gomp3::Wire w, int8_t* __restrict__ tail8,
                    int16_t* __restrict__ head16, uint8_t* __restrict__ side8,
                    int tiles_per_stream) {
  __shared__ __align__(16) uint32_t stail[kTile * 2 * kTailWords];
  const int tid = threadIdx.x;
  const int s = blockIdx.x / tiles_per_stream;
  const int t0 = (blockIdx.x % tiles_per_stream) * kTile;
  const int nv = min(kTile, w.T - t0);
  const size_t g0 = (size_t)s * w.T + t0;

  gomp3::stage_tail<kTile, kThreads>(w, s, t0, stail, tid);
  constexpr int kRow = 4 * kHeadLines;  // head16 bytes of a granule
  uint8_t* head = reinterpret_cast<uint8_t*>(head16 + g0 * 2 * kHeadLines);
  if (w.nch == 2) {
    copy_rows(head, 0, w.head(s, t0), 0, 1, (size_t)nv * kRow, tid);
  } else {  // channel 0's pairs, then channel 1 zero
    copy_rows(head, kRow, w.head(s, t0), kRow / 2, nv, kRow / 2, tid);
    for (int i = tid; i < nv * kRow / 32; i += kThreads)
      reinterpret_cast<uint4*>(head + (i / (kRow / 32)) * kRow + kRow / 2)[i % (kRow / 32)] =
          make_uint4(0, 0, 0, 0);
  }
  copy_rows(side8 + g0 * kSide8, 0, w.side(s, t0), 0, 1, (size_t)nv * kSide8, tid);
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(tail8 + g0 * 2 * kTailLines);
  for (int i = tid; i < nv * 2 * kTailLines / 16; i += kThreads)
    dst[i] = reinterpret_cast<const uint4*>(stail)[i];
}

}  // namespace

extern "C" {

// buf u8 [S][row_bytes] with row_bytes = nch*L*T + T*nch*64*2 + T*168 (at
// any address) -> tail8 i8 [S][T][1024], head16 i16 [S][T][128], side8 u8
// [S][T][168] (16-byte aligned). 0 <= L <= 512, nch in {1, 2}. S == 0 or
// T == 0 launches nothing.
int gomp3_unpack_fused(int device, const uint8_t* buf, int8_t* tail8,
                       int16_t* head16, uint8_t* side8, int S, int T, int L,
                       int nch, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (S < 0 || T < 0 || L < 0 || L > kTailLines || (nch != 1 && nch != 2))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0) return (int)cudaGetLastError();
  const gomp3::Wire w = {buf, gomp3::wire_row_bytes(T, L, nch), T, L, nch};
  const int tiles = (T + kTile - 1) / kTile;
  unpack_fused_kernel<<<S * tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, tail8, head16, side8, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
