// K1: unpack + requantize + MS/intensity stereo, a tile of granules per block.
//
// Replaces: the XLA program of _requantize, _stereo and the loads in front
// of them in go_mp3_tpu/ops/granule.py (:242-358): the packed unpacks
// (batch_from_packed / batch_from_packed8, :560-608), the GranuleBatch that
// decode_chunk_impl takes as it is (:77-93, :493), and the fused wire's
// unpack (unpack_fused / unpack_fused_mono, :661-723) that
// decode_chunk_fused_batch_impl (:726-741) fuses into those loads. Plain
// version: requant_stereo_ref (and, for the wire, requant_stereo_fused_ref)
// in go_mp3_tpu_torch/ops/granule.py.
//
// What bounds it on an H100: memory (the floor below); the instructions
// come close behind. Per granule it reads 1,152 spectral
// values (2,624 bytes on the int8 interface, ~2,624 on the wire at full
// width, 2,592 on int16, 2,867 as a GranuleBatch) and writes 4,608 bytes of
// f32, for ~2 exp2f/log2f per line: 93.1 MB a [64, 240] chunk on the int8
// interface and on the wire, 0.0278 ms at 3.35 TB/s.
//
// Design. A block owns a tile of G consecutive granules of one stream
// (G = 1, 2 or 4, picked by the wrapper so that a chunk of one stream still
// spreads over the card; no output depends on it). An item is
// kSpan = 1, 2 or 4 lines of both channels of one granule (MS and
// intensity stereo mix the channels of a line): a small tile gets a thread
// a line or two, a large one a thread per 4 lines of several granules.
// The block runs in three steps with one barrier between each:
//  A. every load of the tile in one pass, so the block waits on device
//     memory once: the tile's side words into shared memory; each
//     thread's spectra (its items' lines) into registers, 1-8 bytes a
//     load; on the wire, the tile's tail through fused_tile.cuh's [lines x
//     granules] loader, transposed in shared memory by __byte_perm, and the
//     head pairs straight into registers;
//  B. every thread builds the tile's per-band values from the side words:
//     the requantize exponents (22 long + 39 short per channel), the
//     intensity multipliers as deltas from 1, and each granule's ginfo word
//     (block types, classes, mono), which K2 and K3 read instead of the
//     side words. The items' band indices (3 x 6 x 576 bytes of per-line
//     maps, L1-resident) are loaded into registers just before, so they
//     arrive while B runs;
//  C. the items. The arithmetic issues more instructions than the bytes
//     take to move, so C skips what is exact without it: a zero line its
//     exp2f/log2f (the expression gives +0; most lines of a real granule
//     are zero), and a granule without intensity stereo the multiplier
//     product (exactly 1). The outputs leave in 4-16-byte stores,
//     coalesced along the lines.
// Only the load differs between the four inputs (template parameter): the
// int16 interface, the int8 interface, the GranuleBatch's fields (each in
// its own dtype, assembled into the same side words) and the fused wire
// rows; no unpacked copy of any of them exists in device memory.
// The tile body (steps A-C) is requant_tile.cuh's: the granule chain
// (chain.cu) runs the same body into shared memory.
//
// Arithmetic: every float expression is the one-granule-a-block kernel's
// (a_long, a_short, the exp2f/log2f pair, the MS butterfly, the intensity
// product), so all four inputs and every tile size give its bits.
// exp2f/log2f are the accurate ones: the build has no --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "fused_tile.cuh"
#include "requant_tile.cuh"

namespace {

// A block of G granules: items of span_for(G) lines of both channels,
// threads_for(G) threads, so that a small tile still has a thread a line
// or two and a large one a thread per 4 lines of several granules.
__host__ __device__ constexpr int span_for(int G) { return G == 1 ? 1 : G == 2 ? 2 : 4; }
__host__ __device__ constexpr int threads_for(int G) { return G <= 2 ? kLines : kLines / 2; }

template <int kLayout, int G>
__global__ void __launch_bounds__(threads_for(G), G <= 2 ? 2 : 4)
requant_stereo_kernel(const Inputs in, const gomp3::Wire w, float* __restrict__ out,
                      int32_t* __restrict__ ginfo, int T, int tiles_per_stream,
                      int stereo, size_t granules) {
  __shared__ RequantSmem<kLayout, G> sm;
  const int s = blockIdx.x / tiles_per_stream;
  const int t0 = (blockIdx.x % tiles_per_stream) * G;
  const int nv = min(G, T - t0);          // granules of the tile
  const size_t g0 = (size_t)s * T + t0;   // flat index of its first granule
  requant_tile<kLayout, G, threads_for(G), span_for(G)>(
      in, w, s, t0, nv, g0, stereo, granules, out + g0 * 2 * kLines, ginfo + g0, t0, sm,
      threadIdx.x);
}

template <int kLayout, int G>
cudaError_t launch(const Inputs& in, const gomp3::Wire& w, float* out, int32_t* ginfo,
                   int S, int T, int stereo, cudaStream_t st) {
  const int tiles = (T + G - 1) / G;
  requant_stereo_kernel<kLayout, G><<<S * tiles, threads_for(G), 0, st>>>(
      in, w, out, ginfo, T, tiles, stereo, (size_t)S * T);
  return cudaGetLastError();
}

template <int kLayout>
cudaError_t launch_tile(int G, const Inputs& in, const gomp3::Wire& w, float* out,
                        int32_t* ginfo, int S, int T, int stereo, cudaStream_t st) {
  switch (G) {
    case 1: return launch<kLayout, 1>(in, w, out, ginfo, S, T, stereo, st);
    case 2: return launch<kLayout, 2>(in, w, out, ginfo, S, T, stereo, st);
    case 4: return launch<kLayout, 4>(in, w, out, ginfo, S, T, stereo, st);
    default: return cudaErrorInvalidValue;
  }
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
  return (int)requant_upload_tables(pretab, is_l, is_r, long_start, short_start3, long_sfb,
                                    req_short, is_short);
}

// layout: a Layout; inputs: host array of the layout's device pointers
// (2, 3, 14 or 1, in the order above). out f32 [S][T][2][576], ginfo i32
// [S][T]. tile: granules a block, 1, 2 or 4. tail_lines (0..512) and
// nch (1 or 2): the wire's, read only by the fused layout. Spectra and
// head16 8-byte aligned, tail8 4-byte aligned; the wire at any address.
// S == 0 or T == 0 launches nothing.
int gomp3_requant_stereo(int device, int layout, const void* const* inputs,
                         float* out, int32_t* ginfo, int S, int T, int tile,
                         int stereo, int tail_lines, int nch, void* stream) {
  gomp3::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int count = input_count(layout);
  if (count == 0 || S < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if (layout == kFused && (tail_lines < 0 || tail_lines > kTailLines || (nch != 1 && nch != 2)))
    return (int)cudaErrorInvalidValue;
  if (S == 0 || T == 0) return (int)cudaGetLastError();
  Inputs in = {};
  for (int i = 0; i < count; i++) in.p[i] = inputs[i];
  gomp3::Wire w = {static_cast<const uint8_t*>(in.p[0]),
                   gomp3::wire_row_bytes(T, tail_lines, nch), T, tail_lines, nch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kInt16: return (int)launch_tile<kInt16>(tile, in, w, out, ginfo, S, T, stereo, s);
    case kInt8: return (int)launch_tile<kInt8>(tile, in, w, out, ginfo, S, T, stereo, s);
    case kBatch: return (int)launch_tile<kBatch>(tile, in, w, out, ginfo, S, T, stereo, s);
    default: return (int)launch_tile<kFused>(tile, in, w, out, ginfo, S, T, stereo, s);
  }
}

}  // extern "C"
