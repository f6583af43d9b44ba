// K2: the finish of the 48k-family chains -- final-rate f32 samples to wire
// bytes and the peak.
//
// Replaces the TPU kernel dsd2dxd_tpu/ops/fused.py::make_finish_planes (its
// pallas_call), and, for 32-bit float output, the XLA epilogue
// dsd2dxd_tpu/ops/phase.py::finish_tile that the JAX package runs there.
// After the head (K1e, fused_decim.cu in planar mode) and the ×160/147
// tail (torch.matmul, ops/rational.py), it computes per channel c and
// output frame m of the (C, n_frames) f32 tile z:
//   y = gain * z[c][m]; peak = max |y| over m < n_valid
//   the wire word of y by epilogue<BITS, DITHER> (epilogue.cuh, the same
//   code K1 finishes its samples with: 16/20/24-bit NONE/TPDF/RECT, 32-bit
//   NONE/FPD), dither counter (m, c, 0, 0) under the tile's key
//   frame-interleaved wire bytes, little endian for WAV and raw output, big
//   endian for AIFF/AIFC.
// Plain version: dsd2dxd_tpu_torch/ops/fused.py::finish_reference
// (decim_epilogue of gain * z); bit-equal on the card.
//
// What bounds it on an H100: memory. Each sample is 4 bytes in and 2-4
// bytes out, against at most one Philox4x32-10 call (~40 integer ops), so
// a tile is one pass over its bytes. Design (simple first): one thread per
// (frame, channel), thread i owning sample i = m * C + c of the
// frame-interleaved output, so a warp writes one contiguous run of wire
// bytes; reads are C strided streams of consecutive floats. The peak is the
// K1 reduction (warp max, block max, one atomicMax on the f32 bit pattern).
// The TPU kernel's blocked plane layout and its (8, 128) sub-blocks exist
// only for the host interleaver of the TPU path and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

struct FinishParams {
  long long n_frames;  // frames per channel of z
  long long n_valid;   // frames m >= n_valid leave the peak alone
  int channels;
  float gain;          // y = gain * z (exact for gain 1)
  int bit_depth;       // 16, 20, 24 (integer) or 32 (float)
  int dither;          // DITHER_*
  uint32_t key0;
  uint32_t key1;
  int big_endian;
};

template <int BITS, int DITHER>
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ z, uint8_t* __restrict__ out,
              float* __restrict__ peak, const FinishParams p) {
  constexpr int BPS = BITS == 16 ? 2 : (BITS == 32 ? 4 : 3);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  float local_peak = 0.0f;
  if (i < p.n_frames * p.channels) {
    const long long m = i / p.channels;
    const int c = (int)(i - m * p.channels);
    const float y = __fmul_rn(z[c * p.n_frames + m], p.gain);
    if (m < p.n_valid) local_peak = fabsf(y);
    const uint32_t w =
        epilogue<BITS, DITHER>(y, (uint32_t)m, (uint32_t)c, p.key0, p.key1);
    store_wire<BPS>(out + i * BPS, w, p.big_endian);
  }
  block_peak(local_peak, peak);
}

template <int BITS, int DITHER>
static int launch(const void* z, void* out, void* peak, const FinishParams* p,
                  cudaStream_t stream) {
  const long long n = p->n_frames * p->channels;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS));
  finish_kernel<BITS, DITHER><<<grid, THREADS, 0, stream>>>(
      (const float*)z, (uint8_t*)out, (float*)peak, *p);
  return (int)cudaGetLastError();
}

extern "C" int dsd2dxd_finish_params_size() { return (int)sizeof(FinishParams); }

extern "C" int dsd2dxd_finish(const void* z, void* out, void* peak,
                              const FinishParams* p, void* stream) {
  if (p->n_frames < 1 || p->channels < 1 ||
      (p->n_frames * p->channels + THREADS - 1) / THREADS > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p->bit_depth * 4 + p->dither) {
    case 16 * 4 + DITHER_NONE: return launch<16, DITHER_NONE>(z, out, peak, p, s);
    case 16 * 4 + DITHER_TPDF: return launch<16, DITHER_TPDF>(z, out, peak, p, s);
    case 16 * 4 + DITHER_RECT: return launch<16, DITHER_RECT>(z, out, peak, p, s);
    case 20 * 4 + DITHER_NONE: return launch<20, DITHER_NONE>(z, out, peak, p, s);
    case 20 * 4 + DITHER_TPDF: return launch<20, DITHER_TPDF>(z, out, peak, p, s);
    case 20 * 4 + DITHER_RECT: return launch<20, DITHER_RECT>(z, out, peak, p, s);
    case 24 * 4 + DITHER_NONE: return launch<24, DITHER_NONE>(z, out, peak, p, s);
    case 24 * 4 + DITHER_TPDF: return launch<24, DITHER_TPDF>(z, out, peak, p, s);
    case 24 * 4 + DITHER_RECT: return launch<24, DITHER_RECT>(z, out, peak, p, s);
    case 32 * 4 + DITHER_NONE: return launch<32, DITHER_NONE>(z, out, peak, p, s);
    case 32 * 4 + DITHER_FPD: return launch<32, DITHER_FPD>(z, out, peak, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
