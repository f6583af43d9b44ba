// K1a-K1e: fused pure-decimation DSD -> PCM, one pass from raw DSD bytes to
// wire bytes (or, as the head of a 48k-family chain, to planar f32), for
// every pure ÷2^k chain (÷8 ... ÷128).
//
// Replaces the TPU kernel dsd2dxd_tpu/ops/fused.py::_build_kernel (launched
// by make_fused_step's pallas_call) in all of its pure-decimation modes:
//   K1a  G=1 (÷8), 24-bit;
//   K1b  G=2/4 word lanes (÷16, ÷32);
//   K1c  the à-trous tail of the ÷64/÷128 chains (G=4 head + dilated tail,
//        phase 0 taken after);
//   K1d  the 16-bit, 20-bit and 32-bit float (NONE/FPD) epilogues;
//   K1e  the float head of the 48k-family chains (make_fused_rational_step:
//        bit_depth 32, no dither, level 0): the gain-1 cascade output
//        written as planar f32, out[c * T_out + m], with no peak. The
//        ×160/147 tail and the finish kernel (K2, finish.cu) take it from
//        there.
// Word lanes and the undecimated à-trous tail exist only for the TPU's
// layout. Here every stage is computed decimated and directly, so the four
// modes are one cascade of up to MAX_STAGES stages and one epilogue chosen
// at compile time (template <BITS, DITHER, PLANAR>, one instantiation per
// epilogue plus the planar head). Plain version:
// dsd2dxd_tpu_torch/ops/fused.py::fused_decim_reference (K1e:
// fused_decim_cascade with gain 1); the two agree bit for bit on the card
// (same products, same pairwise sum order, same Philox draws, no FMA
// contraction).
//
// What it computes, per channel and output frame m of the tile (R = prod M_s,
// frame_bytes = R / 8 input bytes per output frame):
//   window = halo (H bytes) ++ tile (T bytes), MSB-first ±1 samples
//   stage s: y_s[j] = sum_k h_s[k] * y_{s-1}[M_s j - k]   (L = 1 stages)
//   y = gain * y_last[m]; peak = max |y| over m < n_valid
//   16/20/24-bit: q = clip(rint(y * 2^(b-1) + dither), -2^(b-1), 2^(b-1) - 1),
//                 20-bit then << 4 into a 24-bit container; 2/3/3 wire bytes
//   32-bit: y (NONE) or y + tpdf * ulp(y) (FPD); 4 wire bytes (IEEE-754)
//   little endian for WAV and raw output, big endian for AIFF/AIFC.
//
// What bounds it on an H100: not memory. A tile moves frame_bytes bytes in
// and 2-4 bytes out per output frame, but costs sum_s N_s * R / prod(M_<=s)
// FIR MACs per frame (Equiripple: 158 at ÷8, 334 at ÷16, 612 at ÷32, 2340
// at ÷128) plus at most one Philox4x32-10 call, so the kernel is bound by
// fp32 instruction throughput and shared-memory reads.
//
// Design (simple first; wgmma/TMA/persistence are for later work):
// - grid (ceil(T_out / block_out), C): a block owns block_out output frames
//   of one channel and reads exactly the bytes their filter context needs
//   (-277 bits before the block for E ÷8, -4079 for E ÷128), from the halo
//   or the tile as the index falls. Blocks are independent: no state is
//   carried between them, unlike the TPU's sequential grid.
// - it unpacks the bits to ±1 f32 in dynamic shared memory and runs the
//   stages ping-pong between two shared buffers; the last stage feeds the
//   epilogue straight from registers.
// - shared memory: the unpacked stage-0 window is block_out * R + context
//   floats, 271 KB at ÷128 with block_out = 512, over the 227 KB a block may
//   have. The wrapper therefore lets block_out follow the chain (512 down to
//   ÷32, 256 at ÷64, 128 at ÷128: block_out * R <= 16384 bits, at most ~82 KB
//   of stage-0 window). The other route, reading stage 0 from the packed bytes,
//   would save that window but needs a second FIR routine for stage 0; with
//   one routine for every stage the redundant context stays <= 25 % of the
//   stage-0 work (4079 of 16384 bits at ÷128), which is cheaper than the
//   code.
// - taps come from the chain (device buffer), so every bank runs.
// - each output sums its N products pairwise in the plain version's order
//   (binary counter: S_a + (S_b + ...) over N's power-of-two blocks), with
//   __fmul_rn/__fadd_rn so nvcc cannot contract to FMA.
// - peak: frames m >= n_valid (the idle pad of a partial final tile, where
//   the filter rings) are left out; warp max, block max, one atomicMax on the
//   bit pattern of the non-negative f32 (order-independent, deterministic).
// - dither and the wire word: epilogue.cuh, shared with K2. FPD's ulp is
//   f32(bits(y) & 0x7F800000) * 2^-23, as the TPU kernel takes it.
// - the window load, the unpack, the stages and the last stage's loop and
//   peak live in decim_body.cuh, which the floor probes of P2 (probes.cu)
//   share; K1 adds only its epilogue.

#include <cstdint>
#include <cuda_runtime.h>

#include "decim_body.cuh"

template <int BITS, int DITHER, bool PLANAR>
__global__ void __launch_bounds__(THREADS)
fused_decim_kernel(const uint8_t* __restrict__ halo,
                   const uint8_t* __restrict__ x,
                   const float* __restrict__ taps, uint8_t* __restrict__ out,
                   float* __restrict__ peak, const DecimParams p) {
  constexpr int BPS = BITS == 16 ? 2 : (BITS == 32 ? 4 : 3);
  extern __shared__ float smem[];
  const int c = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * p.block_out;
  float* h_s = smem;
  float* buf_a = smem + p.buf_a;
  float* buf_b = smem + p.buf_b;

  load_window(halo, x, taps, h_s, p, c, m0,
              [&](int i, uint32_t byte) { unpack_byte(buf_a, i, byte); });
  const float* in = run_stages(h_s, buf_a, buf_b, p);
  const float local_peak = last_stage<!PLANAR>(
      h_s, in, p, m0, [&](long long m, float y) {
        if constexpr (PLANAR) {
          reinterpret_cast<float*>(out)[c * (long long)p.tile_frames + m] = y;
        } else {
          const uint32_t w = epilogue<BITS, DITHER>(y, (uint32_t)m,
                                                    (uint32_t)c, p.key0, p.key1);
          store_wire<BPS>(out + (m * p.channels + c) * BPS, w, p.big_endian);
        }
      });
  if constexpr (!PLANAR) block_peak(local_peak, peak);
}

template <int BITS, int DITHER, bool PLANAR = false>
static int launch(const void* halo, const void* x, const void* taps,
                  void* out, void* peak, const DecimParams* p,
                  cudaStream_t stream) {
  auto kernel = fused_decim_kernel<BITS, DITHER, PLANAR>;
  if (p->smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p->tile_frames + p->block_out - 1) / p->block_out,
                  p->channels);
  kernel<<<grid, THREADS, p->smem_bytes, stream>>>(
      (const uint8_t*)halo, (const uint8_t*)x, (const float*)taps,
      (uint8_t*)out, (float*)peak, *p);
  return (int)cudaGetLastError();
}

extern "C" int dsd2dxd_decim_params_size() { return (int)sizeof(DecimParams); }

extern "C" int dsd2dxd_fused_decim(const void* halo, const void* x,
                                   const void* taps, void* out, void* peak,
                                   const DecimParams* p, void* stream) {
  if (p->n_stages < 1 || p->n_stages > MAX_STAGES || p->tile_frames < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p->planar) {
    if (p->bit_depth != 32 || p->dither != DITHER_NONE)
      return (int)cudaErrorInvalidValue;
    return launch<32, DITHER_NONE, true>(halo, x, taps, out, peak, p, s);
  }
  switch (p->bit_depth * 4 + p->dither) {
    case 16 * 4 + DITHER_NONE: return launch<16, DITHER_NONE>(halo, x, taps, out, peak, p, s);
    case 16 * 4 + DITHER_TPDF: return launch<16, DITHER_TPDF>(halo, x, taps, out, peak, p, s);
    case 16 * 4 + DITHER_RECT: return launch<16, DITHER_RECT>(halo, x, taps, out, peak, p, s);
    case 20 * 4 + DITHER_NONE: return launch<20, DITHER_NONE>(halo, x, taps, out, peak, p, s);
    case 20 * 4 + DITHER_TPDF: return launch<20, DITHER_TPDF>(halo, x, taps, out, peak, p, s);
    case 20 * 4 + DITHER_RECT: return launch<20, DITHER_RECT>(halo, x, taps, out, peak, p, s);
    case 24 * 4 + DITHER_NONE: return launch<24, DITHER_NONE>(halo, x, taps, out, peak, p, s);
    case 24 * 4 + DITHER_TPDF: return launch<24, DITHER_TPDF>(halo, x, taps, out, peak, p, s);
    case 24 * 4 + DITHER_RECT: return launch<24, DITHER_RECT>(halo, x, taps, out, peak, p, s);
    case 32 * 4 + DITHER_NONE: return launch<32, DITHER_NONE>(halo, x, taps, out, peak, p, s);
    case 32 * 4 + DITHER_FPD: return launch<32, DITHER_FPD>(halo, x, taps, out, peak, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
