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
// layout. Here every stage is computed decimated and directly, so the modes
// are one cascade of up to MAX_STAGES stages and one epilogue chosen per
// launch. Plain version: dsd2dxd_tpu_torch/ops/fused.py::fused_decim_reference
// (K1e: fused_decim_cascade with gain 1); the two agree bit for bit on the
// card (the same products, the same pairwise sum order, the same Philox
// draws, no FMA contraction).
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
// at ÷128) plus at most one Philox4x32-10 call. Bit-equality forbids FMA, so
// a MAC is at least two FP32 instructions (__fmul_rn, __fadd_rn): the floor
// is twice the f32 FMA bound. The design spends as few other instructions
// and shared-memory wavefronts per MAC as it can:
// - grid (ceil(T_out / block_out), C): a block owns block_out output frames
//   of one channel and its own window of the input (halo or tile as the
//   index falls; blocks are independent, unlike the TPU's sequential grid).
// - the window stays packed: the block copies its bytes (n_load_bytes, 2.6
//   KB at ÷128) with 16-byte loads from the aligned span that covers them,
//   as big-endian u32 words, so bit b of the window is bit 31 - b % 32 of
//   word b / 32. (Blocks whose window reaches into the halo or past the
//   tile take it byte by byte, with the DSD idle byte 0x69 past the end.)
// - stage 0 reads those bits through tables: its taps are zero-padded to
//   4 n_groups (x + 0 = x leaves the pairwise sum as it was), and each
//   aligned group of 4 taps is a complete subtree of the sum whose 16
//   possible values (the products are ±h, exact) the wrapper computes once
//   per step (ops/fused.py::stage0_tables). A thread computes 4 outputs
//   from one 64-bit window of bits; per 4 taps an output costs one table
//   read (16 floats of a table lie in 16 banks: no conflict) and one add of
//   the tree, and the entry's address one shift and one LOP3 (the tables
//   start on a 64-byte boundary, so the LOP3 that masks the nibble also ORs
//   in the table's address), which at ÷2 two outputs share: output j + 2
//   reads output j's nibbles one nibble on.
// - every later stage of the cached chains is ÷2: its input lies in two
//   polyphase halves (x[2i], x[2i+1]), which the stage before writes. A
//   thread computes VEC = 4 consecutive outputs from float4 reads of both
//   halves (a warp reads 512 consecutive bytes: no conflict; each input is
//   read once per 4 outputs, not once per tap) and one broadcast float4
//   read per 4 taps, the tap count a compile-time constant for the counts
//   in use (a switch, each case fully unrolled, the sum tree static code)
//   and a generic loop for others.
// - shared memory holds the coefficients, the packed window and two
//   ping-pong buffers of stage outputs: 57 KB at ÷64 and block_out 256,
//   where the unpacked window took 111 KB, so 3 blocks share an SM, not 2
//   (ops/fused.py::BLOCK_OUT takes 320 there, 70 KB). The registers (64 a
//   thread) allow 4 blocks of 256 threads.
// - peak: frames m >= n_valid (the idle pad of a partial final tile, where
//   the filter rings) are left out; warp max, block max, one atomicMax on the
//   bit pattern of the non-negative f32 (order-independent, deterministic).
// - dither and the wire word: epilogue.cuh, shared with K2. FPD's ulp is
//   f32(bits(y) & 0x7F800000) * 2^-23, as the TPU kernel takes it. The last
//   stage writes its outputs to shared memory, and one loop per epilogue
//   (chosen per launch) reads them in frame order.
// The body is decim_body.cuh's, at RUNG_FULL: the floor probes (probes.cu)
// run the same body stopped earlier.

#include <cstdint>
#include <cuda_runtime.h>

#include "decim_body.cuh"
#include "device_check.cuh"

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_decim_kernel(const uint8_t* __restrict__ halo,
                   const uint8_t* __restrict__ x,
                   const float* __restrict__ coefs, uint8_t* __restrict__ out,
                   float* __restrict__ peak, const DecimParams p) {
  decim_body<RUNG_FULL>(halo, x, coefs, out, peak, p);
}

static bool valid_epilogue(const DecimParams* p) {
  if (p->planar) return p->bit_depth == 32 && p->dither == DITHER_NONE;
  switch (p->bit_depth) {
    case 16: case 20: case 24:
      return p->dither == DITHER_NONE || p->dither == DITHER_TPDF ||
             p->dither == DITHER_RECT;
    case 32: return p->dither == DITHER_NONE || p->dither == DITHER_FPD;
    default: return false;
  }
}

extern "C" int dsd2dxd_decim_params_size() { return (int)sizeof(DecimParams); }

extern "C" int dsd2dxd_fused_decim(const void* halo, const void* x,
                                   const void* coefs, void* out, void* peak,
                                   const DecimParams* p, void* stream,
                                   int device) {
  if (!valid_decim_params(p) || !valid_epilogue(p))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = check_device(device);
  if (e != cudaSuccess) return (int)e;
  e = set_decim_attributes(fused_decim_kernel);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p->tile_frames + p->block_out - 1) / p->block_out,
                  p->channels);
  fused_decim_kernel<<<grid, THREADS, p->smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)halo, (const uint8_t*)x, (const float*)coefs,
      (uint8_t*)out, (float*)peak, *p);
  return (int)cudaGetLastError();
}

// res: resident blocks per SM at smem_bytes of dynamic shared memory,
// threads per block, registers per thread, local (stack) bytes per thread.
extern "C" int dsd2dxd_fused_decim_attrs(int smem_bytes, int* res,
                                         int device) {
  cudaError_t e = check_device(device);
  if (e != cudaSuccess) return (int)e;
  e = set_decim_attributes(fused_decim_kernel);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[0], fused_decim_kernel,
                                                    THREADS, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fused_decim_kernel);
  if (e != cudaSuccess) return (int)e;
  res[1] = THREADS;
  res[2] = a.numRegs;
  res[3] = (int)a.localSizeBytes;
  return 0;
}
