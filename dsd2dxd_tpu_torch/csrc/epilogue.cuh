// The per-sample output stage shared by the fused decimation kernel (K1,
// fused_decim.cu) and the finish kernel (K2, finish.cu): Philox4x32-10
// dither and the wire word of one sample. Both kernels draw their noise
// from this one copy, so a sample gets the same bits whichever kernel
// finishes it. Plain version: dsd2dxd_tpu_torch/ops/fused.py::decim_epilogue
// (noise from ops/philox.py, line for line).
//
//   16/20/24-bit: q = clip(rint(y * 2^(b-1) + dither), -2^(b-1), 2^(b-1) - 1),
//                 20-bit then << 4 into a 24-bit container
//   32-bit: y (NONE) or y + tpdf * ulp(y) (FPD), ulp from the exponent bits
// Dither: counter (frame, channel, 0, 0), key (key0, key1); uniforms
// (x >> 8) * 2^-24; TPDF and FPD (u0 + u1) - 1, RECT u0 - 0.5. Every
// product and sum is __fmul_rn/__fadd_rn, so nvcc cannot contract to FMA.

#pragma once

#include <cstdint>

#define THREADS 256

enum { DITHER_NONE = 0, DITHER_TPDF = 1, DITHER_RECT = 2, DITHER_FPD = 3 };

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The wire word of one sample (its bytes low first) for epilogue
// <BITS, DITHER>; y is the gain-scaled sample of frame m, channel c.
template <int BITS, int DITHER>
__device__ __forceinline__ uint32_t epilogue(float y, uint32_t m, uint32_t c,
                                             uint32_t k0, uint32_t k1) {
  float u0 = 0.0f, u1 = 0.0f;
  if constexpr (DITHER != DITHER_NONE) {
    uint32_t ctr[4] = {m, c, 0u, 0u};
    philox4x32_10(ctr, k0, k1);
    u0 = __uint2float_rn(ctr[0] >> 8) * 5.9604644775390625e-08f;  // 2^-24
    u1 = __uint2float_rn(ctr[1] >> 8) * 5.9604644775390625e-08f;
  }
  if constexpr (BITS == 32) {
    float v = y;
    if constexpr (DITHER == DITHER_FPD) {
      const float tpdf = __fadd_rn(__fadd_rn(u0, u1), -1.0f);
      const float ulp = __fmul_rn(
          __int_as_float(__float_as_int(y) & 0x7F800000),
          1.1920928955078125e-07f);  // 2^-23
      v = __fadd_rn(y, __fmul_rn(tpdf, ulp));
    }
    return __float_as_uint(v);
  } else {
    const float scale = (float)(1 << (BITS - 1));
    float v = __fmul_rn(y, scale);
    if constexpr (DITHER == DITHER_TPDF) {
      v = __fadd_rn(v, __fadd_rn(__fadd_rn(u0, u1), -1.0f));
    } else if constexpr (DITHER == DITHER_RECT) {
      v = __fadd_rn(v, __fadd_rn(u0, -0.5f));
    }
    const float q = fminf(fmaxf(rintf(v), -scale), scale - 1.0f);
    uint32_t w = (uint32_t)(int)q;
    if constexpr (BITS == 20) w <<= 4;  // 20 significant bits at the top of 24
    return w;
  }
}

// Store the low BPS bytes of w at o, in wire order.
template <int BPS>
__device__ __forceinline__ void store_wire(uint8_t* o, uint32_t w,
                                           int big_endian) {
#pragma unroll
  for (int b = 0; b < BPS; ++b)
    o[big_endian ? BPS - 1 - b : b] = (uint8_t)(w >> (8 * b));
}

// Fold each thread's |y| maximum into *peak: warp max, block max, then one
// atomicMax on the bit pattern of the non-negative f32 (it orders like the
// value, so the result is order-independent and deterministic). Every
// thread of the block must call it (a block of any size up to 1024).
__device__ __forceinline__ void block_peak(float local_peak, float* peak) {
  __shared__ float warp_max[32];
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local_peak = fmaxf(local_peak, __shfl_xor_sync(0xffffffffu, local_peak, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = local_peak;
  __syncthreads();
  if (tid < 32) {
    float v = tid < (int)(blockDim.x / 32) ? warp_max[tid] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (tid == 0) atomicMax(reinterpret_cast<int*>(peak), __float_as_int(v));
  }
}
