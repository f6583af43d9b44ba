// K1a: fused ÷8 DSD -> 24-bit PCM, one pass from raw DSD bytes to wire bytes.
//
// Replaces the G=1, no-tail, 24-bit form of the TPU kernel
// dsd2dxd_tpu/ops/fused.py::_build_kernel (launched by make_fused_step's
// pallas_call). Plain version: dsd2dxd_tpu_torch/ops/fused.py::
// fused_div8_reference; the two agree bit for bit on the card (same
// products, same pairwise sum order, same Philox draws, no FMA contraction).
//
// What it computes, per channel and output frame m of the tile:
//   window = halo (H bytes) ++ tile (T bytes), MSB-first ±1 samples
//   stage s: y_s[j] = sum_k h_s[k] * y_{s-1}[M_s j - k]   (L = 1 stages)
//   y = gain * y_last[m]; peak = max |y|
//   q = clip(rint(y * 2^23 + dither), -2^23, 2^23 - 1) -> 3 wire bytes
//
// What bounds it on an H100: not memory. A tile moves 1 byte in and 3 bytes
// out per output frame, but costs sum_s N_s * 8/prod(M_<=s) FIR MACs
// (158 for the Equiripple DSD64 chain) plus one Philox4x32-10 call, so the
// kernel is bound by fp32 issue and shared-memory reads.
//
// Design (simple first; wgmma/TMA/persistence are for later work):
// - grid (ceil(T / block_out), C): a block owns block_out output frames of
//   one channel and reads exactly the bytes their filter context needs
//   (off0 = -(15 + 17*2 + 57*4) = -277 bits before the block for E), from
//   the halo or the tile as the index falls. Blocks are independent: no
//   state is carried between them, unlike the TPU's sequential grid.
// - it unpacks the bits to ±1 f32 in dynamic shared memory and runs the
//   stages ping-pong between two shared buffers; the last stage feeds the
//   epilogue straight from registers.
// - taps come from the chain (device buffer), so E, X and D all run.
// - each output sums its N products pairwise in the plain version's order
//   (binary counter: S_a + (S_b + ...) over N's power-of-two blocks),
//   with __fmul_rn/__fadd_rn so nvcc cannot contract to FMA.
// - peak: warp max, block max, one atomicMax on the bit pattern of the
//   non-negative f32 (order-independent, so deterministic).
// - dither: Philox4x32-10, counter (frame, channel, 0, 0), key from the
//   wrapper; uniforms (x >> 8) * 2^-24; TPDF (u0 + u1) - 1, RECT u0 - 0.5.

#include <cstdint>
#include <cuda_runtime.h>

#define MAX_STAGES 4
#define THREADS 256
#define MAX_LEVELS 8  // tree levels: taps per stage < 256

struct Div8Params {
  int n_stages;
  int channels;
  int tile_frames;   // T: input bytes = output frames per channel
  int halo_bytes;    // H
  int block_out;     // output frames per block
  int byte_off;      // window byte of the block's first input byte, minus m0
  int bit_off;       // first needed bit inside that byte
  int n_load_bytes;  // bytes each block unpacks
  int n_taps_total;
  int buf_a;         // float offsets into dynamic shared memory
  int buf_b;
  int smem_bytes;
  int n_taps[MAX_STAGES];
  int decim[MAX_STAGES];
  int tap_off[MAX_STAGES];
  int out_len[MAX_STAGES];  // outputs per block of each stage
  float gain;
  int apply_gain;
  float scale;       // 2^23
  int dither;        // 0 none, 1 TPDF, 2 RECT
  uint32_t key0;
  uint32_t key1;
  int big_endian;
};

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

// sum_{k<n} h[k] * src[-k], summed pairwise in the order of the plain
// version's tree_sum.
__device__ __forceinline__ float fir_tree(const float* __restrict__ h,
                                          const float* src, int n) {
  float acc[MAX_LEVELS];
  for (int k = 0; k < n; ++k) {
    float v = __fmul_rn(h[k], src[-k]);
#pragma unroll
    for (int lv = 0; lv < MAX_LEVELS; ++lv) {
      if ((k >> lv) & 1) {
        v = __fadd_rn(acc[lv], v);
      } else {
        acc[lv] = v;
        break;
      }
    }
  }
  float out = 0.0f;
  bool have = false;
#pragma unroll
  for (int lv = 0; lv < MAX_LEVELS; ++lv) {
    if ((n >> lv) & 1) {
      out = have ? __fadd_rn(acc[lv], out) : acc[lv];
      have = true;
    }
  }
  return out;
}

__global__ void __launch_bounds__(THREADS)
fused_div8_kernel(const uint8_t* __restrict__ halo,
                  const uint8_t* __restrict__ x,
                  const float* __restrict__ taps, uint8_t* __restrict__ out,
                  float* __restrict__ peak, const Div8Params p) {
  extern __shared__ float smem[];
  __shared__ float warp_max[THREADS / 32];
  const int c = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * p.block_out;
  const long long H = p.halo_bytes;
  const long long T = p.tile_frames;
  const int tid = threadIdx.x;
  float* h_s = smem;
  float* buf_a = smem + p.buf_a;
  float* buf_b = smem + p.buf_b;

  for (int i = tid; i < p.n_taps_total; i += blockDim.x) h_s[i] = taps[i];
  for (int i = tid; i < p.n_load_bytes; i += blockDim.x) {
    const long long wb = m0 + p.byte_off + i;  // window byte
    uint32_t byte = 0x69u;                     // DSD idle past the window
    if (wb < H) {
      byte = halo[c * H + wb];
    } else if (wb - H < T) {
      byte = x[c * T + (wb - H)];
    }
#pragma unroll
    for (int b = 0; b < 8; ++b)
      buf_a[8 * i + b] = ((byte >> (7 - b)) & 1u) ? 1.0f : -1.0f;
  }
  __syncthreads();

  const float* in = buf_a + p.bit_off;
  const int last = p.n_stages - 1;
  for (int s = 0; s < last; ++s) {
    float* dst = ((s + 1) & 1) ? buf_b : buf_a;
    const float* h = h_s + p.tap_off[s];
    const int n = p.n_taps[s];
    const int m = p.decim[s];
    const int len = p.out_len[s];
    for (int j = tid; j < len; j += blockDim.x)
      dst[j] = fir_tree(h, in + m * j + n - 1, n);
    __syncthreads();
    in = dst;
  }

  const float* h = h_s + p.tap_off[last];
  const int n = p.n_taps[last];
  const int md = p.decim[last];
  float local_peak = 0.0f;
  for (int j = tid; j < p.block_out; j += blockDim.x) {
    const long long m = m0 + j;
    if (m >= T) break;
    float y = fir_tree(h, in + md * j + n - 1, n);
    if (p.apply_gain) y = __fmul_rn(y, p.gain);
    local_peak = fmaxf(local_peak, fabsf(y));
    float v = __fmul_rn(y, p.scale);
    if (p.dither) {
      uint32_t ctr[4] = {(uint32_t)m, (uint32_t)c, 0u, 0u};
      philox4x32_10(ctr, p.key0, p.key1);
      const float u0 = __uint2float_rn(ctr[0] >> 8) * 5.9604644775390625e-08f;
      if (p.dither == 1) {
        const float u1 =
            __uint2float_rn(ctr[1] >> 8) * 5.9604644775390625e-08f;
        v = __fadd_rn(v, __fadd_rn(__fadd_rn(u0, u1), -1.0f));
      } else {
        v = __fadd_rn(v, __fadd_rn(u0, -0.5f));
      }
    }
    const float q = fminf(fmaxf(rintf(v), -8388608.0f), 8388607.0f);
    const int qi = (int)q;
    uint8_t* o = out + (m * p.channels + c) * 3;
    const uint8_t b0 = qi & 0xFF, b1 = (qi >> 8) & 0xFF, b2 = (qi >> 16) & 0xFF;
    if (p.big_endian) {
      o[0] = b2; o[1] = b1; o[2] = b0;
    } else {
      o[0] = b0; o[1] = b1; o[2] = b2;
    }
  }

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
    // |y| >= 0: its f32 bit pattern orders like the value
    if (tid == 0) atomicMax(reinterpret_cast<int*>(peak), __float_as_int(v));
  }
}

extern "C" int dsd2dxd_div8_params_size() { return (int)sizeof(Div8Params); }

extern "C" int dsd2dxd_fused_div8(const void* halo, const void* x,
                                  const void* taps, void* out, void* peak,
                                  const Div8Params* p, void* stream) {
  if (p->n_stages < 1 || p->n_stages > MAX_STAGES) return (int)cudaErrorInvalidValue;
  if (p->smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_div8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p->smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p->tile_frames + p->block_out - 1) / p->block_out, p->channels);
  fused_div8_kernel<<<grid, THREADS, p->smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)halo, (const uint8_t*)x, (const float*)taps,
      (uint8_t*)out, (float*)peak, *p);
  return (int)cudaGetLastError();
}
