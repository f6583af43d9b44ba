// The body of the fused decimation kernel (K1, fused_decim.cu) up to its
// last stage, shared with the floor probes of P2 (probes.cu), so that a
// probe rung differs from production only in where it stops:
//   - DecimParams, the block geometry the wrapper computes
//     (dsd2dxd_tpu_torch/ops/fused.py::_kernel_params);
//   - load_window: the block's taps to shared memory, and its window of
//     raw DSD bytes (halo ++ tile, DSD idle past the end), one byte per
//     thread, handed to a store callback (K1 unpacks MSB-first to ±1 f32);
//   - run_stages: stages 0 .. n_stages-2, ping-pong between the two
//     shared buffers, each output summed pairwise by fir_tree;
//   - last_stage: the last stage per output frame, its gain and peak,
//     each sample handed to an emit callback (K1: the epilogue).
// Plain version of the whole: ops/fused.py::fused_decim_cascade.

#pragma once

#include <cstdint>

#include "epilogue.cuh"

#define MAX_STAGES 8
#define MAX_LEVELS 8  // tree levels: taps per stage < 256

struct DecimParams {
  int n_stages;
  int channels;
  int tile_bytes;    // T: input bytes per channel
  int tile_frames;   // T_out = T / frame_bytes: output frames per channel
  int frame_bytes;   // input bytes per output frame (R / 8)
  int n_valid;       // frames m >= n_valid leave the peak alone
  int halo_bytes;    // H
  int block_out;     // output frames per block
  int byte_off;      // window byte of the block's first input byte, minus m0 * frame_bytes
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
  int bit_depth;     // 16, 20, 24 (integer) or 32 (float)
  int dither;        // DITHER_*
  uint32_t key0;
  uint32_t key1;
  int big_endian;
  int planar;        // K1e: planar f32 out[c * tile_frames + m], no peak
};

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

// The taps to h_s, then every window byte i < n_load_bytes of the block
// whose first output frame is m0 (channel c) to store(i, byte); a barrier
// after. Bytes past the window read as the DSD idle byte.
template <typename Store>
__device__ __forceinline__ void load_window(const uint8_t* __restrict__ halo,
                                            const uint8_t* __restrict__ x,
                                            const float* __restrict__ taps,
                                            float* h_s, const DecimParams& p,
                                            int c, long long m0, Store store) {
  const long long H = p.halo_bytes;
  const long long T = p.tile_bytes;
  const int tid = threadIdx.x;
  for (int i = tid; i < p.n_taps_total; i += blockDim.x) h_s[i] = taps[i];
  const long long wb0 = m0 * p.frame_bytes + p.byte_off;
  for (int i = tid; i < p.n_load_bytes; i += blockDim.x) {
    const long long wb = wb0 + i;  // window byte
    uint32_t byte = 0x69u;         // DSD idle past the window
    if (wb < H) {
      byte = halo[c * H + wb];
    } else if (wb - H < T) {
      byte = x[c * T + (wb - H)];
    }
    store(i, byte);
  }
  __syncthreads();
}

// K1's store: byte i as its 8 MSB-first ±1 samples at buf[8i ...].
__device__ __forceinline__ void unpack_byte(float* buf, int i, uint32_t byte) {
#pragma unroll
  for (int b = 0; b < 8; ++b)
    buf[8 * i + b] = ((byte >> (7 - b)) & 1u) ? 1.0f : -1.0f;
}

// Stages 0 .. n_stages-2 of the cascade over the unpacked window in
// buf_a; returns the last stage's input. STRIDE1: output j reads its
// input from j on instead of M j (P2's cas0a rung): a warp's reads are 32
// consecutive floats, 32 distinct banks, so no bank conflict; numerically
// wrong on purpose.
template <bool STRIDE1 = false>
__device__ __forceinline__ const float* run_stages(const float* h_s,
                                                   float* buf_a, float* buf_b,
                                                   const DecimParams& p) {
  const float* in = buf_a + p.bit_off;
  const int last = p.n_stages - 1;
  for (int s = 0; s < last; ++s) {
    float* dst = ((s + 1) & 1) ? buf_b : buf_a;
    const float* h = h_s + p.tap_off[s];
    const int n = p.n_taps[s];
    const int m = STRIDE1 ? 1 : p.decim[s];
    const int len = p.out_len[s];
    for (int j = threadIdx.x; j < len; j += blockDim.x)
      dst[j] = fir_tree(h, in + m * j + n - 1, n);
    __syncthreads();
    in = dst;
  }
  return in;
}

// The last stage for the block's frames m = m0 + j < tile_frames: y = its
// output (times p.gain when p.apply_gain), handed to emit(m, y). Returns
// the thread's max |y| over frames m < n_valid when PEAK, else 0.
template <bool PEAK, bool STRIDE1 = false, typename Emit>
__device__ __forceinline__ float last_stage(const float* h_s, const float* in,
                                            const DecimParams& p,
                                            long long m0, Emit emit) {
  const int last = p.n_stages - 1;
  const float* h = h_s + p.tap_off[last];
  const int n = p.n_taps[last];
  const int md = STRIDE1 ? 1 : p.decim[last];
  float local_peak = 0.0f;
  for (int j = threadIdx.x; j < p.block_out; j += blockDim.x) {
    const long long m = m0 + j;
    if (m >= p.tile_frames) break;
    float y = fir_tree(h, in + md * j + n - 1, n);
    if (p.apply_gain) y = __fmul_rn(y, p.gain);
    if (PEAK && m < p.n_valid) local_peak = fmaxf(local_peak, fabsf(y));
    emit(m, y);
  }
  return local_peak;
}
