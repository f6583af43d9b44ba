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

#include <cstdint>
#include <cuda_runtime.h>

#include "device_check.cuh"
#include "epilogue.cuh"
#include "tree_sum.cuh"

#define MAX_STAGES 8
#define VEC 4          // outputs per thread of a ÷2 float stage
#define MIN_BLOCKS 4   // blocks per SM the registers must allow (<= 64 each)
#define MAX_SMEM (227 * 1024)

struct DecimParams {
  int n_stages;
  int channels;
  int tile_bytes;    // T: input bytes per channel
  int tile_frames;   // T_out = T / frame_bytes: output frames per channel
  int frame_bytes;   // input bytes per output frame (R / 8)
  int n_valid;       // frames m >= n_valid leave the peak alone
  int halo_bytes;    // H
  int block_out;     // output frames per block
  int byte_off;      // window byte of the block's first byte, minus m0 * frame_bytes
  int bit_off;       // stage 0's first bit inside that byte
  int n_load_bytes;  // window bytes a block reads
  int n_groups;      // stage 0: taps (zero-padded) / 4
  int decim0;        // stage 0: M
  int n_coefs;       // f32 coefficients: stage-0 tables, then later stages' taps
  int win;           // f32 offsets into dynamic shared memory: the window
  int buf_a;         //   words, buffer A (outputs of stages 0, 2, ...),
  int buf_b;         //   buffer B (stages 1, 3, ...)
  int smem_bytes;
  int n_taps[MAX_STAGES];
  int tap_off[MAX_STAGES];  // stage s >= 1: its taps among the coefficients
  int n_out[MAX_STAGES];    // outputs each stage computes per block
  int half[MAX_STAGES];     // stage s >= 1: floats of each half of its input
  float gain;
  int apply_gain;
  int bit_depth;     // 16, 20, 24 (integer) or 32 (float)
  int dither;        // DITHER_*
  uint32_t key0;
  uint32_t key1;
  int big_endian;
  int planar;        // K1e: planar f32 out[c * tile_frames + m], no peak
};

__device__ __forceinline__ float lane(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// The block's window to `win` as big-endian words: returns the bit of the
// words where stage 0's first output starts.
__device__ __forceinline__ int load_window(const uint8_t* __restrict__ halo,
                                           const uint8_t* __restrict__ x,
                                           uint32_t* win, const DecimParams& p,
                                           int c, long long m0) {
  const long long H = p.halo_bytes;
  const long long T = p.tile_bytes;
  const long long wb0 = m0 * p.frame_bytes + p.byte_off;  // window byte
  const int n = p.n_load_bytes;
  if (wb0 >= H && wb0 + n <= H + T) {
    // inside the tile: the 16-byte chunks that cover it (each holds a
    // byte of the tile, so it lies in the tile's allocation)
    const uint8_t* src = x + c * T + (wb0 - H);
    const int s = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    const uint4* src4 = reinterpret_cast<const uint4*>(src - s);
    uint4* dst = reinterpret_cast<uint4*>(win);
    for (int i = threadIdx.x; i < (s + n + 15) >> 4; i += blockDim.x) {
      uint4 v = __ldg(src4 + i);
      v.x = __byte_perm(v.x, 0, 0x0123);
      v.y = __byte_perm(v.y, 0, 0x0123);
      v.z = __byte_perm(v.z, 0, 0x0123);
      v.w = __byte_perm(v.w, 0, 0x0123);
      dst[i] = v;
    }
    return 8 * s + p.bit_off;
  }
  for (int i = threadIdx.x; i < (n + 3) >> 2; i += blockDim.x) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long wb = wb0 + 4 * i + b;
      uint32_t byte = 0x69u;  // DSD idle past the window
      if (wb < H) {
        byte = halo[c * H + wb];
      } else if (wb - H < T) {
        byte = x[c * T + (wb - H)];
      }
      w = (w << 8) | byte;
    }
    win[i] = w;
  }
  return p.bit_off;
}

// The f32 at shared address addr. (Not volatile: every address derives
// from window words read after the barrier that follows the tables' copy,
// and the tables never change after it, so no reordering can move a read
// before its data.)
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// The 32 window bits from bit pos on, bit pos the most significant.
__device__ __forceinline__ uint32_t bits32(const uint32_t* win, int pos) {
  const int w = pos >> 5;
  return __funnelshift_l(win[w + 1], win[w], pos & 31);
}

// The byte offset of nibble s (from the most significant) of a chunk
// within its table, ORed with the tables' 64-byte aligned address tab:
// one shift and one LOP3.
__device__ __forceinline__ uint32_t nib_addr(uint32_t chunk, int s,
                                             uint32_t tab) {
  const int sh = 26 - 4 * s;
  return ((sh >= 0 ? chunk >> sh : chunk << -sh) & 0x3cu) | tab;
}

// One stage-0 output of Q tap groups (Q = 0: q groups, known at run time)
// whose bits start at window bit pos. Tap k = 4g + i reads bit
// pos + 4q - 1 - k, so group g is the nibble at pos + 4(q - 1 - g), its bit
// i (from the least significant) tap 4g + i's sign; entry nibble of table
// g (16 floats at shared address tab + 64g, tab 64-byte aligned, so that
// one LOP3 forms the address) is the group's subtree sum, and the groups
// are summed in tap order.
template <int Q>
__device__ __forceinline__ float stage0_out(uint32_t tab, const uint32_t* win,
                                            int pos, int q) {
  float acc[MAX_LEVELS];
  if constexpr (Q > 0) {
    constexpr int NW = (4 * Q + 31) / 32;
    uint32_t w[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c) w[c] = bits32(win, pos + 32 * c);
#pragma unroll
    for (int g = 0; g < Q; ++g) {
      const int r = Q - 1 - g;
      tree_push(acc, g, lds(nib_addr(w[r >> 3], r & 7, tab) + 64 * g));
    }
    return tree_total(acc, Q);
  } else {
    for (int g = 0; g < q; ++g)
      tree_push(acc, g,
                lds(nib_addr(bits32(win, pos + 4 * (q - 1 - g)), 0, tab) + 64 * g));
    return tree_total(acc, q);
  }
}

// Four outputs of a ÷2 stage 0 of Q <= 6 groups, at window bits pos,
// pos + 2, pos + 4 and pos + 6. Output pos + 4 reads the nibbles of output
// pos one nibble on (its group g is their group g - 1's), and pos + 6
// those of pos + 2, so each nibble's address serves two table reads: the
// 4Q + 4 taps of two outputs from one chunk of 32 bits.
template <int Q>
__device__ __forceinline__ void stage0_quad(uint32_t tab, const uint32_t* win,
                                            int pos, float (&y)[4]) {
  static_assert(Q >= 1 && Q <= 6, "4Q + 6 bits must fit a 32-bit chunk");
  const int w = pos >> 5;
  const uint64_t ww = ((uint64_t)win[w] << 32) | win[w + 1];
  const uint32_t ca = (uint32_t)((ww << (pos & 31)) >> 32);       // bits pos..
  const uint32_t cb = (uint32_t)((ww << ((pos & 31) + 2)) >> 32); // pos + 2..
  float acc[4][MAX_LEVELS];
#pragma unroll
  for (int g = 0; g < Q; ++g) {
    const uint32_t a0 = nib_addr(ca, Q - 1 - g, tab) + 64 * g;
    const uint32_t a1 = nib_addr(cb, Q - 1 - g, tab) + 64 * g;
    const uint32_t a2 = nib_addr(ca, Q - g, tab) + 64 * g;
    const uint32_t a3 = nib_addr(cb, Q - g, tab) + 64 * g;
    tree_push(acc[0], g, lds(a0));
    tree_push(acc[1], g, lds(a1));
    tree_push(acc[2], g, lds(a2));
    tree_push(acc[3], g, lds(a3));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = tree_total(acc[i], Q);
}

// Stage 0: outputs j = 4t .. 4t + 3 of each thread, to the two polyphase
// halves of stage 1's input (out, out + half[1]), or in order when it is
// the last stage.
template <int Q>
__device__ __forceinline__ void stage0(uint32_t tab, const uint32_t* win,
                                       int base, const DecimParams& p,
                                       float* out) {
  const int m = p.decim0;
  const bool last = p.n_stages == 1;
  float* od = out + (last ? 0 : p.half[1]);
  for (int t = threadIdx.x; t < p.n_out[0] / 4; t += blockDim.x) {
    const int pos = base + 4 * m * t;
    float y[4];
    if constexpr (Q >= 1 && Q <= 6) {
      if (m == 2) {
        stage0_quad<Q>(tab, win, pos, y);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          y[i] = stage0_out<Q>(tab, win, pos + m * i, p.n_groups);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[i] = stage0_out<Q>(tab, win, pos + m * i, p.n_groups);
    }
    if (last) {
      reinterpret_cast<float4*>(out)[t] = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      reinterpret_cast<float2*>(out)[t] = make_float2(y[0], y[2]);
      reinterpret_cast<float2*>(od)[t] = make_float2(y[1], y[3]);
    }
  }
}

// A ÷2 stage of N taps (N = 0: n, known at run time) on the polyphase
// input (in, in + half): thread t computes outputs j = 4t + v, v < VEC, and
// writes them to the next stage's halves (out, out + out_half) or, for the
// last stage, in order. Output j's tap k reads x[2j + d], d = N - 1 - k:
// half d & 1, element 4t + v + d / 2. The thread walks its elements from
// the last down, so each output sees its taps in order k = 0, 1, ...
template <int N>
__device__ __forceinline__ void fir2(const float* h, const float* in,
                                     int half, float* out, int out_half,
                                     int n_vec, bool last, int n) {
  static_assert(VEC == 4, "the stores below write 4 outputs");
  const float4* ev = reinterpret_cast<const float4*>(in);
  const float4* od = reinterpret_cast<const float4*>(in + half);
  const float4* h4 = reinterpret_cast<const float4*>(h);
  for (int t = threadIdx.x; t < n_vec; t += blockDim.x) {
    float y[VEC];
    if constexpr (N > 0) {
      constexpr int NCH = (VEC - 1 + (N - 1) / 2) / 4 + 1;
      float acc[VEC][MAX_LEVELS];
      // taps 4a .. 4a + 3 in hq[a], read by one broadcast float4 load when
      // the first of them is used (next: the next group to read; every
      // index is known at compile time once the loops are unrolled)
      float4 hq[(N + 3) / 4];
      int next = 0;
#pragma unroll
      for (int c = NCH - 1; c >= 0; --c) {
        const float4 e4 = ev[t + c];
        const float4 o4 = od[t + c];
#pragma unroll
        for (int i = 3; i >= 0; --i) {
#pragma unroll
          for (int ph = 1; ph >= 0; --ph) {
            const float xv = lane(ph ? o4 : e4, i);
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const int d = 2 * (4 * c + i - v) + ph;
              if (d >= 0 && d < N) {
                const int k = N - 1 - d;
                if ((k >> 2) == next) hq[next++] = h4[k >> 2];
                tree_push(acc[v], k, __fmul_rn(lane(hq[k >> 2], k & 3), xv));
              }
            }
          }
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) y[v] = tree_total(acc[v], N);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float acc[MAX_LEVELS];
        for (int k = 0; k < n; ++k) {
          const int d = n - 1 - k;
          const float* src = (d & 1) ? in + half : in;
          tree_push(acc, k, __fmul_rn(h[k], src[VEC * t + v + (d >> 1)]));
        }
        y[v] = tree_total(acc, n);
      }
    }
    if (last) {
      reinterpret_cast<float4*>(out)[t] = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      reinterpret_cast<float2*>(out)[t] = make_float2(y[0], y[2]);
      reinterpret_cast<float2*>(out + out_half)[t] = make_float2(y[1], y[3]);
    }
  }
}

// The block's frames m = m0 + j < tile_frames from the last stage's
// outputs y[j]: times p.gain when p.apply_gain, then the epilogue (or the
// planar f32 of K1e); the peak over frames m < n_valid.
template <int BITS, int DITHER, bool PLANAR>
__device__ __forceinline__ void emit(const float* y, uint8_t* out,
                                     float* peak, const DecimParams& p,
                                     int c, long long m0) {
  constexpr int BPS = BITS == 16 ? 2 : (BITS == 32 ? 4 : 3);
  float local_peak = 0.0f;
  for (int j = threadIdx.x; j < p.block_out; j += blockDim.x) {
    const long long m = m0 + j;
    if (m >= p.tile_frames) break;
    float v = y[j];
    if (p.apply_gain) v = __fmul_rn(v, p.gain);
    if constexpr (PLANAR) {
      reinterpret_cast<float*>(out)[c * (long long)p.tile_frames + m] = v;
    } else {
      if (m < p.n_valid) local_peak = fmaxf(local_peak, fabsf(v));
      const uint32_t w = epilogue<BITS, DITHER>(v, (uint32_t)m, (uint32_t)c,
                                                p.key0, p.key1);
      store_wire<BPS>(out + (m * p.channels + c) * BPS, w, p.big_endian);
    }
  }
  if constexpr (!PLANAR) block_peak(local_peak, peak);
}

#define FIR2_CASE(N)                                                  \
  case N:                                                             \
    fir2<N>(h, in, p.half[s], out, out_half, n_vec, last, N);         \
    break;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_decim_kernel(const uint8_t* __restrict__ halo,
                   const uint8_t* __restrict__ x,
                   const float* __restrict__ coefs, uint8_t* __restrict__ out,
                   float* __restrict__ peak, const DecimParams p) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * p.block_out;
  uint32_t* win = reinterpret_cast<uint32_t*>(smem + p.win);
  float* buf_a = smem + p.buf_a;
  float* buf_b = smem + p.buf_b;
  // the coefficients from the first 64-byte boundary on (the region has
  // 16 floats to spare), so that the tables' addresses are one LOP3 each
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t tab = (s0 + 63u) & ~63u;
  float* cf = smem + (tab - s0) / 4;

  for (int i = threadIdx.x; i < p.n_coefs / 4; i += blockDim.x)
    reinterpret_cast<float4*>(cf)[i] = __ldg(reinterpret_cast<const float4*>(coefs) + i);
  const int base = load_window(halo, x, win, p, c, m0);
  __syncthreads();

  switch (p.n_groups) {  // padded stage-0 taps / 4 of the cached chains
    case 1: stage0<1>(tab, win, base, p, buf_a); break;
    case 4: stage0<4>(tab, win, base, p, buf_a); break;
    case 5: stage0<5>(tab, win, base, p, buf_a); break;
    case 6: stage0<6>(tab, win, base, p, buf_a); break;
    case 24: stage0<24>(tab, win, base, p, buf_a); break;
    default: stage0<0>(tab, win, base, p, buf_a); break;
  }
  __syncthreads();

  for (int s = 1; s < p.n_stages; ++s) {
    const float* in = (s & 1) ? buf_a : buf_b;
    float* out = (s & 1) ? buf_b : buf_a;
    const bool last = s == p.n_stages - 1;
    const int out_half = last ? 0 : p.half[s + 1];
    const int n_vec = p.n_out[s] / VEC;
    const float* h = cf + p.tap_off[s];
    switch (p.n_taps[s]) {  // the tap counts of the cached chains' ÷2 stages
      FIR2_CASE(2)
      FIR2_CASE(16)
      FIR2_CASE(18)
      FIR2_CASE(22)
      FIR2_CASE(48)
      FIR2_CASE(56)
      FIR2_CASE(58)
      FIR2_CASE(72)
      FIR2_CASE(78)
      default: fir2<0>(h, in, p.half[s], out, out_half, n_vec, last, p.n_taps[s]); break;
    }
    __syncthreads();
  }

  const float* y = ((p.n_stages - 1) & 1) ? buf_b : buf_a;
  if (p.planar) {
    emit<32, DITHER_NONE, true>(y, out, peak, p, c, m0);
    return;
  }
  switch (p.bit_depth * 4 + p.dither) {
    case 16 * 4 + DITHER_NONE: emit<16, DITHER_NONE, false>(y, out, peak, p, c, m0); break;
    case 16 * 4 + DITHER_TPDF: emit<16, DITHER_TPDF, false>(y, out, peak, p, c, m0); break;
    case 16 * 4 + DITHER_RECT: emit<16, DITHER_RECT, false>(y, out, peak, p, c, m0); break;
    case 20 * 4 + DITHER_NONE: emit<20, DITHER_NONE, false>(y, out, peak, p, c, m0); break;
    case 20 * 4 + DITHER_TPDF: emit<20, DITHER_TPDF, false>(y, out, peak, p, c, m0); break;
    case 20 * 4 + DITHER_RECT: emit<20, DITHER_RECT, false>(y, out, peak, p, c, m0); break;
    case 24 * 4 + DITHER_NONE: emit<24, DITHER_NONE, false>(y, out, peak, p, c, m0); break;
    case 24 * 4 + DITHER_TPDF: emit<24, DITHER_TPDF, false>(y, out, peak, p, c, m0); break;
    case 24 * 4 + DITHER_RECT: emit<24, DITHER_RECT, false>(y, out, peak, p, c, m0); break;
    case 32 * 4 + DITHER_NONE: emit<32, DITHER_NONE, false>(y, out, peak, p, c, m0); break;
    case 32 * 4 + DITHER_FPD: emit<32, DITHER_FPD, false>(y, out, peak, p, c, m0); break;
  }
}

// Let the kernel take all the dynamic shared memory a block may have
// (MAX_SMEM less its static warp maxima), and prefer shared memory over L1
// (it reads each input byte once).
static cudaError_t set_attributes() {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fused_decim_kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_decim_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM - (int)a.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_decim_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
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
  if (p->n_stages < 1 || p->n_stages > MAX_STAGES || p->tile_frames < 1 ||
      p->smem_bytes > MAX_SMEM || p->n_coefs % 4 || !valid_epilogue(p))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = check_device(device);
  if (e != cudaSuccess) return (int)e;
  e = set_attributes();
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
  e = set_attributes();
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
