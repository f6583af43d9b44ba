// The body of the fused decimation kernel (K1, fused_decim.cu), shared with
// its floor probes (probes.cu): the block's packed window copy, stage 0
// through the tap tables, the ÷2 stages, the epilogue, and the kernel body
// itself as a template on a rung.
//
// decim_body<RUNG_FULL> is K1 (fused_decim_kernel). The other rungs are P2
// (probes.cu, probe_step_kernel): the same body stopped after
//   RUNG_DMA     the coefficients' and the packed window's copy to shared
//                memory; out[c][m] = the block's j-th window byte as f32
//                (frame m = m0 + j), the cheapest store that depends on them
//   RUNG_UNPACK  + stage 0 through the exact 4-tap tables (the body has no
//                separate unpack: the tables turn bits into products);
//                out[c][m] = stage 0's output j of the block
//   RUNG_CAS0A   + the ÷2 stages, with every stage-0 read of 32 window bits
//                taken as the aligned word that holds its first bit (no
//                funnel shift) and every read of the generic ÷2 loop
//                rounded down to its float4 (the unrolled tap counts read
//                aligned float4 already); planar f32, numerically wrong on
//                purpose
//   RUNG_CAS0    + the real cascade and the peak over frames m < n_valid;
//                planar f32 at the launch's gain (K1e's output)
//   RUNG_QUANT   + K1's 24-bit epilogue (emit's dither, rint, clip) at
//                DITHER, as int32 words
// so the rungs differ from K1 and from each other only in where the body
// stops. Plain versions: dsd2dxd_tpu_torch/tools/floorstrip.py.
//
// P1 (probes.cu, dma_probe_kernel) copies its window with copy_span, K1's
// 16-byte copy of the aligned span.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "tree_sum.cuh"

#define MAX_STAGES 8   // must equal kernels.MAX_STAGES
#define VEC 4          // outputs per thread of a ÷2 float stage (kernels.VEC)
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

enum { RUNG_DMA = 0, RUNG_UNPACK = 1, RUNG_CAS0A = 2, RUNG_CAS0 = 3,
       RUNG_QUANT = 4, RUNG_FULL = 5 };

// What emit stores per frame: K1's wire bytes, or planar f32 samples or
// int32 epilogue words, out[c * tile_frames + m].
enum { OUT_WIRE = 0, OUT_F32 = 1, OUT_I32 = 2 };

__device__ __forceinline__ float lane(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// The n bytes from src on to dst as big-endian words, by the block's
// threads in 16-byte loads of the aligned span that covers them (each
// chunk holds a byte of the span, so it lies in the span's allocation):
// returns the offset (0-15) of src's first byte in dst.
__device__ __forceinline__ int copy_span(const uint8_t* src, int n,
                                         uint32_t* dst) {
  const int s = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const uint4* src4 = reinterpret_cast<const uint4*>(src - s);
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < (s + n + 15) >> 4; i += blockDim.x) {
    uint4 v = __ldg(src4 + i);
    v.x = __byte_perm(v.x, 0, 0x0123);
    v.y = __byte_perm(v.y, 0, 0x0123);
    v.z = __byte_perm(v.z, 0, 0x0123);
    v.w = __byte_perm(v.w, 0, 0x0123);
    dst4[i] = v;
  }
  return s;
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
  if (wb0 >= H && wb0 + n <= H + T)  // inside the tile
    return 8 * copy_span(x + c * T + (wb0 - H), n, win) + p.bit_off;
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

// Stage 0's read of 32 window bits from bit pos: bits32, or with ALIGNED
// (P2's cas0a) the aligned word that holds bit pos, no shift.
template <bool ALIGNED>
__device__ __forceinline__ uint32_t chunk32(const uint32_t* win, int pos) {
  if constexpr (ALIGNED) {
    return win[pos >> 5];
  } else {
    return bits32(win, pos);
  }
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
template <int Q, bool ALIGNED = false>
__device__ __forceinline__ float stage0_out(uint32_t tab, const uint32_t* win,
                                            int pos, int q) {
  float acc[MAX_LEVELS];
  if constexpr (Q > 0) {
    constexpr int NW = (4 * Q + 31) / 32;
    uint32_t w[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c) w[c] = chunk32<ALIGNED>(win, pos + 32 * c);
#pragma unroll
    for (int g = 0; g < Q; ++g) {
      const int r = Q - 1 - g;
      tree_push(acc, g, lds(nib_addr(w[r >> 3], r & 7, tab) + 64 * g));
    }
    return tree_total(acc, Q);
  } else {
    for (int g = 0; g < q; ++g)
      tree_push(acc, g,
                lds(nib_addr(chunk32<ALIGNED>(win, pos + 4 * (q - 1 - g)), 0,
                             tab) + 64 * g));
    return tree_total(acc, q);
  }
}

// Four outputs of a ÷2 stage 0 of Q <= 6 groups, at window bits pos,
// pos + 2, pos + 4 and pos + 6. Output pos + 4 reads the nibbles of output
// pos one nibble on (its group g is their group g - 1's), and pos + 6
// those of pos + 2, so each nibble's address serves two table reads: the
// 4Q + 4 taps of two outputs from one chunk of 32 bits. ALIGNED: the two
// chunks are the aligned words that hold bits pos and pos + 2.
template <int Q, bool ALIGNED = false>
__device__ __forceinline__ void stage0_quad(uint32_t tab, const uint32_t* win,
                                            int pos, float (&y)[4]) {
  static_assert(Q >= 1 && Q <= 6, "4Q + 6 bits must fit a 32-bit chunk");
  uint32_t ca, cb;
  if constexpr (ALIGNED) {
    ca = win[pos >> 5];
    cb = win[(pos + 2) >> 5];
  } else {
    const int w = pos >> 5;
    const uint64_t ww = ((uint64_t)win[w] << 32) | win[w + 1];
    ca = (uint32_t)((ww << (pos & 31)) >> 32);        // bits pos..
    cb = (uint32_t)((ww << ((pos & 31) + 2)) >> 32);  // pos + 2..
  }
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
template <int Q, bool ALIGNED = false>
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
        stage0_quad<Q, ALIGNED>(tab, win, pos, y);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          y[i] = stage0_out<Q, ALIGNED>(tab, win, pos + m * i, p.n_groups);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        y[i] = stage0_out<Q, ALIGNED>(tab, win, pos + m * i, p.n_groups);
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
// half d & 1, element 4t + v + d / 2 (ALIGNED, N = 0: that element rounded
// down to a multiple of 4). The thread walks its elements from the last
// down, so each output sees its taps in order k = 0, 1, ...
template <int N, bool ALIGNED = false>
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
          const int e = VEC * t + v + (d >> 1);
          tree_push(acc, k, __fmul_rn(h[k], src[ALIGNED ? e & ~3 : e]));
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
// outputs y[j]: times p.gain when p.apply_gain, then (OUT_WIRE) the
// epilogue's wire bytes, (OUT_I32) its int32 word or (OUT_F32) the f32
// sample, planar; with PEAK the peak over frames m < n_valid.
template <int BITS, int DITHER, int OUT, bool PEAK>
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
    if constexpr (PEAK) {
      if (m < p.n_valid) local_peak = fmaxf(local_peak, fabsf(v));
    }
    if constexpr (OUT == OUT_F32) {
      reinterpret_cast<float*>(out)[c * (long long)p.tile_frames + m] = v;
    } else {
      const uint32_t w = epilogue<BITS, DITHER>(v, (uint32_t)m, (uint32_t)c,
                                                p.key0, p.key1);
      if constexpr (OUT == OUT_WIRE) {
        store_wire<BPS>(out + (m * p.channels + c) * BPS, w, p.big_endian);
      } else {
        reinterpret_cast<int32_t*>(out)[c * (long long)p.tile_frames + m] =
            (int32_t)w;
      }
    }
  }
  if constexpr (PEAK) block_peak(local_peak, peak);
}

// out[c * tile_frames + m] = v(j) for the block's frames m = m0 + j.
template <typename F>
__device__ __forceinline__ void store_planar(uint8_t* out,
                                             const DecimParams& p, int c,
                                             long long m0, F v) {
  for (int j = threadIdx.x; j < p.block_out; j += blockDim.x) {
    const long long m = m0 + j;
    if (m >= p.tile_frames) break;
    reinterpret_cast<float*>(out)[c * (long long)p.tile_frames + m] = v(j);
  }
}

// A rung's exit: true in every launch (tile_frames >= 1), but not to the
// compiler, so a rung kernel keeps all of K1's code after its exit and
// ptxas allocates the part before it as it does in K1 (cut at compile
// time, the rungs from cas0a on took a stack frame and local loads that K1
// does not have).
__device__ __forceinline__ bool rung_exit(const DecimParams& p) {
  return p.tile_frames > 0;
}

#define FIR2_CASE(N)                                                   \
  case N:                                                              \
    fir2<N, ALIGNED>(h, in, p.half[s], out, out_half, n_vec, last, N); \
    break;

// The kernel body for block (blockIdx.x, channel blockIdx.y), stopped
// after RUNG (see the top of this file) by a rung_exit; RUNG_FULL is K1.
// DITHER is the quant rung's; K1 chooses its epilogue per launch.
template <int RUNG, int DITHER = DITHER_NONE>
__device__ __forceinline__ void decim_body(const uint8_t* __restrict__ halo,
                                           const uint8_t* __restrict__ x,
                                           const float* __restrict__ coefs,
                                           uint8_t* __restrict__ out,
                                           float* __restrict__ peak,
                                           const DecimParams& p) {
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

  if constexpr (RUNG == RUNG_DMA) {
    if (rung_exit(p)) {
      const int b0 = (base - p.bit_off) >> 3;  // the window's first byte
      store_planar(out, p, c, m0, [&](int j) {
        const int b = b0 + j;
        return (float)((win[b >> 2] >> (24 - 8 * (b & 3))) & 0xffu);
      });
      return;
    }
  }
  constexpr bool ALIGNED = RUNG == RUNG_CAS0A;
  switch (p.n_groups) {  // padded stage-0 taps / 4 of the cached chains
    case 1: stage0<1, ALIGNED>(tab, win, base, p, buf_a); break;
    case 4: stage0<4, ALIGNED>(tab, win, base, p, buf_a); break;
    case 5: stage0<5, ALIGNED>(tab, win, base, p, buf_a); break;
    case 6: stage0<6, ALIGNED>(tab, win, base, p, buf_a); break;
    case 24: stage0<24, ALIGNED>(tab, win, base, p, buf_a); break;
    default: stage0<0, ALIGNED>(tab, win, base, p, buf_a); break;
  }
  __syncthreads();

  if constexpr (RUNG == RUNG_UNPACK) {
    if (rung_exit(p)) {
      // stage 0's output j: in order, or in its polyphase half
      const int h1 = p.n_stages == 1 ? 0 : p.half[1];
      const int sh = p.n_stages == 1 ? 0 : 1;
      store_planar(out, p, c, m0, [&](int j) {
        return buf_a[(j & sh) * h1 + (j >> sh)];
      });
      return;
    }
  }

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
      default:
        fir2<0, ALIGNED>(h, in, p.half[s], out, out_half, n_vec, last,
                         p.n_taps[s]);
        break;
    }
    __syncthreads();
  }

  const float* y = ((p.n_stages - 1) & 1) ? buf_b : buf_a;
  if constexpr (RUNG == RUNG_CAS0A) {
    if (rung_exit(p)) {
      emit<32, DITHER_NONE, OUT_F32, false>(y, out, peak, p, c, m0);
      return;
    }
  } else if constexpr (RUNG == RUNG_CAS0) {
    if (rung_exit(p)) {
      emit<32, DITHER_NONE, OUT_F32, true>(y, out, peak, p, c, m0);
      return;
    }
  } else if constexpr (RUNG == RUNG_QUANT) {
    if (rung_exit(p)) {
      emit<24, DITHER, OUT_I32, true>(y, out, peak, p, c, m0);
      return;
    }
  }
  if (p.planar) {
    emit<32, DITHER_NONE, OUT_F32, false>(y, out, peak, p, c, m0);
    return;
  }
  switch (p.bit_depth * 4 + p.dither) {
    case 16 * 4 + DITHER_NONE: emit<16, DITHER_NONE, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 16 * 4 + DITHER_TPDF: emit<16, DITHER_TPDF, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 16 * 4 + DITHER_RECT: emit<16, DITHER_RECT, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 20 * 4 + DITHER_NONE: emit<20, DITHER_NONE, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 20 * 4 + DITHER_TPDF: emit<20, DITHER_TPDF, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 20 * 4 + DITHER_RECT: emit<20, DITHER_RECT, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 24 * 4 + DITHER_NONE: emit<24, DITHER_NONE, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 24 * 4 + DITHER_TPDF: emit<24, DITHER_TPDF, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 24 * 4 + DITHER_RECT: emit<24, DITHER_RECT, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 32 * 4 + DITHER_NONE: emit<32, DITHER_NONE, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
    case 32 * 4 + DITHER_FPD: emit<32, DITHER_FPD, OUT_WIRE, true>(y, out, peak, p, c, m0); break;
  }
}

#undef FIR2_CASE

// Let `kernel` (K1 or a rung) take all the dynamic shared memory a block
// may have (MAX_SMEM less its static bytes), and prefer shared memory over
// L1 (it reads each input byte once).
template <typename Kernel>
static cudaError_t set_decim_attributes(Kernel kernel) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM - (int)a.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// The geometry a launch of the body needs.
static inline bool valid_decim_params(const DecimParams* p) {
  return p->n_stages >= 1 && p->n_stages <= MAX_STAGES &&
         p->tile_frames >= 1 && p->smem_bytes <= MAX_SMEM &&
         p->n_coefs % 4 == 0;
}
