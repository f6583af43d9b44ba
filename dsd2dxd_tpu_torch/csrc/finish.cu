// K2: the finish of the 48k-family chains -- final-rate f32 samples to wire
// bytes and the peak -- in two modes, one launch per tile either way.
//
// Replaces the TPU kernel dsd2dxd_tpu/ops/fused.py::make_finish_planes (its
// pallas_call), and, for 32-bit float output, the XLA epilogue
// dsd2dxd_tpu/ops/phase.py::finish_tile that the JAX package runs there;
// the second mode also takes in the ×160/147 stage that the JAX package
// leaves to XLA (phase.stage_apply_rational_natural).
//
// Mode "from z" (finish_kernel; plain version ops/fused.py::
// finish_reference): per channel c and frame m of the (C, n_frames) f32
// tile z,
//   y = gain * z[c][m]; peak = max |y| over m < n_valid
//   the wire word of y by epilogue<BITS, DITHER> (epilogue.cuh, the same
//   code K1 finishes its samples with: 16/20/24-bit NONE/TPDF/RECT, 32-bit
//   NONE/FPD), dither counter (m, c, 0, 0) under the tile's key
//   frame-interleaved wire bytes, little endian for WAV and raw output, big
//   endian for AIFF/AIFC.
//
// Mode "from the head's samples" (finish_tail_kernel; plain version
// ops/rational.py::rational_tail_reference, then finish_reference): z is
// never written. The input is the head's (C, 147 K) f32 samples y (K1e) and
// the (C, 147) history of the previous tile. Band block k -- the nhist
// samples before input sample 147 k, then its 147 samples -- gives final
// frames 160 k .. 160 k + 159: frame 160 k + rho is the sum over t < T of
//   coefs[rho][t] * window_k[offs[rho] + t]
// (the T consecutive entries of row rho of the band that hold all its
// nonzeros; ops/rational.py::tail_table), each product __fmul_rn, added
// with __fadd_rn in the order of plan.tree_sum (tree_sum.cuh), so the sum
// is bit-equal to the plain version's. Then the same finish as above.
//
// What bounds it on an H100: "from z" moves 4 bytes in and 2-4 out per
// sample and, when dithered, runs one Philox4x32-10 call per sample (in
// SASS 17 32x32->64 multiplies and 18 xors, on separate pipes); by the
// card's peak rates the calls take about half the time of the bytes.
// Measured (PERF.md): undithered it runs at two thirds of the memory rate;
// dithered, the Philox calls take as long again and the time no longer
// depends on the bytes per sample: the bytes are the bound, the integer
// instructions are what holds it back. "From the head's
// samples" does 2 T f32 operations and 1.25 T shared-memory reads per
// sample on top of that.
// Design:
// - a block owns runs of F consecutive frames of all C channels (F a
//   multiple of 16 -- a power of two "from z", 640 with the tail -- so a
//   run's F C bps wire bytes start and end on 16-byte boundaries at 2, 3
//   and 4 bytes per sample), and walks over the tile's runs; the grid is
//   the blocks the card keeps resident, so the peak costs one atomicMax
//   per block;
// - a thread puts its wire words into shared memory in wire order (byte
//   order and the 20-bit shift applied first), and the block flushes the
//   run with 16-byte stores, neighbouring threads on neighbouring
//   addresses; only the ragged end of a tile's last run goes out byte by
//   byte;
// - a thread finishes four samples at a time, so four Philox chains are in
//   flight; "from z" reads them with one 16-byte load where the row is
//   aligned (scalar loads elsewhere);
// - "from the head's samples": a run is TAIL_B band blocks (640 frames). The
//   block copies their 147 TAIL_B input samples per channel to shared
//   memory (16-byte loads where y's row is aligned; the nhist samples
//   before them from y, or from the history at the tile's start), keeps the
//   coefficient table there (row stride odd, so a warp's 32 phases fall in
//   32 banks), copies the next run's window (cp.async) while it sums this
//   one, and thread (c, rho) computes phase rho of all TAIL_B band
//   blocks of channel c: each coefficient is read once for four outputs. A
//   warp is 32 consecutive phases of one channel, so its window reads are
//   consecutive words. The tap counts of the cached chains (16, 18, 19)
//   have a case each, unrolled; any other is refused.
// The TPU kernel's blocked plane layout and its (8, 128) sub-blocks exist
// only for the host interleaver of the TPU path and are not carried over.

#include <cstdint>
#include <mutex>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include "device_check.cuh"
#include "epilogue.cuh"
#include "tree_sum.cuh"

#define P_IN 147          // input samples per band block
#define P_OUT 160         // final frames per band block
#define TAIL_B 4          // band blocks per run: 147 * 4 * 4 bytes = 16 * 147
static_assert(TAIL_B == 4, "finish4 takes four samples");
#define TAIL_THREADS 320  // two channels' 160 phases: 10 warps
#define TAIL_MIN_BLOCKS 3
#define MAX_SMEM (227 * 1024)
#define MAX_Z_SMEM (40 * 1024)  // "from z": staged bytes, of a block's 48 KB

struct FinishParams {
  long long n_frames;  // final frames per channel (160 * n_blocks in tail mode)
  long long n_valid;   // frames m >= n_valid leave the peak alone
  int channels;
  float gain;          // y = gain * z (exact for gain 1)
  int bit_depth;       // 16, 20, 24 (integer) or 32 (float)
  int dither;          // DITHER_*
  uint32_t key0;
  uint32_t key1;
  int big_endian;
  int run_frames;      // from z: F, frames per run (a power of two >= 16)
  int n_blocks;        // tail: K, band blocks per channel; y is (C, 147 K)
  int nhist;           // tail: samples before a band block that it reads
  int n_taps;          // tail: T, entries per phase
  int coef_stride;     // tail: floats per row of the table (odd, >= T)
  int win_stride;      // tail: floats per channel of the window buffer
  int smem_bytes;      // tail: dynamic shared memory of a block
};

__host__ __device__ constexpr int bytes_per_sample(int bits) {
  return bits == 16 ? 2 : (bits == 32 ? 4 : 3);
}

// The low BPS bytes of w as the word whose bytes, low first, are the wire's.
template <int BPS>
__device__ __forceinline__ uint32_t wire_order(uint32_t w, int big_endian) {
  // one permute and one shift, their operands the same for a whole launch
  return __byte_perm(w, 0, big_endian ? 0x0123 : 0x3210) >>
         (big_endian ? 32 - 8 * BPS : 0);
}

// The low BPS bytes of v to shared memory at s (BPS-aligned for 2 and 4).
template <int BPS>
__device__ __forceinline__ void stage_word(uint8_t* s, uint32_t v) {
  if constexpr (BPS == 4) {
    *reinterpret_cast<uint32_t*>(s) = v;
  } else if constexpr (BPS == 2) {
    *reinterpret_cast<uint16_t*>(s) = (uint16_t)v;
  } else {
    s[0] = (uint8_t)v;
    s[1] = (uint8_t)(v >> 8);
    s[2] = (uint8_t)(v >> 16);
  }
}

// A run's staged bytes to `out` (both 16-byte aligned): 16-byte stores, then
// the last nbytes % 16 one by one (only a tile's ragged last run has any).
__device__ __forceinline__ void flush_run(const uint8_t* stage, uint8_t* out,
                                          int nbytes) {
  const int n16 = nbytes >> 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(stage);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) __stcs(o4 + i, s4[i]);
  for (int i = (n16 << 4) + threadIdx.x; i < nbytes; i += blockDim.x)
    out[i] = stage[i];
}

// Finish four samples v[k] (already gain-scaled) of channel c: sample k is
// frame m + stride * k of the tile, frame j + stride * k of the run whose
// bytes are staged at `stage`; only the first n_live are real. Folds |v|
// of frames below n_valid into local_peak.
template <int BITS, int DITHER>
__device__ __forceinline__ void finish4(const float (&v)[4], long long m,
                                        int j, int stride, int n_live, int c,
                                        const FinishParams& p, uint8_t* stage,
                                        float& local_peak) {
  constexpr int BPS = bytes_per_sample(BITS);
  // frames from m on that count for the peak, as an int
  const long long left = p.n_valid - m;
  const int n_peak =
      left > 0x7fffffffLL ? 0x7fffffff : (left < 0 ? 0 : (int)left);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = epilogue<BITS, DITHER>(v[k], (uint32_t)(m + stride * k),
                                  (uint32_t)c, p.key0, p.key1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < n_live) {
      if (stride * k < n_peak) local_peak = fmaxf(local_peak, fabsf(v[k]));
      stage_word<BPS>(stage + ((j + stride * k) * p.channels + c) * BPS,
                      wire_order<BPS>(w[k], p.big_endian));
    }
  }
}

// -- mode "from z" ------------------------------------------------------------

// Item i of a run is channel i / (F / 4), frames 4 (i % (F / 4)) .. + 3 (F a
// power of two: a shift and a mask), so a warp reads 512 consecutive bytes
// of one row of z. The runs' bytes are staged in two buffers in turn: one
// barrier per run orders a buffer's flush before the writes of the run
// after the next.
template <int BITS, int DITHER>
__global__ void __launch_bounds__(THREADS)
finish_kernel(const float* __restrict__ z, uint8_t* __restrict__ out,
              float* __restrict__ peak, const FinishParams p) {
  constexpr int BPS = bytes_per_sample(BITS);
  extern __shared__ __align__(16) uint8_t stage_z[];
  const int F = p.run_frames;
  const int groups = F / 4;
  const int group_shift = 31 - __clz(groups);
  const int run_bytes = F * p.channels * BPS;
  const long long n_runs = (p.n_frames + F - 1) / F;
  float local_peak = 0.0f;
  int buf = 0;
  for (long long r = blockIdx.x; r < n_runs; r += gridDim.x, buf ^= 1) {
    uint8_t* stage = stage_z + buf * run_bytes;
    const long long m0 = r * F;
    const int frames = (int)min((long long)F, p.n_frames - m0);
    for (int i = threadIdx.x; i < p.channels * groups; i += blockDim.x) {
      const int c = i >> group_shift;
      const int j = 4 * (i & (groups - 1));
      const int n_live = min(4, frames - j);
      if (n_live <= 0) continue;
      const float* src = z + c * p.n_frames + m0 + j;
      float v[4];
      if (n_live == 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4 q = __ldcs(reinterpret_cast<const float4*>(src));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = k < n_live ? __ldcs(src + k) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(v[k], p.gain);
      finish4<BITS, DITHER>(v, m0 + j, j, 1, n_live, c, p, stage, local_peak);
    }
    __syncthreads();
    flush_run(stage, out + m0 * p.channels * BPS, frames * p.channels * BPS);
  }
  block_peak(local_peak, peak);
}

// -- mode "from the head's samples" ------------------------------------------

// Phase sums of the TAIL_B band blocks of a run for one (channel, phase):
// z[b] = tree sum over t < T of h[t] * w[147 b + t], w the channel's window
// from the phase's first entry on.
template <int T>
__device__ __forceinline__ void band_sums(const float* h, const float* w,
                                          float (&z)[TAIL_B]) {
  float acc[TAIL_B][MAX_LEVELS];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float ht = h[t];
#pragma unroll
    for (int b = 0; b < TAIL_B; ++b)
      tree_push(acc[b], t, __fmul_rn(ht, w[P_IN * b + t]));
  }
#pragma unroll
  for (int b = 0; b < TAIL_B; ++b) z[b] = tree_total(acc[b], T);
}

#define FINISH4_CASE(BITS, DITHER)                                         \
  case BITS * 4 + DITHER:                                                  \
    finish4<BITS, DITHER>(v, m0 + rho, rho, P_OUT, n_live, c, p, stage,    \
                          local_peak);                                     \
    break;

// Start the copy of run r's window to `win` (channels rows of win_stride):
// the run's own samples from slot `pad` on (16-byte copies where y's row is
// aligned), before them the nhist samples that precede the run -- the
// previous run's last, or the history's (the last P_IN samples of the
// previous tile). Asynchronous: the caller commits and waits.
__device__ __forceinline__ void start_window(const float* y, const float* hist,
                                             float* win, const FinishParams& p,
                                             int r, int pad) {
  const long long n_base = (long long)P_IN * p.n_blocks;
  const long long s0 = (long long)P_IN * TAIL_B * r;  // first input sample
  const int n_in = P_IN * min(TAIL_B, p.n_blocks - r * TAIL_B);
  for (int c = 0; c < p.channels; ++c) {
    const float* row = y + c * n_base;
    const float* src = row + s0;
    float* wc = win + c * p.win_stride + pad;
    const int n4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n_in >> 2 : 0;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      __pipeline_memcpy_async(wc + 4 * i, src + 4 * i, 16);
    for (int i = 4 * n4 + threadIdx.x; i < n_in; i += blockDim.x)
      __pipeline_memcpy_async(wc + i, src + i, 4);
    for (int i = threadIdx.x; i < p.nhist; i += blockDim.x) {
      const long long s = s0 - p.nhist + i;
      __pipeline_memcpy_async(wc + i - p.nhist,
                              s >= 0 ? row + s : hist + c * P_IN + P_IN + s, 4);
    }
  }
}

// Shared memory (f32 slots): the table (160 rows of coef_stride, rounded up
// to 4), the phases' offsets (160 ints), two windows (each channels rows of
// win_stride: a band block's first sample at slot `pad`, nhist rounded up to
// 4, so that the run's samples land 16-byte aligned), the staged run. The
// next run's window is copied (cp.async) while this one is summed. Two
// barriers per run: window landed / bytes staged.
template <int T>
__global__ void __launch_bounds__(TAIL_THREADS, TAIL_MIN_BLOCKS)
finish_tail_kernel(const float* __restrict__ y, const float* __restrict__ hist,
                   const float* __restrict__ coefs,
                   const int* __restrict__ offs, uint8_t* __restrict__ out,
                   float* __restrict__ peak, const FinishParams p) {
  extern __shared__ __align__(16) float smem[];
  const int table_len = (P_OUT * p.coef_stride + 3) & ~3;
  const int win_len = p.channels * p.win_stride;
  float* cf = smem;
  int* of = reinterpret_cast<int*>(smem + table_len);
  float* wins = smem + table_len + P_OUT;
  uint8_t* stage = reinterpret_cast<uint8_t*>(wins + 2 * win_len);
  const int pad = (p.nhist + 3) & ~3;
  const int bps = bytes_per_sample(p.bit_depth);
  const int n_runs = (p.n_blocks + TAIL_B - 1) / TAIL_B;
  const int epi = p.bit_depth * 4 + p.dither;

  if (blockIdx.x < n_runs) start_window(y, hist, wins, p, blockIdx.x, pad);
  __pipeline_commit();
  for (int i = threadIdx.x; i < P_OUT * p.coef_stride; i += blockDim.x)
    cf[i] = coefs[i];
  for (int i = threadIdx.x; i < P_OUT; i += blockDim.x) of[i] = offs[i];

  float local_peak = 0.0f;
  int buf = 0;
  for (int r = blockIdx.x; r < n_runs; r += gridDim.x, buf ^= 1) {
    const float* win = wins + buf * win_len;
    if (r + gridDim.x < n_runs)
      start_window(y, hist, wins + (buf ^ 1) * win_len, p, r + gridDim.x, pad);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this run's window, all but the next run's
    __syncthreads();

    const int nb = min(TAIL_B, p.n_blocks - r * TAIL_B);
    const long long m0 = (long long)P_OUT * TAIL_B * r;  // first final frame
    for (int i = threadIdx.x; i < p.channels * P_OUT; i += blockDim.x) {
      const int c = i / P_OUT;
      const int rho = i - c * P_OUT;
      float v[TAIL_B];
      band_sums<T>(cf + rho * p.coef_stride,
                   win + c * p.win_stride + pad - p.nhist + of[rho], v);
#pragma unroll
      for (int b = 0; b < TAIL_B; ++b) v[b] = __fmul_rn(v[b], p.gain);
      const int n_live = nb;
      switch (epi) {
        FINISH4_CASE(16, DITHER_NONE)
        FINISH4_CASE(16, DITHER_TPDF)
        FINISH4_CASE(16, DITHER_RECT)
        FINISH4_CASE(20, DITHER_NONE)
        FINISH4_CASE(20, DITHER_TPDF)
        FINISH4_CASE(20, DITHER_RECT)
        FINISH4_CASE(24, DITHER_NONE)
        FINISH4_CASE(24, DITHER_TPDF)
        FINISH4_CASE(24, DITHER_RECT)
        FINISH4_CASE(32, DITHER_NONE)
        FINISH4_CASE(32, DITHER_FPD)
      }
    }
    __syncthreads();
    flush_run(stage, out + m0 * p.channels * bps,
              P_OUT * nb * p.channels * bps);
  }
  block_peak(local_peak, peak);
}

// -- launches ---------------------------------------------------------------------

// The blocks of `kernel` the card keeps resident at once (at least 1), or
// a negative CUDA error. A launch asks the card only when the block or its
// shared memory differ from the launch before on the same device (`memo`,
// one slot per device ordinal for each kernel, so cards launching in turn
// keep their own): a conversion repeats one shape tile after tile.
// `dev` is the current device, checked by the entry (check_device).
struct Resident {
  int threads = 0, smem_bytes = 0, blocks = 0;
};

template <typename Kernel>
static int resident_blocks(Kernel kernel, int dev, int threads, int smem_bytes,
                           int max_smem_bytes, Resident* memo) {
  static std::mutex lock;
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaSuccess;
  std::lock_guard<std::mutex> guard(lock);
  Resident& m = memo[dev];
  if (m.threads == threads && m.smem_bytes == smem_bytes) return m.blocks;
  if (max_smem_bytes > 0)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem_bytes);
  if (e != cudaSuccess) return -(int)e;
  m = {threads, smem_bytes, sms * (per_sm > 0 ? per_sm : 1)};
  return m.blocks;
}

static bool valid_params(const FinishParams* p) {
  if (p->n_frames < 1 || p->channels < 1) return false;
  switch (p->bit_depth) {
    case 16: case 20: case 24:
      return p->dither == DITHER_NONE || p->dither == DITHER_TPDF ||
             p->dither == DITHER_RECT;
    case 32: return p->dither == DITHER_NONE || p->dither == DITHER_FPD;
    default: return false;
  }
}

template <int BITS, int DITHER>
static int launch(const void* z, void* out, void* peak, const FinishParams* p,
                  cudaStream_t stream, int dev) {
  const int smem = 2 * p->run_frames * p->channels * bytes_per_sample(BITS);
  if (smem > MAX_Z_SMEM) return (int)cudaErrorInvalidValue;
  static Resident memo[MAX_DEVICES];
  const int resident =
      resident_blocks(finish_kernel<BITS, DITHER>, dev, THREADS, smem, 0, memo);
  if (resident < 0) return -resident;
  const long long n_runs = (p->n_frames + p->run_frames - 1) / p->run_frames;
  const unsigned grid = (unsigned)(n_runs < resident ? n_runs : resident);
  finish_kernel<BITS, DITHER><<<grid, THREADS, smem, stream>>>(
      (const float*)z, (uint8_t*)out, (float*)peak, *p);
  return (int)cudaGetLastError();
}

template <int T>
static int launch_tail(const void* y, const void* hist, const void* coefs,
                       const void* offs, void* out, void* peak,
                       const FinishParams* p, cudaStream_t stream, int dev) {
  const int threads = p->channels == 1 ? TAIL_THREADS / 2 : TAIL_THREADS;
  static Resident memo[MAX_DEVICES];
  const int resident = resident_blocks(finish_tail_kernel<T>, dev, threads,
                                       p->smem_bytes, MAX_SMEM - 256, memo);
  if (resident < 0) return -resident;
  const int n_runs = (p->n_blocks + TAIL_B - 1) / TAIL_B;
  const unsigned grid = (unsigned)(n_runs < resident ? n_runs : resident);
  finish_tail_kernel<T><<<grid, threads, p->smem_bytes, stream>>>(
      (const float*)y, (const float*)hist, (const float*)coefs,
      (const int*)offs, (uint8_t*)out, (float*)peak, *p);
  return (int)cudaGetLastError();
}

extern "C" int dsd2dxd_finish_params_size() { return (int)sizeof(FinishParams); }

// Mode "from z": z (C, n_frames) f32 -> out (n_frames * C * bps) wire bytes.
extern "C" int dsd2dxd_finish(const void* z, void* out, void* peak,
                              const FinishParams* p, void* stream, int dev) {
  if (!valid_params(p) || p->run_frames < 16 ||
      (p->run_frames & (p->run_frames - 1)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = check_device(dev);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p->bit_depth * 4 + p->dither) {
    case 16 * 4 + DITHER_NONE: return launch<16, DITHER_NONE>(z, out, peak, p, s, dev);
    case 16 * 4 + DITHER_TPDF: return launch<16, DITHER_TPDF>(z, out, peak, p, s, dev);
    case 16 * 4 + DITHER_RECT: return launch<16, DITHER_RECT>(z, out, peak, p, s, dev);
    case 20 * 4 + DITHER_NONE: return launch<20, DITHER_NONE>(z, out, peak, p, s, dev);
    case 20 * 4 + DITHER_TPDF: return launch<20, DITHER_TPDF>(z, out, peak, p, s, dev);
    case 20 * 4 + DITHER_RECT: return launch<20, DITHER_RECT>(z, out, peak, p, s, dev);
    case 24 * 4 + DITHER_NONE: return launch<24, DITHER_NONE>(z, out, peak, p, s, dev);
    case 24 * 4 + DITHER_TPDF: return launch<24, DITHER_TPDF>(z, out, peak, p, s, dev);
    case 24 * 4 + DITHER_RECT: return launch<24, DITHER_RECT>(z, out, peak, p, s, dev);
    case 32 * 4 + DITHER_NONE: return launch<32, DITHER_NONE>(z, out, peak, p, s, dev);
    case 32 * 4 + DITHER_FPD: return launch<32, DITHER_FPD>(z, out, peak, p, s, dev);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Mode "from the head's samples": y (C, 147 n_blocks) f32, hist (C, 147)
// f32, the table's coefs (160, coef_stride) f32 and offs (160) i32 -> out
// (160 n_blocks * C * bps) wire bytes.
extern "C" int dsd2dxd_finish_tail(const void* y, const void* hist,
                                   const void* coefs, const void* offs,
                                   void* out, void* peak,
                                   const FinishParams* p, void* stream,
                                   int dev) {
  const int pad = (p->nhist + 3) & ~3;
  if (!valid_params(p) || p->n_blocks < 1 ||
      p->n_frames != (long long)P_OUT * p->n_blocks || p->nhist < 1 ||
      p->nhist > P_IN || p->coef_stride < p->n_taps || p->win_stride % 4 ||
      p->win_stride < pad + P_IN * TAIL_B || p->smem_bytes > MAX_SMEM - 256 ||
      p->smem_bytes <
          4 * (((P_OUT * p->coef_stride + 3) & ~3) + P_OUT +
               2 * p->channels * p->win_stride) +
              P_OUT * TAIL_B * p->channels * bytes_per_sample(p->bit_depth))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = check_device(dev);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p->n_taps) {  // the entries per phase of the cached 48k chains
    case 16: return launch_tail<16>(y, hist, coefs, offs, out, peak, p, s, dev);
    case 18: return launch_tail<18>(y, hist, coefs, offs, out, peak, p, s, dev);
    case 19: return launch_tail<19>(y, hist, coefs, offs, out, peak, p, s, dev);
    default: return (int)cudaErrorInvalidValue;
  }
}
