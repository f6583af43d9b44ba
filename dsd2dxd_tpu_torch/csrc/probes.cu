// P1 and P2: the floor probes of the fused decimation kernel (K1).
//
// P1 replaces the TPU kernel tools/dmabench.py::_probe (its pallas_call):
// K1's scaffold with no DSP, in seven modes that split the copy and launch
// floor of a block from everything else. P2 replaces
// tools/floorstrip.py::_probe_step (its pallas_call): K1's body cut short
// at successive points. Plain versions (PyTorch):
// dsd2dxd_tpu_torch/tools/dmabench.py::dma_probe_reference and
// dsd2dxd_tpu_torch/tools/floorstrip.py::probe_step_reference; the CUDA
// entries are bound in tools/ through kernels.py.
//
// P1 (dma_probe_kernel<MODE>): a grid of (n_blocks, rows) blocks; block
// (i, c) owns k_sub output values of row c (a channel), out[c][i*k_sub+j],
// and a window of u32 words of that row:
//   noop     no input read; out = j (the grid and the output stream alone)
//   noflush  window x[c][i*B, i*B + H + B); every block writes the same
//            output block out[c][j] (so the write stream is one block)
//   dma      the same window, its own output block
//   halo0    the window without the overlap: x[c][i*B, i*B + B)
//   contig   block i's windows relaid out beforehand into one contiguous
//            slab of rows * (H + B) words; block (i, c) loads the
//            row_words words at slab offset c * row_words
//   bspec    the same words brought to shared memory by one bulk copy
//            (cp.async.bulk, the Tensor Memory Accelerator's 1-D copy,
//            completing on an mbarrier)
// Each block stores the last k_sub words of what it loaded, as f32 of their
// int32 bits, from shared memory: the stores depend on the loads, so nvcc
// keeps them. (The seventh mode, relayout, is the halo replication in
// torch ops; it has no kernel.) noflush's blocks run in no order, so its
// output block holds, element by element, the value of some block; the
// plain version returns every block's and the checks hold it so.
//
// P2 (probe_step_kernel<RUNG, DITHER>): K1's body as it was before its
// redesign for Hopper (the unpacked-window kernel: byte loads, an unpack
// to ±1 f32 in shared memory, one FIR routine for every stage), on
// ProbeParams (tools/floorstrip.py::probe_params), stopped after
//   dma     the window's bytes (one byte per thread) into shared memory;
//           out[c][m] = the block's j-th byte (frame m = m0 + j), the
//           cheapest store that depends on them
//   unpack  + the unpack to ±1 f32; out[c][m] = the sum of the samples
//           j, j + block_out, j + 2 block_out, ... (R of them, R = 8 *
//           frame_bytes): an aligned consume, each warp reading 32
//           consecutive floats, so it adds no bank conflict of its own
//   cas0a   + the cascade with every output j reading its input from j on
//           instead of M j (run_stages<STRIDE1>): a warp reads 32
//           consecutive floats, one per bank, so no bank conflict, where
//           the real stride-2 reads are 2-way conflicts; numerically wrong
//           on purpose
//   cas0    + the real cascade (run_stages and last_stage); planar f32 out
//           at gain 1 and the peak over frames m < n_valid
//   quant   + K1's epilogue at 24 bit (dither, rint, clip) as int32
// The last rung, full, is K1 itself (ops/fused.py::make_fused_step, the
// redesigned kernel of fused_decim.cu), so quant beside full is the old
// body beside the new one in the same run. The TPU ladder's `fan` rung
// (the sublane fan-in of sub-blocks) has no counterpart: K1's blocks are
// independent windows.
//
// What bounds them on an H100: P1 and P2's dma rung move bytes and do
// nothing else, so memory (3.35 TB/s) and the launch of the grid; unpack
// adds R shared-memory writes per frame; the cascade rungs add the FIR
// work (2 products per stage per output at the scale-0 taps of the
// synthetic chain).

#include <cstdint>
#include <cuda_runtime.h>

#include "device_check.cuh"
#include "epilogue.cuh"

#define MAX_STAGES 8
#define MAX_LEVELS 8  // tree levels: taps per stage < 256

struct ProbeParams {
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
  int planar;        // unused by the rungs (K1's field)
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
                                            float* h_s, const ProbeParams& p,
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

// The unpack: byte i as its 8 MSB-first ±1 samples at buf[8i ...].
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
                                                   const ProbeParams& p) {
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
                                            const ProbeParams& p,
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

enum { P1_NOOP = 0, P1_NOFLUSH = 1, P1_DMA = 2, P1_HALO0 = 3, P1_CONTIG = 4,
       P1_BSPEC = 5 };
enum { RUNG_DMA = 0, RUNG_UNPACK = 1, RUNG_CAS0A = 2, RUNG_CAS0 = 3,
       RUNG_QUANT = 4 };

struct DmaParams {
  long long in_row_words;  // words per input row (contig/bspec: per slab)
  int rows;                // channels
  int n_blocks;
  int block_words;         // B
  int halo_words;          // H
  int k_sub;               // values stored per block and row
  int row_words;           // contig/bspec: words each block loads
  int slab_words;          // contig/bspec: words of one block's slab
  int smem_bytes;
};

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global memory to shared memory, issued by thread 0 and
// awaited by every thread of the block.
__device__ __forceinline__ void bulk_copy_to_shared(void* dst,
                                                    const void* src,
                                                    uint32_t bytes) {
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_a = (uint32_t)__cvta_generic_to_shared(&bar);
  const uint32_t dst_a = (uint32_t)__cvta_generic_to_shared(dst);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar_a), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst_a),
        "l"(src), "r"(bytes), "r"(bar_a)
        : "memory");
  }
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar_a), "r"(0u)
        : "memory");
  } while (!done);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
dma_probe_kernel(const uint32_t* __restrict__ x, float* __restrict__ out,
                 const DmaParams p) {
  extern __shared__ __align__(16) uint32_t win[];
  const int i = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const long long out_row =
      MODE == P1_NOFLUSH ? p.k_sub : (long long)p.n_blocks * p.k_sub;
  float* o = out + c * out_row + (MODE == P1_NOFLUSH ? 0 : (long long)i * p.k_sub);
  if constexpr (MODE == P1_NOOP) {
    for (int j = tid; j < p.k_sub; j += blockDim.x) o[j] = (float)j;
    return;
  }
  const uint32_t* src;
  int n;
  if constexpr (MODE == P1_CONTIG || MODE == P1_BSPEC) {
    src = x + (long long)i * p.slab_words + (long long)c * p.row_words;
    n = p.row_words;
  } else {
    src = x + c * p.in_row_words + (long long)i * p.block_words;
    n = MODE == P1_HALO0 ? p.block_words : p.halo_words + p.block_words;
  }
  if constexpr (MODE == P1_BSPEC) {
    bulk_copy_to_shared(win, src, 4u * (uint32_t)n);
  } else {
    for (int t = tid; t < n; t += blockDim.x) win[t] = src[t];
    __syncthreads();
  }
  for (int j = tid; j < p.k_sub; j += blockDim.x)
    o[j] = (float)(int)win[n - p.k_sub + j];
}

template <int MODE>
static int launch_dma(const void* x, void* out, const DmaParams* p,
                      cudaStream_t stream) {
  auto kernel = dma_probe_kernel<MODE>;
  if (p->smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(p->n_blocks, p->rows);
  kernel<<<grid, THREADS, p->smem_bytes, stream>>>((const uint32_t*)x,
                                                   (float*)out, *p);
  return (int)cudaGetLastError();
}

extern "C" int dsd2dxd_dma_params_size() { return (int)sizeof(DmaParams); }

extern "C" int dsd2dxd_probe_params_size() { return (int)sizeof(ProbeParams); }

extern "C" int dsd2dxd_dma_probe(const void* x, void* out, int mode,
                                 const DmaParams* p, void* stream,
                                 int device) {
  if (p->n_blocks < 1 || p->rows < 1 || p->k_sub < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = check_device(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case P1_NOOP: return launch_dma<P1_NOOP>(x, out, p, s);
    case P1_NOFLUSH: return launch_dma<P1_NOFLUSH>(x, out, p, s);
    case P1_DMA: return launch_dma<P1_DMA>(x, out, p, s);
    case P1_HALO0: return launch_dma<P1_HALO0>(x, out, p, s);
    case P1_CONTIG: return launch_dma<P1_CONTIG>(x, out, p, s);
    case P1_BSPEC: return launch_dma<P1_BSPEC>(x, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int RUNG, int DITHER>
__global__ void __launch_bounds__(THREADS)
probe_step_kernel(const uint8_t* __restrict__ halo,
                  const uint8_t* __restrict__ x,
                  const float* __restrict__ taps, void* __restrict__ out,
                  float* __restrict__ peak, const ProbeParams p) {
  extern __shared__ float smem[];
  const int c = blockIdx.y;
  const long long m0 = (long long)blockIdx.x * p.block_out;
  const int tid = threadIdx.x;
  float* h_s = smem;
  float* buf_a = smem + p.buf_a;
  float* buf_b = smem + p.buf_b;
  float* out_f = reinterpret_cast<float*>(out) + c * (long long)p.tile_frames;

  if constexpr (RUNG == RUNG_DMA) {
    uint8_t* raw = reinterpret_cast<uint8_t*>(buf_a);
    load_window(halo, x, taps, h_s, p, c, m0,
                [&](int i, uint32_t byte) { raw[i] = (uint8_t)byte; });
    for (int j = tid; j < p.block_out; j += blockDim.x) {
      const long long m = m0 + j;
      if (m >= p.tile_frames) break;
      out_f[m] = (float)raw[j];
    }
    return;
  }
  load_window(halo, x, taps, h_s, p, c, m0,
              [&](int i, uint32_t byte) { unpack_byte(buf_a, i, byte); });
  if constexpr (RUNG == RUNG_UNPACK) {
    const int r = 8 * p.frame_bytes;
    for (int j = tid; j < p.block_out; j += blockDim.x) {
      const long long m = m0 + j;
      if (m >= p.tile_frames) break;
      float s = 0.0f;
      for (int b = 0; b < r; ++b)
        s = __fadd_rn(s, buf_a[j + b * p.block_out]);
      out_f[m] = s;
    }
    return;
  }
  constexpr bool STRIDE1 = RUNG == RUNG_CAS0A;
  const float* in = run_stages<STRIDE1>(h_s, buf_a, buf_b, p);
  const float local_peak = last_stage<true, STRIDE1>(
      h_s, in, p, m0, [&](long long m, float y) {
        if constexpr (RUNG == RUNG_QUANT) {
          reinterpret_cast<int32_t*>(out_f)[m] = (int32_t)epilogue<24, DITHER>(
              y, (uint32_t)m, (uint32_t)c, p.key0, p.key1);
        } else {
          out_f[m] = y;
        }
      });
  block_peak(local_peak, peak);
}

template <int RUNG, int DITHER = DITHER_NONE>
static int launch_step(const void* halo, const void* x, const void* taps,
                       void* out, void* peak, const ProbeParams* p,
                       cudaStream_t stream) {
  auto kernel = probe_step_kernel<RUNG, DITHER>;
  if (p->smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p->tile_frames + p->block_out - 1) / p->block_out,
                  p->channels);
  kernel<<<grid, THREADS, p->smem_bytes, stream>>>(
      (const uint8_t*)halo, (const uint8_t*)x, (const float*)taps, out,
      (float*)peak, *p);
  return (int)cudaGetLastError();
}

extern "C" int dsd2dxd_probe_step(const void* halo, const void* x,
                                  const void* taps, void* out, void* peak,
                                  int rung, const ProbeParams* p,
                                  void* stream, int device) {
  if (p->n_stages < 1 || p->n_stages > MAX_STAGES || p->tile_frames < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = check_device(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rung) {
    case RUNG_DMA: return launch_step<RUNG_DMA>(halo, x, taps, out, peak, p, s);
    case RUNG_UNPACK: return launch_step<RUNG_UNPACK>(halo, x, taps, out, peak, p, s);
    case RUNG_CAS0A: return launch_step<RUNG_CAS0A>(halo, x, taps, out, peak, p, s);
    case RUNG_CAS0: return launch_step<RUNG_CAS0>(halo, x, taps, out, peak, p, s);
    case RUNG_QUANT:
      switch (p->dither) {
        case DITHER_NONE: return launch_step<RUNG_QUANT, DITHER_NONE>(halo, x, taps, out, peak, p, s);
        case DITHER_TPDF: return launch_step<RUNG_QUANT, DITHER_TPDF>(halo, x, taps, out, peak, p, s);
        case DITHER_RECT: return launch_step<RUNG_QUANT, DITHER_RECT>(halo, x, taps, out, peak, p, s);
        default: return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
}
