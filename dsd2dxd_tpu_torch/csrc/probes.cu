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
//   noflush  window x[c][i*B, i*B + H + B), and no output stream: only the
//            last block of each row stores, out[c][j], which is what the
//            TPU's pinned output block leaves (a run-time condition, so
//            every block's loads stay)
//   dma      the same window, its own output block
//   halo0    the window without the overlap: x[c][i*B, i*B + B)
//   contig   block i's windows relaid out beforehand into one contiguous
//            slab of rows * (H + B) words; block (i, c) loads the
//            row_words words at slab offset c * row_words
//   bspec    the same words brought to shared memory by one bulk copy
//            (cp.async.bulk, the Tensor Memory Accelerator's 1-D copy,
//            completing on an mbarrier)
// Every mode but bspec copies its window as K1 copies its own
// (decim_body.cuh, copy_span: 16-byte loads of the aligned span, swapped
// to big-endian words). Each block stores the last k_sub words of what it
// loaded, as f32 of their int32 bits, from shared memory (swapped back):
// the stores depend on the loads, so nvcc keeps them. (The seventh mode,
// relayout, is the halo replication in torch ops; it has no kernel.)
//
// P2 (probe_step_kernel<RUNG, DITHER>): decim_body<RUNG> on K1's
// DecimParams (ops/fused.py::_kernel_params), the body of
// fused_decim_kernel stopped after the rung: dma, unpack, cas0a, cas0, and
// quant at DITHER_NONE and DITHER_TPDF (decim_body.cuh says what each
// stops after and stores). The last rung, full, is K1 itself. The rungs'
// launch configuration and attributes are K1's (THREADS, MIN_BLOCKS, the
// dynamic shared memory, the carveout), so each differs from K1 only in
// where its body stops.
//
// What bounds them on an H100: P1 and P2's dma rung move bytes and do
// nothing else, so memory (3.35 TB/s) and the launch of the grid; the
// later rungs add K1's own work, which is operations-bound (fused_decim.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "decim_body.cuh"
#include "device_check.cuh"

enum { P1_NOOP = 0, P1_NOFLUSH = 1, P1_DMA = 2, P1_HALO0 = 3, P1_CONTIG = 4,
       P1_BSPEC = 5 };

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
    for (int j = tid; j < p.k_sub; j += blockDim.x)
      o[j] = (float)(int)win[n - p.k_sub + j];
  } else {
    const int w0 = copy_span(reinterpret_cast<const uint8_t*>(src), 4 * n,
                             win) >> 2;
    __syncthreads();
    if (MODE == P1_NOFLUSH && i != p.n_blocks - 1) return;
    for (int j = tid; j < p.k_sub; j += blockDim.x)
      o[j] = (float)(int)__byte_perm(win[w0 + n - p.k_sub + j], 0, 0x0123);
  }
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
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
probe_step_kernel(const uint8_t* __restrict__ halo,
                  const uint8_t* __restrict__ x,
                  const float* __restrict__ coefs, uint8_t* __restrict__ out,
                  float* __restrict__ peak, const DecimParams p) {
  decim_body<RUNG, DITHER>(halo, x, coefs, out, peak, p);
}

template <int RUNG, int DITHER = DITHER_NONE>
static int launch_step(const void* halo, const void* x, const void* coefs,
                       void* out, void* peak, const DecimParams* p,
                       cudaStream_t stream) {
  auto kernel = probe_step_kernel<RUNG, DITHER>;
  const cudaError_t e = set_decim_attributes(kernel);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p->tile_frames + p->block_out - 1) / p->block_out,
                  p->channels);
  kernel<<<grid, THREADS, p->smem_bytes, stream>>>(
      (const uint8_t*)halo, (const uint8_t*)x, (const float*)coefs,
      (uint8_t*)out, (float*)peak, *p);
  return (int)cudaGetLastError();
}

// rung: RUNG_DMA .. RUNG_QUANT (quant at p->dither, NONE or TPDF).
extern "C" int dsd2dxd_probe_step(const void* halo, const void* x,
                                  const void* coefs, void* out, void* peak,
                                  int rung, const DecimParams* p,
                                  void* stream, int device) {
  if (!valid_decim_params(p)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = check_device(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rung) {
    case RUNG_DMA: return launch_step<RUNG_DMA>(halo, x, coefs, out, peak, p, s);
    case RUNG_UNPACK: return launch_step<RUNG_UNPACK>(halo, x, coefs, out, peak, p, s);
    case RUNG_CAS0A: return launch_step<RUNG_CAS0A>(halo, x, coefs, out, peak, p, s);
    case RUNG_CAS0: return launch_step<RUNG_CAS0>(halo, x, coefs, out, peak, p, s);
    case RUNG_QUANT:
      switch (p->dither) {
        case DITHER_NONE: return launch_step<RUNG_QUANT, DITHER_NONE>(halo, x, coefs, out, peak, p, s);
        case DITHER_TPDF: return launch_step<RUNG_QUANT, DITHER_TPDF>(halo, x, coefs, out, peak, p, s);
        default: return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
}
