// The pairwise sum both kernels take their taps in: the fused decimation
// kernel (K1, fused_decim.cu) for every FIR stage, the finish kernel (K2,
// finish.cu) for the taps of the ×160/147 band. Plain version:
// dsd2dxd_tpu_torch/ops/plan.py::tree_sum (adjacent pairs level by level,
// an odd last element carried up). Every sum is __fadd_rn, so nvcc cannot
// contract a product into it.

#pragma once

#define MAX_LEVELS 8   // tree levels: fewer than 256 items per sum

// Item k of a sum taken pairwise in the plain version's order
// (plan.tree_sum: a binary counter, acc[lv] the pending block of 2^lv
// items). With k known at compile time the branches fold away.
__device__ __forceinline__ void tree_push(float (&acc)[MAX_LEVELS], int k,
                                          float v) {
#pragma unroll
  for (int lv = 0; lv < MAX_LEVELS; ++lv) {
    if ((k >> lv) & 1) {
      v = __fadd_rn(acc[lv], v);
    } else {
      acc[lv] = v;
      return;
    }
  }
}

// The sum of n pushed items: S_a + (S_b + ...) over n's power-of-two
// blocks, largest (first) outermost.
__device__ __forceinline__ float tree_total(const float (&acc)[MAX_LEVELS],
                                            int n) {
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
