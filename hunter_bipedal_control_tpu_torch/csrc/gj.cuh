// Gauss-Jordan elimination on an [A | I] tableau, shared by the B6
// gj_inverse kernel (one thread per matrix, tableau in its registers/local
// memory) and the B2 project_knot kernel (one block per knot, tableau in
// shared memory, the block's threads splitting each step).
//
// Semantics of hunter_bipedal_control_tpu/ops/linalg.py::gj_inverse:
// pivots in the natural order 0..n-1 (the JAX pivot search scores every
// un-pivoted row as NaN, and argmax returns the first NaN), each pivot row
// divided by its pivot (+1e-30 in the "pivot" mode), then the rank-1
// update of every other row.
#pragma once

#include <cuda_runtime.h>

// M: N rows x 2N columns, row stride LD.  col (N) and prow (2N) are scratch.
// COOP = true: called by all `nthr` threads of a block (thread `tid`), with
// the tableau complete and visible on entry; returns after a barrier.
template <int N, int LD, bool COOP>
__device__ __forceinline__ void gj_eliminate(float* M, bool pivot, float* col, float* prow,
                                             int tid, int nthr) {
  constexpr int W = 2 * N;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    float pval = M[k * LD + k];
    if (pivot) pval = pval + 1e-30f;
    for (int i = tid; i < N; i += nthr) col[i] = (i == k) ? 0.0f : M[i * LD + k];
    for (int j = tid; j < W; j += nthr) prow[j] = M[k * LD + j] / pval;
    if (COOP) __syncthreads();
    for (int idx = tid; idx < N * W; idx += nthr) {
      const int i = idx / W;
      const int j = idx - i * W;
      M[i * LD + j] = (i == k) ? prow[j] : M[i * LD + j] - col[i] * prow[j];
    }
    if (COOP) __syncthreads();
  }
}
