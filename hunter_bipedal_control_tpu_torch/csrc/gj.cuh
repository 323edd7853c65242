// Gauss-Jordan elimination on an [A | I] tableau, shared by the B6
// gj_inverse kernels (n <= 16: one thread per matrix, tableau in its
// registers/local memory; n <= 32: one block per matrix, tableau in shared
// memory) and the B10 observer's leg systems (a thread each).  B2
// (project_knot.cu) eliminates its Gram and B12 (kalman_update.cu) its
// [Ssy | ey | C] on one warp by shuffles, with these semantics.
//
// Semantics of hunter_bipedal_control_tpu/ops/linalg.py::gj_inverse:
// pivots in the natural order 0..n-1 (the JAX pivot search scores every
// un-pivoted row as NaN, and argmax returns the first NaN), each pivot row
// divided by its pivot (+1e-30 in the "pivot" mode), then the rank-1
// update of every other row.
#pragma once

#include <cuda_runtime.h>

// M: n rows x 2n columns, row stride ld.  col (n) and prow (2n) are scratch.
// COOP = true: called by all `nthr` threads of a block (thread `tid`), with
// the tableau complete and visible on entry; returns after a barrier.
template <bool COOP>
__device__ __forceinline__ void gj_eliminate_n(float* M, int n, int ld, bool pivot, float* col,
                                               float* prow, int tid, int nthr) {
  const int w = 2 * n;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    float pval = M[k * ld + k];
    if (pivot) pval = pval + 1e-30f;
    for (int i = tid; i < n; i += nthr) col[i] = (i == k) ? 0.0f : M[i * ld + k];
    for (int j = tid; j < w; j += nthr) prow[j] = M[k * ld + j] / pval;
    if (COOP) __syncthreads();
    for (int idx = tid; idx < n * w; idx += nthr) {
      const int i = idx / w;
      const int j = idx - i * w;
      M[i * ld + j] = (i == k) ? prow[j] : M[i * ld + j] - col[i] * prow[j];
    }
    if (COOP) __syncthreads();
  }
}

// The same with the sizes known at compile time (a thread's own tableau
// stays in registers).
template <int N, int LD, bool COOP>
__device__ __forceinline__ void gj_eliminate(float* M, bool pivot, float* col, float* prow,
                                             int tid, int nthr) {
  gj_eliminate_n<COOP>(M, N, LD, pivot, col, prow, tid, nthr);
}
