// The compiled model of the SoA kernels: the Hunter biped's tree topology
// (nj = 10 joints, L = 11 links, nc = 4 contact frames), the layout of the
// constants buffer that ocp/soa_kernel.py::consts_buffer writes from
// models/soa.py::build_consts, and the 3-vector / 3x3 helpers.  Shared by
// B1 (soa_linearize.cu) and B8a (leg_ik.cu); soa_kernel.py::check_topology
// refuses a model whose topology differs from this one.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NJ = 10;
constexpr int L = 11;
constexpr int NC = 4;

#define SOA_PARENT {0, 1, 2, 3, 4, 0, 6, 7, 8, 9}
#define SOA_CHILD {1, 2, 3, 4, 5, 6, 7, 8, 9, 10}
#define SOA_CPARENT {5, 10, 5, 10}
// ancestor mask (L x NJ): joint j moves link k
#define SOA_ANC {                                              \
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {1, 0, 0, 0, 0, 0, 0, 0, 0, 0}, \
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0}, {1, 1, 1, 0, 0, 0, 0, 0, 0, 0}, \
    {1, 1, 1, 1, 0, 0, 0, 0, 0, 0}, {1, 1, 1, 1, 1, 0, 0, 0, 0, 0}, \
    {0, 0, 0, 0, 0, 1, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 1, 1, 0, 0, 0}, \
    {0, 0, 0, 0, 0, 1, 1, 1, 0, 0}, {0, 0, 0, 0, 0, 1, 1, 1, 1, 0}, \
    {0, 0, 0, 0, 0, 1, 1, 1, 1, 1}}

const int h_parent[NJ] = SOA_PARENT;
const int h_child[NJ] = SOA_CHILD;
const int h_cparent[NC] = SOA_CPARENT;
const int h_anc[L][NJ] = SOA_ANC;
__constant__ int c_parent[NJ] = SOA_PARENT;
__constant__ int c_child[NJ] = SOA_CHILD;
__constant__ int c_cparent[NC] = SOA_CPARENT;
__constant__ int c_anc[L][NJ] = SOA_ANC;

// constants buffer layout (ocp/soa_kernel.py::consts_buffer writes it)
constexpr int K_OPOS = 0;                 // (NJ, 3) joint origin positions
constexpr int K_OROT = K_OPOS + NJ * 3;   // (NJ, 9) joint origin rotations
constexpr int K_AXIS = K_OROT + NJ * 9;   // (NJ, 3) joint axes
constexpr int K_RK = K_AXIS + NJ * 3;     // (NJ, 9) skew(axis)
constexpr int K_RKK = K_RK + NJ * 9;      // (NJ, 9) skew(axis)^2
constexpr int K_COML = K_RKK + NJ * 9;    // (L, 3) link CoMs
constexpr int K_MASS = K_COML + L * 3;    // (L,) link masses
constexpr int K_INER = K_MASS + L;        // (L, 9) link inertias
constexpr int K_CPOS = K_INER + L * 9;    // (NC, 3) contact offsets
constexpr int K_M = K_CPOS + NC * 3;      // total mass
constexpr int K_INVM = K_M + 1;           // 1 / total mass
constexpr int K_MSUB = K_INVM + 1;        // (NJ,) subtree masses
constexpr int N_CONSTS = K_MSUB + NJ;

// ---------------------------------------------------------------------------
// 3-vector / 3x3 helpers (row-major); outputs may not alias inputs
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void mv3(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float tr3(const float* M) { return M[0] + M[4] + M[8]; }

// closed-form 3x3 inverse via the adjugate (soa.py::inv3)
__device__ void inv3(const float* M, float* out) {
  const float c00 = M[4] * M[8] - M[5] * M[7];
  const float c01 = M[5] * M[6] - M[3] * M[8];
  const float c02 = M[3] * M[7] - M[4] * M[6];
  const float det = M[0] * c00 + M[1] * c01 + M[2] * c02;
  const float inv_det = 1.0f / det;
  const float c10 = M[2] * M[7] - M[1] * M[8];
  const float c11 = M[0] * M[8] - M[2] * M[6];
  const float c12 = M[1] * M[6] - M[0] * M[7];
  const float c20 = M[1] * M[5] - M[2] * M[4];
  const float c21 = M[2] * M[3] - M[0] * M[5];
  const float c22 = M[0] * M[4] - M[1] * M[3];
  out[0] = inv_det * c00; out[1] = inv_det * c10; out[2] = inv_det * c20;
  out[3] = inv_det * c01; out[4] = inv_det * c11; out[5] = inv_det * c21;
  out[6] = inv_det * c02; out[7] = inv_det * c12; out[8] = inv_det * c22;
}

}  // namespace
