// B2: per-knot equality projection of the SQP's LQ data.
//
// Replaces hunter_bipedal_control_tpu/solver/sqp.py::project_knot (with
// ops/linalg.py::gj_inverse(pivot=False) and bsmm, the JAX package's
// broadcast small matmul).  Per knot, with m = 16 equality rows and
// nx = nu = 22:
//   G   = D D' + diag(1 - mask) + proj_reg I,  G^-1 by Gauss-Jordan
//   D+  = D' G^-1,   X = D+ [g C D],   e = -X0,  E = -X1,  P = I - X2
//   YQ  = Quu [e E P],  BU = B [e E P],  T = [E P]' [Quu e + qu, Quu E, Qux, Quu P]
// and the reduced LQ data (A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P).
//
// Bound on the card: 8,448 knots at the bench shape read 12.9 KB and write
// 13.8 KB each (~226 MB in all, ~68 us at 3.35 TB/s) for ~0.29 MFLOP each
// (~2.5 GFLOP, ~37 us at 67 TFLOP/s fp32): memory bound.  Design: one block
// per knot; the block stages its 12 inputs in shared memory once (~13 KB,
// ~36 KB with the work arrays), keeps every intermediate there, and writes
// each output once.  The products are plain per-thread dot products over
// shared memory; the 16x16 Gram inverse is the shared gj_eliminate, split
// over the block's threads.
#include <cuda_runtime.h>

#include "gj.cuh"

namespace {

constexpr int NX = 22;
constexpr int NU = 22;
constexpr int NM = 16;
constexpr int NC = 1 + NX + NU;     // columns of X / U = [e E P]
constexpr int NT = 1 + 2 * NX + NU; // columns of T
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
project_knot_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
                    const float* __restrict__ gd, const float* __restrict__ gqx,
                    const float* __restrict__ gqu, const float* __restrict__ gQxx,
                    const float* __restrict__ gQuu, const float* __restrict__ gQux,
                    const float* __restrict__ gg, const float* __restrict__ gC,
                    const float* __restrict__ gD, const float* __restrict__ gmask,
                    float* __restrict__ oA, float* __restrict__ oB, float* __restrict__ od,
                    float* __restrict__ oqx, float* __restrict__ oqw,
                    float* __restrict__ oQxx, float* __restrict__ oQww,
                    float* __restrict__ oQwx, float* __restrict__ oE,
                    float* __restrict__ oe, float* __restrict__ oP,
                    float proj_reg, float hess_reg, int pivot) {
  __shared__ float A[NX * NX], B[NX * NU], d[NX], qx[NX], qu[NU];
  __shared__ float Qxx[NX * NX], Quu[NU * NU], Qux[NU * NX];
  __shared__ float g[NM], C[NM * NX], D[NM * NU], mask[NM];
  __shared__ float G[NM * 2 * NM], col[NM], prow[2 * NM];
  __shared__ float Dp[NU * NM];
  __shared__ float U[NU * NC];
  __shared__ float YQ[NU * NC];
  __shared__ float T[(NX + NU) * NT];

  const int tid = threadIdx.x;
  const long long k = blockIdx.x;

  auto load = [&](float* dst, const float* src, int n) {
    const float* s = src + k * n;
    for (int i = tid; i < n; i += THREADS) dst[i] = s[i];
  };
  load(A, gA, NX * NX);
  load(B, gB, NX * NU);
  load(d, gd, NX);
  load(qx, gqx, NX);
  load(qu, gqu, NU);
  load(Qxx, gQxx, NX * NX);
  load(Quu, gQuu, NU * NU);
  load(Qux, gQux, NU * NX);
  load(g, gg, NM);
  load(C, gC, NM * NX);
  load(D, gD, NM * NU);
  load(mask, gmask, NM);
  __syncthreads();

  // Gram tableau [D D' + diag(1 - mask) + proj_reg I | I]
  for (int idx = tid; idx < NM * NM; idx += THREADS) {
    const int i = idx / NM, j = idx - i * NM;
    float acc = 0.0f;
    for (int c = 0; c < NU; ++c) acc += D[i * NU + c] * D[j * NU + c];
    if (i == j) acc = (acc + (1.0f - mask[i])) + proj_reg;
    G[i * 2 * NM + j] = acc;
    G[i * 2 * NM + NM + j] = (i == j) ? 1.0f : 0.0f;
  }
  __syncthreads();
  gj_eliminate<NM, 2 * NM, true>(G, pivot != 0, col, prow, tid, THREADS);

  // D+ = D' G^-1   (nu x m)
  for (int idx = tid; idx < NU * NM; idx += THREADS) {
    const int i = idx / NM, j = idx - i * NM;
    float acc = 0.0f;
    for (int r = 0; r < NM; ++r) acc += D[r * NU + i] * G[r * 2 * NM + NM + j];
    Dp[idx] = acc;
  }
  __syncthreads();

  // X = D+ [g C D];  U = [e E P] = [-X0, -X1, I - X2]
  for (int idx = tid; idx < NU * NC; idx += THREADS) {
    const int i = idx / NC, c = idx - i * NC;
    float acc = 0.0f;
    for (int r = 0; r < NM; ++r) {
      const float rhs = (c == 0) ? g[r] : (c <= NX) ? C[r * NX + c - 1] : D[r * NU + c - 1 - NX];
      acc += Dp[i * NM + r] * rhs;
    }
    U[idx] = (c > NX) ? ((i == c - 1 - NX) ? 1.0f : 0.0f) - acc : -acc;
  }
  __syncthreads();

  // YQ = Quu U;  BU = B U -> d_t, A_t, B_t;  e, E, P out
  for (int idx = tid; idx < NU * NC; idx += THREADS) {
    const int i = idx / NC, c = idx - i * NC;
    float acc = 0.0f;
    for (int r = 0; r < NU; ++r) acc += Quu[i * NU + r] * U[r * NC + c];
    YQ[idx] = acc;
  }
  for (int idx = tid; idx < NX * NC; idx += THREADS) {
    const int i = idx / NC, c = idx - i * NC;
    float acc = 0.0f;
    for (int r = 0; r < NU; ++r) acc += B[i * NU + r] * U[r * NC + c];
    if (c == 0) {
      od[k * NX + i] = d[i] + acc;
    } else if (c <= NX) {
      oA[k * NX * NX + i * NX + c - 1] = A[i * NX + c - 1] + acc;
    } else {
      oB[k * NX * NU + i * NU + c - 1 - NX] = acc;
    }
  }
  for (int idx = tid; idx < NU * NC; idx += THREADS) {
    const int i = idx / NC, c = idx - i * NC;
    if (c == 0) {
      oe[k * NU + i] = U[idx];
    } else if (c <= NX) {
      oE[k * NU * NX + i * NX + c - 1] = U[idx];
    } else {
      oP[k * NU * NU + i * NU + c - 1 - NX] = U[idx];
    }
  }
  __syncthreads();

  // T = [E P]' R1,  R1 = [Quu e + qu, Quu E, Qux, Quu P]   ((nx+nu) x NT)
  for (int idx = tid; idx < (NX + NU) * NT; idx += THREADS) {
    const int r = idx / NT, c = idx - r * NT;
    float acc = 0.0f;
    for (int i = 0; i < NU; ++i) {
      float r1;
      if (c == 0) r1 = YQ[i * NC] + qu[i];
      else if (c <= NX) r1 = YQ[i * NC + c];
      else if (c <= 2 * NX) r1 = Qux[i * NX + c - 1 - NX];
      else r1 = YQ[i * NC + c - NX];
      acc += U[i * NC + 1 + r] * r1;
    }
    T[idx] = acc;
  }
  __syncthreads();

  float sigma = 0.0f;
  for (int i = 0; i < NU; ++i) sigma += Quu[i * NU + i];
  sigma = 1.0f + sigma / NU;

  for (int i = tid; i < NX; i += THREADS) {
    float qe = 0.0f;
    for (int r = 0; r < NU; ++r) qe += Qux[r * NX + i] * U[r * NC];
    oqx[k * NX + i] = qx[i] + T[i * NT] + qe;
  }
  for (int i = tid; i < NU; i += THREADS) oqw[k * NU + i] = T[(NX + i) * NT];
  for (int idx = tid; idx < NX * NX; idx += THREADS) {
    const int i = idx / NX, j = idx - i * NX;
    oQxx[k * NX * NX + idx] =
        Qxx[idx] + T[i * NT + 1 + j] + T[i * NT + 1 + NX + j] + T[j * NT + 1 + NX + i];
  }
  for (int idx = tid; idx < NU * NX; idx += THREADS) {
    const int i = idx / NX, j = idx - i * NX;
    oQwx[k * NU * NX + idx] = T[(NX + i) * NT + 1 + j] + T[(NX + i) * NT + 1 + NX + j];
  }
  for (int idx = tid; idx < NU * NU; idx += THREADS) {
    const int i = idx / NU, j = idx - i * NU;
    const float eye = (i == j) ? 1.0f : 0.0f;
    oQww[k * NU * NU + idx] = T[(NX + i) * NT + 1 + 2 * NX + j]
                              + sigma * (eye - U[i * NC + 1 + NX + j]) + hess_reg * eye;
  }
}

}  // namespace

extern "C" int hk_project_knot(const float* A, const float* B, const float* d, const float* qx,
                               const float* qu, const float* Qxx, const float* Quu,
                               const float* Qux, const float* g, const float* C, const float* D,
                               const float* mask, float* oA, float* oB, float* od, float* oqx,
                               float* oqw, float* oQxx, float* oQww, float* oQwx, float* oE,
                               float* oe, float* oP, int n_knots, float proj_reg,
                               float hess_reg, int pivot, void* stream) {
  project_knot_kernel<<<n_knots, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, d, qx, qu, Qxx, Quu, Qux, g, C, D, mask, oA, oB, od, oqx, oqw, oQxx, oQww, oQwx,
      oE, oe, oP, proj_reg, hess_reg, pivot);
  return static_cast<int>(cudaGetLastError());
}
