// B3: sequential Riccati backward sweep + forward rollout of the deltas.
//
// Replaces hunter_bipedal_control_tpu/solver/riccati.py::backward_scan (with
// its Newton-Schulz solve of Huu, ops/linalg.py::spd_solve / ns_inverse) and
// the forward rollout scan of solver/sqp.py::solve (sqp.py:338-361).
// Per scenario, backward over the N knots from S = 0, s = 0:
//   SM = S [A B d] (+ s on the last column),  H = [A B]' SM
//   Huu = Qww + H_uu + reg (1 + tr/nu) I,  Hux = Qwx + H_ux,  hu = qw + H_u
//   [K kff] = -Huu^-1 [Hux hu]          (Cholesky of 0.5 (Huu + Huu'))
//   S = sym(Qxx + H_xx + Hux' K),  s = qx + H_x + Hux' kff
// then forward from dx0: w = K dx + kff, du = e + E dx + P w,
// dx' = A dx + B w + d.
//
// NS was a TPU workaround for row-sequential LU; a Cholesky factor takes its
// place.  Huu reaches the kernel symmetric only up to the float32 rounding
// of the projection (P = I - D+ D, ~1e-2 relative on the main path), and its
// small eigenvalues (~1e-5 against ~1) make a factor of the lower triangle
// alone an order of magnitude farther from the float64 step than NS on the
// full matrix; factoring the symmetric part matches NS.  The factor solves
// exactly: where 20 NS iterations have not converged (warm steps of
// scenarios far from the nominal state) it follows the exact float64 solve,
// not NS.
//
// Bound on the card: the recursion is sequential in the knots, so its floor
// is the latency of 66 dependent knot steps per scenario, not bytes (~136 MB
// at the bench shape, ~41 us at 3.35 TB/s) or flops (~1.6 GFLOP, ~23 us at
// 67 TFLOP/s fp32).  Design: one block per scenario (128 blocks on 132 SMs),
// looping over the knots inside the kernel; S, s and the 22-wide work
// matrices stay in shared memory for the whole sweep; the gains go to
// device memory once and are read back by the same block in the rollout.
#include <cuda_runtime.h>

namespace {

constexpr int NX = 22;
constexpr int NU = 22;
constexpr int NM = NX + NU + 1;  // columns of [A B d]
constexpr int NH = NX + NU;      // rows of H
constexpr int NK = NX + 1;       // columns of [K kff]
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
riccati_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
               const float* __restrict__ gd, const float* __restrict__ gQxx,
               const float* __restrict__ gQww, const float* __restrict__ gQwx,
               const float* __restrict__ gqx, const float* __restrict__ gqw,
               const float* __restrict__ gE, const float* __restrict__ gP,
               const float* __restrict__ ge, const float* __restrict__ gdx0,
               float* __restrict__ oK, float* __restrict__ okff,
               float* __restrict__ odxs, float* __restrict__ odus, int N, float reg) {
  __shared__ float S[NX * NX], s[NX];
  __shared__ float M[NX * NM];     // [A B d]
  __shared__ float SM[NX * NM];
  __shared__ float H[NH * NM];
  __shared__ float L[NU * NU];     // Huu, then its Cholesky factor (lower)
  __shared__ float R[NU * NK];     // [Hux hu], then [K kff]
  __shared__ float Sn[NX * NX];
  __shared__ float shift;
  __shared__ float dx[NX], w[NU], rE[NU], rA[NX];

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;

  for (int i = tid; i < NX * NX; i += THREADS) S[i] = 0.0f;
  for (int i = tid; i < NX; i += THREADS) s[i] = 0.0f;
  __syncthreads();

  for (int k = N - 1; k >= 0; --k) {
    const long long kn = b * N + k;
    const float* A = gA + kn * NX * NX;
    const float* B = gB + kn * NX * NU;
    const float* d = gd + kn * NX;
    for (int idx = tid; idx < NX * NM; idx += THREADS) {
      const int i = idx / NM, c = idx - i * NM;
      M[idx] = (c < NX) ? A[i * NX + c] : (c < NX + NU) ? B[i * NU + c - NX] : d[i];
    }
    __syncthreads();

    // SM = S [A B d], last column + s
    for (int idx = tid; idx < NX * NM; idx += THREADS) {
      const int i = idx / NM, c = idx - i * NM;
      float acc = 0.0f;
      for (int r = 0; r < NX; ++r) acc += S[i * NX + r] * M[r * NM + c];
      SM[idx] = (c == NM - 1) ? acc + s[i] : acc;
    }
    __syncthreads();

    // H = [A B]' SM
    for (int idx = tid; idx < NH * NM; idx += THREADS) {
      const int i = idx / NM, c = idx - i * NM;
      float acc = 0.0f;
      for (int r = 0; r < NX; ++r) acc += M[r * NM + i] * SM[r * NM + c];
      H[idx] = acc;
    }
    __syncthreads();

    // Huu, [Hux hu]
    const float* Qww = gQww + kn * NU * NU;
    const float* Qwx = gQwx + kn * NU * NX;
    const float* qw = gqw + kn * NU;
    for (int idx = tid; idx < NU * NU; idx += THREADS) {
      const int i = idx / NU, j = idx - i * NU;
      L[idx] = Qww[idx] + H[(NX + i) * NM + NX + j];
    }
    for (int idx = tid; idx < NU * NK; idx += THREADS) {
      const int i = idx / NK, c = idx - i * NK;
      R[idx] = (c < NX) ? Qwx[i * NX + c] + H[(NX + i) * NM + c]
                        : qw[i] + H[(NX + i) * NM + NM - 1];
    }
    __syncthreads();
    if (tid == 0) {
      float tr = 0.0f;
      for (int i = 0; i < NU; ++i) tr += L[i * NU + i];
      shift = reg * (1.0f + tr / NU);
    }
    __syncthreads();
    // the shifted Huu, symmetrized into the lower triangle the factor reads
    for (int idx = tid; idx < NU * NU; idx += THREADS) {
      const int i = idx / NU, j = idx - i * NU;
      if (i == j) L[idx] += shift;
      else if (i > j) L[idx] = 0.5f * (L[idx] + L[j * NU + i]);
    }
    __syncthreads();

    // in-place Cholesky sym(Huu) = L L'
    for (int j = 0; j < NU; ++j) {
      if (tid == 0) L[j * NU + j] = sqrtf(L[j * NU + j]);
      __syncthreads();
      for (int i = j + 1 + tid; i < NU; i += THREADS) L[i * NU + j] /= L[j * NU + j];
      __syncthreads();
      for (int idx = tid; idx < NU * NU; idx += THREADS) {
        const int i = idx / NU, c = idx - i * NU;
        if (i > j && c > j && c <= i) L[idx] -= L[i * NU + j] * L[c * NU + j];
      }
      __syncthreads();
    }

    // [K kff] = -Huu^-1 [Hux hu]: one column per thread
    if (tid < NK) {
      const int c = tid;
      for (int i = 0; i < NU; ++i) {
        float v = R[i * NK + c];
        for (int r = 0; r < i; ++r) v -= L[i * NU + r] * R[r * NK + c];
        R[i * NK + c] = v / L[i * NU + i];
      }
      for (int i = NU - 1; i >= 0; --i) {
        float v = R[i * NK + c];
        for (int r = i + 1; r < NU; ++r) v -= L[r * NU + i] * R[r * NK + c];
        R[i * NK + c] = v / L[i * NU + i];
      }
      for (int i = 0; i < NU; ++i) R[i * NK + c] = -R[i * NK + c];
    }
    __syncthreads();

    // gains out; S_new = Qxx + H_xx + Hux' K; s_new = qx + H_x + Hux' kff.
    // Hux = Qwx + H_ux is recomputed from its sources (R now holds K).
    for (int idx = tid; idx < NU * NK; idx += THREADS) {
      const int i = idx / NK, c = idx - i * NK;
      if (c < NX) oK[kn * NU * NX + i * NX + c] = R[idx];
      else okff[kn * NU + i] = R[idx];
    }
    const float* Qxx = gQxx + kn * NX * NX;
    const float* qx = gqx + kn * NX;
    for (int idx = tid; idx < NX * NK; idx += THREADS) {
      const int i = idx / NK, c = idx - i * NK;
      float acc = 0.0f;
      for (int r = 0; r < NU; ++r)
        acc += (Qwx[r * NX + i] + H[(NX + r) * NM + i]) * R[r * NK + c];
      if (c < NX) Sn[i * NX + c] = Qxx[i * NX + c] + H[i * NM + c] + acc;
      else s[i] = qx[i] + H[i * NM + NM - 1] + acc;
    }
    __syncthreads();
    for (int idx = tid; idx < NX * NX; idx += THREADS) {
      const int i = idx / NX, j = idx - i * NX;
      S[idx] = 0.5f * (Sn[idx] + Sn[j * NX + i]);
    }
    __syncthreads();
  }

  // forward rollout
  for (int i = tid; i < NX; i += THREADS) dx[i] = gdx0[b * NX + i];
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    const long long kn = b * N + k;
    const float* K = oK + kn * NU * NX;
    const float* E = gE + kn * NU * NX;
    const float* A = gA + kn * NX * NX;
    for (int i = tid; i < NX; i += THREADS) odxs[(b * (N + 1) + k) * NX + i] = dx[i];
    for (int r = tid; r < NU + NU + NX; r += THREADS) {
      const float* row = (r < NU) ? K + r * NX : (r < 2 * NU) ? E + (r - NU) * NX
                                                               : A + (r - 2 * NU) * NX;
      float acc = 0.0f;
      for (int j = 0; j < NX; ++j) acc += row[j] * dx[j];
      if (r < NU) w[r] = acc + okff[kn * NU + r];
      else if (r < 2 * NU) rE[r - NU] = acc;
      else rA[r - 2 * NU] = acc;
    }
    __syncthreads();
    const float* P = gP + kn * NU * NU;
    const float* B = gB + kn * NX * NU;
    float nxt = 0.0f;
    int own = -1;
    for (int r = tid; r < NU + NX; r += THREADS) {
      const float* row = (r < NU) ? P + r * NU : B + (r - NU) * NU;
      float acc = 0.0f;
      for (int j = 0; j < NU; ++j) acc += row[j] * w[j];
      if (r < NU) {
        odus[kn * NU + r] = ge[kn * NU + r] + rE[r] + acc;
      } else {
        nxt = rA[r - NU] + acc + gd[kn * NX + r - NU];
        own = r - NU;
      }
    }
    __syncthreads();
    if (own >= 0) dx[own] = nxt;
    __syncthreads();
  }
  for (int i = tid; i < NX; i += THREADS) odxs[(b * (N + 1) + N) * NX + i] = dx[i];
}

}  // namespace

extern "C" int hk_riccati_solve(const float* A, const float* B, const float* d,
                                const float* Qxx, const float* Qww, const float* Qwx,
                                const float* qx, const float* qw, const float* E,
                                const float* P, const float* e, const float* dx0, float* K,
                                float* kff, float* dxs, float* dus, int batch, int N,
                                float reg, void* stream) {
  riccati_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, d, Qxx, Qww, Qwx, qx, qw, E, P, e, dx0, K, kff, dxs, dus, N, reg);
  return static_cast<int>(cudaGetLastError());
}
