// B5: parallel-in-time Riccati (associative scan) + forward rollout.
//
// Replaces hunter_bipedal_control_tpu/solver/riccati.py::backward_associative
// (:188, with _stage_elements :126 and _combine :154), forward_associative
// (:245) and the closed-loop rollout of solver/sqp.py::solve (:327-336), the
// riccati_parallel=True configuration.  Per scenario, from S = 0, s = 0:
//   elements   k < N:  Qr = sym(Qww) + reg (1 + tr(Qww)/nu) I,
//              [iQwx iqw iBt] = Qr^-1 [Qwx qw B'],
//              F = A - B iQwx, C = B iBt, X = sym(Qxx - Qwx' iQwx),
//              c = d - B iqw, q = qx - Qwx' iqw;   element N: (0, 0, 0, 0, 0)
//   suffix scan (star product of the later composite e2 and the earlier
//   element e1):  W = (I + C1 X2)^-1,  F = F2 W F1,  C = C2 + F2 W C1 F2',
//              X = sym(X1 + F1' X2 W F1),  c = c2 + F2 W (c1 - C1 q2),
//              q = q1 + F1' W' (q2 + X2 c1)
//   gains      k < N, from (S, s) = (X, q) of the suffix composite at k+1:
//              SM = S [A B d] (+ s on the last column), H = B' SM,
//              Huu = sym(Qww + H_uu) + reg (1 + tr/nu) I,
//              [K kff] = -Huu^-1 [Qwx + H_ux, qw + H_u]
//   rollout    A_cl = A + B K, b_cl = d + B kff, composed as affine maps by a
//              prefix scan; dx_{k+1} = M_k dx0 + v_k, w = K dx + kff,
//              du = e + E dx + P w.
//
// The JAX package solves Qr, Huu and (I + C1 X2) by Newton-Schulz, a TPU
// workaround for row-sequential factorizations (ops/linalg.py:1-16).  Here
// they are exact: Cholesky of the symmetric part for Qr and Huu (as B3
// factors Huu), Gauss-Jordan with partial pivoting for I + C1 X2, which is
// not symmetric but has real eigenvalues >= 1.  A Cholesky pivot that is not
// > 0 (or NaN) makes that block's outputs NaN, as jnp.linalg.cholesky's NaN
// factor does; NaN then spreads through the scans to every knot that
// depends on it and reaches the line search's isfinite test.
//
// Bound on the card: the work is ~N log2(N) dependent 22x22 products and
// inverses at B = 1 (~50 MFLOP at N = 53, under 1 us at 67 TFLOP/s fp32;
// ~0.2 MB of inputs and outputs, under 0.1 us at 3.35 TB/s), so the floor
// is latency: ceil(log2(N+1)) + ceil(log2 N) + 3 dependent launches, each a
// chain of barriers inside one block.  Design: one block per (knot,
// scenario) in every phase (grid.x = knot, grid.y = scenario, so any batch
// up to 65535 runs); Hillis-Steele rounds with one launch per round and
// ping-pong buffers in device memory (1496 floats per element, 506 per
// affine map); all operands of a block in shared memory (~26 KB in the
// combine); products give one output entry per thread.
#include <cuda_runtime.h>

namespace {

constexpr int NX = 22;
constexpr int NU = 22;
constexpr int NN = NX * NX;
constexpr int NR = NX + 1 + NX;  // columns of [Qwx qw B']
constexpr int NM = NX + NU + 1;  // columns of [A B d]
constexpr int NK = NX + 1;       // columns of [K kff]
constexpr int NT = 2 * NX;       // columns of the tableau [I + C1 X2 | I]
// element layout: F, C, X (NX x NX each), c, q (NX each)
constexpr int OF = 0, OC = NN, OX = 2 * NN, Oc = 3 * NN, Oq = 3 * NN + NX;
constexpr int ELEM = 3 * NN + 2 * NX;
// affine map layout: M (NX x NX), v (NX)
constexpr int OV = NN;
constexpr int AFF = NN + NX;
constexpr int THREADS = 256;
constexpr int ROLL_THREADS = 64;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// out (n x m, row stride ldo) = op(A) op(B), op(A) n x p, op(B) p x m, all
// row-major with row strides lda / ldb; TA / TB read A / B transposed.
// Callers synchronize after.
template <bool TA, bool TB>
__device__ void smm(float* out, int ldo, const float* A, int lda, const float* B, int ldb,
                    int n, int p, int m) {
  for (int idx = threadIdx.x; idx < n * m; idx += blockDim.x) {
    const int i = idx / m, j = idx - i * m;
    float acc = 0.0f;
    for (int r = 0; r < p; ++r)
      acc += (TA ? A[r * lda + i] : A[i * lda + r]) * (TB ? B[j * ldb + r] : B[r * ldb + j]);
    out[i * ldo + j] = acc;
  }
}

// In-place Cholesky L L' of the n x n matrix whose lower triangle (with the
// diagonal) L holds; *bad becomes 1 if a pivot is not > 0.  Ends synchronized.
__device__ void cholesky(float* L, int n, int* bad) {
  for (int j = 0; j < n; ++j) {
    if (threadIdx.x == 0) {
      const float v = L[j * n + j];
      if (!(v > 0.0f)) *bad = 1;
      L[j * n + j] = sqrtf(v);
    }
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < n; i += blockDim.x) L[i * n + j] /= L[j * n + j];
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, c = idx - i * n;
      if (i > j && c > j && c <= i) L[idx] -= L[i * n + j] * L[c * n + j];
    }
    __syncthreads();
  }
}

// R (n x m) <- (L L')^-1 R, one right-hand side column per thread.  Ends
// synchronized.
__device__ void cholesky_solve(const float* L, float* R, int n, int m) {
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    for (int i = 0; i < n; ++i) {
      float v = R[i * m + c];
      for (int r = 0; r < i; ++r) v -= L[i * n + r] * R[r * m + c];
      R[i * m + c] = v / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
      float v = R[i * m + c];
      for (int r = i + 1; r < n; ++r) v -= L[r * n + i] * R[r * m + c];
      R[i * m + c] = v / L[i * n + i];
    }
  }
  __syncthreads();
}

// L <- sym(L) + reg (1 + tr(L)/n) I on the lower triangle.  Ends synchronized.
__device__ void shift_symmetrize(float* L, int n, float reg, float* shift) {
  if (threadIdx.x == 0) {
    float tr = 0.0f;
    for (int i = 0; i < n; ++i) tr += L[i * n + i];
    *shift = reg * (1.0f + tr / n);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    if (i == j) L[idx] += *shift;
    else if (i > j) L[idx] = 0.5f * (L[idx] + L[j * n + i]);
  }
  __syncthreads();
}

// ---- 1. per-stage elements (grid: N+1 knots x batch) ----
__global__ void __launch_bounds__(THREADS)
elements_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
                const float* __restrict__ gd, const float* __restrict__ gQxx,
                const float* __restrict__ gQww, const float* __restrict__ gQwx,
                const float* __restrict__ gqx, const float* __restrict__ gqw,
                float* __restrict__ elems, int N, float reg) {
  __shared__ float L[NU * NU], R[NU * NR], Bs[NX * NU], Qwx[NU * NX], Xt[NN];
  __shared__ float shift;
  __shared__ int bad;
  const int tid = threadIdx.x;
  const int k = blockIdx.x;
  const long long b = blockIdx.y;
  float* out = elems + (b * (N + 1) + k) * ELEM;
  if (k == N) {  // the terminal element: S_N = 0, s_N = 0
    for (int i = tid; i < ELEM; i += THREADS) out[i] = 0.0f;
    return;
  }
  const long long kn = b * N + k;
  const float* A = gA + kn * NN;
  const float* Qxx = gQxx + kn * NN;
  const float* d = gd + kn * NX;
  const float* qx = gqx + kn * NX;
  const float* qw = gqw + kn * NU;
  for (int i = tid; i < NU * NU; i += THREADS) L[i] = gQww[kn * NU * NU + i];
  for (int i = tid; i < NX * NU; i += THREADS) Bs[i] = gB[kn * NX * NU + i];
  for (int i = tid; i < NU * NX; i += THREADS) Qwx[i] = gQwx[kn * NU * NX + i];
  if (tid == 0) bad = 0;
  __syncthreads();
  for (int idx = tid; idx < NU * NR; idx += THREADS) {
    const int i = idx / NR, c = idx - i * NR;
    R[idx] = c < NX ? Qwx[i * NX + c] : c == NX ? qw[i] : Bs[(c - NX - 1) * NU + i];
  }
  shift_symmetrize(L, NU, reg, &shift);
  cholesky(L, NU, &bad);
  if (bad) {
    for (int i = tid; i < ELEM; i += THREADS) out[i] = qnan();
    return;
  }
  cholesky_solve(L, R, NU, NR);
  for (int idx = tid; idx < NN; idx += THREADS) {
    const int i = idx / NX, j = idx - i * NX;
    float bf = 0.0f, bc = 0.0f, qq = 0.0f;
    for (int r = 0; r < NU; ++r) {
      bf += Bs[i * NU + r] * R[r * NR + j];
      bc += Bs[i * NU + r] * R[r * NR + NX + 1 + j];
      qq += Qwx[r * NX + i] * R[r * NR + j];
    }
    out[OF + idx] = A[idx] - bf;
    out[OC + idx] = bc;
    Xt[idx] = Qxx[idx] - qq;
  }
  for (int i = tid; i < NX; i += THREADS) {
    float bq = 0.0f, wq = 0.0f;
    for (int r = 0; r < NU; ++r) {
      bq += Bs[i * NU + r] * R[r * NR + NX];
      wq += Qwx[r * NX + i] * R[r * NR + NX];
    }
    out[Oc + i] = d[i] - bq;
    out[Oq + i] = qx[i] - wq;
  }
  __syncthreads();
  for (int idx = tid; idx < NN; idx += THREADS) {
    const int i = idx / NX, j = idx - i * NX;
    out[OX + idx] = 0.5f * (Xt[idx] + Xt[j * NX + i]);
  }
}

// ---- 2. one Hillis-Steele round of the suffix scan (grid: N+1 x batch) ----
// out[k] = combine(e2 = in[k + dist], e1 = in[k]), or in[k] past the end.
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ in, float* __restrict__ out, int N1, int dist) {
  __shared__ float F1[NN], C1[NN], X1[NN], F2[NN], C2[NN], X2[NN];
  __shared__ float c1[NX], q1[NX], c2[NX], q2[NX], t1[NX], t2[NX], t3[NX];
  __shared__ float T[NX * NT], prow[NT], fac[NX];
  __shared__ float F2W[NN], U[NN], V[NN], Y[NN], Z[NN];
  __shared__ int piv;
  const int tid = threadIdx.x;
  const int k = blockIdx.x;
  const long long b = blockIdx.y;
  const float* s1 = in + (b * N1 + k) * ELEM;
  float* o = out + (b * N1 + k) * ELEM;
  if (k + dist >= N1) {
    for (int i = tid; i < ELEM; i += THREADS) o[i] = s1[i];
    return;
  }
  const float* s2 = in + (b * N1 + k + dist) * ELEM;
  for (int i = tid; i < NN; i += THREADS) {
    F1[i] = s1[OF + i]; C1[i] = s1[OC + i]; X1[i] = s1[OX + i];
    F2[i] = s2[OF + i]; C2[i] = s2[OC + i]; X2[i] = s2[OX + i];
  }
  for (int i = tid; i < NX; i += THREADS) {
    c1[i] = s1[Oc + i]; q1[i] = s1[Oq + i]; c2[i] = s2[Oc + i]; q2[i] = s2[Oq + i];
  }
  __syncthreads();

  // W = (I + C1 X2)^-1 by Gauss-Jordan on [I + C1 X2 | I], partial pivoting
  for (int idx = tid; idx < NX * NT; idx += THREADS) {
    const int i = idx / NT, j = idx - i * NT;
    float v;
    if (j < NX) {
      v = i == j ? 1.0f : 0.0f;
      for (int r = 0; r < NX; ++r) v += C1[i * NX + r] * X2[r * NX + j];
    } else {
      v = (j - NX == i) ? 1.0f : 0.0f;
    }
    T[idx] = v;
  }
  __syncthreads();
  for (int col = 0; col < NX; ++col) {
    if (tid == 0) {
      int p = col;
      float best = fabsf(T[col * NT + col]);
      for (int i = col + 1; i < NX; ++i) {
        const float v = fabsf(T[i * NT + col]);
        if (v > best) { best = v; p = i; }
      }
      piv = p;
    }
    __syncthreads();
    if (piv != col && tid < NT) {
      const float tmp = T[col * NT + tid];
      T[col * NT + tid] = T[piv * NT + tid];
      T[piv * NT + tid] = tmp;
    }
    __syncthreads();
    if (tid < NT) prow[tid] = T[col * NT + tid] / T[col * NT + col];
    if (tid < NX) fac[tid] = T[tid * NT + col];
    __syncthreads();
    for (int idx = tid; idx < NX * NT; idx += THREADS) {
      const int i = idx / NT, j = idx - i * NT;
      T[idx] = i == col ? prow[j] : T[idx] - fac[i] * prow[j];
    }
    __syncthreads();
  }
  const float* W = T + NX;  // row stride NT

  // F2W = F2 W, U = X2 W, t1 = c1 - C1 q2, t2 = q2 + X2 c1
  smm<false, false>(F2W, NX, F2, NX, W, NT, NX, NX, NX);
  smm<false, false>(U, NX, X2, NX, W, NT, NX, NX, NX);
  for (int i = tid; i < NX; i += THREADS) {
    float a = 0.0f, x = 0.0f;
    for (int r = 0; r < NX; ++r) {
      a += C1[i * NX + r] * q2[r];
      x += X2[i * NX + r] * c1[r];
    }
    t1[i] = c1[i] - a;
    t2[i] = q2[i] + x;
  }
  __syncthreads();
  // V = F2W F1 (the new F), Y = U F1, Z = F2W C1, t3 = W' t2, c
  smm<false, false>(V, NX, F2W, NX, F1, NX, NX, NX, NX);
  smm<false, false>(Y, NX, U, NX, F1, NX, NX, NX, NX);
  smm<false, false>(Z, NX, F2W, NX, C1, NX, NX, NX, NX);
  for (int i = tid; i < NX; i += THREADS) {
    float w = 0.0f, f = 0.0f;
    for (int r = 0; r < NX; ++r) {
      w += W[r * NT + i] * t2[r];
      f += F2W[i * NX + r] * t1[r];
    }
    t3[i] = w;
    o[Oc + i] = c2[i] + f;
  }
  __syncthreads();
  // F; C = C2 + Z F2'; U <- X1 + F1' Y; q = q1 + F1' t3
  for (int idx = tid; idx < NN; idx += THREADS) {
    const int i = idx / NX, j = idx - i * NX;
    float zc = 0.0f, fy = 0.0f;
    for (int r = 0; r < NX; ++r) {
      zc += Z[i * NX + r] * F2[j * NX + r];
      fy += F1[r * NX + i] * Y[r * NX + j];
    }
    o[OF + idx] = V[idx];
    o[OC + idx] = C2[idx] + zc;
    U[idx] = X1[idx] + fy;
  }
  for (int i = tid; i < NX; i += THREADS) {
    float f = 0.0f;
    for (int r = 0; r < NX; ++r) f += F1[r * NX + i] * t3[r];
    o[Oq + i] = q1[i] + f;
  }
  __syncthreads();
  for (int idx = tid; idx < NN; idx += THREADS) {
    const int i = idx / NX, j = idx - i * NX;
    o[OX + idx] = 0.5f * (U[idx] + U[j * NX + i]);
  }
}

// ---- 3. gains and closed-loop maps (grid: N knots x batch) ----
__global__ void __launch_bounds__(THREADS)
gains_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
             const float* __restrict__ gd, const float* __restrict__ gQww,
             const float* __restrict__ gQwx, const float* __restrict__ gqw,
             const float* __restrict__ elems, float* __restrict__ oK,
             float* __restrict__ okff, float* __restrict__ aff, int N, float reg) {
  __shared__ float M[NX * NM], S[NN], s[NX], SM[NX * NM], H[NU * NM];
  __shared__ float L[NU * NU], R[NU * NK];
  __shared__ float shift;
  __shared__ int bad;
  const int tid = threadIdx.x;
  const int k = blockIdx.x;
  const long long b = blockIdx.y;
  const long long kn = b * N + k;
  const float* el = elems + (b * (N + 1) + k + 1) * ELEM;  // suffix composite at k+1
  const float* A = gA + kn * NN;
  const float* B = gB + kn * NX * NU;
  const float* d = gd + kn * NX;
  float* K = oK + kn * NU * NX;
  float* kff = okff + kn * NU;
  float* a = aff + kn * AFF;
  for (int idx = tid; idx < NX * NM; idx += THREADS) {
    const int i = idx / NM, c = idx - i * NM;
    M[idx] = c < NX ? A[i * NX + c] : c < NX + NU ? B[i * NU + c - NX] : d[i];
  }
  for (int i = tid; i < NN; i += THREADS) S[i] = el[OX + i];
  for (int i = tid; i < NX; i += THREADS) s[i] = el[Oq + i];
  if (tid == 0) bad = 0;
  __syncthreads();
  for (int idx = tid; idx < NX * NM; idx += THREADS) {
    const int i = idx / NM, c = idx - i * NM;
    float acc = 0.0f;
    for (int r = 0; r < NX; ++r) acc += S[i * NX + r] * M[r * NM + c];
    SM[idx] = c == NM - 1 ? acc + s[i] : acc;
  }
  __syncthreads();
  smm<true, false>(H, NM, M + NX, NM, SM, NM, NU, NX, NM);  // H = B' SM
  __syncthreads();
  const float* Qww = gQww + kn * NU * NU;
  const float* Qwx = gQwx + kn * NU * NX;
  const float* qw = gqw + kn * NU;
  for (int idx = tid; idx < NU * NU; idx += THREADS) {
    const int i = idx / NU, j = idx - i * NU;
    L[idx] = Qww[idx] + H[i * NM + NX + j];
  }
  for (int idx = tid; idx < NU * NK; idx += THREADS) {
    const int i = idx / NK, c = idx - i * NK;
    R[idx] = c < NX ? Qwx[i * NX + c] + H[i * NM + c] : qw[i] + H[i * NM + NM - 1];
  }
  __syncthreads();
  shift_symmetrize(L, NU, reg, &shift);
  cholesky(L, NU, &bad);
  if (bad) {
    for (int i = tid; i < NU * NX; i += THREADS) K[i] = qnan();
    for (int i = tid; i < NU; i += THREADS) kff[i] = qnan();
    for (int i = tid; i < AFF; i += THREADS) a[i] = qnan();
    return;
  }
  cholesky_solve(L, R, NU, NK);
  for (int idx = tid; idx < NU * NK; idx += THREADS) {
    const int i = idx / NK, c = idx - i * NK;
    if (c < NX) K[i * NX + c] = -R[idx];
    else kff[i] = -R[idx];
  }
  // A_cl = A + B K, b_cl = d + B kff
  for (int idx = tid; idx < NX * NK; idx += THREADS) {
    const int i = idx / NK, c = idx - i * NK;
    float acc = 0.0f;
    for (int r = 0; r < NU; ++r) acc += M[i * NM + NX + r] * R[r * NK + c];
    if (c < NX) a[i * NX + c] = M[i * NM + c] - acc;
    else a[OV + i] = d[i] - acc;
  }
}

// ---- 4. one Hillis-Steele round of the affine prefix scan (grid: N x batch) ----
// out[k] = (M_k M_{k-dist}, M_k v_{k-dist} + v_k), or in[k] for k < dist.
__global__ void __launch_bounds__(THREADS)
affine_kernel(const float* __restrict__ in, float* __restrict__ out, int N, int dist) {
  __shared__ float M1[NN], v1[NX], M2[NN];
  const int tid = threadIdx.x;
  const int k = blockIdx.x;
  const long long b = blockIdx.y;
  const float* e2 = in + (b * N + k) * AFF;
  float* o = out + (b * N + k) * AFF;
  if (k < dist) {
    for (int i = tid; i < AFF; i += THREADS) o[i] = e2[i];
    return;
  }
  const float* e1 = in + (b * N + k - dist) * AFF;
  for (int i = tid; i < NN; i += THREADS) {
    M1[i] = e1[i];
    M2[i] = e2[i];
  }
  for (int i = tid; i < NX; i += THREADS) v1[i] = e1[OV + i];
  __syncthreads();
  smm<false, false>(o, NX, M2, NX, M1, NX, NX, NX, NX);
  for (int i = tid; i < NX; i += THREADS) {
    float acc = 0.0f;
    for (int r = 0; r < NX; ++r) acc += M2[i * NX + r] * v1[r];
    o[OV + i] = acc + e2[OV + i];
  }
}

// ---- 5. states and input deltas (grid: N+1 knots x batch) ----
__global__ void __launch_bounds__(ROLL_THREADS)
rollout_kernel(const float* __restrict__ aff, const float* __restrict__ gK,
               const float* __restrict__ gkff, const float* __restrict__ gE,
               const float* __restrict__ gP, const float* __restrict__ ge,
               const float* __restrict__ gdx0, float* __restrict__ odxs,
               float* __restrict__ odus, int N) {
  __shared__ float dx0[NX], dx[NX], w[NU];
  const int tid = threadIdx.x;
  const int k = blockIdx.x;
  const long long b = blockIdx.y;
  for (int i = tid; i < NX; i += ROLL_THREADS) dx0[i] = gdx0[b * NX + i];
  __syncthreads();
  for (int i = tid; i < NX; i += ROLL_THREADS) {
    float v = dx0[i];
    if (k > 0) {
      const float* a = aff + (b * N + k - 1) * AFF;
      v = a[OV + i];
      for (int j = 0; j < NX; ++j) v += a[i * NX + j] * dx0[j];
    }
    dx[i] = v;
    odxs[(b * (N + 1) + k) * NX + i] = v;
  }
  if (k == N) return;
  __syncthreads();
  const long long kn = b * N + k;
  for (int i = tid; i < NU; i += ROLL_THREADS) {
    float v = gkff[kn * NU + i];
    for (int j = 0; j < NX; ++j) v += gK[kn * NU * NX + i * NX + j] * dx[j];
    w[i] = v;
  }
  __syncthreads();
  for (int i = tid; i < NU; i += ROLL_THREADS) {
    float v = ge[kn * NU + i];
    for (int j = 0; j < NX; ++j) v += gE[kn * NU * NX + i * NX + j] * dx[j];
    for (int j = 0; j < NU; ++j) v += gP[kn * NU * NU + i * NU + j] * w[j];
    odus[kn * NU + i] = v;
  }
}

}  // namespace

// Scratch (float32, from the caller): elems0 / elems1 batch x (N+1) x 1496,
// aff0 / aff1 batch x N x 506.  Launches 3 + ceil(log2(N+1)) + ceil(log2 N)
// kernels on the stream; returns the first launch error.
extern "C" int hk_riccati_assoc(const float* A, const float* B, const float* d,
                                const float* Qxx, const float* Qww, const float* Qwx,
                                const float* qx, const float* qw, const float* E,
                                const float* P, const float* e, const float* dx0, float* K,
                                float* kff, float* dxs, float* dus, float* elems0,
                                float* elems1, float* aff0, float* aff1, int batch, int N,
                                float reg, void* stream) {
  if (batch < 1 || batch > 65535 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const dim3 g1(N + 1, batch), g0(N, batch);
  elements_kernel<<<g1, THREADS, 0, st>>>(A, B, d, Qxx, Qww, Qwx, qx, qw, elems0, N, reg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  float* cur = elems0;
  float* nxt = elems1;
  for (int dist = 1; dist < N + 1; dist *= 2) {
    combine_kernel<<<g1, THREADS, 0, st>>>(cur, nxt, N + 1, dist);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    float* t = cur; cur = nxt; nxt = t;
  }
  gains_kernel<<<g0, THREADS, 0, st>>>(A, B, d, Qww, Qwx, qw, cur, K, kff, aff0, N, reg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  float* acur = aff0;
  float* anxt = aff1;
  for (int dist = 1; dist < N; dist *= 2) {
    affine_kernel<<<g0, THREADS, 0, st>>>(acur, anxt, N, dist);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    float* t = acur; acur = anxt; anxt = t;
  }
  rollout_kernel<<<g1, ROLL_THREADS, 0, st>>>(acur, K, kff, E, P, e, dx0, dxs, dus, N);
  return static_cast<int>(cudaGetLastError());
}
