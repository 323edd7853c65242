// B4: batched dense convex QP by a fixed-count primal-dual interior point.
//
// Replaces hunter_bipedal_control_tpu/ops/qp.py::solve_qp (the WBC's QP,
// wbc/wbc.py:294-300: 38 variables, 28 equality rows, 40 inequality rows,
// 10 iterations).  Per QP and iteration, as the JAX version:
//   mu = s'lam / mi,  sigma_mu = max(0.2 mu, mu_min)
//   residuals r_dual, r_eq, r_ineq, r_cent;  w = lam / max(s, 1e-12)
//   Hbar = H + Ain' diag(w) Ain + 1e-7 tr(Hbar)/n I,  L = chol(sym(Hbar))
//   [HiA Hir] = Hbar^-1 [Aeq' rbar],  Ls = chol(sym(Aeq HiA + eq_reg I))
//   dnu = Schur^-1 (r_eq - Aeq Hir),  dx, ds, dlam
//   alpha = min(1, fraction-to-boundary ratios over s and lam)
// A Cholesky that fails (a pivot <= 0 or NaN) leaves a NaN lower triangle,
// as jnp.linalg.cholesky does, and NaN propagates through every max and min
// below (fmaxf / fminf would drop it), so a failed solve ends with a NaN x
// and the WBC's acceptance test falls back exactly where the JAX one does.
//
// Bound on the card: ~0.23 MFLOP per QP and iteration (the symmetric
// products Hbar and Aeq HiA counted as one triangle each) against ~17 KB of
// input and output per QP, so at B = 4096 and 10 iterations the work is
// ~9.3 GFLOP (~0.14 ms at 67 TFLOP/s fp32) against ~71 MB (~0.02 ms at
// 3.35 TB/s): bound by operations.  The operations sit in chains of small
// dependent steps (two Cholesky factorizations and four triangular sweeps
// per iteration), so the latency of one block's barriers, not the FLOP
// rate, sets the time.  Design: one block of 256 threads per QP, every
// iteration in one launch; H, Aeq, Ain, the factors, [HiA Hir] and the
// Schur matrix stay in shared memory (~32 KB at the WBC's shape, so several
// blocks share an SM); products give one output entry per thread, the
// factorizations go column by column with barriers, the triangular sweeps
// step over the rows with all threads on the right-hand sides below, and
// the step length is a warp min-reduction over the 2 mi ratios.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// max / min that return NaN if either argument is NaN (jnp.maximum / min).
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// Warp 0 reduces f(i) over i < m (sum, min or max, NaN-propagating for the
// last two); every thread gets the result.  Ends with a barrier.
template <typename F>
__device__ float block_reduce(int m, int op, F f, float* scratch) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    float acc = op == 0 ? 0.0f : f(tid < m ? tid : 0);
    for (int i = tid; i < m; i += 32) {
      const float v = f(i);
      acc = op == 0 ? acc + v : op == 1 ? nmin(acc, v) : nmax(acc, v);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, acc, off);
      acc = op == 0 ? acc + o : op == 1 ? nmin(acc, o) : nmax(acc, o);
    }
    if (tid == 0) *scratch = acc;
  }
  __syncthreads();
  const float r = *scratch;
  __syncthreads();
  return r;
}

// In place: A (n x n, row stride n) -> the lower Cholesky factor of
// 0.5 (A + A').  On failure the lower triangle is NaN.  All threads call;
// entry and exit are behind barriers.
__device__ void cholesky(float* A, int n) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < n * n; idx += THREADS) {
    const int i = idx / n, j = idx - i * n;
    if (j < i) A[idx] = 0.5f * (A[idx] + A[j * n + i]);
  }
  __syncthreads();
  bool failed = false;
  for (int k = 0; k < n; ++k) {
    const float d = A[k * n + k];
    if (!(d > 0.0f)) {  // uniform: every thread read the same value
      failed = true;
      break;
    }
    const float r = sqrtf(d);
    __syncthreads();
    if (tid == 0) A[k * n + k] = r;
    for (int i = k + 1 + tid; i < n; i += THREADS) A[i * n + k] /= r;
    __syncthreads();
    const int m = n - k - 1;
    for (int idx = tid; idx < m * m; idx += THREADS) {
      const int ii = idx / m, jj = idx - ii * m;
      if (jj <= ii) {
        const int i = k + 1 + ii, j = k + 1 + jj;
        A[i * n + j] -= A[i * n + k] * A[j * n + k];
      }
    }
    __syncthreads();
  }
  if (failed) {
    for (int idx = tid; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx - i * n;
      if (j <= i) A[idx] = __int_as_float(0x7fc00000);
    }
    __syncthreads();
  }
}

// In place: X (n x c, row stride ld) <- (L L')^-1 X, L from cholesky().
__device__ void cho_solve(const float* L, int n, float* X, int c, int ld) {
  const int tid = threadIdx.x;
  for (int k = 0; k < n; ++k) {  // L y = X
    for (int j = tid; j < c; j += THREADS) X[k * ld + j] /= L[k * n + k];
    __syncthreads();
    const int rows = n - k - 1;
    for (int idx = tid; idx < rows * c; idx += THREADS) {
      const int i = k + 1 + idx / c, j = idx % c;
      X[i * ld + j] -= L[i * n + k] * X[k * ld + j];
    }
    __syncthreads();
  }
  for (int k = n - 1; k >= 0; --k) {  // L' x = y
    for (int j = tid; j < c; j += THREADS) X[k * ld + j] /= L[k * n + k];
    __syncthreads();
    for (int idx = tid; idx < k * c; idx += THREADS) {
      const int i = idx / c, j = idx % c;
      X[i * ld + j] -= L[k * n + i] * X[k * ld + j];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
solve_qp_kernel(const float* __restrict__ gH, const float* __restrict__ gg,
                const float* __restrict__ gAeq, const float* __restrict__ gbeq,
                const float* __restrict__ gAin, const float* __restrict__ gbin,
                const float* __restrict__ gx0, const float* __restrict__ glam0,
                const float* __restrict__ gnu0, const float* __restrict__ gs_floor,
                const float* __restrict__ glam_floor, float* __restrict__ ox,
                float* __restrict__ onu, float* __restrict__ olam, float* __restrict__ ores,
                int n, int me, int mi, int n_iters, float eq_reg, float frac, float mu_min) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const int mt = me + 1;  // columns of [Aeq' rbar]
  float* H = sm;
  float* Aeq = H + n * n;
  float* Ain = Aeq + me * n;
  float* L = Ain + mi * n;
  float* T = L + n * n;      // n x (me + 1): [Aeq' rbar], then [HiA Hir]
  float* S = T + n * mt;     // me x me Schur, then its factor
  float* g = S + me * me;
  float* x = g + n;
  float* rd = x + n;
  float* dx = rd + n;
  float* beq = dx + n;
  float* nu = beq + me;
  float* req = nu + me;
  float* dnu = req + me;
  float* bin = dnu + me;
  float* s = bin + mi;
  float* lam = s + mi;
  float* w = lam + mi;
  float* rin = w + mi;
  float* rc = rin + mi;
  float* ssafe = rc + mi;
  float* tv = ssafe + mi;
  float* ds = tv + mi;
  float* dlam = ds + mi;
  float* scratch = dlam + mi;

  for (int i = tid; i < n * n; i += THREADS) H[i] = gH[b * n * n + i];
  for (int i = tid; i < me * n; i += THREADS) Aeq[i] = gAeq[b * me * n + i];
  for (int i = tid; i < mi * n; i += THREADS) Ain[i] = gAin[b * mi * n + i];
  for (int i = tid; i < n; i += THREADS) {
    g[i] = gg[b * n + i];
    x[i] = gx0[b * n + i];
  }
  for (int i = tid; i < me; i += THREADS) {
    beq[i] = gbeq[b * me + i];
    nu[i] = gnu0[b * me + i];
  }
  const float s_floor = gs_floor[b], lam_floor = glam_floor[b];
  for (int i = tid; i < mi; i += THREADS) {
    bin[i] = gbin[b * mi + i];
    lam[i] = nmax(glam0[b * mi + i], lam_floor);
  }
  __syncthreads();
  for (int r = tid; r < mi; r += THREADS) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc += Ain[r * n + k] * x[k];
    s[r] = nmax(bin[r] - acc, s_floor);
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    const float mu = block_reduce(mi, 0, [&](int i) { return s[i] * lam[i]; }, scratch) / mi;
    const float sigma_mu = nmax(0.2f * mu, mu_min);

    // residuals
    for (int i = tid; i < n; i += THREADS) {
      float acc = g[i];
      for (int k = 0; k < n; ++k) acc += H[i * n + k] * x[k];
      for (int r = 0; r < me; ++r) acc += Aeq[r * n + i] * nu[r];
      for (int r = 0; r < mi; ++r) acc += Ain[r * n + i] * lam[r];
      rd[i] = acc;
    }
    for (int r = tid; r < me; r += THREADS) {
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc += Aeq[r * n + k] * x[k];
      req[r] = acc - beq[r];
    }
    for (int r = tid; r < mi; r += THREADS) {
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc += Ain[r * n + k] * x[k];
      const float ri = acc + s[r] - bin[r];
      const float rcr = lam[r] * s[r] - sigma_mu;
      const float sf = nmax(s[r], 1e-12f);
      rin[r] = ri;
      rc[r] = rcr;
      ssafe[r] = sf;
      w[r] = lam[r] / sf;
      tv[r] = (lam[r] * ri - rcr) / sf;
    }
    __syncthreads();

    // Hbar = H + Ain' diag(w) Ain;  T = [Aeq' rbar]
    for (int idx = tid; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx - i * n;
      float acc = 0.0f;
      for (int r = 0; r < mi; ++r) acc += Ain[r * n + i] * (w[r] * Ain[r * n + j]);
      L[idx] = H[idx] + acc;
    }
    for (int idx = tid; idx < n * mt; idx += THREADS) {
      const int i = idx / mt, c = idx - i * mt;
      if (c < me) {
        T[idx] = Aeq[c * n + i];
      } else {
        float acc = 0.0f;
        for (int r = 0; r < mi; ++r) acc += Ain[r * n + i] * tv[r];
        T[idx] = rd[i] + acc;
      }
    }
    __syncthreads();
    const float trace = block_reduce(n, 0, [&](int i) { return L[i * n + i]; }, scratch);
    const float reg = 1e-7f * trace / n;
    for (int i = tid; i < n; i += THREADS) L[i * n + i] += reg;
    __syncthreads();
    cholesky(L, n);
    cho_solve(L, n, T, mt, mt);

    // Schur = Aeq HiA + eq_reg I;  dnu <- r_eq - Aeq Hir
    for (int idx = tid; idx < me * me; idx += THREADS) {
      const int r = idx / me, c = idx - r * me;
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc += Aeq[r * n + k] * T[k * mt + c];
      S[idx] = acc + (r == c ? eq_reg : 0.0f);
    }
    for (int r = tid; r < me; r += THREADS) {
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc += Aeq[r * n + k] * T[k * mt + me];
      dnu[r] = req[r] - acc;
    }
    __syncthreads();
    cholesky(S, me);
    cho_solve(S, me, dnu, 1, 1);

    for (int i = tid; i < n; i += THREADS) {
      float acc = 0.0f;
      for (int c = 0; c < me; ++c) acc += T[i * mt + c] * dnu[c];
      dx[i] = -T[i * mt + me] - acc;
    }
    __syncthreads();
    for (int r = tid; r < mi; r += THREADS) {
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc += Ain[r * n + k] * dx[k];
      const float d = -rin[r] - acc;
      ds[r] = d;
      dlam[r] = -(rc[r] + lam[r] * d) / ssafe[r];
    }
    __syncthreads();

    // fraction-to-boundary step length (a NaN direction gives ratio 1, as
    // jnp.where(d < 0, ..., 1.0) does)
    const float amin = block_reduce(
        2 * mi, 1,
        [&](int i) {
          const float d = i < mi ? ds[i] : dlam[i - mi];
          const float v = i < mi ? s[i] : lam[i - mi];
          return d < 0.0f ? -frac * v / nmin(d, -1e-12f) : 1.0f;
        },
        scratch);
    const float alpha = nmin(1.0f, amin);
    for (int i = tid; i < n; i += THREADS) x[i] += alpha * dx[i];
    for (int r = tid; r < mi; r += THREADS) {
      s[r] = nmax(s[r] + alpha * ds[r], 1e-12f);
      lam[r] = nmax(lam[r] + alpha * dlam[r], 1e-12f);
    }
    for (int r = tid; r < me; r += THREADS) nu[r] += alpha * dnu[r];
    __syncthreads();
  }

  // primal residual: max(max |Aeq x - beq|, max max(Ain x - bin, 0))
  const float res = block_reduce(
      me + mi, 2,
      [&](int i) {
        float acc = 0.0f;
        if (i < me) {
          for (int k = 0; k < n; ++k) acc += Aeq[i * n + k] * x[k];
          return fabsf(acc - beq[i]);
        }
        const int r = i - me;
        for (int k = 0; k < n; ++k) acc += Ain[r * n + k] * x[k];
        return nmax(acc - bin[r], 0.0f);
      },
      scratch);
  for (int i = tid; i < n; i += THREADS) ox[b * n + i] = x[i];
  for (int i = tid; i < me; i += THREADS) onu[b * me + i] = nu[i];
  for (int i = tid; i < mi; i += THREADS) olam[b * mi + i] = lam[i];
  if (tid == 0) ores[b] = res;
}

}  // namespace

extern "C" int hk_solve_qp(const float* H, const float* g, const float* Aeq, const float* beq,
                           const float* Ain, const float* bin, const float* x0,
                           const float* lam0, const float* nu0, const float* s_floor,
                           const float* lam_floor, float* x, float* nu, float* lam,
                           float* res, int batch, int n, int me, int mi, int n_iters,
                           float eq_reg, float frac, float mu_min, void* stream) {
  const size_t floats = 2 * n * n + 2 * me * n + mi * n + n + me * me + 4 * n + 4 * me +
                        10 * mi + 1;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        solve_qp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  solve_qp_kernel<<<batch, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      H, g, Aeq, beq, Ain, bin, x0, lam0, nu0, s_floor, lam_floor, x, nu, lam, res, n, me, mi,
      n_iters, eq_reg, frac, mu_min);
  return static_cast<int>(cudaGetLastError());
}
