// B4: batched dense convex QP by a fixed-count primal-dual interior point.
//
// Replaces hunter_bipedal_control_tpu/ops/qp.py::solve_qp (the WBC's QP,
// wbc/wbc.py:294-300: 38 variables, 28 equality rows, 40 inequality rows,
// 10 iterations; the hierarchical WBC's levels: one equality row, 40 or 1
// inequality rows, 15 iterations).  Per QP and iteration, as the JAX
// version:
//   mu = s'lam / mi,  sigma_mu = max(0.2 mu, mu_min)
//   residuals r_dual, r_eq, r_ineq, r_cent;  w = lam / max(s, 1e-12)
//   Hbar = H + Ain' diag(w) Ain + 1e-7 tr(Hbar)/n I,  L L' = sym(Hbar)
//   Schur = Aeq Hbar^-1 Aeq' + eq_reg I,  dnu = Schur^-1 (r_eq - Aeq Hbar^-1 rbar)
//   dx = -Hbar^-1 (rbar + Aeq' dnu), ds, dlam
//   alpha = min(1, fraction-to-boundary ratios over s and lam)
// in one forward sweep: Y = L^-1 [Aeq' | rbar] (29 columns at the WBC's
// shape), Schur = Y_A' Y_A + eq_reg I (a Gram product, exactly symmetric),
// Aeq Hbar^-1 rbar = Y_A' y_r, dx = -L'^-1 (y_r + Y_A dnu): the algebra of
// JAX's two cho_solves over [Aeq' rbar], with other rounding.
// A Cholesky that fails (a pivot <= 0 or NaN) leaves a NaN lower triangle,
// as jnp.linalg.cholesky does, and NaN propagates through every max and min
// below (fmaxf / fminf would drop it), so a failed solve ends with a NaN x
// and the WBC's acceptance test falls back exactly where the JAX one does.
// True fp32 throughout (no tensor cores: the products are 38 wide).
//
// Bound on the card: ~0.19 MFLOP per QP and iteration in the least work of
// this elimination (the symmetric products Hbar and the Schur matrix one
// triangle each, one forward sweep, one back sweep of one column) against
// ~17 KB of input and output per QP, so at B = 4096 and 10 iterations the
// work is ~7.7 GFLOP (~0.11 ms at 67 TFLOP/s fp32) against ~71 MB (~0.02 ms
// at 3.35 TB/s): bound by operations.  The operations sit in chains of
// small dependent steps (two Cholesky factorizations and three triangular
// sweeps per iteration), so at B = 1 the latency of one QP's chain sets the
// time (one warp issuing the QP's operations at one per lane and clock
// would take ~0.03 ms), and at B = 4096 the QPs in flight per SM.
//
// Design: one warp per QP and no __syncthreads anywhere.  Two QPs' warps
// share a block, each on its own slice of shared memory; a warp past the
// batch returns at once.  Phases are separated by __syncwarp, and the
// reductions (mu, the trace, the step length, the final residual) are
// warp shuffles.  Lanes own the entries lane and lane + 32 of every vector
// (n, me, mi <= 64).  H, Ain and Aeq stay in shared memory at an odd row
// stride (no bank conflicts down a column or along a row); the symmetric
// matrices (Hbar and its factor, the Schur matrix and its factor) are
// packed lower triangles.  Hbar and the Schur matrix are formed in 4 x 4
// register tiles of their lower block triangle (16 independent sums per
// lane).  The Cholesky factorizations are left-looking with the lanes
// owning rows and the pivot passed by shuffle; with the size compiled in,
// the rows stay in registers and each column's update is one shuffle and
// one multiply-add per later column.  Every sweep multiplies by the
// pivots' reciprocals (a division on the chain costs more than the rest
// of the step).  One lane per right-hand side runs the forward sweep over
// [Aeq' rbar] with no barrier; the two single-column sweeps keep the column
// in the lanes' registers and pass the pivot entry by shuffle.  At the
// WBC's shape a QP takes 27,232 bytes of shared memory: eight QPs per SM.
// The WBC's sizes are compiled in (fixed trip counts, the factors' rows
// and the forward sweep's column in registers); every other shape runs the
// same kernel with runtime sizes.
#include <cuda_runtime.h>

namespace {

// The WBC's QP (wbc/wbc.py: NDEC, N_EQ_ROWS, N_INEQ_ROWS), compiled in.
constexpr int WBC_N = 38, WBC_ME = 28, WBC_MI = 40;
// The largest n, me, mi the kernel takes (ops/qp.py::MAX_DIM): a lane owns
// at most two entries of each vector.
constexpr int MAX_DIM = 64;
// QPs (warps) per block, at most; the shared memory a block may take.
constexpr int MAX_QPS_PER_BLOCK = 2;
constexpr int MAX_SMEM = 232448;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// Measurement build only (profile_step qp_phases): -DQP_PHASE_CLOCKS sums
// QP 0's clock64 cycles per phase of the iteration (lane 0, at the phase's
// end).
constexpr int QP_PHASES = 10;  // mu, residuals, hbar_rbar, chol_hbar, forward_sweep,
                               // schur, chol_schur, dnu, dx, step
#ifdef QP_PHASE_CLOCKS
__device__ unsigned long long qp_phase_cycles[QP_PHASES];
#define QP_PHASE(p)                                  \
  if (b == 0 && lane == 0) {                         \
    const long long now = clock64();                 \
    qp_phase_cycles[p] += now - t_phase;             \
    t_phase = now;                                   \
  }
#else
#define QP_PHASE(p)
#endif

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// max / min that return NaN if either argument is NaN (jnp.maximum / min).
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fminf(a, b);
}

// Butterfly reductions: every lane ends with the same bits (each step
// combines the same two values on both lanes).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = nmin(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Entry k of a vector whose entry i lives in lane i % 32, slot i / 32.
__device__ __forceinline__ float lane_entry(const float (&v)[2], int k) {
  return __shfl_sync(FULL, k < 32 ? v[0] : v[1], k & 31);
}

// Packed lower triangle: entry (i, j), j <= i, at tri(i) + j.
__host__ __device__ __forceinline__ int tri(int i) { return (i * (i + 1)) >> 1; }

// The lane's first tile (bi, bj), bj <= bi, of a block triangle in row
// order, then every 32nd: rows of 1, 2, 3, ... tiles are stepped by counters.
__device__ __forceinline__ void next_tile(int& bi, int& bj) {
  while (bj > bi) {
    bj -= bi + 1;
    ++bi;
  }
}

// store(i, j, sum_{r < len} a(r, i) w_r a(r, j)) for every entry j <= i < m
// of a lower triangle, a(r, i) = A[r * rs + i * es], w_r = 1 without WEIGHTS.
// A lane takes 4 x 4 tiles of the block triangle (16 independent sums, 8
// loads per r), every 32nd from its own; a diagonal tile stores its lower
// half.  Rows past m read row m - 1 and are not stored.
template <bool WEIGHTS, class Store>
__device__ void gram(int m, int len, const float* A, int rs, int es, const float* w, int lane,
                     Store store) {
  const int nb = (m + 3) >> 2;
  int bi = 0, bj = lane;
  next_tile(bi, bj);
  for (; bi < nb; bj += 32, next_tile(bi, bj)) {
    int iu[4], jv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      iu[u] = min(4 * bi + u, m - 1) * es;
      jv[u] = min(4 * bj + u, m - 1) * es;
    }
    float acc[4][4] = {};
#pragma unroll 2
    for (int r = 0; r < len; ++r) {
      const float* a = A + r * rs;
      float ai[4], aj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ai[u] = a[iu[u]];
        aj[u] = a[jv[u]];
      }
      if constexpr (WEIGHTS) {
        const float wr = w[r];
#pragma unroll
        for (int v = 0; v < 4; ++v) aj[v] = wr * aj[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += ai[u] * aj[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * bi + u, j = 4 * bj + v;
        if (i < m && j <= i) store(i, j, acc[u][v]);
      }
  }
}

// One QP's slice of shared memory, in floats.  ld (odd) is the row stride of
// H, Ain, Aeq and the Y buffer.
struct Layout {
  int ld, h, ain, aeq, yt, l, s, g, beq, bin, x, dx, invl, invs, nu, lam, w, tv, total;
};

__host__ __device__ inline Layout layout(int n, int me, int mi) {
  Layout o;
  o.ld = n | 1;
  int p = 0;
  o.h = p;    p += n * o.ld;
  o.ain = p;  p += mi * o.ld;
  o.aeq = p;  p += me * o.ld;
  o.yt = p;   p += (me + 1) * o.ld;  // rows: Y' = (L^-1 [Aeq' rbar])'
  o.l = p;    p += tri(n);
  o.s = p;    p += tri(me);
  o.g = p;    p += n;
  o.beq = p;  p += me;
  o.bin = p;  p += mi;
  o.x = p;    p += n;
  o.dx = p;   p += n;
  o.invl = p; p += n;
  o.invs = p; p += me;
  o.nu = p;   p += me;
  o.lam = p;  p += mi;
  o.w = p;    p += mi;
  o.tv = p;   p += mi;
  o.total = p;
  return o;
}

// In place: the packed lower triangle A (m rows) -> its Cholesky factor
// (A holds one triangle, so it is its own symmetrization), left-looking:
// lane i % 32 owns rows i, and column k is one chain per row, A_ik - sum_p
// L_ip L_kp (p = 0, 1, ..., k - 1), the pivot passed by shuffle.
// inv_d[k] = 1 / L_kk for the sweeps.  A pivot that is not > 0 (NaN
// included) leaves the whole triangle and inv_d NaN, as jnp.linalg.cholesky
// does; every lane holds the same pivot, so the exit is uniform over the
// warp.  Entry and exit behind __syncwarp.
__device__ void cholesky(float* A, int m, float* inv_d, int lane) {
  const int i0 = min(lane, m - 1), i1 = min(lane + 32, m - 1);
  const int t0 = tri(i0), t1 = tri(i1);
  for (int k = 0; k < m; ++k) {
    const int tk = tri(k);
    // rows below k read past their own row: valid memory, not stored
    float a0 = A[t0 + k], a1 = A[t1 + k];
#pragma unroll 4
    for (int p = 0; p < k; ++p) {
      const float lk = A[tk + p];
      a0 -= A[t0 + p] * lk;
      a1 -= A[t1 + p] * lk;
    }
    const float acc[2] = {a0, a1};
    const float d = lane_entry(acc, k);
    if (!(d > 0.0f)) {
      for (int p = lane; p < tri(m); p += 32) A[p] = qnan();
      for (int p = lane; p < m; p += 32) inv_d[p] = qnan();
      __syncwarp();
      return;
    }
    const float r = sqrtf(d), inv = 1.0f / r;
    if (lane == (k & 31)) {
      A[tk + k] = r;
      inv_d[k] = inv;
    }
    if (lane > k && lane < m) A[t0 + k] = a0 * inv;
    if (lane + 32 > k && lane + 32 < m) A[t1 + k] = a1 * inv;
    __syncwarp();
  }
}

// cholesky() with the size M compiled in: the lane's rows stay in registers
// through the factorization (right-looking: column k's update is, per later
// column j, one shuffle of L_jk and one multiply-add per row, all
// independent), then go back to A.
template <int M>
__device__ void cholesky_regs(float* A, float* inv_d, int lane) {
  constexpr int R = (M + 31) / 32;  // rows per lane
  float a[R][M];  // a[t][j] = A(lane + 32 t, j) for j <= that row
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int i = min(lane + 32 * t, M - 1);  // rows past M: copies of row M - 1
#pragma unroll
    for (int j = 0; j < M; ++j) a[t][j] = j <= i ? A[tri(i) + j] : 0.0f;
  }
  bool ok = true;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float d = __shfl_sync(FULL, a[k >> 5][k], k & 31);
    if (!(d > 0.0f)) {  // uniform: every lane holds the same pivot
      ok = false;
      break;
    }
    const float r = sqrtf(d), inv = 1.0f / r;
    float l[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      l[t] = a[t][k] * inv;  // entries right of a row's diagonal are never stored
      a[t][k] = lane + 32 * t == k ? r : l[t];
    }
    if (lane == (k & 31)) inv_d[k] = inv;
#pragma unroll
    for (int j = k + 1; j < M; ++j) {
      const float ljk = __shfl_sync(FULL, l[j >> 5], j & 31);
#pragma unroll
      for (int t = 0; t < R; ++t) a[t][j] -= l[t] * ljk;
    }
  }
  if (!ok) {
    for (int p = lane; p < tri(M); p += 32) A[p] = qnan();
    for (int p = lane; p < M; p += 32) inv_d[p] = qnan();
  } else {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int i = lane + 32 * t;
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (j <= i && i < M) A[tri(i) + j] = a[t][j];
    }
  }
  __syncwarp();
}

// Rows c <= me of Yt (right-hand sides of length n, row stride ld) <- rows of
// L^-1 [Aeq' | rbar]: row c < me starts as Aeq's row c, row me holds rbar.
// One lane per row, no barrier inside; each step multiplies by 1 / L_kk.
// With the size compiled in (NC > 0) the row is held in registers.
template <int NC>
__device__ void forward_rows(const float* L, const float* inv_d, const float* Aeq, float* Yt,
                             int n, int me, int ld, int lane) {
  for (int c = lane; c <= me; c += 32) {
    const float* src = c < me ? Aeq + c * ld : Yt + me * ld;
    float* y = Yt + c * ld;
    if constexpr (NC > 0) {
      float v[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) v[i] = src[i];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        v[k] *= inv_d[k];
#pragma unroll
        for (int i = k + 1; i < NC; ++i) v[i] -= L[tri(i) + k] * v[k];
      }
#pragma unroll
      for (int i = 0; i < NC; ++i) y[i] = v[i];
    } else {
      if (c < me)
        for (int i = 0; i < n; ++i) y[i] = src[i];
      for (int k = 0; k < n; ++k) {
        const float yk = y[k] * inv_d[k];
        y[k] = yk;
        int ti = tri(k + 1);
        for (int i = k + 1; i < n; ++i) {
          y[i] -= L[ti + k] * yk;
          ti += i + 1;
        }
      }
    }
  }
  __syncwarp();
}

// v (entry i in lane i % 32, slot i / 32; m rows) <- L'^-1 v, or with
// `forward` first L^-1 v and then L'^-1 of that.  L is a packed factor,
// inv_d its diagonal's reciprocals; the pivot entry travels by shuffle.
__device__ void solve_column(const float* L, const float* inv_d, int m, float (&v)[2], int lane,
                             bool forward) {
  if (forward)
    for (int k = 0; k < m; ++k) {
      const float yk = lane_entry(v, k) * inv_d[k];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = lane + 32 * t;
        if (i == k) v[t] = yk;
        else if (i > k && i < m) v[t] -= L[tri(i) + k] * yk;
      }
    }
  for (int k = m - 1; k >= 0; --k) {
    const int tk = tri(k);
    const float zk = lane_entry(v, k) * inv_d[k];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = lane + 32 * t;
      if (i == k) v[t] = zk;
      else if (i < k) v[t] -= L[tk + i] * zk;
    }
  }
}

template <int NC, int EC, int IC>
__global__ void __launch_bounds__(32 * MAX_QPS_PER_BLOCK)
solve_qp_kernel(const float* __restrict__ gH, const float* __restrict__ gg,
                const float* __restrict__ gAeq, const float* __restrict__ gbeq,
                const float* __restrict__ gAin, const float* __restrict__ gbin,
                const float* __restrict__ gx0, const float* __restrict__ glam0,
                const float* __restrict__ gnu0, const float* __restrict__ gmargin,
                float* __restrict__ ox, float* __restrict__ onu, float* __restrict__ olam,
                float* __restrict__ ores, int* __restrict__ oits, int batch, int n_rt,
                int me_rt, int mi_rt, int n_iters, int margin_stride, float eq_reg, float frac,
                float mu_min, float margin_value) {
  extern __shared__ float smem[];
  const int n = NC > 0 ? NC : n_rt, me = EC > 0 ? EC : me_rt, mi = IC > 0 ? IC : mi_rt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // the whole warp: nothing below waits on another warp
  const Layout lay = layout(n, me, mi);
  const int ld = lay.ld;
  float* sm = smem + warp * lay.total;
  float* H = sm + lay.h;
  float* Ain = sm + lay.ain;
  float* Aeq = sm + lay.aeq;
  float* Yt = sm + lay.yt;
  float* L = sm + lay.l;
  float* S = sm + lay.s;
  float* g = sm + lay.g;
  float* beq = sm + lay.beq;
  float* bin = sm + lay.bin;
  float* x = sm + lay.x;
  float* dx = sm + lay.dx;
  float* invl = sm + lay.invl;
  float* invs = sm + lay.invs;
  float* nu = sm + lay.nu;
  float* lam = sm + lay.lam;
  float* w = sm + lay.w;
  float* tv = sm + lay.tv;
  float* yr = Yt + me * ld;  // rbar, then L^-1 rbar

  for (int i = 0; i < n; ++i)
    for (int k = lane; k < n; k += 32) H[i * ld + k] = gH[(b * n + i) * n + k];
  for (int r = 0; r < mi; ++r)
    for (int k = lane; k < n; k += 32) Ain[r * ld + k] = gAin[(b * mi + r) * n + k];
  for (int r = 0; r < me; ++r)
    for (int k = lane; k < n; k += 32) Aeq[r * ld + k] = gAeq[(b * me + r) * n + k];
  const float margin = gmargin ? gmargin[b * margin_stride] : margin_value;
  const float s_floor = gx0 ? margin : 1.0f;
  // lane-owned entries: index lane + 32 t (the slacks in registers)
  float s_[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = lane + 32 * t;
    if (i < n) {
      g[i] = gg[b * n + i];
      x[i] = gx0 ? gx0[b * n + i] : 0.0f;
    }
    if (i < me) {
      beq[i] = gbeq[b * me + i];
      nu[i] = gnu0 ? gnu0[b * me + i] : 0.0f;
    }
    if (i < mi) {
      bin[i] = gbin[b * mi + i];
      lam[i] = glam0 ? nmax(glam0[b * mi + i], margin) : 1.0f;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = lane + 32 * t;
    if (r < mi) {
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc += Ain[r * ld + k] * x[k];
      s_[t] = nmax(bin[r] - acc, s_floor);
    }
  }

#ifdef QP_PHASE_CLOCKS
  long long t_phase = clock64();
#endif
  for (int it = 0; it < n_iters; ++it) {
    float part = 0.0f;
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (lane + 32 * t < mi) part += s_[t] * lam[lane + 32 * t];
    const float mu = warp_sum(part) / mi;
    const float sigma_mu = nmax(0.2f * mu, mu_min);
    QP_PHASE(0)

    // residuals
    float rd_[2] = {0.0f, 0.0f}, req_[2] = {0.0f, 0.0f};
    float rin_[2] = {0.0f, 0.0f}, rc_[2] = {0.0f, 0.0f}, ss_[2] = {1.0f, 1.0f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = lane + 32 * t;
      if (i < n) {
        float hx = 0.0f, an = 0.0f, al = 0.0f;
        for (int k = 0; k < n; ++k) hx += H[i * ld + k] * x[k];
        for (int r = 0; r < me; ++r) an += Aeq[r * ld + i] * nu[r];
        for (int r = 0; r < mi; ++r) al += Ain[r * ld + i] * lam[r];
        rd_[t] = ((hx + g[i]) + an) + al;
      }
      if (i < me) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k) acc += Aeq[i * ld + k] * x[k];
        req_[t] = acc - beq[i];
      }
      if (i < mi) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k) acc += Ain[i * ld + k] * x[k];
        const float l = lam[i];
        rin_[t] = acc + s_[t] - bin[i];
        rc_[t] = l * s_[t] - sigma_mu;
        ss_[t] = nmax(s_[t], 1e-12f);
        w[i] = l / ss_[t];
        tv[i] = (l * rin_[t] - rc_[t]) / ss_[t];
      }
    }
    __syncwarp();
    QP_PHASE(1)

    // Hbar = sym(H) + Ain' diag(w) Ain, one triangle
    gram<true>(n, mi, Ain, ld, 1, w, lane, [&](int i, int j, float acc) {
      const float h = i == j ? H[i * ld + i] : 0.5f * (H[i * ld + j] + H[j * ld + i]);
      L[tri(i) + j] = h + acc;
    });
    // rbar = r_dual + Ain' (lam r_ineq - r_cent) / s
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = lane + 32 * t;
      if (i < n) {
        float acc = 0.0f;
        for (int r = 0; r < mi; ++r) acc += Ain[r * ld + i] * tv[r];
        yr[i] = rd_[t] + acc;
      }
    }
    __syncwarp();
    float trace = 0.0f;
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (lane + 32 * t < n) trace += L[tri(lane + 32 * t) + lane + 32 * t];
    const float reg = 1e-7f * warp_sum(trace) / n;
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (lane + 32 * t < n) L[tri(lane + 32 * t) + lane + 32 * t] += reg;
    __syncwarp();
    QP_PHASE(2)

    // L L' = Hbar;  Y = L^-1 [Aeq' rbar]
    if constexpr (NC > 0)
      cholesky_regs<NC>(L, invl, lane);
    else
      cholesky(L, n, invl, lane);
    QP_PHASE(3)
    forward_rows<NC>(L, invl, Aeq, Yt, n, me, ld, lane);
    QP_PHASE(4)

    // Schur = Y_A' Y_A + eq_reg I (one triangle);  rhs = r_eq - Y_A' y_r
    gram<false>(me, n, Yt, 1, ld, nullptr, lane, [&](int i, int j, float acc) {
      S[tri(i) + j] = acc + (i == j ? eq_reg : 0.0f);
    });
    float dnu_[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = lane + 32 * t;
      if (r < me) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k) acc += Yt[r * ld + k] * yr[k];
        dnu_[t] = req_[t] - acc;
      }
    }
    __syncwarp();
    QP_PHASE(5)
    if constexpr (EC > 0)
      cholesky_regs<EC>(S, invs, lane);
    else
      cholesky(S, me, invs, lane);
    QP_PHASE(6)
    solve_column(S, invs, me, dnu_, lane, true);
    QP_PHASE(7)

    // dx = -L'^-1 (y_r + Y_A dnu)
    float dx_[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (lane + 32 * t < n) dx_[t] = yr[lane + 32 * t];
    for (int c = 0; c < me; ++c) {
      const float dc = lane_entry(dnu_, c);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (lane + 32 * t < n) dx_[t] += Yt[c * ld + lane + 32 * t] * dc;
    }
    solve_column(L, invl, n, dx_, lane, false);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      dx_[t] = -dx_[t];
      if (lane + 32 * t < n) dx[lane + 32 * t] = dx_[t];
    }
    __syncwarp();
    QP_PHASE(8)

    // ds, dlam and the fraction-to-boundary step (a NaN direction gives
    // ratio 1, as jnp.where(d < 0, ..., 1.0) does)
    float ds_[2] = {0.0f, 0.0f}, dl_[2] = {0.0f, 0.0f}, amin = 1.0f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = lane + 32 * t;
      if (r < mi) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k) acc += Ain[r * ld + k] * dx[k];
        const float l = lam[r];
        const float d = -rin_[t] - acc;
        ds_[t] = d;
        dl_[t] = -(rc_[t] + l * d) / ss_[t];
        const float rs = d < 0.0f ? -frac * s_[t] / nmin(d, -1e-12f) : 1.0f;
        const float rl = dl_[t] < 0.0f ? -frac * l / nmin(dl_[t], -1e-12f) : 1.0f;
        amin = nmin(amin, nmin(rs, rl));
      }
    }
    const float alpha = nmin(1.0f, warp_min(amin));
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = lane + 32 * t;
      if (i < n) x[i] += alpha * dx_[t];
      if (i < mi) {
        s_[t] = nmax(s_[t] + alpha * ds_[t], 1e-12f);
        lam[i] = nmax(lam[i] + alpha * dl_[t], 1e-12f);
      }
      if (i < me) nu[i] += alpha * dnu_[t];
    }
    __syncwarp();
    QP_PHASE(9)
  }

  // primal residual: max(max |Aeq x - beq|, max max(Ain x - bin, 0))
  float res = 0.0f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = lane + 32 * t;
    if (r < me) {
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc += Aeq[r * ld + k] * x[k];
      res = nmax(res, fabsf(acc - beq[r]));
    }
    if (r < mi) {
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) acc += Ain[r * ld + k] * x[k];
      res = nmax(res, nmax(acc - bin[r], 0.0f));
    }
  }
  res = warp_max(res);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = lane + 32 * t;
    if (i < n) ox[b * n + i] = x[i];
    if (i < me) onu[b * me + i] = nu[i];
    if (i < mi) olam[b * mi + i] = lam[i];
  }
  if (lane == 0) {
    ores[b] = res;
    oits[b] = n_iters;
  }
}

template <int NC, int EC, int IC>
int launch(const float* H, const float* g, const float* Aeq, const float* beq, const float* Ain,
           const float* bin, const float* x0, const float* lam0, const float* nu0,
           const float* margin, float* x, float* nu, float* lam, float* res, int* its,
           int batch, int n, int me, int mi, int n_iters, int margin_stride, float eq_reg,
           float frac, float mu_min, float margin_value, cudaStream_t stream) {
  const size_t per_qp = static_cast<size_t>(layout(n, me, mi).total) * sizeof(float);
  int qps = MAX_QPS_PER_BLOCK;
  while (qps > 1 && qps * per_qp > MAX_SMEM) --qps;
  const size_t bytes = qps * per_qp;
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {  // raised once per device and instance
    static size_t raised[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= MAX_DEVICES || raised[dev] < bytes) {
      e = cudaFuncSetAttribute(solve_qp_kernel<NC, EC, IC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < MAX_DEVICES) raised[dev] = bytes;
    }
  }
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(batch) + qps - 1) / qps);
  solve_qp_kernel<NC, EC, IC><<<blocks, 32 * qps, bytes, stream>>>(
      H, g, Aeq, beq, Ain, bin, x0, lam0, nu0, margin, x, nu, lam, res, its, batch, n, me, mi,
      n_iters, margin_stride, eq_reg, frac, mu_min, margin_value);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0, lam0, nu0 may be NULL (the cold start: 0, 1, 0); margin may be NULL
// (then margin_value for every QP), else QP b reads margin[b * margin_stride].
// The slack floor is the margin with x0, else 1; lam0 is floored at the margin.
extern "C" int hk_solve_qp(const float* H, const float* g, const float* Aeq, const float* beq,
                           const float* Ain, const float* bin, const float* x0,
                           const float* lam0, const float* nu0, const float* margin, float* x,
                           float* nu, float* lam, float* res, int* its, int batch, int n, int me,
                           int mi, int n_iters, int margin_stride, float eq_reg, float frac,
                           float mu_min, float margin_value, void* stream) {
  if (n < 1 || me < 1 || mi < 1 || n > MAX_DIM || me > MAX_DIM || mi > MAX_DIM || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == WBC_N && me == WBC_ME && mi == WBC_MI)
    return launch<WBC_N, WBC_ME, WBC_MI>(H, g, Aeq, beq, Ain, bin, x0, lam0, nu0, margin, x, nu,
                                         lam, res, its, batch, n, me, mi, n_iters,
                                         margin_stride, eq_reg, frac, mu_min, margin_value, st);
  return launch<0, 0, 0>(H, g, Aeq, beq, Ain, bin, x0, lam0, nu0, margin, x, nu, lam, res, its,
                         batch, n, me, mi, n_iters, margin_stride, eq_reg, frac, mu_min,
                         margin_value, st);
}

#ifdef QP_PHASE_CLOCKS
// The phase sums since the last call (QP_PHASES of them), then zeroed.
extern "C" int hk_qp_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, qp_phase_cycles, sizeof(qp_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[QP_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(qp_phase_cycles, zero, sizeof(zero)));
}
#endif
