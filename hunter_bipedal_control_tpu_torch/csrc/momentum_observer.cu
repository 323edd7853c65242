// B10: one update of the generalized-momentum disturbance observer.
//
// Replaces hunter_bipedal_control_tpu/estim/contact.py::
// momentum_observer_update (:49-100): M, the Coriolis matrix (through
// models/dynamics.py::coriolis_matrix, dM/dq), g, the first-order filter
// and the two legs' min-norm wrench solves (B6's 5x5 gj_inverse use), as
// the port's estim/contact.py::momentum_observer_plain computes them.
//
// The observer needs C(q, v)' v - g(q), not C: by Mdot = C + C' and the
// Newton-Euler form of C v (rbd_dynamics.cuh), C' v = sum_k dJ_k' h_k with
// h_k = (m_k c_dot_k, I_k w_k) link k's momentum at its CoM and dJ_k the
// time derivative of its CoM Jacobian along v; and M v = sum_k J_k' h_k.
// So no dM/dq and no M is formed.
//
// One 128-thread block per scenario, in seven phases over shared memory:
//   1. lane 0 runs the chain (rbd -> q, v in the Euler-rate form; FK, world
//      inertias, the velocity pass, E and dE/dt; rbd_dynamics.cuh);
//   2. a lane per link fills its CoM's 16 Jacobian columns, J v and its
//      momentum h_k; a lane per toe its linear Jacobian rows;
//   3. a lane per (link, column) its term of dJ_k' h_k; 60 lanes the two
//      legs' A = S_l J6' (5 x 6: the toe's linear rows and its link's
//      angular columns, joint columns 6..10 and 11..15);
//   4. a lane per coordinate i: p_i = sum_k J_k,i' h_k, (C' v)_i, g_i =
//      9.81 sum_k m_k (J_lin,k)_z,i, and the filter:
//        gamma = exp(-lambda dt), beta = (1 - gamma) / (gamma dt),
//        p_scg = beta p + S' tau + C' v - g,
//        p_scg_z = (1 - gamma) p_scg + gamma p_scg_z_last,
//        tau_dist = beta p - p_scg_z;
//      50 lanes the legs' A A' + 1e-6 I;
//   5. 10 lanes the legs' right-hand sides b = S_l tau_dist;
//   6. a lane per leg eliminates its tableau [A A' + 1e-6 I | b] by
//      gj.cuh's Gauss-Jordan (pivots in the natural order, each + 1e-30, as
//      the JAX package's gj_inverse adds it): y = (A A' + 1e-6 I)^-1 b,
//      the inverse never formed;
//   7. 12 lanes w = A' y, then 4 lanes the norms: est_forces = [w_L, w_R,
//      |F_L|, |F_R|, |w_L|, |w_R|].
// Nothing is clamped or branched on the data, so a NaN state spreads as
// it does in the plain version.
//
// Work: per scenario 58 floats in, 48 out.  The function needs ~10k
// floating-point operations per scenario (chip_smoke.py::observer_cost);
// at B=1 the kernel is latency bound (one serial chain, ~8 barriers).
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too; the cutoff frequency from a one-float buffer
// (estim/contact.py::params_buffer).  True float32: no fast math.
#include <cuda_runtime.h>

#include "gj.cuh"
#include "rbd_dynamics.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NRBD = 2 * NQ;    // 32
constexpr int NLEG = 5;         // joints per leg
constexpr int NEST = 16;        // est_forces
constexpr int TW = 2 * NLEG;    // tableau width: [A A' + 1e-6 I | b | 0]

__global__ void __launch_bounds__(THREADS)
momentum_observer_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                         const float* __restrict__ grbd, const float* __restrict__ gtau,
                         const float* __restrict__ gpl, float dt, float* __restrict__ opz,
                         float* __restrict__ oest, float* __restrict__ otd) {
  __shared__ State s;
  __shared__ float K[N_CONSTS], lam, rbd[NRBD], tau[NJ], pl[NQ];
  __shared__ float cd[L][3], hl[L][3], ha[L][3];   // CoM velocities, momenta
  __shared__ float term[L][NQ];                     // dJ_k' h_k by link
  __shared__ float td[NQ];                          // tau_dist
  __shared__ float A[2][NLEG][6], T[2][NLEG][TW], w[2][6];

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  for (int i = tid; i < N_CONSTS; i += THREADS) K[i] = gK[i];
  if (tid < NRBD) rbd[tid] = grbd[b * NRBD + tid];
  if (tid < NJ) tau[tid] = gtau[b * NJ + tid];
  if (tid < NQ) pl[tid] = gpl[b * NQ + tid];
  if (tid == 0) lam = gP[0];
  __syncthreads();

  // ---- 1. the chain ----
  if (tid == 0) {
    float q[NQ];
    rbd_to_qv(rbd, q, s.v);
    state_chain(K, q, &s);
  }
  __syncthreads();

  // ---- 2. the links' columns and momenta, the toes' linear rows ----
  if (tid < L) {
    link_columns(&s, tid);
    link_momentum(K, &s, tid, cd[tid], hl[tid], ha[tid]);
  } else if (tid >= 32 && tid < 34) {
    contact_columns(K, &s, tid - 32);
  }
  __syncthreads();

  // ---- 3. dJ_k' h_k by (link, column); the legs' A ----
  for (int e = tid; e < L * NQ; e += THREADS) {
    const int k = e / NQ, i = e % NQ;
    term[k][i] = momentum_rate_term(&s, k, i, cd[k], hl[k], ha[k]);
  }
  for (int e = tid; e < 2 * NLEG * 6; e += THREADS) {
    const int l = e / (NLEG * 6), r = (e / 6) % NLEG, c = e % 6;
    const int col = 6 + NLEG * l + r;
    // toe l sits on link c_cparent[l]: its angular rows are that link's
    A[l][r][c] = c < 3 ? s.Jc[3 * l + c][col] : s.Ja[c_cparent[l]][col][c - 3];
  }
  __syncthreads();

  // ---- 4. p, C' v - g and the filter; the legs' A A' + 1e-6 I ----
  if (tid < NQ) {
    const int i = tid;
    float p = 0.0f, cv = 0.0f, gz = 0.0f;
    for (int k = 0; k < L; ++k) {
      const float* li = s.Jl[k][i];
      const float* ai = s.Ja[k][i];
      p = p + (((li[0] * hl[k][0] + li[1] * hl[k][1]) + li[2] * hl[k][2])
               + ((ai[0] * ha[k][0] + ai[1] * ha[k][1]) + ai[2] * ha[k][2]));
      cv = cv + term[k][i];
      gz = gz + K[K_MASS + k] * li[2];
    }
    const float g = GRAVITY * gz;
    const float gama = expf(-lam * dt);
    const float beta = (1.0f - gama) / (gama * dt);
    const float p_scg = ((beta * p + (i < 6 ? 0.0f : tau[i - 6])) + cv) - g;
    const float pz = (1.0f - gama) * p_scg + gama * pl[i];
    const float dist = beta * p - pz;
    td[i] = dist;
    opz[b * NQ + i] = pz;
    otd[b * NQ + i] = dist;
  } else if (tid >= 32 && tid < 32 + 2 * NLEG * NLEG) {
    const int e = tid - 32, l = e / (NLEG * NLEG), r = (e / NLEG) % NLEG, c = e % NLEG;
    float acc = 0.0f;
    for (int j = 0; j < 6; ++j) acc = acc + A[l][r][j] * A[l][c][j];
    T[l][r][c] = acc + (r == c ? 1e-6f : 0.0f);
  }
  __syncthreads();

  // ---- 5. the right-hand sides ----
  if (tid < 2 * NLEG) {
    const int l = tid / NLEG, r = tid % NLEG;
    T[l][r][NLEG] = td[6 + NLEG * l + r];
    for (int c = NLEG + 1; c < TW; ++c) T[l][r][c] = 0.0f;
  }
  __syncthreads();

  // ---- 6. Gauss-Jordan, a lane per leg ----
  if (tid < 2) {
    float col[NLEG], prow[TW];
    gj_eliminate_n<false>(&T[tid][0][0], NLEG, TW, true, col, prow, 0, 1);
  }
  __syncthreads();

  // ---- 7. the wrenches and their norms ----
  if (tid < 12) {
    const int l = tid / 6, c = tid % 6;
    float acc = 0.0f;
    for (int r = 0; r < NLEG; ++r) acc = acc + A[l][r][c] * T[l][r][NLEG];
    w[l][c] = acc;
    oest[b * NEST + tid] = acc;
  }
  __syncthreads();
  if (tid < 4) {
    const int l = tid % 2, n = tid < 2 ? 3 : 6;
    float ss = 0.0f;
    for (int c = 0; c < n; ++c) ss = ss + w[l][c] * w[l][c];
    oest[b * NEST + 12 + tid] = sqrtf(ss);
  }
}

}  // namespace

extern "C" int hk_momentum_observer(const float* consts, const float* params, const float* rbd,
                                    const float* tau, const float* p_last, float* p_scg_z,
                                    float* est_forces, float* tau_dist, int batch, float dt,
                                    void* stream) {
  momentum_observer_kernel<<<static_cast<unsigned>(batch), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(consts, params, rbd, tau,
                                                                  p_last, dt, p_scg_z,
                                                                  est_forces, tau_dist);
  return static_cast<int>(cudaGetLastError());
}
