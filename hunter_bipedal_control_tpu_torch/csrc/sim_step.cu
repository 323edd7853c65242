// B11: the full-order plant's physics substeps of one control tick.
//
// Replaces the substep scan of hunter_bipedal_control_tpu/backends/
// fullorder.py::sim_step (:145-189): per substep FK, the contact points and
// their Jacobians, the spring-damper contact law with its Coulomb clamp
// (_contact_force :102), the clamped PD + feedforward motor (_motor_torque
// :119), models/dynamics.py's mass_matrix and nle, the optional mass scale
// and uniform field (:159-174), the 16x16 system M + diag(armature + dt
// damping) solved for the acceleration (the B6 gj_inverse use of :181-182)
// and the semi-implicit Euler update, as the port's
// backends/fullorder.py::substeps_plain computes them.  The 32-slot command
// ring stays in the torch wrapper (backends/fullorder.py::sim_step).
//
// One 128-thread block per scenario runs all the tick's substeps, in six
// phases per substep over shared memory:
//   1. lane 0 runs the chain (FK, world inertias, the velocity pass, E and
//      dE/dt; rbd_dynamics.cuh, as B9 runs it);
//   2. a lane per link fills its CoM's 16 Jacobian columns, J v, dJ/dt v and
//      its wrench terms of nle; a lane per contact its point, Jacobian and
//      J v;
//   3. lanes per (i, j) sum M; a lane per coordinate nle and the field's
//      generalized force sum_k m_k Jlin_k' a; 4 lanes the contact law; 10
//      lanes the clamped motor torque;
//   4. a lane per row the tableau [A_sys | rhs]: A_sys = ms M + diag(arm +
//      dt damp), rhs = S' tau + sum_c Jc' f_c + ms field - ms nle - damp v;
//   5. Gauss-Jordan on the one right-hand side, pivots in the natural order
//      each + 1e-30 as the JAX package's gj_inverse adds it: per step one
//      lane per column divides the pivot row and one lane per row keeps its
//      pivot-column entry, then a lane per (row, column >= k) eliminates;
//      the inverse is never formed;
//   6. a lane per coordinate: v += dt a, q += dt v.
// Nothing is clamped or skipped on the data beyond the contact law's own
// branches (in contact where the penetration is > 0, the normal force at
// least 0, the tangential one within mu f_n, compared so that a NaN
// passes through as jnp.maximum / jnp.minimum pass it), so a NaN state
// spreads as it does in the plain version.  With ``decisions`` the kernel
// also writes every substep's in-contact decisions.
//
// Work: per scenario 86 floats in, 60 out.  Per substep this kernel spends
// ~100k floating-point operations: all 256 entries of M over 11 links with
// I J recomputed for each, ~79k; the Jacobian columns, zero ones and the
// contacts' dJ/dt v included, ~14k; Gauss-Jordan, ~5k.  The function needs
// ~17k (chip_smoke.py::sim_step_cost: M's distinct entries over the nonzero
// columns, a Cholesky solve), so the bound at B=1024 is set by operations.
// Each substep is one serial chain and ~37 barriers, so at B=1 the kernel
// is latency bound; this first design does not split the chain.
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too; the SimParams scalars from one float32 buffer
// (backends/fullorder.py::params_buffer).  True float32: no fast math.
#include <cuda_runtime.h>

#include "rbd_dynamics.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NCMD = 5 * NJ;  // pos_des, vel_des, kp, kd, tau_ff

// SimParams' scalars in order (backends/fullorder.py::params_buffer)
constexpr int P_DT = 0, P_KN = 1, P_DN = 2, P_KT = 3, P_MU = 4, P_ARM = 5, P_DAMP = 6,
              P_DROP = 7, N_SIM_PARAMS = 8;

// lane of phase 3: contact c's force (world frame) from its point and
// velocity; returns the in-contact decision
__device__ bool contact_force(const float* P, const float* p, const float* vp, float* f) {
  const float pen = P[P_DROP] - p[2];
  const bool in_contact = pen > 0.0f;
  float fn = in_contact ? P[P_KN] * pen - P[P_DN] * vp[2] : 0.0f;
  fn = fn < 0.0f ? 0.0f : fn;
  const float ft0 = in_contact ? -P[P_KT] * vp[0] : 0.0f;
  const float ft1 = in_contact ? -P[P_KT] * vp[1] : 0.0f;
  const float ft_norm = sqrtf(ft0 * ft0 + ft1 * ft1) + 1e-9f;
  float r = P[P_MU] * fn / ft_norm;
  r = r > 1.0f ? 1.0f : r;
  f[0] = ft0 * r;
  f[1] = ft1 * r;
  f[2] = fn;
  return in_contact;
}

__global__ void __launch_bounds__(THREADS)
sim_step_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                const float* __restrict__ geff, const float* __restrict__ gq,
                const float* __restrict__ gv, const float* __restrict__ gcmd,
                const float* __restrict__ gms, const float* __restrict__ ggd, int substeps,
                float* __restrict__ oq, float* __restrict__ ov, float* __restrict__ oacc,
                float* __restrict__ ofc, bool* __restrict__ odec) {
  __shared__ State s;
  __shared__ float K[N_CONSTS], P[N_SIM_PARAMS], cmd[5][NJ], eff[NJ];
  __shared__ float q[NQ], ms, gd[3];
  __shared__ float F[L][3], T[L][3];     // the links' wrench terms of nle
  __shared__ float M[NQ][NQ], h[NQ], field[NQ];
  __shared__ float fc[NC][3], tau[NJ];
  __shared__ float A[NQ][NQ + 1];         // the tableau [A_sys | rhs]
  __shared__ float prow[NQ + 1], pcol[NQ];

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  for (int i = tid; i < N_CONSTS; i += THREADS) K[i] = gK[i];
  if (tid < N_SIM_PARAMS) P[tid] = gP[tid];
  if (tid < NJ) eff[tid] = geff[tid];
  if (tid < NCMD) cmd[tid / NJ][tid % NJ] = gcmd[b * NCMD + tid];
  if (tid < NQ) {
    q[tid] = gq[b * NQ + tid];
    s.v[tid] = gv[b * NQ + tid];
  }
  if (tid < 3) gd[tid] = ggd[b * 3 + tid];
  if (tid == 0) ms = gms[b];
  __syncthreads();
  const float dt = P[P_DT];

  for (int step = 0; step < substeps; ++step) {
    // ---- 1. the chain ----
    if (tid == 0) state_chain(K, q, &s);
    __syncthreads();

    // ---- 2. Jacobian columns, the links' wrench terms ----
    if (tid < L) {
      link_columns(&s, tid);
      link_wrench(K, &s, tid, F[tid], T[tid]);
    } else if (tid >= 32 && tid < 32 + NC) {
      contact_columns(K, &s, tid - 32);
    }
    __syncthreads();

    // ---- 3. M, nle, the field term, contact forces, motor torques ----
    for (int e = tid; e < NQ * NQ; e += THREADS)
      M[e / NQ][e % NQ] = mass_entry(K, &s, e / NQ, e % NQ);
    if (tid < NQ) {
      h[tid] = nle_entry(&s, F, T, tid);
      float f = 0.0f;
      for (int k = 0; k < L; ++k) {
        const float* li = s.Jl[k][tid];
        f = f + K[K_MASS + k] * ((li[0] * gd[0] + li[1] * gd[1]) + li[2] * gd[2]);
      }
      field[tid] = f;
    } else if (tid >= 32 && tid < 32 + NC) {
      const int c = tid - 32;
      const bool in_contact = contact_force(P, s.pc[c], s.vc[c], fc[c]);
      if (odec != nullptr) odec[(b * substeps + step) * NC + c] = in_contact;
    } else if (tid >= 64 && tid < 64 + NJ) {
      const int j = tid - 64;
      float t = (cmd[4][j] + cmd[2][j] * (cmd[0][j] - q[6 + j]))
                + cmd[3][j] * (cmd[1][j] - s.v[6 + j]);
      t = t < -eff[j] ? -eff[j] : t;
      tau[j] = t > eff[j] ? eff[j] : t;
    }
    __syncthreads();

    // ---- 4. the tableau ----
    if (tid < NQ) {
      const int i = tid;
      float jf = 0.0f;
      for (int r = 0; r < NF; ++r) jf = jf + s.Jc[r][i] * fc[r / 3][r % 3];
      const float tau_gen = ((i < 6 ? 0.0f : tau[i - 6]) + jf) + ms * field[i];
      const float arm = i < 6 ? 0.0f : P[P_ARM], damp = i < 6 ? 0.0f : P[P_DAMP];
      for (int j = 0; j < NQ; ++j) A[i][j] = ms * M[i][j] + (i == j ? arm + dt * damp : 0.0f);
      A[i][NQ] = (tau_gen - ms * h[i]) - damp * s.v[i];
    }
    __syncthreads();

    // ---- 5. Gauss-Jordan on [A_sys | rhs] ----
    for (int k = 0; k < NQ; ++k) {
      if (tid <= NQ) prow[tid] = A[k][tid] / (A[k][k] + 1e-30f);
      else if (tid >= 32 && tid < 32 + NQ) pcol[tid - 32] = A[tid - 32][k];
      __syncthreads();
      const int width = NQ + 1 - k;  // columns k..NQ
      for (int e = tid; e < NQ * width; e += THREADS) {
        const int i = e / width, j = k + e % width;
        A[i][j] = i == k ? prow[j] : A[i][j] - pcol[i] * prow[j];
      }
      __syncthreads();
    }

    // ---- 6. semi-implicit Euler ----
    if (tid < NQ) {
      const float a = A[tid][NQ];
      const float v_new = s.v[tid] + dt * a;
      s.v[tid] = v_new;
      q[tid] = q[tid] + dt * v_new;
      if (step == substeps - 1) oacc[b * NQ + tid] = a;
    }
    __syncthreads();
  }

  if (tid < NQ) {
    oq[b * NQ + tid] = q[tid];
    ov[b * NQ + tid] = s.v[tid];
  }
  if (tid < NF) ofc[b * NF + tid] = fc[tid / 3][tid % 3];
}

}  // namespace

extern "C" int hk_sim_step(const float* consts, const float* params, const float* effort,
                           const float* q, const float* v, const float* cmd,
                           const float* mass_scale, const float* gravity_delta, float* q_out,
                           float* v_out, float* acc, float* contact_forces, bool* decisions,
                           int batch, int substeps, void* stream) {
  sim_step_kernel<<<static_cast<unsigned>(batch), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(consts, params, effort, q, v, cmd,
                                                         mass_scale, gravity_delta, substeps,
                                                         q_out, v_out, acc, contact_forces,
                                                         decisions);
  return static_cast<int>(cudaGetLastError());
}
