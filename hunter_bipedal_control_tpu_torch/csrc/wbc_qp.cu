// B9: the weighted WBC's QP assembly.
//
// Replaces hunter_bipedal_control_tpu/wbc/wbc.py::_measured_pipeline (:123),
// _desired_pipeline (:142) and wbc_update's task rows and products
// (:154-274), with models/dynamics.py::mass_matrix (:29) and nle (:55) and
// the Jacobians and their time derivatives of models/kinematics.py (:195,
// :202, :229, :236) inside, as the port's wbc/wbc.py::wbc_qp_plain computes
// them: from (x_des, u_des, rbd_measured, contact_flags, stance_mode) and the
// WBC's gains, the QP that ops/qp.py::solve_qp (B4) takes: H (38x38), g (38),
// Aeq (28x38), beq (28), Ain (40x38), bin (40).
//
// One 128-thread block per scenario, in five phases over shared memory:
//   1. lane 0 runs the measured state's chain (rbd -> q, v in the Euler-rate
//      form; FK; world inertias; the velocity pass), lane 32 the desired
//      state's (FK; the base velocity from the centroidal momentum; the
//      velocity pass);
//   2. a lane per (state, link) fills the link CoM's 16 Jacobian columns and
//      their time derivatives along v, summing J v and dJ/dt v; a lane per
//      (state, contact) the contact point's; one lane the base's angular
//      rows' dJ/dt v;
//   3. the measured M = sum_k J_k' diag(m_k, I_k) J_k and nle = sum_k J_k'
//      [m_k (dJ_k v + g e_z); I_k dw_k + w_k x I_k w_k] (Newton-Euler at each
//      link CoM in the Euler-rate coordinates: the same equations as the
//      Lagrangian C v + g); the desired base acceleration solves
//      A_b dvb = m hdot - (dA/dt) v, the CMM's derivative along the flow
//      with u held, through the base block's closed-form 3x3 inverse;
//   4. the 36 weighted task rows and their right-hand sides;
//   5. H = rows' rows + 1e-6 I, g = -rows' b, and Aeq, beq, Ain, bin.
//
// The base columns of every Jacobian carry E(theta) (v[3:6] are ZYX Euler
// rates), and their time derivatives dE/dt.  The entry of a joint that does
// not move a point is its column's value times 0 (the ancestor mask), as the
// plain version multiplies it, so a NaN state spreads as it does there:
// nothing is clamped, skipped or branched on the data.  log3 takes the angle
// as atan2(|vee|, (tr - 1) / 2), the plain version as arccos((tr - 1) / 2):
// the same function, without arccos's float32 loss near 0.
//
// Bound on the card: per scenario 79 floats in, 4,134 out (16.5 KB; ~68 MB
// at B=4096, ~0.020 ms at 3.35 TB/s); H's product alone is 38 x 38 x 36
// multiply-adds (~0.1 MFLOP): bytes bound.  The first design is simple and
// latency bound at B=1 (two serial chains in one lane each).
//
// The state's chain, Jacobian columns and the M / nle sums are
// rbd_dynamics.cuh's, shared with B11 (sim_step.cu).  Model constants come
// from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too; the WBC's gains from one float32 buffer
// (wbc/wbc.py::params_buffer).  True float32: no fast math.
#include <cuda_runtime.h>

#include "rbd_dynamics.cuh"

namespace {

constexpr int NX = 12 + NJ;             // 22
constexpr int NRBD = 2 * NQ;            // 32
constexpr int NDEC = NQ + NF + NJ;      // 38
constexpr int NEQ = NQ + NF;            // 28
constexpr int NIN = 2 * NJ + 5 * NC;    // 40
constexpr int NROW = NF + 2 + 1 + 3 + NF + 6;  // 36 weighted task rows
constexpr int THREADS = 128;

// WbcParams' tensor fields in order (wbc/wbc.py::params_buffer); 8 and 9,
// base_accel_kp and _kd, do not enter the QP (as in the plain version)
constexpr int P_TL = 0, P_MU = 5, P_SW_KP = 6, P_SW_KD = 7, P_BH_KP = 10, P_BH_KD = 11,
              P_BR_KP = 12, P_BR_KD = 13, P_W_SW = 14, P_W_BASE = 15, P_W_CF = 16,
              N_WBC_PARAMS = 17;

// task row ranges
constexpr int R_SW = 0, R_XY = NF, R_HZ = R_XY + 2, R_ANG = R_HZ + 1, R_CF = R_ANG + 3,
              R_ST = R_CF + NF;

// SO(3) log of a rotation (spatial.py::log3), the angle by atan2
__device__ void log3_dev(const float* R, float* out) {
  const float c = 0.5f * (tr3(R) - 1.0f);
  const float vee[3] = {0.5f * (R[7] - R[5]), 0.5f * (R[2] - R[6]), 0.5f * (R[3] - R[1])};
  const float s = sqrtf(vee[0] * vee[0] + vee[1] * vee[1] + vee[2] * vee[2]);
  const float th = atan2f(s, c);
  const float scale = th < 1e-6f ? 1.0f + th * th / 6.0f : th / sinf(th);
  for (int a = 0; a < 3; ++a) out[a] = scale * vee[a];
}

// row r of the unweighted task matrix, column j
__device__ __forceinline__ float task_entry(const State* m, int r, int j) {
  if (r < R_XY) return j < NQ ? m->Jc[r][j] : 0.0f;
  if (r < R_ANG) return j == r - R_XY ? 1.0f : 0.0f;
  if (r < R_CF) {
    // the base's angular rows: [0, E, joint axes x 0]
    const int a = r - R_ANG;
    if (j < 3) return 0.0f;
    if (j < 6) return m->E[3 * a + j - 3];
    if (j < NQ) return m->k.aw[j - 6][a] * static_cast<float>(c_anc[0][j - 6]);
    return 0.0f;
  }
  if (r < R_ST) return j == NQ + r - R_CF ? 1.0f : 0.0f;
  return j == r - R_ST ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
wbc_qp_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
              const float* __restrict__ gxd, const float* __restrict__ gud,
              const float* __restrict__ grbd, const float* __restrict__ gfl,
              const bool* __restrict__ gst, float* __restrict__ oH, float* __restrict__ og,
              float* __restrict__ oAeq, float* __restrict__ obeq, float* __restrict__ oAin,
              float* __restrict__ obin) {
  __shared__ State sm, sd;  // measured, desired
  __shared__ float K[N_CONSTS], P[N_WBC_PARAMS];
  __shared__ float xd[NX], ud[NX], rbd[NRBD], fl[NC];
  __shared__ float F[L][3], T[L][3];      // measured link wrench terms of nle
  __shared__ float M[NQ][NQ], h[NQ];
  __shared__ float dJbv[3], acc_b[6], vel_b[6];
  __shared__ float A[NROW][NDEC], rb[NROW];
  __shared__ float walk;

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  for (int i = tid; i < N_CONSTS; i += THREADS) K[i] = gK[i];
  for (int i = tid; i < N_WBC_PARAMS; i += THREADS) P[i] = gP[i];
  for (int i = tid; i < NX; i += THREADS) {
    xd[i] = gxd[b * NX + i];
    ud[i] = gud[b * NX + i];
  }
  for (int i = tid; i < NRBD; i += THREADS) rbd[i] = grbd[b * NRBD + i];
  if (tid < NC) fl[tid] = gfl[b * NC + tid];
  if (tid == 0) walk = gst[b] ? 0.0f : 1.0f;
  __syncthreads();

  // ---- 1. the two states' chains ----
  if (tid == 0) {
    float q[NQ];
    rbd_to_qv(rbd, q, sm.v);
    state_chain(K, q, &sm);
  } else if (tid == 32) {
    fk_dev(K, xd + 6, &sd.k);
    base_velocity_dev(K, xd, ud + NF, &sd.k);
    for (int i = 0; i < 6; ++i) sd.v[i] = sd.k.vb[i];
    for (int j = 0; j < NJ; ++j) sd.v[6 + j] = ud[NF + j];
    velocity_pass_dev(sd.v, sd.v + 6, &sd.k);
    euler_E(sd.k.trig, sd.E);
    euler_Edot(sd.k.trig, sd.v + 3, sd.Ed);
  }
  __syncthreads();

  // ---- 2. Jacobian columns and their time derivatives ----
  if (tid < 2 * L) {
    State* s = tid < L ? &sm : &sd;
    const int k = tid % L;
    link_columns(s, k);
    // the measured link's wrench terms of nle
    if (tid < L) link_wrench(K, &sm, k, F[k], T[k]);
  } else if (tid >= 32 && tid < 32 + 2 * NC) {
    const int c = (tid - 32) % NC;
    contact_columns(K, tid < 32 + NC ? &sm : &sd, c);
  } else if (tid == 32 + 2 * NC) {
    // the measured base's angular rows: dJb/dt v = dE/dt theta_dot + joint
    // columns (axis rates x 0)
    for (int a = 0; a < 3; ++a) {
      float s = 0.0f;
      for (int c = 0; c < 3; ++c) s = s + sm.Ed[3 * a + c] * sm.v[3 + c];
      for (int j = 0; j < NJ; ++j) {
        float ad[3];
        cross3(sm.k.om[c_parent[j]], sm.k.aw[j], ad);
        s = s + ad[a] * static_cast<float>(c_anc[0][j]) * sm.v[6 + j];
      }
      dJbv[a] = s;
    }
  }
  __syncthreads();

  // ---- 3. M, nle, the desired base acceleration ----
  for (int e = tid; e < NQ * NQ; e += THREADS)
    M[e / NQ][e % NQ] = mass_entry(K, &sm, e / NQ, e % NQ);
  if (tid < NQ) {
    h[tid] = nle_entry(&sm, F, T, tid);
  } else if (tid == 64) {
    // (dA/dt) v: the centroidal momentum's rate with the accelerations held
    const Kin* w = &sd.k;
    const float m = K[K_M], inv_m = K[K_INVM];
    float hl[3] = {0.0f, 0.0f, 0.0f}, ha[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < L; ++k) {
      const float mk = K[K_MASS + k];
      float Iw_w[3], Iw_wd[3], wx[3], r[3], rc[3];
      mv3(w->Iw[k], sd.w[k], Iw_w);
      mv3(w->Iw[k], sd.wd[k], Iw_wd);
      cross3(sd.w[k], Iw_w, wx);
      for (int a = 0; a < 3; ++a) r[a] = w->com[k][a] - w->pcom[a];
      cross3(r, sd.cdd[k], rc);
      for (int a = 0; a < 3; ++a) {
        hl[a] = hl[a] + mk * sd.cdd[k][a];
        ha[a] = ha[a] + ((Iw_wd[a] + wx[a]) + mk * rc[a]);
      }
    }
    // m hdot of the flow map: contact forces, gravity and their moments
    float fs[3] = {0.0f, 0.0f, 0.0f}, tau[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < NC; ++c) {
      float r[3], t[3];
      for (int a = 0; a < 3; ++a) r[a] = sd.pc[c][a] - w->pcom[a];
      cross3(r, ud + 3 * c, t);
      for (int a = 0; a < 3; ++a) {
        fs[a] = fs[a] + ud[3 * c + a];
        tau[a] = tau[a] + t[a];
      }
    }
    float rl[3], ra[3], x2[3], t[3], Ex[3], Ev[3], Edv[3];
    for (int a = 0; a < 3; ++a) {
      rl[a] = (fs[a] + (a == 2 ? -m * GRAVITY : 0.0f)) - hl[a];
      ra[a] = tau[a] - ha[a];
    }
    mv3(w->iGE, ra, x2);
    mv3(w->A12, x2, t);
    mv3(sd.E, x2, Ex);
    mv3(sd.E, sd.v + 3, Ev);
    mv3(sd.Ed, sd.v + 3, Edv);
    for (int a = 0; a < 3; ++a) {
      acc_b[a] = inv_m * (rl[a] - t[a]);
      acc_b[3 + a] = Ex[a] + Edv[a];
      vel_b[a] = sd.v[a];
      vel_b[3 + a] = Ev[a];
    }
  }
  __syncthreads();

  // ---- 4. the weighted task rows ----
  if (tid == 0) {
    const float w_sw = sqrtf(P[P_W_SW]), w_base = sqrtf(P[P_W_BASE]);
    const float w_cf = sqrtf(P[P_W_CF]);
    for (int r = 0; r < NF; ++r) {
      const int c = r / 3, a = r % 3;
      const float cmd = P[P_SW_KP] * (sd.pc[c][a] - sm.pc[c][a])
                        + P[P_SW_KD] * (sd.vc[c][a] - sm.vc[c][a]);
      rb[R_SW + r] = ((cmd - sm.ac[c][a]) * walk) * ((1.0f - fl[c]) * w_sw);
      rb[R_CF + r] = (ud[r] * walk) * w_cf;
    }
    for (int a = 0; a < 2; ++a) rb[R_XY + a] = (acc_b[a] * walk) * w_base;
    rb[R_HZ] = ((acc_b[2] + P[P_BH_KP] * (xd[8] - sm.k.p[0][2])
                 + P[P_BH_KD] * (vel_b[2] - sm.v[2])) * walk) * w_base;
    // rotation error R_m log3(R_m' R_d) and the measured omega = E theta_dot
    const float* Rm = sm.k.R[0];
    const float* Rd = sd.k.R[0];
    float Rt[9], lg[3], err[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Rt[3 * i + j] = Rm[i] * Rd[j] + Rm[3 + i] * Rd[3 + j] + Rm[6 + i] * Rd[6 + j];
    log3_dev(Rt, lg);
    mv3(Rm, lg, err);
    for (int a = 0; a < 3; ++a)
      rb[R_ANG + a] = (((acc_b[3 + a] + P[P_BR_KP] * err[a])
                        + P[P_BR_KD] * (vel_b[3 + a] - sm.k.om[0][a])) - dJbv[a])
                      * walk * w_base;
    for (int r = R_ST; r < NROW; ++r) rb[r] = 0.0f * ((1.0f - walk) * w_base);
  }
  for (int e = tid; e < NROW * NDEC; e += THREADS) {
    const int r = e / NDEC, j = e % NDEC;
    float wr;
    if (r < R_XY) wr = walk * ((1.0f - fl[r / 3]) * sqrtf(P[P_W_SW]));
    else if (r < R_CF) wr = walk * sqrtf(P[P_W_BASE]);
    else if (r < R_ST) wr = walk * sqrtf(P[P_W_CF]);
    else wr = (1.0f - walk) * sqrtf(P[P_W_BASE]);
    A[r][j] = task_entry(&sm, r, j) * wr;
  }
  __syncthreads();

  // ---- 5. H, g and the constraint rows ----
  float* Hb = oH + b * NDEC * NDEC;
  for (int e = tid; e < NDEC * NDEC; e += THREADS) {
    const int i = e / NDEC, j = e % NDEC;
    float s = 0.0f;
    for (int r = 0; r < NROW; ++r) s = s + A[r][i] * A[r][j];
    Hb[e] = s + (i == j ? 1e-6f : 0.0f);
  }
  if (tid < NDEC) {
    float s = 0.0f;
    for (int r = 0; r < NROW; ++r) s = s + A[r][tid] * rb[r];
    og[b * NDEC + tid] = -s;
  }
  // Aeq = [[M, -J', -S'], [0, diag(swing), 0]], beq = [-nle; 0]
  float* Ae = oAeq + b * NEQ * NDEC;
  for (int e = tid; e < NEQ * NDEC; e += THREADS) {
    const int i = e / NDEC, j = e % NDEC;
    float val;
    if (i < NQ) {
      if (j < NQ) val = M[i][j];
      else if (j < NQ + NF) val = -sm.Jc[j - NQ][i];
      else val = -(i >= 6 && j - NQ - NF == i - 6 ? 1.0f : 0.0f);
    } else {
      const int r = i - NQ;
      val = j == NQ + r ? 1.0f - fl[r / 3] : 0.0f;
    }
    Ae[e] = val;
  }
  if (tid < NEQ) obeq[b * NEQ + tid] = tid < NQ ? -h[tid] : 0.0f;
  // Ain: torque limits [0, +-I]; per foot the friction pyramid times its flag
  float* Ai = oAin + b * NIN * NDEC;
  for (int e = tid; e < NIN * NDEC; e += THREADS) {
    const int i = e / NDEC, j = e % NDEC;
    float val = 0.0f;
    if (i < NJ) {
      val = j == NQ + NF + i ? 1.0f : 0.0f;
    } else if (i < 2 * NJ) {
      val = j == NQ + NF + i - NJ ? -1.0f : 0.0f;
    } else {
      const int f = (i - 2 * NJ) / 5, rr = (i - 2 * NJ) % 5, col = j - NQ - 3 * f;
      if (col >= 0 && col < 3) {
        float pyr;
        if (col == 2) pyr = rr == 0 ? -1.0f : -P[P_MU];
        else if (rr == 0) pyr = 0.0f;
        else pyr = (rr - 1) / 2 == col ? ((rr - 1) % 2 == 0 ? 1.0f : -1.0f) : 0.0f;
        val = pyr * fl[f];
      }
    }
    Ai[e] = val;
  }
  if (tid < NIN) obin[b * NIN + tid] = tid < 2 * NJ ? P[P_TL + (tid % NJ) % 5] : 0.0f;
}

}  // namespace

extern "C" int hk_wbc_qp(const float* consts, const float* params, const float* x_des,
                         const float* u_des, const float* rbd, const float* flags,
                         const bool* stance_mode, float* H, float* g, float* Aeq, float* beq,
                         float* Ain, float* bin, int batch, void* stream) {
  wbc_qp_kernel<<<static_cast<unsigned>(batch), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(consts, params, x_des, u_des, rbd, flags,
                                                       stance_mode, H, g, Aeq, beq, Ain, bin);
  return static_cast<int>(cudaGetLastError());
}
