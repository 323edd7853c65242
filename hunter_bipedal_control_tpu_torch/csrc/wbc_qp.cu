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
// One block per scenario: of WIDE (4) warps while the batch fits one wave
// of such blocks, else of one warp; seven phases over the scenario's shared
// memory with a barrier between them (__syncwarp for one warp).  At B=1 the
// card runs one scenario's dependent chain, whose loops four warps share.
// At B=4096 an H100's SM holds 17 of the one-warp scenarios (12 KB of
// shared memory each, the registers' limit): the batch in two waves, where
// four warps a scenario would take eight.
//   1. the chains per leg (warp 0): a lane per (state, joint) forms the
//      joint's local transform (its sin and cos, Rodrigues, the origin's
//      rotation), a lane per state the base (pose, E, dE/dt); then lanes 0,
//      1 walk the measured state's legs (one 3x3 and two 3-vector products
//      a joint, and the velocity pass, the running frame in registers),
//      lanes 2, 3 the desired state's, which take the base-fixed velocity
//      pass;
//   1b. a lane per (state, link) forms the world inertias; the desired
//      state's CoM, momentum, Itot and W are per-link terms summed by warp
//      shuffles, its base velocity solves the CMM's base block (the 3x3
//      inverse on every lane of the sum), and each link's full velocity is
//      the base's plus its base-fixed one (om = w0 + om_j, vo = v0 + w0 x
//      (p - p0) + vo_j);
//   2. a lane per (state, link CoM or contact point) runs the 16 Jacobian
//      columns and their time derivatives along v (storing the measured
//      state's), summing J v and dJ/dt v, each warp a share of the columns;
//      one lane the base's angular dJ/dt v;
//   3. the measured M's 136 distinct entries over the threads; on the last
//      warp nle, the rotation error, and the desired base acceleration from
//      per-link and per-contact terms summed by shuffles (A_b dvb = m hdot -
//      (dA/dt) v);
//   4. the 36 right-hand sides by row group, the 15 dense weighted rows
//      (swing: the contact Jacobians; angular: [0, E, axes x 0]) on the 16
//      acceleration columns;
//   5. H from its structure: the 16x16 block D' D (136 entries) plus the
//      unit rows' squared weights on the diagonal plus 1e-6 I, the rest of
//      H the unit rows' diagonal and 1e-6; g likewise;
//   6. H, Aeq and Ain as flat 16-byte stores (1,444, 1,064 and 1,520 floats
//      a scenario), their constant patterns from the index.
//
// NaN and Inf.  The plain version forms H = rows_A' rows_A densely: a NaN or
// an Inf in column j of rows_A (0 x Inf = NaN in a structural zero) spreads
// along row and column j of H, and a non-finite row weight makes its row's
// structural zeros NaN.  So each column carries a poison term p_j = sum_r 0
// x rows_A[r][j] (0, or NaN), each H[i][j] gets p_i + p_j and each g[j] p_j
// + sum_r 0 x b[r]: the non-finite entries are where the dense product puts
// them (NaN where it has NaN from NaN inputs).  Nothing else branches on the
// data.  The entry of a joint that does not move a point is its column's
// value times 0 (the ancestor mask), as the plain version multiplies it.
// log3 takes the angle as atan2(|vee|, (tr - 1) / 2), the plain version as
// arccos((tr - 1) / 2): the same function, without arccos's float32 loss
// near 0.
//
// Bound on the card: per scenario 79 floats in, 4,134 out (16.5 KB; ~68 MB
// at B=4096, ~0.020 ms at 3.35 TB/s): bytes bound.  At B=1 one scenario's
// operations (~85 k) at one a lane and clock are the floor.
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too; the WBC's gains from one float32 buffer
// (wbc/wbc.py::params_buffer).  True float32: no fast math.
#include <cstdint>

#include <cuda_runtime.h>

#include "rbd_dynamics.cuh"

namespace {

constexpr int NX = 12 + NJ;             // 22
constexpr int NRBD = 2 * NQ;            // 32
constexpr int NDEC = NQ + NF + NJ;      // 38
constexpr int NEQ = NQ + NF;            // 28
constexpr int NIN = 2 * NJ + 5 * NC;    // 40
constexpr int NROW = NF + 2 + 1 + 3 + NF + 6;  // 36 weighted task rows
constexpr int ND = NF + 3;              // the dense rows: swing 12, angular 3
constexpr int NTRI = NQ * (NQ + 1) / 2;  // 136 distinct entries of a 16x16 symmetric
constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
// warps per scenario: WIDE while the batch fits one wave of the wide blocks
// (four 128-thread blocks on each of an H100's 132 SMs, the registers'
// limit), else one
constexpr int WIDE = 4;
constexpr int WIDE_MAX_BATCH = 4 * 132;
static_assert(NRBD == LANES, "one lane per rbd entry");
static_assert(NQ == 16 && L <= 16 && L + NC <= 16, "a half warp per state's points");

// WbcParams' tensor fields in order (wbc/wbc.py::params_buffer); 8 and 9,
// base_accel_kp and _kd, do not enter the QP (as in the plain version)
constexpr int P_TL = 0, P_MU = 5, P_SW_KP = 6, P_SW_KD = 7, P_BH_KP = 10, P_BH_KD = 11,
              P_BR_KP = 12, P_BR_KD = 13, P_W_SW = 14, P_W_BASE = 15, P_W_CF = 16,
              N_WBC_PARAMS = 17;

// Measurement build only (profile_step wbc_qp_phases): -DWBC_QP_PHASE_CLOCKS
// sums scenario 0's clock64 cycles per phase (thread 0, after the phase's
// closing barrier).
constexpr int WBC_PHASES = 7;  // loads, chains, columns, dynamics, rows, h_g, stores
#ifdef WBC_QP_PHASE_CLOCKS
__device__ unsigned long long wbc_phase_cycles[WBC_PHASES];
#define WBC_PHASE(p)                               \
  if (b == 0 && tid == 0) {                        \
    const long long now = clock64();               \
    wbc_phase_cycles[p] += now - t_phase;          \
    t_phase = now;                                 \
  }
#else
#define WBC_PHASE(p)
#endif

// task row ranges
constexpr int R_SW = 0, R_XY = NF, R_HZ = R_XY + 2, R_ANG = R_HZ + 1, R_CF = R_ANG + 3,
              R_ST = R_CF + NF;

// the desired state: what its rows and its base acceleration read
struct Des {
  Kin k;
  float v[NQ];
  float E[9], Ed[9];
  float w[L][3], wd[L][3], cdd[L][3];   // J v: angular; dJ/dt v: angular, CoM
  float pc[NC][3], vc[NC][3];           // contact points: p, J v
};

// phase 2's sums per point: J v, J_ang v, dJ/dt v, dJ_ang/dt v; with several
// warps each warp's share of the columns, per point lane
constexpr int NSUM = 12;
template <int NW>
struct Partials {
  float v[NW][LANES][NSUM];
};
template <>
struct Partials<1> {};

// the model's constants: in shared memory with several warps a scenario;
// with one, read through the L1 cache, which keeps 17 scenarios on an
// H100's SM (12 KB of shared memory each; the registers' limit) where 15
// fit with them
template <int NW>
struct Consts {
  float v[N_CONSTS];
};
template <>
struct Consts<1> {};

template <int NW>
struct Scenario {
  Consts<NW> K;
  float P[N_WBC_PARAMS];
  float xd[NX], ud[NX], rbd[NRBD], fl[NC];
  float walk;
  State sm;   // measured; after phase 3 its Jl holds the dense rows, its Ja the H block
  Des sd;     // desired
  float F[L][3], T[L][3];  // measured link wrench terms of nle
  float M[NQ][NQ], h[NQ];
  float dJbv[3], acc_b[6], vel_b[6], rot_err[3];
  float rb[NROW];
  float pcol[NDEC];  // the columns' poison terms (0, or NaN)
  float pb;          // the right-hand side's
  unsigned char tri_i[NTRI], tri_j[NTRI];  // (i, j) of the upper triangle's entries
  Partials<NW> part;
};
static_assert(ND * NQ <= L * NQ * 3 && NQ * NQ <= L * NQ * 3, "the reused Jacobian storage");

// the scenario's barrier: its warp, or its block
template <int NW>
__device__ __forceinline__ void scenario_sync() {
  if constexpr (NW == 1) __syncwarp();
  else __syncthreads();
}

// a sum over the lanes of each half warp (every lane of the half gets the
// same bits)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = x + __shfl_xor_sync(FULL, x, o);
  return x;
}

// (i, j), i <= j, of entry e of a 16x16 symmetric matrix's upper triangle, row by row
__device__ __forceinline__ void tri_index(int e, int* i, int* j) {
  int r = 0;
  while (e >= NQ - r) {
    e -= NQ - r;
    ++r;
  }
  *i = r;
  *j = r + e;
}

// SO(3) log of a rotation (spatial.py::log3), the angle by atan2
__device__ void log3_dev(const float* R, float* out) {
  const float c = 0.5f * (tr3(R) - 1.0f);
  const float vee[3] = {0.5f * (R[7] - R[5]), 0.5f * (R[2] - R[6]), 0.5f * (R[3] - R[1])};
  const float s = sqrtf(vee[0] * vee[0] + vee[1] * vee[1] + vee[2] * vee[2]);
  const float th = atan2f(s, c);
  const float scale = th < 1e-6f ? 1.0f + th * th / 6.0f : th / sinf(th);
  for (int a = 0; a < 3; ++a) out[a] = scale * vee[a];
}

// the weight of task row r
template <int NW>
__device__ __forceinline__ float row_weight(const Scenario<NW>& s, int r, float w_sw,
                                            float w_base, float w_cf) {
  if (r < R_XY) return s.walk * ((1.0f - s.fl[r / 3]) * w_sw);
  if (r < R_CF) return s.walk * w_base;
  if (r < R_ST) return s.walk * w_cf;
  return (1.0f - s.walk) * w_base;
}

// entry (i, j) of H: the 16x16 block from Hs, else the unit rows' diagonal
// (forces: d_cf) or 1e-6 (torques), zeros elsewhere, and the poison
template <int NW>
__device__ __forceinline__ float h_entry(const Scenario<NW>& s, const float* Hs, float d_cf,
                                         int i, int j) {
  if (i < NQ && j < NQ) return Hs[i * NQ + j];
  return (i == j ? (i < NQ + NF ? d_cf : 1e-6f) : 0.0f) + (s.pcol[i] + s.pcol[j]);
}

// entry (i, j) of Aeq = [[M, -J', -S'], [0, diag(swing), 0]]
template <int NW>
__device__ __forceinline__ float aeq_entry(const Scenario<NW>& s, int i, int j) {
  if (i < NQ) {
    if (j < NQ) return s.M[i][j];
    if (j < NQ + NF) return -s.sm.Jc[j - NQ][i];
    return -(i >= 6 && j - NQ - NF == i - 6 ? 1.0f : 0.0f);
  }
  const int r = i - NQ;
  return j == NQ + r ? 1.0f - s.fl[r / 3] : 0.0f;
}

// entry (i, j) of Ain: torque limits [0, +-I]; per foot the friction
// pyramid times its flag
template <int NW>
__device__ __forceinline__ float ain_entry(const Scenario<NW>& s, int i, int j) {
  if (i < NJ) return j == NQ + NF + i ? 1.0f : 0.0f;
  if (i < 2 * NJ) return j == NQ + NF + i - NJ ? -1.0f : 0.0f;
  const int f = (i - 2 * NJ) / 5, rr = (i - 2 * NJ) % 5, col = j - NQ - 3 * f;
  if (col < 0 || col >= 3) return 0.0f;
  float pyr;
  if (col == 2) pyr = rr == 0 ? -1.0f : -s.P[P_MU];
  else if (rr == 0) pyr = 0.0f;
  else pyr = (rr - 1) / 2 == col ? ((rr - 1) % 2 == 0 ? 1.0f : -1.0f) : 0.0f;
  return pyr * s.fl[f];
}

// rows of NDEC floats stored as float4 chunks: chunk t's four entries from
// entry(i, j), its row and column found once
template <typename F>
__device__ __forceinline__ void store_rows(float4* out, int rows, int t0, int stride, F entry) {
#pragma unroll 1
  for (int t = t0; t < rows * NDEC / 4; t += stride) {
    int i = 4 * t / NDEC, j = 4 * t - NDEC * i;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = entry(i, j);
      if (++j == NDEC) {
        j = 0;
        ++i;
      }
    }
    out[t] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// NW warps per scenario, one scenario per block
template <int NW>
__global__ void __launch_bounds__(LANES * NW, NW == 1 ? 16 : 1)
wbc_qp_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
              const float* __restrict__ gxd, const float* __restrict__ gud,
              const float* __restrict__ grbd, const float* __restrict__ gfl,
              const bool* __restrict__ gst, float* __restrict__ oH, float* __restrict__ og,
              float* __restrict__ oAeq, float* __restrict__ obeq, float* __restrict__ oAin,
              float* __restrict__ obin) {
  constexpr int NT = LANES * NW;
  __shared__ Scenario<NW> s;
  const int tid = threadIdx.x, warp = tid / LANES, lane = tid % LANES;
  const int half = lane >> 4, k = lane & 15;
  const long long b = blockIdx.x;
#ifdef WBC_QP_PHASE_CLOCKS
  long long t_phase = clock64();
#endif

  // ---- 0. the inputs ----
  const float* K;
  if constexpr (NW == 1) {
    K = gK;
  } else {
    for (int i = tid; i < N_CONSTS; i += NT) s.K.v[i] = gK[i];
    K = s.K.v;
  }
  for (int e = tid; e < NTRI; e += NT) {
    int i, j;
    tri_index(e, &i, &j);
    s.tri_i[e] = static_cast<unsigned char>(i);
    s.tri_j[e] = static_cast<unsigned char>(j);
  }
  if (tid < N_WBC_PARAMS) s.P[tid] = gP[tid];
  if (tid < NX) {
    s.xd[tid] = gxd[b * NX + tid];
    s.ud[tid] = gud[b * NX + tid];
  }
  if (tid < NRBD) s.rbd[tid] = grbd[b * NRBD + tid];
  if (tid < NC) s.fl[tid] = gfl[b * NC + tid];
  if (tid == 0) s.walk = gst[b] ? 0.0f : 1.0f;
  scenario_sync<NW>();
  WBC_PHASE(0)

  if (warp == 0) {
    // ---- 1. the chains: lanes 0-9 (10-19) the measured (desired) joints' local
    // transforms, lane 20 (21) the measured (desired) base; then lanes 0, 1
    // (2, 3) walk the measured (desired) legs; the desired legs take the
    // base-fixed velocity pass (their base velocity needs the whole tree) ----
    float* Tloc = &s.sm.Jl[0][0][0];  // (2, NJ, 9): free until phase 2
    float* aloc = &s.sm.Ja[0][0][0];  // (NJ, 3)
    if (lane < 2 * NJ) {
      const int j = lane % NJ;
      float a[3];
      joint_local_dev(K, j, lane < NJ ? s.rbd[6 + j] : s.xd[12 + j], Tloc + 9 * lane, a);
      if (lane < NJ)
        for (int i = 0; i < 3; ++i) aloc[3 * j + i] = a[i];
    } else if (lane < 2 * NJ + 2) {
      const bool meas = lane == 2 * NJ;
      Kin* w = meas ? &s.sm.k : &s.sd.k;
      float q[NQ], v[NQ];
      if (meas) {
        rbd_to_qv(s.rbd, q, v);
      } else {
        for (int i = 0; i < 6; ++i) q[i] = s.xd[6 + i];
      }
      float trig[4], R0[9], E[9], t[3], om0[3] = {0.0f, 0.0f, 0.0f};
      base_pose_dev(q, trig, R0, w->p[0]);
      euler_E(trig, E);
      if (meas) mv3(E, v + 3, om0);
      mv3(R0, K + K_COML, t);
      for (int e = 0; e < 9; ++e) w->R[0][e] = R0[e];
      for (int i = 0; i < 4; ++i) w->trig[i] = trig[i];
      for (int i = 0; i < 3; ++i) {
        w->com[0][i] = q[i] + t[i];
        w->om[0][i] = om0[i];
        w->vo[0][i] = meas ? v[i] : 0.0f;
      }
      float* Es = meas ? s.sm.E : s.sd.E;
      for (int e = 0; e < 9; ++e) Es[e] = E[e];
      if (meas) {
        for (int i = 0; i < NQ; ++i) s.sm.v[i] = v[i];
        euler_Edot(trig, v + 3, s.sm.Ed);
      }
    }
    __syncwarp();
    if (lane < 4) {
      const bool meas = lane < 2;
      Kin* w = meas ? &s.sm.k : &s.sd.k;
      leg_chain_dev(K, Tloc + (meas ? 0 : 9 * NJ), aloc, meas ? s.sm.v + 6 : s.ud + NF,
                    lane % 2, w->R[0], w->p[0], w->om[0], w->vo[0], w);
    }
    __syncwarp();

    // ---- 1b. world inertias (lanes 0-10 desired, 16-26 measured link k); the
    // desired base velocity from per-link sums ----
    Kin* w = half ? &s.sm.k : &s.sd.k;
    const float mk = k < L ? K[K_MASS + k] : 0.0f;
    float mc[3] = {0.0f, 0.0f, 0.0f};
    if (k < L) {
      link_inertia_world(K, w->R[k], k, w->Iw[k]);
      for (int a = 0; a < 3; ++a) mc[a] = mk * w->com[k][a];
    }
    float pcom[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) pcom[a] = K[K_INVM] * half_sum(mc[a]);
    // per desired link: hl = m c_dot, ha = I w + (c - p_com) x m c_dot of the
    // base-fixed pass, Itot = I, W = m (c - p_b)(c - p_com)'
    float part[24];
    for (int e = 0; e < 24; ++e) part[e] = 0.0f;
    if (half == 0 && k < L) {
      float r1[3], c[3], cdot[3], r[3], t[3], cr[3], d[3];
      for (int a = 0; a < 3; ++a) r1[a] = w->com[k][a] - w->p[k][a];
      cross3(w->om[k], r1, c);
      for (int a = 0; a < 3; ++a) {
        cdot[a] = w->vo[k][a] + c[a];
        r[a] = w->com[k][a] - pcom[a];
        d[a] = w->com[k][a] - w->p[0][a];
      }
      mv3(w->Iw[k], w->om[k], t);
      cross3(r, cdot, cr);
      for (int a = 0; a < 3; ++a) {
        part[a] = mk * cdot[a];
        part[3 + a] = t[a] + mk * cr[a];
      }
      for (int e = 0; e < 9; ++e) {
        part[6 + e] = w->Iw[k][e];
        part[15 + e] = mk * (d[e / 3] * r[e % 3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 24; ++e) part[e] = half_sum(part[e]);
    if (half == 0) {
      // the base block: GE = (Itot + tr(W) I - W) E, A12 = -m skew(p_com - p_b) E
      const float m = K[K_M], inv_m = K[K_INVM];
      const float* Itot = part + 6;
      const float* W = part + 15;
      const float trW = tr3(W);
      float G[9], GE[9], iGE[9], A12[9], sk[9], sE[9], sv[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          G[3 * i + j] = (Itot[3 * i + j] + (i == j ? trW : 0.0f)) - W[3 * i + j];
      mm3(G, s.sd.E, GE);
      for (int i = 0; i < 3; ++i) sv[i] = pcom[i] - w->p[0][i];
      sk[0] = 0.0f;   sk[1] = -sv[2]; sk[2] = sv[1];
      sk[3] = sv[2];  sk[4] = 0.0f;   sk[5] = -sv[0];
      sk[6] = -sv[1]; sk[7] = sv[0];  sk[8] = 0.0f;
      mm3(sk, s.sd.E, sE);
      for (int e = 0; e < 9; ++e) A12[e] = -m * sE[e];
      inv3(GE, iGE);
      float rl[3], ra[3], x2[3], t[3], vb[6];
      for (int i = 0; i < 3; ++i) {
        rl[i] = m * s.xd[i] - part[i];
        ra[i] = m * s.xd[3 + i] - part[3 + i];
      }
      mv3(iGE, ra, x2);
      mv3(A12, x2, t);
      for (int i = 0; i < 3; ++i) {
        vb[i] = inv_m * (rl[i] - t[i]);
        vb[3 + i] = x2[i];
      }
      if (k == 0) {
        for (int e = 0; e < 9; ++e) {
          w->A12[e] = A12[e];
          w->GE[e] = GE[e];
          w->iGE[e] = iGE[e];
        }
        for (int i = 0; i < 3; ++i) w->pcom[i] = pcom[i];
        for (int i = 0; i < 6; ++i) w->vb[i] = s.sd.v[i] = vb[i];
        for (int j = 0; j < NJ; ++j) s.sd.v[6 + j] = s.ud[NF + j];
        euler_Edot(w->trig, vb + 3, s.sd.Ed);
      }
      if (k < L) {
        // the full velocity pass, link by link: om = w0 + om_j, vo = v0 + w0 x (p - p0) + vo_j
        float w0[3], dp[3], c[3];
        mv3(s.sd.E, vb + 3, w0);
        for (int a = 0; a < 3; ++a) dp[a] = w->p[k][a] - w->p[0][a];
        cross3(w0, dp, c);
        for (int a = 0; a < 3; ++a) {
          w->om[k][a] = w0[a] + w->om[k][a];
          w->vo[k][a] = (vb[a] + c[a]) + w->vo[k][a];
        }
      }
    }
  }
  scenario_sync<NW>();
  WBC_PHASE(1)

  // ---- 2. Jacobian columns: lanes 0-10 the measured links' CoMs, 11-14 its
  // contacts, 16-26 and 27-30 the desired's, each warp a share of the 16
  // columns; lane 15 of warp 0 the measured base's angular dJ/dt v ----
  {
    const bool meas = half == 0, link = k < L, point = k < L + NC;
    const int c = k - L;
    const int kl = link ? k : c_cparent[point ? c : 0];
    const Kin* w = meas ? &s.sm.k : &s.sd.k;
    float x[3] = {0.0f, 0.0f, 0.0f}, sum[NSUM];
    for (int e = 0; e < NSUM; ++e) sum[e] = 0.0f;
    if (point) {
      const float* E = meas ? s.sm.E : s.sd.E;
      const float* Ed = meas ? s.sm.Ed : s.sd.Ed;
      const float* v = meas ? s.sm.v : s.sd.v;
      float xd[3];
      if (link) {
        for (int a = 0; a < 3; ++a) x[a] = w->com[kl][a];
      } else {
        float t[3];
        mv3(w->R[kl], K + K_CPOS + 3 * c, t);
        for (int a = 0; a < 3; ++a) x[a] = w->p[kl][a] + t[a];
      }
      point_velocity(w, kl, x, xd);
      const unsigned anc = ancestor_bits(kl);
#pragma unroll 1
      for (int i = warp; i < NQ; i += NW) {
        float lin[3], ang[3], dlin[3], dang[3];
        point_column_kin(w, E, Ed, v, anc, i, x, xd, lin, ang, dlin, dang);
        const float vi = v[i];
        if (meas && link) {
          for (int a = 0; a < 3; ++a) {
            s.sm.Jl[kl][i][a] = lin[a];
            s.sm.Ja[kl][i][a] = ang[a];
          }
        } else if (meas) {
          for (int a = 0; a < 3; ++a) s.sm.Jc[3 * c + a][i] = lin[a];
        }
        for (int a = 0; a < 3; ++a) {
          sum[a] = sum[a] + lin[a] * vi;
          sum[3 + a] = sum[3 + a] + ang[a] * vi;
          sum[6 + a] = sum[6 + a] + dlin[a] * vi;
          sum[9 + a] = sum[9 + a] + dang[a] * vi;
        }
      }
    } else if (warp == 0 && lane == 15) {
      // the measured base's angular rows: dJb/dt v = dE/dt theta_dot + joint
      // columns (axis rates x 0)
      for (int a = 0; a < 3; ++a) {
        float acc = 0.0f;
        for (int cc = 0; cc < 3; ++cc) acc = acc + s.sm.Ed[3 * a + cc] * s.sm.v[3 + cc];
        for (int j = 0; j < NJ; ++j) {
          float ad[3];
          cross3(s.sm.k.om[c_parent[j]], s.sm.k.aw[j], ad);
          acc = acc + ad[a] * static_cast<float>(c_anc[0][j]) * s.sm.v[6 + j];
        }
        s.dJbv[a] = acc;
      }
    }
    if constexpr (NW > 1) {
      // warp 0 adds the other warps' shares, in warp order
      if (point && warp > 0)
        for (int e = 0; e < NSUM; ++e) s.part.v[warp][lane][e] = sum[e];
      __syncthreads();
      if (point && warp == 0)
        for (int u = 1; u < NW; ++u)
          for (int e = 0; e < NSUM; ++e) sum[e] = sum[e] + s.part.v[u][lane][e];
    }
    if (point && warp == 0) {
      if (link) {
        float(*wo)[3] = meas ? s.sm.w : s.sd.w;
        float(*wdo)[3] = meas ? s.sm.wd : s.sd.wd;
        float(*cddo)[3] = meas ? s.sm.cdd : s.sd.cdd;
        for (int a = 0; a < 3; ++a) {
          wo[kl][a] = sum[3 + a];
          wdo[kl][a] = sum[9 + a];
          cddo[kl][a] = sum[6 + a];
        }
        if (meas) link_wrench(K, &s.sm, kl, s.F[kl], s.T[kl]);
      } else {
        float(*pco)[3] = meas ? s.sm.pc : s.sd.pc;
        float(*vco)[3] = meas ? s.sm.vc : s.sd.vc;
        for (int a = 0; a < 3; ++a) {
          pco[c][a] = x[a];
          vco[c][a] = sum[a];
          if (meas) s.sm.ac[c][a] = sum[6 + a];
        }
      }
    }
  }
  scenario_sync<NW>();
  WBC_PHASE(2)

  // ---- 3. M's distinct entries; on the last warp nle, the desired base
  // acceleration and the rotation error ----
#pragma unroll 1
  for (int e = tid; e < NTRI; e += NT) {
    const int i = s.tri_i[e], j = s.tri_j[e];
    const float mij = mass_entry(K, &s.sm, i, j);
    s.M[i][j] = mij;
    s.M[j][i] = mij;
  }
  if (warp == NW - 1) {
    // per desired link (lanes 16-26): -(m cdd), -(I wd + w x I w + m (c - p_com) x cdd);
    // per contact (lanes 27-30): f, (p_c - p_com) x f
    const Kin* w = &s.sd.k;
    float part[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (half == 0) {
      s.h[k] = nle_entry(&s.sm, s.F, s.T, k);
    } else if (k < L) {
      const float mk = K[K_MASS + k];
      float Iw_w[3], Iw_wd[3], wx[3], r[3], rc[3];
      mv3(w->Iw[k], s.sd.w[k], Iw_w);
      mv3(w->Iw[k], s.sd.wd[k], Iw_wd);
      cross3(s.sd.w[k], Iw_w, wx);
      for (int a = 0; a < 3; ++a) r[a] = w->com[k][a] - w->pcom[a];
      cross3(r, s.sd.cdd[k], rc);
      for (int a = 0; a < 3; ++a) {
        part[a] = -(mk * s.sd.cdd[k][a]);
        part[3 + a] = -((Iw_wd[a] + wx[a]) + mk * rc[a]);
      }
    } else if (k < L + NC) {
      const int c = k - L;
      float r[3], t[3];
      for (int a = 0; a < 3; ++a) r[a] = s.sd.pc[c][a] - w->pcom[a];
      cross3(r, s.ud + 3 * c, t);
      for (int a = 0; a < 3; ++a) {
        part[a] = s.ud[3 * c + a];
        part[3 + a] = t[a];
      }
    } else {
      // lane 31: the rotation error R_m log3(R_m' R_d)
      const float* Rm = s.sm.k.R[0];
      const float* Rd = s.sd.k.R[0];
      float Rt[9], lg[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          Rt[3 * i + j] = Rm[i] * Rd[j] + Rm[3 + i] * Rd[3 + j] + Rm[6 + i] * Rd[6 + j];
      log3_dev(Rt, lg);
      mv3(Rm, lg, s.rot_err);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) part[a] = half_sum(part[a]);
    if (lane == 16) {
      // m hdot - (dA/dt) v: rl = f - m g e_z - hl, ra = tau - ha
      const float inv_m = K[K_INVM];
      float rl[3], ra[3], x2[3], t[3], Ex[3], Ev[3], Edv[3];
      for (int a = 0; a < 3; ++a) {
        rl[a] = part[a] + (a == 2 ? -K[K_M] * GRAVITY : 0.0f);
        ra[a] = part[3 + a];
      }
      mv3(w->iGE, ra, x2);
      mv3(w->A12, x2, t);
      mv3(s.sd.E, x2, Ex);
      mv3(s.sd.E, s.sd.v + 3, Ev);
      mv3(s.sd.Ed, s.sd.v + 3, Edv);
      for (int a = 0; a < 3; ++a) {
        s.acc_b[a] = inv_m * (rl[a] - t[a]);
        s.acc_b[3 + a] = Ex[a] + Edv[a];
        s.vel_b[a] = s.sd.v[a];
        s.vel_b[3 + a] = Ev[a];
      }
    }
  }
  scenario_sync<NW>();
  WBC_PHASE(3)

  // ---- 4. the right-hand sides by row group, the dense weighted rows ----
  const float* P = s.P;
  const float walk = s.walk;
  const float w_sw = sqrtf(P[P_W_SW]), w_base = sqrtf(P[P_W_BASE]), w_cf = sqrtf(P[P_W_CF]);
  for (int r = tid; r < NROW; r += NT) {
    float val;
    if (r < R_XY) {
      const int c = r / 3, a = r % 3;
      const float cmd = P[P_SW_KP] * (s.sd.pc[c][a] - s.sm.pc[c][a])
                        + P[P_SW_KD] * (s.sd.vc[c][a] - s.sm.vc[c][a]);
      val = ((cmd - s.sm.ac[c][a]) * walk) * ((1.0f - s.fl[c]) * w_sw);
    } else if (r < R_HZ) {
      val = (s.acc_b[r - R_XY] * walk) * w_base;
    } else if (r == R_HZ) {
      val = ((s.acc_b[2] + P[P_BH_KP] * (s.xd[8] - s.sm.k.p[0][2])
              + P[P_BH_KD] * (s.vel_b[2] - s.sm.v[2])) * walk) * w_base;
    } else if (r < R_CF) {
      // the rotation error and the measured omega = E theta_dot
      const int a = r - R_ANG;
      val = (((s.acc_b[3 + a] + P[P_BR_KP] * s.rot_err[a])
              + P[P_BR_KD] * (s.vel_b[3 + a] - s.sm.k.om[0][a])) - s.dJbv[a])
            * walk * w_base;
    } else if (r < R_ST) {
      val = (s.ud[r - R_CF] * walk) * w_cf;
    } else {
      val = 0.0f * ((1.0f - walk) * w_base);
    }
    s.rb[r] = val;
  }
  float* Dr = &s.sm.Jl[0][0][0];  // (ND, NQ): M and nle no longer read Jl
  for (int e = tid; e < ND * NQ; e += NT) {
    const int r = e / NQ, j = e % NQ;
    float val;
    if (r < NF) {
      val = s.sm.Jc[r][j];
    } else {
      const int a = r - NF;
      // joint columns: the axis times 0 (no joint moves the base: SOA_ANC's row 0)
      val = j < 3 ? 0.0f : (j < 6 ? s.sm.E[3 * a + j - 3] : s.sm.k.aw[j - 6][a] * 0.0f);
    }
    Dr[e] = val * row_weight(s, r < NF ? R_SW + r : R_ANG + r - NF, w_sw, w_base, w_cf);
  }
  scenario_sync<NW>();
  WBC_PHASE(4)

  // ---- 5. the poison terms, H's 16x16 block, g ----
  for (int j = tid; j < NDEC; j += NT) {
    // a non-finite row weight makes its row's structural zeros NaN, in every column
    float p = 0.0f;
    for (int r = 0; r < NROW; ++r) p = p + 0.0f * row_weight(s, r, w_sw, w_base, w_cf);
    if (j < NQ)
      for (int r = 0; r < ND; ++r) p = p + 0.0f * Dr[r * NQ + j];
    s.pcol[j] = p;
  }
  if (tid == NT - 1) {
    float p = 0.0f;
    for (int r = 0; r < NROW; ++r) p = p + 0.0f * s.rb[r];
    s.pb = p;
  }
  scenario_sync<NW>();
  // the unit rows' squared weights: xy (columns 0, 1), height (2), stance (0-5), forces (16-27)
  const float wb_walk = walk * w_base, wb_st = (1.0f - walk) * w_base, wcf_walk = walk * w_cf;
  float* Hs = &s.sm.Ja[0][0][0];  // (NQ, NQ)
#pragma unroll 1
  for (int e = tid; e < NTRI; e += NT) {
    const int i = s.tri_i[e], j = s.tri_j[e];
    float acc = 0.0f;
    for (int r = 0; r < ND; ++r) acc = acc + Dr[r * NQ + i] * Dr[r * NQ + j];
    if (i == j) {
      if (i < 3) acc = acc + wb_walk * wb_walk;
      if (i < 6) acc = acc + wb_st * wb_st;
      acc = acc + 1e-6f;
    }
    acc = acc + (s.pcol[i] + s.pcol[j]);
    Hs[i * NQ + j] = acc;
    Hs[j * NQ + i] = acc;
  }
  // g on the threads from the block's end (the H block's rounds start at its front)
  for (int j = NT - 1 - tid; j < NDEC; j += NT) {
    float acc = 0.0f;
    if (j < NQ) {
      for (int r = 0; r < ND; ++r)
        acc = acc + Dr[r * NQ + j] * s.rb[r < NF ? R_SW + r : R_ANG + r - NF];
      if (j < 2) acc = acc + wb_walk * s.rb[R_XY + j];
      if (j == 2) acc = acc + wb_walk * s.rb[R_HZ];
      if (j < 6) acc = acc + wb_st * s.rb[R_ST + j];
    } else if (j < NQ + NF) {
      acc = wcf_walk * s.rb[R_CF + j - NQ];
    }
    og[b * NDEC + j] = -((acc + s.pcol[j]) + s.pb);
  }
  scenario_sync<NW>();
  WBC_PHASE(5)

  // ---- 6. the stores: H, Aeq, Ain flat in float4, beq and bin ----
  const float d_cf = wcf_walk * wcf_walk + 1e-6f;
  store_rows(reinterpret_cast<float4*>(oH + b * NDEC * NDEC), NDEC, tid, NT,
             [&](int i, int j) { return h_entry(s, Hs, d_cf, i, j); });
  store_rows(reinterpret_cast<float4*>(oAeq + b * NEQ * NDEC), NEQ, tid, NT,
             [&](int i, int j) { return aeq_entry(s, i, j); });
  store_rows(reinterpret_cast<float4*>(oAin + b * NIN * NDEC), NIN, tid, NT,
             [&](int i, int j) { return ain_entry(s, i, j); });
  for (int i = tid; i < NEQ; i += NT) obeq[b * NEQ + i] = i < NQ ? -s.h[i] : 0.0f;
  for (int i = tid; i < NIN; i += NT)
    obin[b * NIN + i] = i < 2 * NJ ? P[P_TL + (i % NJ) % 5] : 0.0f;
  scenario_sync<NW>();
  WBC_PHASE(6)
}

template <int NW>
int launch(const float* consts, const float* params, const float* x_des, const float* u_des,
           const float* rbd, const float* flags, const bool* stance_mode, float* H, float* g,
           float* Aeq, float* beq, float* Ain, float* bin, int batch, cudaStream_t stream) {
  wbc_qp_kernel<NW><<<static_cast<unsigned>(batch), LANES * NW, 0, stream>>>(
      consts, params, x_des, u_des, rbd, flags, stance_mode, H, g, Aeq, beq, Ain, bin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hk_wbc_qp(const float* consts, const float* params, const float* x_des,
                         const float* u_des, const float* rbd, const float* flags,
                         const bool* stance_mode, float* H, float* g, float* Aeq, float* beq,
                         float* Ain, float* bin, int batch, void* stream) {
  // H, Aeq and Ain take 16-byte stores
  if ((reinterpret_cast<std::uintptr_t>(H) | reinterpret_cast<std::uintptr_t>(Aeq)
       | reinterpret_cast<std::uintptr_t>(Ain)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= WIDE_MAX_BATCH)
    return launch<WIDE>(consts, params, x_des, u_des, rbd, flags, stance_mode, H, g, Aeq, beq,
                        Ain, bin, batch, st);
  return launch<1>(consts, params, x_des, u_des, rbd, flags, stance_mode, H, g, Aeq, beq, Ain,
                   bin, batch, st);
}

#ifdef WBC_QP_PHASE_CLOCKS
// The phase sums since the last call (WBC_PHASES of them), then zeroed.
extern "C" int hk_wbc_qp_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, wbc_phase_cycles, sizeof(wbc_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[WBC_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(wbc_phase_cycles, zero, sizeof(zero)));
}
#endif
