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
// Design: a block per scenario of WIDE (4) warps while the batch fits one
// wave of such blocks, else of one warp; the chain and the solve run on
// warp 0, the columns and M's entries on every warp.  Per substep, over the
// scenario's shared memory, a barrier between phases (__syncwarp for one
// warp):
//   1. the chain: lanes 0-12 take the sines and cosines of the 10 joint
//      angles and the base's 3, the base's rotation is formed on every lane,
//      a lane per joint forms its local transform (Rodrigues, the origin's
//      rotation), lane 10 the base (E, dE/dt, its velocity); then the two
//      legs' chains with the velocity pass run side by side on three lanes
//      each, a row of the running rotation a lane (B15's chains);
//   2. the columns: lane (part, point) of the 11 link CoMs and 4 contact
//      points forms the point's Jacobian columns that its part owns (the
//      Euler-rate columns and the joints that move the point: 8 slots over
//      2 x (warps) parts), with their time derivatives along v; dJ/dt v
//      summed by a shuffle across the half warps (and over the warps); a
//      lane per link its world inertia, then its wrench terms F = m (dJ/dt
//      v + g e_z - gd) (the field folded into the gravity vector) and T =
//      I dw + w x I w (w from the velocity pass), a lane per contact the
//      contact law on the point's velocity from the velocity pass; M's
//      21-entry base block from the links' composite sums about the base
//      origin (m r and I + m (|r|^2 - r r'), r the CoM from the origin:
//      [[m I, -(m c)x E], [., E' Ic E]]) and nle's base rows (sum F, E' sum
//      (r x F + T)), each summed by a half warp's shuffles;
//   3. I_k J_k once per (link, joint column); on lanes 0-15 the column's
//      generalized force sum_c Jc' f_c - ms (nle - field), a joint's nle
//      over the links it moves;
//   4. M's other 115 distinct entries (60 base-joint, 30 same-leg joint
//      pairs, each over the at most five links both columns move, from a
//      table sorted by that count so the lanes of a round do like work:
//      m (Jl_i . Jl_j) + Ja_i . (I Ja_j); the 25 pairs of joints of
//      different legs are 0);
//   5. warp 0, lane r (and its mirror r + 16) holds row r of the tableau
//      [A_sys | rhs] in registers: A_sys = ms M + diag(arm + dt damp), rhs =
//      ((S' tau + Jc' f) - ms (nle - field)) - damp v, tau the clamped motor
//      torque of row r's joint; Gauss-Jordan on it, pivots in the natural
//      order, each + 1e-30 as the JAX package's gj_inverse adds it: per
//      pivot k the pivot row arrives by __shfl_sync from lane k and every
//      other row subtracts it times A_rk / (A_kk + 1e-30) (one division a
//      pivot, on every lane), no barrier; the rows are not normalized on the
//      way, each row's right-hand side is divided by its own pivot (+ 1e-30)
//      at the end; the inverse is never formed;
//   6. lane r: v += dt a, q += dt v.
// The zero columns (a joint that does not move a point, the translation
// columns' derivatives) are not formed: each substep carries a poison term,
// 0 x sum(q + v) (0, or NaN), added to the contact velocities and to the
// right-hand side, so a non-finite state spreads as it does in the plain
// version, where those columns are their values times 0.  Nothing else is
// clamped or skipped on the data beyond the contact law's own branches (in
// contact where the penetration is > 0, the normal force at least 0, the
// tangential one within mu f_n, compared so that a NaN passes through as
// torch.maximum / torch.minimum pass it).  With ``decisions`` the kernel
// also writes every substep's in-contact decisions.  The sums are taken in
// other orders than the plain version's (and M's base block by the
// composite inertia), so the outputs differ from it by float32 rounding.
//
// Work: per scenario 86 floats in, 60 out.  Per substep ~17k floating-point
// operations are needed (chip_smoke.py::sim_step_cost: M's distinct entries
// over the nonzero columns, a Cholesky solve); this kernel spends fewer on
// M's base block and more on Gauss-Jordan (~n^3 / 2).  The bound is set by
// operations at every batch; each substep is one dependent chain, so at
// B=1 the kernel is latency bound: the 16 pivots and the legs' chains lead.
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too; the SimParams scalars from one float32 buffer
// (backends/fullorder.py::params_buffer).  True float32: no fast math.
#include <cuda_runtime.h>

#include "rbd_dynamics.cuh"

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NCMD = 5 * NJ;  // pos_des, vel_des, kp, kd, tau_ff
constexpr int NPTS = L + NC;   // 15 points: the link CoMs, then the contacts
constexpr int NSLOT = 3 + LEG_JOINTS;  // a point's column slots: 3 Euler-rate, 5 of its leg
constexpr int NTRI = NQ * (NQ + 1) / 2;  // 136 distinct entries of M
constexpr int NBB = 21;  // M's base-block entries, formed from the links' composite sums
constexpr int NME = NTRI - NBB;  // 115 others, each over the links that both columns move
constexpr int NIJ = 2 * (1 + 2 + 3 + 4 + 5);  // 30 (link, joint column) pairs
// warps per scenario: WIDE while the batch fits one wave of the wide blocks
// (four 128-thread blocks on each of an H100's 132 SMs), else one
constexpr int WIDE = 4;
constexpr int WIDE_MAX_BATCH = 4 * 132;
static_assert(NPTS < 16 && NQ == 16, "a half warp per point, a lane per row");

// SimParams' scalars in order (backends/fullorder.py::params_buffer)
constexpr int P_DT = 0, P_KN = 1, P_DN = 2, P_KT = 3, P_MU = 4, P_ARM = 5, P_DAMP = 6,
              P_DROP = 7, N_SIM_PARAMS = 8;

// Measurement build only (profile_step sim_step_phases): scenario 0's
// clock64 cycles by phase, summed over its substeps (thread 0 of block 0,
// after each phase's closing barrier).
constexpr int SIM_PHASES = 6;  // chain, columns, dynamics (M, nle, law, motor), tableau,
                               // solve, euler
#ifdef SIM_STEP_PHASE_CLOCKS
__device__ unsigned long long sim_phase_cycles[SIM_PHASES];
struct Clock {
  long long t;
  unsigned long long acc[SIM_PHASES];
  bool on;
  __device__ void start(bool o) {
    on = o;
    for (int i = 0; i < SIM_PHASES; ++i) acc[i] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    if (on) {
      const long long now = clock64();
      acc[p] += now - t;
      t = now;
    }
  }
  __device__ void flush() {
    if (on)
      for (int i = 0; i < SIM_PHASES; ++i) sim_phase_cycles[i] += acc[i];
  }
};
#else
struct Clock {
  __device__ void start(bool) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ void flush() {}
};
#endif
enum { PH_CHAIN, PH_COLUMNS, PH_DYNAMICS, PH_TABLEAU, PH_SOLVE, PH_EULER };

// the tree per leg (soa_model.cuh): link k >= 1 is on leg (k - 1) / 5 at
// depth (k - 1) % 5 + 1; joint j moves the links of its leg from j + 1 on,
// its parent link is the base for a leg's first joint, else link j
__device__ __forceinline__ int link_leg(int k) { return (k - 1) / LEG_JOINTS; }
__device__ __forceinline__ int link_depth(int k) { return k == 0 ? 0 : (k - 1) % LEG_JOINTS + 1; }
__device__ __forceinline__ int joint_parent(int j) { return j % LEG_JOINTS == 0 ? 0 : j; }

// the six distinct entries (a, b), a <= b, of a symmetric 3x3, row by row
__device__ __forceinline__ int sym_a(int e) { return e < 3 ? 0 : (e < 5 ? 1 : 2); }
__device__ __forceinline__ int sym_b(int e) { return e < 3 ? e : (e < 5 ? e - 2 : 2); }

// the scenario's shared state
template <int NW>
struct Partials {
  float v[NW][L][6];  // per warp: its parts' dJ/dt v sums of each link
};
template <>
struct Partials<1> {};

template <int NW>
struct Scenario {
  float K[N_CONSTS], P[N_SIM_PARAMS], eff[NJ], cmd[5][NJ];
  float q[NQ], v[NQ];
  float ms, gvec[3];           // the mass scale; g e_z - gd
  Kin k;                       // the chain: R, p, com, aw, anchor, om, vo, Iw, trig
  float Et[3][3], Edt[3][3];   // E(theta)' and its time derivative's, a column a row
  float T[NJ][9], a[NJ][3];    // joint local transforms; axes in the parent's frame
  float4 JL[L][NQ], JA[L][NQ], IJ[L][NQ];  // link CoM columns: linear, angular, I_k angular
  float4 JC[NC][NQ];           // contact points' linear columns
  float F[L][3], Tq[L][3];     // the links' wrench terms
  float hb[6];                 // nle's base rows, less the field
  float fc[NC][3];
  float M[NQ][NQ + 1];         // padded: lane r reads row r
  Partials<NW> part;
  unsigned char ei[NME], ej[NME], ek[NME], en[NME];  // M's entries: i, j, first link, links
  unsigned char ijk[NIJ], iji[NIJ];                      // I J's (link, column)
};

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

// entry e of M's table outside the base block: (i <= j, the first of the
// links both columns move and their count), sorted by that count: per depth
// t = 0..4 and leg the base columns with joint t and the leg's joints
// n <= t with joint t (5 - t links), then the 25 pairs of joints of
// different legs (none)
__device__ void m_entry(int e, int* i, int* j, int* k0, int* n) {
  for (int t = 0; t < LEG_JOINTS; ++t) {
    const int per_leg = 6 + t + 1;
    if (e < 2 * per_leg) {
      const int g = e / per_leg, u = e % per_leg, col = 6 + LEG_JOINTS * g + t;
      *i = u < 6 ? u : 6 + LEG_JOINTS * g + (u - 6);
      *j = col;
      *k0 = LEG_JOINTS * g + 1 + t;
      *n = LEG_JOINTS - t;
      return;
    }
    e -= 2 * per_leg;
  }
  *i = 6 + e / LEG_JOINTS;
  *j = 6 + LEG_JOINTS + e % LEG_JOINTS;
  *k0 = 0;
  *n = 0;
}

// pair e of I J's table: per leg, link by link, the joints that move it
// (the Euler-rate columns' I J enter only the base block)
__device__ void ij_entry(int e, int* k, int* i) {
  const int g = e / (NIJ / 2);
  int u = e % (NIJ / 2), d = 1;
  while (u >= d) {
    u -= d;
    ++d;
  }
  *k = LEG_JOINTS * g + d;
  *i = 6 + LEG_JOINTS * g + u;
}

// lane of the contact law: contact c's force (world frame) from its point
// and velocity; returns the in-contact decision
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

// column i >= 3 of the Jacobian of a point x (velocity xd) and its time
// derivative along v, for a column that moves the point: the Euler-rate
// column c = i - 3 (axis E e_c, its rate dE/dt e_c, about the base origin)
// or joint j = i - 6 (axis aw_j, its rate om_parent x aw_j, about the
// joint's anchor); rbd_dynamics.cuh::point_column_kin's arithmetic
template <int NW>
__device__ __forceinline__ void column_dev(const Scenario<NW>& s, int i, const float* x,
                                           const float* xd, float* lin, float* ang,
                                           float* dlin, float* dang) {
  float a[3], ad[3], r[3], rd[3];
  if (i < 6) {
    const int c = i - 3;
    for (int e = 0; e < 3; ++e) {
      a[e] = s.Et[c][e];
      ad[e] = s.Edt[c][e];
      r[e] = x[e] - s.k.p[0][e];
      rd[e] = xd[e] - s.v[e];
    }
  } else {
    const int j = i - 6;
    for (int e = 0; e < 3; ++e) {
      a[e] = s.k.aw[j][e];
      r[e] = x[e] - s.k.anchor[j][e];
      rd[e] = xd[e] - s.k.vo[j + 1][e];
    }
    cross3(s.k.om[joint_parent(j)], a, ad);
  }
  float t1[3], t2[3];
  cross3(a, r, lin);
  cross3(ad, r, t1);
  cross3(a, rd, t2);
  for (int e = 0; e < 3; ++e) {
    ang[e] = a[e];
    dlin[e] = t1[e] + t2[e];
    dang[e] = ad[e];
  }
}

// the legs' chains side by side with the velocity pass, each on three
// lanes: lane 3 g + i holds row i of leg g's running rotation and component
// i of its position, angular and origin velocities, starting from the
// base's (R0 on every lane; p, om, vo of link 0 in w), given each joint's
// local transform T and axis a (soa_model.cuh::leg_chain_dev's products
// row by row, its cross product's other components by shuffles, as B15's
// chains run); every lane runs it, lanes 0-5 store each link's R, p, CoM,
// om, vo and each joint's anchor and world axis into w
__device__ __forceinline__ void leg_rows(const float* K, const float (*T)[9],
                                         const float (*a)[3], const float* vj, int lane,
                                         const float* R0, Kin* w) {
  const int g = lane < 3 ? 0 : 1, i = lane < 6 ? lane - 3 * g : 2;
  const int base = 3 * g, i1 = base + (i + 1) % 3, i2 = base + (i + 2) % 3;
  const bool store = lane < 6;
  // row i of R0, selected without local memory
  float r0 = i == 0 ? R0[0] : (i == 1 ? R0[3] : R0[6]);
  float r1 = i == 0 ? R0[1] : (i == 1 ? R0[4] : R0[7]);
  float r2 = i == 0 ? R0[2] : (i == 1 ? R0[5] : R0[8]);
  float p = w->p[0][i], om = w->om[0][i], vo = w->vo[0][i];
#pragma unroll
  for (int n = 0; n < LEG_JOINTS; ++n) {
    const int j = LEG_JOINTS * g + n, ch = j + 1;
    const float* o = K + K_OPOS + 3 * j;
    const float* aj = a[j];
    const float* Tj = T[j];
    const float t = r0 * o[0] + r1 * o[1] + r2 * o[2];
    const float aw = r0 * aj[0] + r1 * aj[1] + r2 * aj[2];
    const float c0 = r0 * Tj[0] + r1 * Tj[3] + r2 * Tj[6];
    const float c1 = r0 * Tj[1] + r1 * Tj[4] + r2 * Tj[7];
    const float c2 = r0 * Tj[2] + r1 * Tj[5] + r2 * Tj[8];
    const float por = p + t;
    const float dp = por - p;
    // (om x dp)_i = om_{i+1} dp_{i+2} - om_{i+2} dp_{i+1}
    const float om1 = __shfl_sync(FULL, om, i1), om2 = __shfl_sync(FULL, om, i2);
    const float dp1 = __shfl_sync(FULL, dp, i1), dp2 = __shfl_sync(FULL, dp, i2);
    vo = vo + (om1 * dp2 - om2 * dp1);
    om = om + vj[j] * aw;
    p = por;
    r0 = c0, r1 = c1, r2 = c2;
    const float* cl = K + K_COML + 3 * ch;
    const float tc = r0 * cl[0] + r1 * cl[1] + r2 * cl[2];
    if (store) {
      w->R[ch][3 * i] = r0;
      w->R[ch][3 * i + 1] = r1;
      w->R[ch][3 * i + 2] = r2;
      w->p[ch][i] = p;
      w->anchor[j][i] = p;
      w->aw[j][i] = aw;
      w->com[ch][i] = p + tc;
      w->om[ch][i] = om;
      w->vo[ch][i] = vo;
    }
  }
}

__device__ __forceinline__ float dot3(const float4& a, const float4& b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

template <int NW>
__global__ void __launch_bounds__(LANES * NW, 1)
sim_step_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                const float* __restrict__ geff, const float* __restrict__ gq,
                const float* __restrict__ gv, const float* __restrict__ gcmd,
                const float* __restrict__ gms, const float* __restrict__ ggd, int substeps,
                float* __restrict__ oq, float* __restrict__ ov, float* __restrict__ oacc,
                float* __restrict__ ofc, bool* __restrict__ odec) {
  constexpr int NT = LANES * NW;
  __shared__ Scenario<NW> s;
  const int tid = threadIdx.x, warp = tid / LANES, lane = tid % LANES;
  const int half = lane >> 4, pt = lane & 15, part = 2 * warp + half;
  const long long b = blockIdx.x;
  const float* K = s.K;

  // ---- the inputs, the constant columns, the tables ----
  for (int i = tid; i < N_CONSTS; i += NT) s.K[i] = gK[i];
  if (tid < N_SIM_PARAMS) s.P[tid] = gP[tid];
  if (tid < NJ) s.eff[tid] = geff[tid];
  for (int i = tid; i < NCMD; i += NT) s.cmd[i / NJ][i % NJ] = gcmd[b * NCMD + i];
  if (tid < NQ) {
    s.q[tid] = gq[b * NQ + tid];
    s.v[tid] = gv[b * NQ + tid];
  }
  if (tid < 3) s.gvec[tid] = (tid == 2 ? GRAVITY : 0.0f) - (ggd ? ggd[b * 3 + tid] : 0.0f);
  if (tid == 0) s.ms = gms ? gms[b] : 1.0f;
  // the translation columns (e_i, no angular part) and zeros elsewhere
  for (int e = tid; e < L * NQ; e += NT) {
    const int kk = e / NQ, i = e % NQ;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s.JL[kk][i] = make_float4(i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f,
                              i == 2 ? 1.0f : 0.0f, 0.0f);
    s.JA[kk][i] = z;
    s.IJ[kk][i] = z;
    if (kk < NC) s.JC[kk][i] = s.JL[kk][i];
  }
  for (int e = tid; e < NME; e += NT) {
    int i, j, k0, n;
    m_entry(e, &i, &j, &k0, &n);
    s.ei[e] = static_cast<unsigned char>(i);
    s.ej[e] = static_cast<unsigned char>(j);
    s.ek[e] = static_cast<unsigned char>(k0);
    s.en[e] = static_cast<unsigned char>(n);
  }
  for (int e = tid; e < NIJ; e += NT) {
    int kk, i;
    ij_entry(e, &kk, &i);
    s.ijk[e] = static_cast<unsigned char>(kk);
    s.iji[e] = static_cast<unsigned char>(i);
  }
  __syncthreads();
  if (tid < NJ) mv3(K + K_OROT + 9 * tid, K + K_AXIS + 3 * tid, s.a[tid]);
  const float dt = s.P[P_DT];
  const bool row_lane = warp == 0;  // warp 0 runs the chain and the solve
  constexpr int BW = NW > 1 ? 1 : 0;  // the warp whose second half forms the base block
  const int r = lane & 15;          // warp 0: the row of lane r and of its mirror
  Clock clk;
  clk.start(b == 0 && tid == 0);

  for (int step = 0; step < substeps; ++step) {
    // the poison: 0 x sum(q + v), 0 or NaN, on every lane
    const float pz = 0.0f * half_sum(s.q[pt] + s.v[pt]);

    // ---- 1. the chain: the 13 angles' sines and cosines on lanes 0-12, the
    // joints' local transforms and the base, then the legs, three lanes each ----
    if (row_lane) {
      const float ang = lane < NJ ? s.q[6 + lane] : (lane < NJ + 3 ? s.q[3 + lane - NJ] : 0.0f);
      float sa, ca;
      sincosf(ang, &sa, &ca);
      const float cz = __shfl_sync(FULL, ca, NJ), sz = __shfl_sync(FULL, sa, NJ);
      const float cy = __shfl_sync(FULL, ca, NJ + 1), sy = __shfl_sync(FULL, sa, NJ + 1);
      const float cx = __shfl_sync(FULL, ca, NJ + 2), sx = __shfl_sync(FULL, sa, NJ + 2);
      // the base's rotation on every lane (soa_model.cuh::base_pose_dev)
      const float R0[9] = {cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                           sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                           -sy,     cy * sx,                cy * cx};
      if (lane < NJ) {
        // soa_model.cuh::joint_local_dev's T = R_origin rod from the lane's sine and cosine
        const float u = 1.0f - ca;
        float rod[9];
#pragma unroll
        for (int e = 0; e < 9; ++e)
          rod[e] = ((e % 4 == 0) ? 1.0f : 0.0f) + sa * K[K_RK + 9 * lane + e]
                   + u * K[K_RKK + 9 * lane + e];
        mm3(K + K_OROT + 9 * lane, rod, s.T[lane]);
      } else if (lane == NJ) {
        const float trig[4] = {cz, sz, cy, sy};
        float E[9], Ed[9], t[3], om0[3];
        Kin* w = &s.k;
        euler_E(trig, E);
        euler_Edot(trig, s.v + 3, Ed);
        mv3(E, s.v + 3, om0);
        mv3(R0, K + K_COML, t);
        for (int e = 0; e < 9; ++e) w->R[0][e] = R0[e];
        for (int i = 0; i < 3; ++i) {
          w->p[0][i] = s.q[i];
          w->com[0][i] = s.q[i] + t[i];
          w->om[0][i] = om0[i];
          w->vo[0][i] = s.v[i];
          for (int c = 0; c < 3; ++c) {
            s.Et[c][i] = E[3 * i + c];
            s.Edt[c][i] = Ed[3 * i + c];
          }
        }
      }
      __syncwarp();
      leg_rows(K, s.T, s.a, s.v + 6, lane, R0, &s.k);
    }
    scenario_sync<NW>();
    clk.mark(PH_CHAIN);

    // ---- 2. the columns; world inertias; wrenches, the contact law ----
    float x[3] = {0.0f, 0.0f, 0.0f}, xd[3] = {0.0f, 0.0f, 0.0f};
    float sum[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // dJ/dt v: linear, angular
    // half sums over the links: warp 0's first half nle's base terms (F,
    // r x F + T), warp BW's second half the base block's (m r, I + m (|r|^2 -
    // r r')) with the world inertias, r the link's CoM from the base origin
    float red[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (pt < NPTS) {
      const bool link = pt < L;
      const int c = pt - L;
      const int kl = link ? pt : LEG_JOINTS * (1 + c % 2);  // SOA_CPARENT: links 5, 10, 5, 10
      if (link) {
        for (int e = 0; e < 3; ++e) x[e] = s.k.com[kl][e];
        if (warp == BW && half == 1) {
          float Iw[9], r[3];
          link_inertia_world(K, s.k.R[kl], kl, Iw);
          for (int e = 0; e < 9; ++e) s.k.Iw[kl][e] = Iw[e];
          const float mk = K[K_MASS + kl];
          for (int e = 0; e < 3; ++e) {
            r[e] = x[e] - s.k.p[0][e];
            red[e] = mk * r[e];
          }
          const float rr = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2];
#pragma unroll
          for (int e = 0; e < 6; ++e) {
            const int a = sym_a(e), bb = sym_b(e);
            red[3 + e] = Iw[3 * a + bb] + mk * ((a == bb ? rr : 0.0f) - r[a] * r[bb]);
          }
        }
      } else {
        float t[3];
        mv3(s.k.R[kl], K + K_CPOS + 3 * c, t);
        for (int e = 0; e < 3; ++e) x[e] = s.k.p[kl][e] + t[e];
      }
      point_velocity(&s.k, kl, x, xd);
      const int g = link_leg(kl), depth = link_depth(kl);
#pragma unroll 1
      for (int slot = part; slot < NSLOT; slot += 2 * NW) {
        if (slot >= 3 && slot - 3 >= depth) break;
        const int i = slot < 3 ? 3 + slot : 6 + LEG_JOINTS * g + (slot - 3);
        float lin[3], ang[3], dlin[3], dang[3];
        column_dev(s, i, x, xd, lin, ang, dlin, dang);
        const float vi = s.v[i];
        if (link) {
          s.JL[kl][i] = make_float4(lin[0], lin[1], lin[2], 0.0f);
          s.JA[kl][i] = make_float4(ang[0], ang[1], ang[2], 0.0f);
          for (int e = 0; e < 3; ++e) {
            sum[e] = sum[e] + dlin[e] * vi;
            sum[3 + e] = sum[3 + e] + dang[e] * vi;
          }
        } else {
          s.JC[c][i] = make_float4(lin[0], lin[1], lin[2], 0.0f);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 6; ++e) sum[e] = sum[e] + __shfl_xor_sync(FULL, sum[e], 16);
    if constexpr (NW > 1) {
      // warp 0 adds the other warps' shares, in warp order
      if (warp > 0 && half == 0 && pt < L)
        for (int e = 0; e < 6; ++e) s.part.v[warp][pt][e] = sum[e];
      __syncthreads();
      if (warp == 0 && half == 0 && pt < L)
        for (int u = 1; u < NW; ++u)
          for (int e = 0; e < 6; ++e) sum[e] = sum[e] + s.part.v[u][pt][e];
    } else {
      __syncwarp();  // the world inertias of the second half
    }
    if (row_lane && half == 0 && pt < L) {
      // link pt's wrench terms: F = m (dJ/dt v + g e_z - gd), T = I dw + w x I w
      const float mk = K[K_MASS + pt];
      const float* w = s.k.om[pt];
      float Iw_w[3], Iw_wd[3], wx[3];
      mv3(s.k.Iw[pt], w, Iw_w);
      mv3(s.k.Iw[pt], sum + 3, Iw_wd);
      cross3(w, Iw_w, wx);
      float F[3], T[3], r[3], rF[3];
      for (int e = 0; e < 3; ++e) {
        F[e] = mk * (sum[e] + s.gvec[e]);
        T[e] = Iw_wd[e] + wx[e];
        s.F[pt][e] = F[e];
        s.Tq[pt][e] = T[e];
        r[e] = x[e] - s.k.p[0][e];
      }
      cross3(r, F, rF);
      for (int e = 0; e < 3; ++e) {
        red[e] = F[e];
        red[3 + e] = rF[e] + T[e];
      }
    } else if (row_lane && half == 0 && pt >= L && pt < NPTS) {
      const int c = pt - L;
      const float vc[3] = {xd[0] + pz, xd[1] + pz, xd[2] + pz};
      const bool in_contact = contact_force(s.P, x, vc, s.fc[c]);
      if (odec != nullptr) odec[(b * substeps + step) * NC + c] = in_contact;
    }
    if (warp == 0 || warp == BW) {
#pragma unroll
      for (int e = 0; e < 9; ++e) red[e] = half_sum(red[e]);
      if (warp == BW && half == 1) {
        // M's base block: [[m I, -m (c - p0)x E], [., E' Ic E]], Ic the composite
        // inertia about the base origin: lanes 0-5 the Euler-rate pairs, 6-14
        // the mixed entries, 15 the translation block
        if (pt < 6) {
          const int a = sym_a(pt), bb = sym_b(pt);
          const float Ic[9] = {red[3], red[4], red[5], red[4], red[6], red[7],
                               red[5], red[7], red[8]};
          float t[3];
          mv3(Ic, s.Et[bb], t);
          const float mij = (s.Et[a][0] * t[0] + s.Et[a][1] * t[1]) + s.Et[a][2] * t[2];
          s.M[3 + a][3 + bb] = mij;
          s.M[3 + bb][3 + a] = mij;
        } else if (pt < 15) {
          const int i = (pt - 6) / 3, c = (pt - 6) % 3;
          float t[3];
          cross3(s.Et[c], red, t);
          const float ti = i == 0 ? t[0] : (i == 1 ? t[1] : t[2]);
          s.M[i][3 + c] = ti;
          s.M[3 + c][i] = ti;
        } else {
          for (int e = 0; e < 9; ++e) s.M[e / 3][e % 3] = e % 4 == 0 ? K[K_M] : 0.0f;
        }
      } else if (warp == 0 && half == 0 && pt < 6) {
        // nle's base rows: sum_k F_k, E_c . sum_k (r_k x F_k + T_k)
        const int c = pt - 3;
        s.hb[pt] = pt < 3 ? (pt == 0 ? red[0] : (pt == 1 ? red[1] : red[2]))
                          : (s.Et[c][0] * red[3] + s.Et[c][1] * red[4]) + s.Et[c][2] * red[5];
      }
    }
    scenario_sync<NW>();
    clk.mark(PH_COLUMNS);

    // ---- 3. I J per (link, joint column); the columns' generalized forces ----
    // (on the threads beside warp 0's first half, which forms the generalized forces)
    for (int e = tid < 16 ? NIJ : tid - 16; e < NIJ; e += NT - 16) {
      const int kk = s.ijk[e], i = s.iji[e];
      const float4 a = s.JA[kk][i];
      const float av[3] = {a.x, a.y, a.z};
      float o[3];
      mv3(s.k.Iw[kk], av, o);
      s.IJ[kk][i] = make_float4(o[0], o[1], o[2], 0.0f);
    }
    float gen = 0.0f;  // warp 0's first half: sum_c Jc' f - ms (nle - field) of column r
    if (row_lane && half == 0) {
      const int g = r < 6 ? 0 : (r - 6) / LEG_JOINTS, n = r < 6 ? 0 : (r - 6) % LEG_JOINTS;
      float h = r < 6 ? s.hb[r] : 0.0f;
      // a joint's row over the links it moves
#pragma unroll
      for (int u = 0; u < LEG_JOINTS; ++u) {
        const int kk = LEG_JOINTS * g + 1 + n + u;
        if (r >= 6 && kk <= LEG_JOINTS * g + LEG_JOINTS) {
          const float4 li = s.JL[kk][r], ai = s.JA[kk][r];
          h = h + (((li.x * s.F[kk][0] + li.y * s.F[kk][1]) + li.z * s.F[kk][2])
                   + ((ai.x * s.Tq[kk][0] + ai.y * s.Tq[kk][1]) + ai.z * s.Tq[kk][2]));
        }
      }
      float jf = 0.0f;
      for (int c = 0; c < NC; ++c) {
        if (r >= 6 && c % 2 != g) continue;  // contacts 0, 2 on leg 0; 1, 3 on leg 1
        const float4 jc = s.JC[c][r];
        jf = jf + jc.x * s.fc[c][0];
        jf = jf + jc.y * s.fc[c][1];
        jf = jf + jc.z * s.fc[c][2];
      }
      gen = jf - s.ms * h;
    }
    scenario_sync<NW>();

    // ---- 4. M's distinct entries ----
#pragma unroll 1
    for (int e = tid; e < NME; e += NT) {
      const int i = s.ei[e], j = s.ej[e], k0 = s.ek[e], n = s.en[e];
      float lin = 0.0f, ang = 0.0f;
#pragma unroll
      for (int u = 0; u < LEG_JOINTS; ++u) {
        if (u < n) {
          const int kk = k0 + u;
          lin = lin + K[K_MASS + kk] * dot3(s.JL[kk][i], s.JL[kk][j]);
          ang = ang + dot3(s.JA[kk][i], s.IJ[kk][j]);
        }
      }
      const float mij = lin + ang;
      s.M[i][j] = mij;
      s.M[j][i] = mij;
    }
    scenario_sync<NW>();
    clk.mark(PH_DYNAMICS);

    if (row_lane) {
      // ---- 5. the tableau's row r in registers, Gauss-Jordan by shuffles ----
      const float arm = r < 6 ? 0.0f : s.P[P_ARM], damp = r < 6 ? 0.0f : s.P[P_DAMP];
      const float ms = s.ms, diag = arm + dt * damp;
      float tau = 0.0f;
      if (r >= 6) {
        const int j = r - 6;
        float t = (s.cmd[4][j] + s.cmd[2][j] * (s.cmd[0][j] - s.q[r]))
                  + s.cmd[3][j] * (s.cmd[1][j] - s.v[r]);
        t = t < -s.eff[j] ? -s.eff[j] : t;
        tau = t > s.eff[j] ? s.eff[j] : t;
      }
      gen = __shfl_sync(FULL, gen, r);
      float row[NQ + 1];
#pragma unroll
      for (int c = 0; c < NQ; ++c) row[c] = ms * s.M[r][c] + (c == r ? diag : 0.0f);
      row[NQ] = (((r < 6 ? 0.0f : tau) + gen) - damp * s.v[r]) + pz;
      clk.mark(PH_TABLEAU);
      float own_inv = 0.0f;  // the reciprocal of this row's pivot + 1e-30
#pragma unroll
      for (int kp = 0; kp < NQ; ++kp) {
        const float inv = 1.0f / (__shfl_sync(FULL, row[kp], kp) + 1e-30f);
        own_inv = r == kp ? inv : own_inv;
        const float m = r == kp ? 0.0f : row[kp] * inv;
#pragma unroll
        for (int c = kp + 1; c <= NQ; ++c) row[c] = row[c] - m * __shfl_sync(FULL, row[c], kp);
      }
      clk.mark(PH_SOLVE);

      // ---- 6. semi-implicit Euler ----
      if (lane < NQ) {
        const float acc = row[NQ] * own_inv;
        const float v_new = s.v[r] + dt * acc;
        s.v[r] = v_new;
        s.q[r] = s.q[r] + dt * v_new;
        if (step == substeps - 1) oacc[b * NQ + r] = acc;
      }
    }
    scenario_sync<NW>();
    clk.mark(PH_EULER);
  }
  clk.flush();

  if (tid < NQ) {
    oq[b * NQ + tid] = s.q[tid];
    ov[b * NQ + tid] = s.v[tid];
  }
  if (tid < NF) ofc[b * NF + tid] = s.fc[tid / 3][tid % 3];
}

template <int NW>
int launch(const float* consts, const float* params, const float* effort, const float* q,
           const float* v, const float* cmd, const float* mass_scale,
           const float* gravity_delta, float* q_out, float* v_out, float* acc,
           float* contact_forces, bool* decisions, int batch, int substeps,
           cudaStream_t stream) {
  sim_step_kernel<NW><<<static_cast<unsigned>(batch), LANES * NW, 0, stream>>>(
      consts, params, effort, q, v, cmd, mass_scale, gravity_delta, substeps, q_out, v_out,
      acc, contact_forces, decisions);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hk_sim_step(const float* consts, const float* params, const float* effort,
                           const float* q, const float* v, const float* cmd,
                           const float* mass_scale, const float* gravity_delta, float* q_out,
                           float* v_out, float* acc, float* contact_forces, bool* decisions,
                           int batch, int substeps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= WIDE_MAX_BATCH)
    return launch<WIDE>(consts, params, effort, q, v, cmd, mass_scale, gravity_delta, q_out,
                        v_out, acc, contact_forces, decisions, batch, substeps, st);
  return launch<1>(consts, params, effort, q, v, cmd, mass_scale, gravity_delta, q_out, v_out,
                   acc, contact_forces, decisions, batch, substeps, st);
}

#ifdef SIM_STEP_PHASE_CLOCKS
// The phase sums since the last call (SIM_PHASES of them), then zeroed.
extern "C" int hk_sim_step_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sim_phase_cycles, sizeof(sim_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[SIM_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(sim_phase_cycles, zero, sizeof(zero)));
}
#endif
