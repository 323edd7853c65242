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
// Design: a warp per scenario at every batch, four scenarios a block (the
// grid's last block may hold fewer).  The block's threads load the model's
// constants into shared memory once, behind the block's one barrier; each
// warp then works in its own shared memory with __syncwarp between phases:
//   1. the constants (each thread's loads issued before its stores) and
//      the scenario's 58 input floats (rbd, the torques, p_scg_z_last) in
//      one coalesced round trip; gamma = exp(-lambda dt) and beta = (1 -
//      gamma) / (gamma dt) on every lane;
//   2. the chain: one sincosf on lanes 0-12 (the joint angles, the base's
//      zyx); the Euler rates' three quotients on lanes 0-2 from one
//      correctly rounded reciprocal of cos(pitch) and an FMA correction
//      (pivot_quotient), then E(theta)^-1 omega, E and dE/dt on every lane;
//      a lane per joint its Rodrigues matrix; then the two legs side by
//      side on three lanes each, a row of the running rotation a lane, in
//      fk_dev's order (R_parent R_origin, then that times the Rodrigues
//      matrix) with the velocity pass's cross products by shuffles within
//      the three lanes; the links' frames, CoMs, velocities, the joints'
//      world axes and anchors and the two toes to shared memory;
//   3. a lane per link: its world inertia R I R', w_k = J_ang,k v summed
//      over the 16 columns in order, the CoM's velocity and h_k;
//   4. the (link, column) pairs: lane i and lane 16 + i take column i,
//      links 0-5 and links 6-10 (then the toe of joint i - 6's leg); each
//      pair's column and time derivative is formed once, with its terms
//      J_k,i' h_k, dJ_k,i' h_k and (J_lin,k)_z,i, the six links of a lane
//      unrolled so that their loads overlap; the toes' columns are the
//      legs' A = S_l J6' rows (5 x 6);
//   5. lane i < 16 adds its column's terms over the links in the order
//      k = 0..10: p_i, (C' v)_i and g_i = 9.81 sum_k m_k (J_lin,k)_z,i,
//      then the filter:
//        p_scg = beta p + S' tau + C' v - g,
//        p_scg_z = (1 - gamma) p_scg + gamma p_scg_z_last,
//        tau_dist = beta p - p_scg_z;
//   6. 30 lanes the 15 distinct entries of each leg's A A' + 1e-6 I (the
//      mirror entry is the same sum of the same products); lane 6 + 5 l + r
//      holds row r of leg l's tableau [A A' + 1e-6 I | S_l tau_dist] in
//      registers, both legs at once;
//   7. Gauss-Jordan by shuffles with gj.cuh's semantics (pivots in the
//      natural order, each + 1e-30 as the JAX package's gj_inverse adds it,
//      the pivot row divided by its pivot as IEEE division rounds it, from
//      one correctly rounded reciprocal a pivot, then the rank-1 update of
//      the other rows): y = (A A' + 1e-6 I)^-1 b, the inverse never formed
//      and no padding column kept;
//   8. 12 lanes w = A' y, four lanes the norms by shuffles: est_forces =
//      [w_L, w_R, |F_L|, |F_R|, |w_L|, |w_R|]; p_scg_z, tau_dist and
//      est_forces stored, 16 consecutive floats each.
// Every value is formed by the operations, in the order, of the first
// design's (rbd_dynamics.cuh's state_chain, link_columns, link_momentum,
// momentum_rate_term; gj.cuh): built with -fmad=false, both give the same
// floats; with the default contraction, nvcc fuses a different set of
// multiply-adds in the two, which moves the last bits (profile_step
// observer_times, "outputs_vs_other" and "outputs_vs_other_unfused").  A joint
// that does not move a point enters as its column's value times 0, and
// nothing is clamped or branched on the data, so a NaN state spreads as it
// does in the plain version.
//
// Work: per scenario 58 floats in, 48 out; ~10k floating-point operations
// (chip_smoke.py::observer_cost).  At B=1 the kernel is latency bound: the
// legs' five dependent joints and the (link, column) terms lead (profile_step
// observer_phases).
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too; the cutoff frequency from a one-float buffer
// (estim/contact.py::params_buffer).  True float32: no fast math.
#include <cuda_runtime.h>

#include "rbd_dynamics.cuh"

namespace {

constexpr int LANES = 32;
constexpr int WARPS = 4;        // scenarios a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int NRBD = 2 * NQ;    // 32
constexpr int NLEG = 5;         // joints per leg
constexpr int NEST = 16;        // est_forces
constexpr int HALF_LINKS = 6;   // links of the first half warp's lanes (0-5; 6-10 the second's)

// the scenario's inputs in its shared memory
constexpr int I_RBD = 0, I_TAU = I_RBD + NRBD, I_PL = I_TAU + NJ, N_IN = I_PL + NQ;

// one scenario's shared memory
struct Scenario {
  float in[N_IN];
  float rod[NJ][9];                            // joint j's Rodrigues matrix
  float R[L][9];                               // world_R_link
  float p[L][3], com[L][3], om[L][3], vo[L][3];
  float aw[NJ][3], anchor[NJ][3], pc[2][3];    // joint axes and anchors, the toes
  float cd[L][3], hl[L][3], ha[L][3];          // CoM velocities, momenta
  float term[L][3][NQ];                        // per link and column: J' h, dJ' h, (J_lin)_z
  float A[2][NLEG][6];                         // per leg S_l J6'
  float T[2][NLEG][NLEG];                      // per leg A A' + 1e-6 I
};

// Measurement build only (profile_step observer_phases): -DMO_PHASE_CLOCKS
// sums block 0's clock64 cycles on thread 0 (scenario 0's lane 0) by phase
// in registers, added to the device sums once at the end: the loads, the
// chain, the links' momenta, the (link, column) terms and A, the sums and
// the filter, A A' and the tableau, the solve, the wrenches and the stores.
enum { PH_LOAD, PH_CHAIN, PH_COLUMNS, PH_TERMS, PH_FILTER, PH_AAT, PH_SOLVE, PH_WRENCH,
       MO_PHASES };
#ifdef MO_PHASE_CLOCKS
__device__ unsigned long long mo_phase_cycles[MO_PHASES];
#define MO_PHASE(p)                              \
  if (blockIdx.x == 0 && threadIdx.x == 0) {     \
    const long long now = clock64();             \
    mo_acc[p] += now - t_phase;                  \
    t_phase = now;                               \
  }
#define MO_FLUSH()                                                                      \
  if (blockIdx.x == 0 && threadIdx.x == 0)                                              \
    for (int q = 0; q < MO_PHASES; ++q)                                                 \
      atomicAdd(&mo_phase_cycles[q], static_cast<unsigned long long>(mo_acc[q]));
#else
#define MO_PHASE(p)
#define MO_FLUSH()
#endif

// num / den as IEEE division rounds it, from the correctly rounded
// reciprocal y = 1 / den: q = num y, then one correction by the exact
// residual num - den q (Markstein: RN(q + (num - den q) y) is the correctly
// rounded quotient when y is, for a finite, nonzero den whose quotient and
// reciprocal stay in the normal range; a zero numerator keeps its signed
// zero).  No lane takes a division's slow path, and none diverges.
__device__ __forceinline__ float pivot_quotient(float num, float den, float y) {
  const float q = num * y;
  const float r = fmaf(-den, q, num);
  return num == 0.0f ? q : fmaf(r, y, q);
}

// v[c] of a 3-vector in registers for a c known only at run time (an
// index into a register array would put the array on the stack)
__device__ __forceinline__ float pick3(const float* v, int c) {
  return c == 0 ? v[0] : (c == 1 ? v[1] : v[2]);
}

// SOA_ANC[k][j] without the constant bank (the lanes of a warp ask for
// different links): joint j of leg j / LEG_JOINTS moves link k of the same
// leg from its own child link on
__device__ __forceinline__ float moves(int j, int k) {
  return (k >= 1 && (k - 1) / LEG_JOINTS == j / LEG_JOINTS && j % LEG_JOINTS <= (k - 1) % LEG_JOINTS)
             ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(LANES * WARPS)
momentum_observer_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                         const float* __restrict__ grbd, const float* __restrict__ gtau,
                         const float* __restrict__ gpl, int batch, float dt,
                         float* __restrict__ opz, float* __restrict__ oest,
                         float* __restrict__ otd) {
  __shared__ float K[N_CONSTS];
  __shared__ Scenario scenarios[WARPS];
  const int lane = threadIdx.x % LANES;
  const long long b = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / LANES;
  const bool live = b < batch;
  Scenario& s = scenarios[threadIdx.x / LANES];
#ifdef MO_PHASE_CLOCKS
  long long t_phase = clock64();
  long long mo_acc[MO_PHASES] = {};
#endif

  // ---- 1. the loads, the constants' all issued before their stores ----
  {
    constexpr int T = LANES * WARPS, R = (N_CONSTS + T - 1) / T;
    float kv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = threadIdx.x + r * T;
      kv[r] = i < N_CONSTS ? gK[i] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (threadIdx.x + r * T < N_CONSTS) K[threadIdx.x + r * T] = kv[r];
  }
  const float lam = gP[0];
  if (live) {
    const float r = grbd[b * NRBD + lane];
    const float t = lane < NJ ? gtau[b * NJ + lane] : 0.0f;
    const float z = lane < NQ ? gpl[b * NQ + lane] : 0.0f;
    s.in[I_RBD + lane] = r;
    if (lane < NJ) s.in[I_TAU + lane] = t;
    if (lane < NQ) s.in[I_PL + lane] = z;
  }
  __syncthreads();  // the constants: the block's one barrier
  if (!live) return;  // the whole warp
  const float gama = expf(-lam * dt);
  const float beta = (1.0f - gama) / (gama * dt);
  const float* in = s.in;
  MO_PHASE(PH_LOAD);

  // ---- 2. the chain ----
  // lanes 0-9 the joint angles, 10-12 the base's zyx: one sincosf for all
  float sa, ca;
  sincosf(lane < NJ ? in[6 + lane] : (lane < NJ + 3 ? in[lane - NJ] : 0.0f), &sa, &ca);
  const float cz = __shfl_sync(FULL, ca, NJ), sz = __shfl_sync(FULL, sa, NJ);
  const float cy = __shfl_sync(FULL, ca, NJ + 1), sy = __shfl_sync(FULL, sa, NJ + 1);
  const float cx = __shfl_sync(FULL, ca, NJ + 2), sx = __shfl_sync(FULL, sa, NJ + 2);
  // the Euler rates E(zyx)^-1 omega_world (rbd_dynamics.cuh::euler_rates_dev):
  // lanes 0-2 the quotients sy / cy, cz / cy, sz / cy
  const float quo = pivot_quotient(lane == 0 ? sy : (lane == 1 ? cz : sz), cy, __frcp_rn(cy));
  const float ty = __shfl_sync(FULL, quo, 0), czy = __shfl_sync(FULL, quo, 1),
              szy = __shfl_sync(FULL, quo, 2);
  float thd[3];
  {
    const float Einv[9] = {cz * ty, sz * ty, 1.0f, -sz, cz, 0.0f, czy, szy, 0.0f};
    mv3(Einv, in + NQ, thd);
  }
  const float trig[4] = {cz, sz, cy, sy};
  float E[9], Ed[9];
  euler_E(trig, E);
  euler_Edot(trig, thd, Ed);
  if (lane < NJ) {
    // soa_model.cuh::fk_dev's Rodrigues matrix from the lane's sine and cosine
    const float u = 1.0f - ca;
#pragma unroll
    for (int e = 0; e < 9; ++e)
      s.rod[lane][e] = ((e % 4 == 0) ? 1.0f : 0.0f) + sa * K[K_RK + 9 * lane + e]
                       + u * K[K_RKK + 9 * lane + e];
  }
  __syncwarp();
  // the legs side by side: lane 3 g + i (and every sixth lane after it, the
  // same values) holds row i of leg g's running rotation (the base's at
  // first) and component i of its origin, angular and linear velocity
  {
    const int t = lane % 6, g = t / 3, i = t % 3;
    const int i1 = 3 * g + (i + 1) % 3, i2 = 3 * g + (i + 2) % 3;
    const bool store = lane < 6;
    float r0 = i == 0 ? cz * cy : (i == 1 ? sz * cy : -sy);
    float r1 = i == 0 ? cz * sy * sx - sz * cx : (i == 1 ? sz * sy * sx + cz * cx : cy * sx);
    float r2 = i == 0 ? cz * sy * cx + sz * sx : (i == 1 ? sz * sy * cx - cz * sx : cy * cx);
    float om0[3];
    mv3(E, thd, om0);
    float p = in[3 + i], vo = in[NQ + 3 + i], om = pick3(om0, i);
    if (store && g == 0) {
      const float* cl = K + K_COML;
      s.R[0][3 * i] = r0, s.R[0][3 * i + 1] = r1, s.R[0][3 * i + 2] = r2;
      s.p[0][i] = p;
      s.com[0][i] = p + (r0 * cl[0] + r1 * cl[1] + r2 * cl[2]);
      s.om[0][i] = om;
      s.vo[0][i] = vo;
    }
#pragma unroll
    for (int n = 0; n < LEG_JOINTS; ++n) {
      const int j = LEG_JOINTS * g + n, ch = j + 1;
      const float* O = K + K_OROT + 9 * j;
      const float* op = K + K_OPOS + 3 * j;
      const float* ax = K + K_AXIS + 3 * j;
      const float* rod = s.rod[j];
      // fk_dev: Ror = R_parent R_origin, t = R_parent origin, aw = Ror axis,
      // R_child = Ror rod (the lane's row of each)
      const float q0 = r0 * O[0] + r1 * O[3] + r2 * O[6];
      const float q1 = r0 * O[1] + r1 * O[4] + r2 * O[7];
      const float q2 = r0 * O[2] + r1 * O[5] + r2 * O[8];
      const float tt = r0 * op[0] + r1 * op[1] + r2 * op[2];
      const float por = p + tt;
      const float aw = q0 * ax[0] + q1 * ax[1] + q2 * ax[2];
      r0 = q0 * rod[0] + q1 * rod[3] + q2 * rod[6];
      r1 = q0 * rod[1] + q1 * rod[4] + q2 * rod[7];
      r2 = q0 * rod[2] + q1 * rod[5] + q2 * rod[8];
      // velocity_pass_dev: vo += om x (anchor - p_parent), om += qd_j aw
      const float dp = por - p;
      const float oa = __shfl_sync(FULL, om, i1), ob = __shfl_sync(FULL, om, i2);
      const float da = __shfl_sync(FULL, dp, i1), db = __shfl_sync(FULL, dp, i2);
      const float c = oa * db - ob * da;
      vo = vo + c;
      om = om + in[NQ + 6 + j] * aw;
      p = por;
      if (store) {
        const float* cl = K + K_COML + 3 * ch;
        s.R[ch][3 * i] = r0, s.R[ch][3 * i + 1] = r1, s.R[ch][3 * i + 2] = r2;
        s.p[ch][i] = p;
        s.anchor[j][i] = p;
        s.aw[j][i] = aw;
        s.com[ch][i] = p + (r0 * cl[0] + r1 * cl[1] + r2 * cl[2]);
        s.om[ch][i] = om;
        s.vo[ch][i] = vo;
      }
    }
    // the leg's toe (contact g, on link 5 or 10: SOA_CPARENT)
    if (store) {
      const float* cp = K + K_CPOS + 3 * g;
      s.pc[g][i] = p + (r0 * cp[0] + r1 * cp[1] + r2 * cp[2]);
    }
  }
  __syncwarp();
  MO_PHASE(PH_CHAIN);

  // ---- 3. a lane per link: I_k, w_k = J_ang,k v, the CoM's velocity, h_k ----
  if (lane < L) {
    const int k = lane;
    float Rk[9], Iw[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) Rk[e] = s.R[k][e];
    link_inertia_world(K, Rk, k, Iw);
    // link_columns' sum over the columns: 0 for the translations, E's
    // columns, the joints' axes times the ancestor mask
    float w[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float vi = in[NQ + 3 + i];
#pragma unroll
      for (int a = 0; a < 3; ++a) w[a] = w[a] + 0.0f * vi;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int a = 0; a < 3; ++a) w[a] = w[a] + E[3 * a + c] * thd[c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float mask = moves(j, k), vi = in[NQ + 6 + j];
#pragma unroll
      for (int a = 0; a < 3; ++a) w[a] = w[a] + (s.aw[j][a] * mask) * vi;
    }
    // link_momentum: cd = vo + om x (com - p), ha = I_k w_k, hl = m_k cd
    float d[3], t[3], cd[3], ha[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = s.com[k][a] - s.p[k][a];
    cross3(s.om[k], d, t);
#pragma unroll
    for (int a = 0; a < 3; ++a) cd[a] = s.vo[k][a] + t[a];
    mv3(Iw, w, ha);
    const float mk = K[K_MASS + k];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s.cd[k][a] = cd[a];
      s.hl[k][a] = mk * cd[a];
      s.ha[k][a] = ha[a];
    }
  }
  __syncwarp();
  MO_PHASE(PH_COLUMNS);

  // ---- 4. the (link, column) pairs: column i = lane % 16 on links 0-5
  // (lanes 0-15) or 6-10 and then the toe (lanes 16-31) ----
  {
    const int i = lane & 15, half = lane >> 4, j = i - 6;
    const bool trans = i < 3, joint = i >= 6;
    // rbd_dynamics.cuh::point_column's axis, its derivative and the
    // reference point and velocity of column i: E's and dE/dt's column
    // about the base origin, joint j's world axis, om_parent x axis about
    // its anchor; none for a translation
    float ax[3], adv[3], ref[3], vref[3];
    if (joint) {
      const int par = j % LEG_JOINTS == 0 ? 0 : j;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        ax[a] = s.aw[j][a];
        ref[a] = s.anchor[j][a];
        vref[a] = s.vo[j + 1][a];
      }
      cross3(s.om[par], ax, adv);
    } else {
      const int c = trans ? 0 : i - 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        ax[a] = pick3(E + 3 * a, c);
        adv[a] = pick3(Ed + 3 * a, c);
        ref[a] = s.p[0][a];
        vref[a] = in[NQ + 3 + a];
      }
    }
#pragma unroll
    for (int kk = 0; kk < HALF_LINKS; ++kk) {
      const int k = half * HALF_LINKS + kk;  // L: the toe of the lane's leg
      const bool toe = k == L;
      if (toe && !joint) continue;
      float x[3], xd[3], hl[3], ha[3];
      float mask = 1.0f;
      if (toe) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          x[a] = s.pc[j / LEG_JOINTS][a];
          xd[a] = hl[a] = ha[a] = 0.0f;
        }
      } else {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          x[a] = s.com[k][a];
          xd[a] = s.cd[k][a];
          hl[a] = s.hl[k][a];
          ha[a] = s.ha[k][a];
        }
        if (joint) mask = moves(j, k);
      }
      float r[3], rd[3], l[3], t1[3], t2[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        r[a] = x[a] - ref[a];
        rd[a] = xd[a] - vref[a];
      }
      cross3(ax, r, l);
      cross3(adv, r, t1);
      cross3(ax, rd, t2);
      float lin[3], ang[3], dlin[3], dang[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lin[a] = trans ? (a == i ? 1.0f : 0.0f) : l[a] * mask;
        ang[a] = trans ? 0.0f : ax[a] * mask;
        dlin[a] = trans ? 0.0f : (t1[a] + t2[a]) * mask;
        dang[a] = trans ? 0.0f : adv[a] * mask;
      }
      if (toe) {
        // the toe's linear rows and its link's angular columns at joint j
        float* Ar = s.A[j / LEG_JOINTS][j % LEG_JOINTS];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          Ar[a] = lin[a];
          Ar[3 + a] = ang[a];
        }
      } else {
        s.term[k][0][i] = ((lin[0] * hl[0] + lin[1] * hl[1]) + lin[2] * hl[2])
                          + ((ang[0] * ha[0] + ang[1] * ha[1]) + ang[2] * ha[2]);
        s.term[k][1][i] = ((dlin[0] * hl[0] + dlin[1] * hl[1]) + dlin[2] * hl[2])
                          + ((dang[0] * ha[0] + dang[1] * ha[1]) + dang[2] * ha[2]);
        s.term[k][2][i] = lin[2];
      }
    }
  }
  __syncwarp();
  MO_PHASE(PH_TERMS);

  // ---- 5. p, C' v and g over the links in order; the filter ----
  float dist = 0.0f;
  if (lane < NQ) {
    const int i = lane;
    float p = 0.0f, cv = 0.0f, gz = 0.0f;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      p = p + s.term[k][0][i];
      cv = cv + s.term[k][1][i];
      gz = gz + K[K_MASS + k] * s.term[k][2][i];
    }
    const float g = GRAVITY * gz;
    const float p_scg = ((beta * p + (i < 6 ? 0.0f : in[I_TAU + i - 6])) + cv) - g;
    const float pz = (1.0f - gama) * p_scg + gama * in[I_PL + i];
    dist = beta * p - pz;
    opz[b * NQ + i] = pz;
    otd[b * NQ + i] = dist;
  }
  MO_PHASE(PH_FILTER);

  // ---- 6. the legs' A A' + 1e-6 I: a lane per distinct entry; the tableau ----
  if (lane < 30) {
    const int l = lane / 15;
    int r = 0, c = lane % 15;
    while (c >= NLEG - r) {
      c -= NLEG - r;
      ++r;
    }
    c += r;
    float acc = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) acc = acc + s.A[l][r][jj] * s.A[l][c][jj];
    const float v = acc + (r == c ? 1e-6f : 0.0f);
    s.T[l][r][c] = v;
    s.T[l][c][r] = v;
  }
  __syncwarp();
  // lane 6 + 5 l + r: row r of leg l (the other lanes a copy of some row)
  const int rr = (lane + 4) % (2 * NLEG), l = rr / NLEG, r = rr % NLEG;
  float M[NLEG + 1];
#pragma unroll
  for (int c = 0; c < NLEG; ++c) M[c] = s.T[l][r][c];
  M[NLEG] = dist;
  MO_PHASE(PH_AAT);

  // ---- 7. Gauss-Jordan by shuffles ----
#pragma unroll
  for (int k = 0; k < NLEG; ++k) {
    const int src = 6 + NLEG * l + k;
    const float pval = __shfl_sync(FULL, M[k], src) + 1e-30f;
    const float y = __frcp_rn(pval);
    const float colv = M[k];
#pragma unroll
    for (int c = k + 1; c <= NLEG; ++c) {
      const float q = pivot_quotient(__shfl_sync(FULL, M[c], src), pval, y);
      M[c] = r == k ? q : M[c] - colv * q;
    }
  }
  MO_PHASE(PH_SOLVE);

  // ---- 8. the wrenches w = A' y, their norms; the stores ----
  const int lw = (lane / 6) & 1, cw = lane % 6;
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < NLEG; ++q)
    acc = acc + s.A[lw][q][cw] * __shfl_sync(FULL, M[NLEG], 6 + NLEG * lw + q);
  const int ln = (lane - 12) & 1, nn = lane < 14 ? 3 : 6;
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float wc = __shfl_sync(FULL, acc, 6 * ln + c);
    if (c < nn) ss = ss + wc * wc;
  }
  if (lane < NEST) oest[b * NEST + lane] = lane < 12 ? acc : sqrtf(ss);
  MO_PHASE(PH_WRENCH);
  MO_FLUSH();
}

}  // namespace

extern "C" int hk_momentum_observer(const float* consts, const float* params, const float* rbd,
                                    const float* tau, const float* p_last, float* p_scg_z,
                                    float* est_forces, float* tau_dist, int batch, float dt,
                                    void* stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(batch) + WARPS - 1) / WARPS;
  momentum_observer_kernel<<<static_cast<unsigned>(blocks), LANES * WARPS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      consts, params, rbd, tau, p_last, batch, dt, p_scg_z, est_forces, tau_dist);
  return static_cast<int>(cudaGetLastError());
}

#ifdef MO_PHASE_CLOCKS
// The phase sums since the last call (MO_PHASES of them), then zeroed.
extern "C" int hk_momentum_observer_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, mo_phase_cycles, sizeof(mo_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[MO_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(mo_phase_cycles, zero, sizeof(zero)));
}
#endif
