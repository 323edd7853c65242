// B15: the DDP's nonlinear closed-loop rollouts, every (scenario, step
// size) in one launch.
//
// Replaces hunter_bipedal_control_tpu/solver/ddp.py::solve's
// rollout_closed (:78-96) and reroll (:189-194), over
// solver/rollout.py::rollout_step (:127): ode45_step (:98) with
// _dopri_substeps (:60), rk4_step (:118) and sqp.py::rk2_step (:134), and
// with ocp/problem.py::stage_cost_value (:259) and eq_constraints (:149),
// as the port's solver/ddp.py::closed_rollout_plain computes them.  Per
// knot k of a rollout:
//   u_k = (u_bar_k + alpha kff_k) + K_k (x_k - x_bar_k)   (u_bar_k without K)
//   cost += dt * stage cost(x_k, u_k),  eq += |g mask|_1,
//   x_{k+1} = RK2 | RK4 | ODE45 over [0, dt] under u_k;
// then eq /= N.  The rows' flow is the integrator's first stage.
//
// ODE45 is the JAX package's bounded Dormand-Prince 5(4): at most
// max_substeps slots, each advancing, retrying with a smaller step or doing
// nothing, then one RK4 step over the residual.  The slot loop stops once
// the interval is covered (an inactive slot changes nothing), and the RK4
// finish is skipped where the residual is 0 and its first flow is finite
// (it then returns its start exactly).  Every operation a decision follows
// (the stage sums and candidates, the error norm's squares summed in
// component order, t + hs, dt - t, the clips, err^-0.2) is rounded as torch
// rounds it, one operation at a time (__fadd_rn and its kin: no
// contraction into FMAs), in the JAX package's order, and every clip and
// max keeps NaN as jnp.clip does, so a diverging step size behaves as in
// the plain versions; the decisions are warp-uniform.
//
// Design: a block per scenario (a grid row per 8 step sizes), a warp per
// step size and one more warp that stages the knots.  The model's
// constants, the OCP's parameters, Q and R are loaded once per block; each
// knot's data (K_k transposed, kff_k, x_bar_k, u_bar_k, x_nom, flags, the
// foot references: 600 floats) is copied once per block into shared memory
// by that warp's cp.async, the next knot's while this one computes, one
// block barrier a knot.  A warp's lanes own the 22 components
// of the state and the input: lane i forms u_i's feedback row, the
// integrators' axpys, RK4's combine and ODE45's stage sums per component in
// the plain version's order, and the quadratic forms as (Q' dx)_j dx_j on
// lane j summed by shuffles.  A flow on a warp (B9's kinematics):
// the joints' local transforms on lanes 0-9 and the base on lane 10, the
// two legs' chains side by side, three lanes each (lane 3 g + i a row of
// the running rotation, soa_model.cuh::leg_chain_dev's products row by
// row, with the base-fixed velocity pass), the 11 links' world inertias, CoM,
// momentum and base-block terms on their own lanes summed by half-warp
// shuffles, the base block's 3x3 inverse on every lane of the sum, the
// contact points on lanes 16-19 meanwhile, the contact torques on lanes 0-3;
// the row pass adds the contact links' full velocities (om = w0 + om_j, vo
// = v0 + w0 x (p - p0) + vo_j) and the contact velocities on lanes 0-3, the
// 16 equality rows on lanes 0-15 and the 36 soft rows with their penalties
// over the lanes.  The FK's products are regrouped (R (R_origin rod), as
// B9's chain does) and the sums are shuffle trees, so the flows and costs
// differ from the plain version by float32 rounding; fk_dev,
// base_velocity_dev, flow_dev and combined_rows_dev, which B1 and B14
// share, are not used.
//
// Bound on the card: bytes (~0.5 KB per knot and rollout) and operations
// are far below the card's rates (chip_smoke.py::ddp_rollout_cost); each
// rollout is one dependent chain of flows, so the kernel is latency bound:
// one warp per rollout walks the chain with ~22 lanes busy.
//
// True float32: no fast math; a singular 3x3 base block gives inf/NaN as
// soa.py::inv3 does and a NaN state spreads as it does in the plain version.
#include <cuda_runtime.h>

#include <math.h>

#include "soa_rows.cuh"

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;  // step sizes per block
constexpr int RK2 = 0, RK4 = 1;  // 2: ODE45
static_assert(NX <= LANES && NU <= LANES && NEQ <= LANES, "a lane per component");
static_assert(L <= 16 && NC <= 4, "a half warp per link, four contact lanes");

// Measurement build only (profile_step ddp_rollout_phases): rollout 0's
// clock64 cycles by phase, summed over its knots (thread 0 of block 0).
constexpr int DDP_PHASES = 9;  // loads, feedback, fk, base_velocity, velocity_contacts,
                               // row_terms, stage_cost, flows, integrator
#ifdef DDP_ROLLOUT_PHASE_CLOCKS
__device__ unsigned long long ddp_phase_cycles[DDP_PHASES];
struct Clock {
  long long t;
  unsigned long long acc[DDP_PHASES];
  bool on;
  __device__ void start(bool o) {
    on = o;
    for (int i = 0; i < DDP_PHASES; ++i) acc[i] = 0;
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
      for (int i = 0; i < DDP_PHASES; ++i) ddp_phase_cycles[i] += acc[i];
  }
};
#else
struct Clock {
  __device__ void start(bool) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ void flush() {}
};
#endif
enum { PH_LOADS, PH_FEEDBACK, PH_FK, PH_BASE, PH_VEL, PH_ROWS, PH_COST, PH_FLOWS, PH_INTEG };

// Dormand-Prince RK5(4) tableau (solver/rollout.py), rounded to float as
// JAX's weak typing and torch's scalar operands round it
#define F(v) static_cast<float>(v)
__constant__ float c_A[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {F(1.0 / 5), 0, 0, 0, 0, 0},
    {F(3.0 / 40), F(9.0 / 40), 0, 0, 0, 0},
    {F(44.0 / 45), F(-56.0 / 15), F(32.0 / 9), 0, 0, 0},
    {F(19372.0 / 6561), F(-25360.0 / 2187), F(64448.0 / 6561), F(-212.0 / 729), 0, 0},
    {F(9017.0 / 3168), F(-355.0 / 33), F(46732.0 / 5247), F(49.0 / 176), F(-5103.0 / 18656), 0},
    {F(35.0 / 384), 0.0f, F(500.0 / 1113), F(125.0 / 192), F(-2187.0 / 6784), F(11.0 / 84)}};
__constant__ float c_B5[7] = {F(35.0 / 384), 0.0f, F(500.0 / 1113), F(125.0 / 192),
                              F(-2187.0 / 6784), F(11.0 / 84), 0.0f};
__constant__ float c_B4[7] = {F(5179.0 / 57600), 0.0f, F(7571.0 / 16695), F(393.0 / 640),
                              F(-92097.0 / 339200), F(187.0 / 2100), F(1.0 / 40)};
#undef F

// one knot's data, staged once per block
struct Knot {
  float Kt[NX * NU];  // K_k transposed: Kt[j][i] = K_k[i][j]
  float kff[NU];
  float xb[NX];
  float ub[NU];
  float xn[NX];
  float fl[NC];
  float fpr[NC * 3];
  float fvr[NC * 3];
};

// one rollout's (warp's) working set; per-component rows have a slot per lane
struct Warp {
  FlowKin k;            // the flow's kinematics
  float T[NJ][9];       // the joints' local transforms
  float x[LANES];       // the state a flow reads
  float u[LANES];       // the knot's input
  float d[LANES];       // x - x_bar, then x - x_nom
  float du[LANES];      // u - u_nom
  float sq[LANES];      // ODE45's squared scaled errors
  float ks[7][LANES];   // the stage flows
  float vc[NC][3];      // the contact velocities
};

struct Block {
  float K[N_CONSTS];
  float P[N_PARAMS];
  float Q[NX * NX];
  float R[NU * NU];
  float axis[NJ][3];    // the joints' axes in their parents' frames
  Knot kn[2];
  Warp w[MAX_WARPS];
};

// jnp.maximum / jnp.minimum / jnp.clip: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float clip_nan(float a, float lo, float hi) {
  return min_nan(max_nan(a, lo), hi);
}

// a sum over the lanes of each half warp, and over the warp (every lane of
// the half or the warp gets the same bits)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = x + __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, int tid, int nt) {
  for (int e = tid; e < n; e += nt) cp_async4(dst + e, src + e);
}

// knot k of scenario b into d, by the block's threads (one commit group)
__device__ void stage_knot(Knot& d, const float* gKfb, const float* gkff, const float* gxb,
                           const float* gub, const float* gxn, const float* gfl,
                           const float* gfpr, const float* gfvr, long long b, int k, int n_knots,
                           int tid, int nt) {
  const long long kb = b * n_knots + k;        // the knot in (B, N) arrays
  const long long r1 = b * (n_knots + 1) + k;  // and in (B, N+1) arrays
  if (gKfb != nullptr) {
    const float* Kk = gKfb + kb * NU * NX;
    for (int e = tid; e < NU * NX; e += nt) {
      const int i = e / NX, j = e - NX * (e / NX);
      cp_async4(&d.Kt[j * NU + i], Kk + e);
    }
    copy_async(d.kff, gkff + kb * NU, NU, tid, nt);
    copy_async(d.xb, gxb + r1 * NX, NX, tid, nt);
  }
  copy_async(d.ub, gub + kb * NU, NU, tid, nt);
  copy_async(d.xn, gxn + r1 * NX, NX, tid, nt);
  copy_async(d.fl, gfl + r1 * NC, NC, tid, nt);
  copy_async(d.fpr, gfpr + r1 * NC * 3, NC * 3, tid, nt);
  copy_async(d.fvr, gfvr + r1 * NC * 3, NC * 3, tid, nt);
  cp_commit();
}

// one of six values by a lane's index 0..5, without local memory
__device__ __forceinline__ float pick6(const float* v, int i) {
  float r = v[0];
#pragma unroll
  for (int e = 1; e < 6; ++e) r = i == e ? v[e] : r;
  return r;
}

// the legs' chains side by side, each on three lanes: lane 3 g + i holds
// row i of leg g's running rotation and component i of its position and
// base-fixed angular and origin velocities (soa_model.cuh::leg_chain_dev's
// products row by row, its cross products' other components by shuffles);
// every lane runs it, lanes 0-5 store each link's R, p, CoM, om and vo into
// w.  R0 and p0: the base's rotation and position on every lane.
__device__ __forceinline__ void chains_warp(const float* K, const float (*T)[9],
                                            const float (*axis)[3], const float* vj, int lane,
                                            const float* R0, const float* p0, FlowKin* w) {
  const int g = lane < 3 ? 0 : 1, i = lane < 6 ? lane - 3 * g : 2;
  const int base = 3 * g, i1 = base + (i + 1) % 3, i2 = base + (i + 2) % 3;
  const bool store = lane < 6;
  // row i of R0 and p0's component i, selected without local memory
  float r0 = i == 0 ? R0[0] : (i == 1 ? R0[3] : R0[6]);
  float r1 = i == 0 ? R0[1] : (i == 1 ? R0[4] : R0[7]);
  float r2 = i == 0 ? R0[2] : (i == 1 ? R0[5] : R0[8]);
  float p = i == 0 ? p0[0] : (i == 1 ? p0[1] : p0[2]), om = 0.0f, vo = 0.0f;
#pragma unroll
  for (int n = 0; n < LEG_JOINTS; ++n) {
    const int j = LEG_JOINTS * g + n, ch = j + 1;
    const float* o = K + K_OPOS + 3 * j;
    const float* a = axis[j];
    const float* Tj = T[j];
    const float t = r0 * o[0] + r1 * o[1] + r2 * o[2];
    const float aw = r0 * a[0] + r1 * a[1] + r2 * a[2];
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
      w->com[ch][i] = p + tc;
      w->om[ch][i] = om;
      w->vo[ch][i] = vo;
    }
  }
}

// soa.py::flow at (w.x, w.u) on one warp: lane i (< NX) returns component
// i.  ROWS (the row pass) also leaves the contact points in w.k.pc and the
// contact velocities in w.vc.  Starts and ends with a warp barrier, so the
// caller may write w.x before and after.
template <bool ROWS>
__device__ float warp_flow(const Block& s, Warp& w, int lane, Clock& ck) {
  const float* K = s.K;
  const float* x = w.x;
  const float* u = w.u;
  const float inv_m = K[K_INVM];
  __syncwarp();
  // the angles' sines and cosines: lanes 0-9 the joints', 10-12 the base's
  // z, y, x; the base's rotation on every lane
  const float ang = lane < NJ ? x[12 + lane] : (lane < NJ + 3 ? x[9 + lane - NJ] : 0.0f);
  float sa, ca;
  sincosf(ang, &sa, &ca);
  const float cz = __shfl_sync(FULL, ca, NJ), sz = __shfl_sync(FULL, sa, NJ);
  const float cy = __shfl_sync(FULL, ca, NJ + 1), sy = __shfl_sync(FULL, sa, NJ + 1);
  const float cx = __shfl_sync(FULL, ca, NJ + 2), sx = __shfl_sync(FULL, sa, NJ + 2);
  const float R0[9] = {cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                       sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                       -sy,     cy * sx,                cy * cx};
  const float p0[3] = {x[6], x[7], x[8]};
  // the joints' local transforms (lanes 0-9); the base link (lane 10)
  if (lane < NJ) {
    const float c1 = 1.0f - ca;
    float rod[9];
#pragma unroll
    for (int e = 0; e < 9; ++e)
      rod[e] = ((e % 4 == 0) ? 1.0f : 0.0f) + sa * K[K_RK + 9 * lane + e]
               + c1 * K[K_RKK + 9 * lane + e];
    mm3(K + K_OROT + 9 * lane, rod, w.T[lane]);
  } else if (lane == NJ) {
    float t[3];
    mv3(R0, K + K_COML, t);
    for (int e = 0; e < 9; ++e) w.k.R[0][e] = R0[e];
    for (int i = 0; i < 3; ++i) {
      w.k.p[0][i] = p0[i];
      w.k.com[0][i] = p0[i] + t[i];
      w.k.om[0][i] = w.k.vo[0][i] = 0.0f;
    }
  }
  __syncwarp();
  // the legs' chains side by side, with the base-fixed velocity pass
  chains_warp(K, w.T, s.axis, u + 3 * NC, lane, R0, p0, &w.k);
  __syncwarp();
  if constexpr (ROWS) ck.mark(PH_FK);
  // per link (lanes 0-10): its world inertia and m c; the contact points
  // (lanes 16-19)
  const int k = lane;
  const float mk = lane < L ? K[K_MASS + k] : 0.0f;
  float mc[3] = {0.0f, 0.0f, 0.0f}, Iw[9];
  if (lane < L) {
    link_inertia_world(K, w.k.R[k], k, Iw);
    for (int a = 0; a < 3; ++a) mc[a] = mk * w.k.com[k][a];
  } else if (lane >= 16 && lane < 16 + NC) {
    const int c = lane - 16, kk = c_cparent[c];
    float t[3];
    mv3(w.k.R[kk], K + K_CPOS + 3 * c, t);
    for (int a = 0; a < 3; ++a) w.k.pc[c][a] = w.k.p[kk][a] + t[a];
  }
  float pcom[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) pcom[a] = K[K_INVM] * half_sum(mc[a]);
  // per link: the base-fixed pass's momentum about the CoM, I, W
  float part[24];
#pragma unroll
  for (int e = 0; e < 24; ++e) part[e] = 0.0f;
  if (lane < L) {
    float r1[3], c[3], cdot[3], r[3], t[3], cr[3], d[3];
    for (int a = 0; a < 3; ++a) r1[a] = w.k.com[k][a] - w.k.p[k][a];
    cross3(w.k.om[k], r1, c);
    for (int a = 0; a < 3; ++a) {
      cdot[a] = w.k.vo[k][a] + c[a];
      r[a] = w.k.com[k][a] - pcom[a];
      d[a] = w.k.com[k][a] - p0[a];
    }
    mv3(Iw, w.k.om[k], t);
    cross3(r, cdot, cr);
    for (int a = 0; a < 3; ++a) {
      part[a] = mk * cdot[a];
      part[3 + a] = t[a] + mk * cr[a];
    }
    for (int e = 0; e < 9; ++e) {
      part[6 + e] = Iw[e];
      part[15 + e] = mk * (d[e / 3] * r[e % 3]);
    }
  }
#pragma unroll
  for (int e = 0; e < 24; ++e) part[e] = half_sum(part[e]);
  // the base block and the base velocity: Ab vb = m h - (momentum of the
  // joints), on every lane of the lower half
  const float m = K[K_M];
  float G[9], E[9], GE[9], iGE[9], A12[9], sk[9], sE[9], sv[3], ra[3], x2[3], t[3], vb[6];
  const float trW = part[15] + part[19] + part[23];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      G[3 * i + j] = (part[6 + 3 * i + j] + (i == j ? trW : 0.0f)) - part[15 + 3 * i + j];
  const float trig[4] = {cz, sz, cy, sy};
  euler_E(trig, E);
  mm3(G, E, GE);
  for (int i = 0; i < 3; ++i) sv[i] = pcom[i] - p0[i];
  sk[0] = 0.0f;   sk[1] = -sv[2]; sk[2] = sv[1];
  sk[3] = sv[2];  sk[4] = 0.0f;   sk[5] = -sv[0];
  sk[6] = -sv[1]; sk[7] = sv[0];  sk[8] = 0.0f;
  mm3(sk, E, sE);
  for (int e = 0; e < 9; ++e) A12[e] = -m * sE[e];
  inv3(GE, iGE);
  for (int i = 0; i < 3; ++i) ra[i] = m * x[3 + i] - part[3 + i];
  mv3(iGE, ra, x2);
  mv3(A12, x2, t);
  for (int i = 0; i < 3; ++i) {
    vb[i] = inv_m * ((m * x[i] - part[i]) - t[i]);
    vb[3 + i] = x2[i];
  }
  if constexpr (ROWS) ck.mark(PH_BASE);
  __syncwarp();  // the contact points
  // the contact forces' torques about the CoM (lanes 0-3, summed)
  float tq[3] = {0.0f, 0.0f, 0.0f};
  if (lane < NC) {
    float r[3];
    for (int a = 0; a < 3; ++a) r[a] = w.k.pc[lane][a] - pcom[a];
    cross3(r, u + 3 * lane, tq);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    tq[a] = tq[a] + __shfl_xor_sync(FULL, tq[a], 1);
    tq[a] = tq[a] + __shfl_xor_sync(FULL, tq[a], 2);
  }
  const float ha0 = __shfl_sync(FULL, tq[0], 0), ha1 = __shfl_sync(FULL, tq[1], 0),
              ha2 = __shfl_sync(FULL, tq[2], 0);
  // the flow's rows [hdot_lin; hdot_ang; vb; vj], component `lane`
  float out = 0.0f;
  if (lane < 3) {
    out = inv_m * (((u[lane] + u[3 + lane]) + u[6 + lane]) + u[9 + lane]);
    if (lane == 2) out = out + (-GRAVITY);
  } else if (lane < 6) {
    out = inv_m * (lane == 3 ? ha0 : (lane == 4 ? ha1 : ha2));
  } else if (lane < 12) {
    out = pick6(vb, lane - 6);
  } else if (lane < NX) {
    out = u[lane];
  }
  if constexpr (ROWS) {
    // the contact links' full velocities and the contact velocities (lanes 0-3)
    if (lane < NC) {
      const int kk = c_cparent[lane];
      float w0[3], om[3], dp[3], c[3], vo[3], d[3], cv[3];
      mv3(E, vb + 3, w0);
      for (int a = 0; a < 3; ++a) {
        om[a] = w0[a] + w.k.om[kk][a];
        dp[a] = w.k.p[kk][a] - p0[a];
      }
      cross3(w0, dp, c);
      for (int a = 0; a < 3; ++a) {
        vo[a] = (vb[a] + c[a]) + w.k.vo[kk][a];
        d[a] = w.k.pc[lane][a] - w.k.p[kk][a];
      }
      cross3(om, d, cv);
      for (int a = 0; a < 3; ++a) w.vc[lane][a] = vo[a] + cv[a];
    }
    ck.mark(PH_VEL);
  }
  __syncwarp();
  return out;
}

// the soft row r's value h (soa.py::combined_rows' order: cone, xy, qj, vj, fz)
__device__ __forceinline__ float soft_value(const Block& s, const Warp& w, const Knot& kn,
                                            int r) {
  const float* u = w.u;
  if (r < NC) {
    const float f0 = u[3 * r], f1 = u[3 * r + 1];
    return s.P[P_MU_C] * u[3 * r + 2] - sqrtf(f0 * f0 + f1 * f1 + s.P[P_CONE_REG]);
  }
  if (r < 4 + 2 * NC) {
    const int c = (r - 4) / 2, a = (r - 4) % 2;
    return (w.vc[c][a] - kn.fvr[3 * c + a]) + s.P[P_XY_GAIN] * (w.k.pc[c][a] - kn.fpr[3 * c + a]);
  }
  if (r < 4 + 2 * NC + NJ) return w.x[12 + r - 4 - 2 * NC];
  if (r < 4 + 2 * NC + 2 * NJ) return u[3 * NC + r - 4 - 2 * NC - NJ];
  return u[3 * (r - 4 - 2 * NC - 2 * NJ) + 2];
}

// penalties.py::relaxed_barrier's value, one logf on either branch
__device__ __forceinline__ float relaxed_value(float h, float mu, float delta) {
  const float lg = logf(h > delta ? h : delta);
  const float z = (h - 2.0f * delta) / delta;
  return h > delta ? -mu * lg : mu * 0.5f * (z * z - 1.0f) - mu * lg;
}

// soa_rows.cuh::soft_penalty's mask and value of soft row r, on one code
// path for every row (the row's parameters selected, both barriers formed)
__device__ __forceinline__ float soft_mask_penalty(const float* P, const float* fl, int r,
                                                   float h, float* mask) {
  const int jr = r < 4 + 2 * NC + NJ ? r - 4 - 2 * NC : r - 4 - 2 * NC - NJ;
  const int j = jr < 0 ? 0 : jr;
  float lo, hi, mu, delta;
  if (r < NC) {
    lo = 0.0f, hi = 0.0f, mu = P[P_CONE_MU], delta = P[P_CONE_DELTA];
  } else if (r < 4 + 2 * NC + NJ) {
    lo = P[P_LOWER + j], hi = P[P_UPPER + j], mu = P[P_POS_MU], delta = P[P_POS_DELTA];
  } else if (r < 4 + 2 * NC + 2 * NJ) {
    lo = -P[P_VLIM + j], hi = P[P_VLIM + j], mu = P[P_VEL_MU], delta = P[P_VEL_DELTA];
  } else {
    lo = 0.0f, hi = P[P_FZ_MAX], mu = P[P_F_MU], delta = P[P_F_DELTA];
  }
  const float p1 = relaxed_value(r < NC ? h : h - lo, mu, delta);
  const float p2 = relaxed_value(hi - h, mu, delta);
  const float wgt = P[P_SWING_W];
  if (r < NC) {
    *mask = fl[r];
    return p1;
  }
  if (r < 4 + 2 * NC) {
    *mask = 1.0f - fl[(r - 4) / 2];
    return 0.5f * wgt * h * h;
  }
  *mask = 1.0f;
  return p1 + p2;
}

// the row pass's terms: |g mask|_1 over the 16 equality rows (lanes 0-15)
// and sum mask p over the 36 soft rows (lane r and r + 32), warp sums
__device__ void row_terms(const Block& s, const Warp& w, const Knot& kn, int lane, float* eq,
                          float* cp) {
  float e = 0.0f;
  if (lane < NEQ) {
    const int c = lane / 4, a = lane % 4;
    const bool stance = kn.fl[c] > 0.5f;
    float g, mask = 1.0f;
    if (a < 3) {
      const float zv = a < 2 ? w.vc[c][a]
                             : w.vc[c][2] + s.P[P_XY_GAIN] * (w.k.pc[c][2] - s.P[P_Z_REF]);
      g = stance ? zv : w.u[3 * c + a];
    } else {
      const float nv = (w.vc[c][2] - kn.fvr[3 * c + 2])
                       + s.P[P_POS_GAIN] * (w.k.pc[c][2] - kn.fpr[3 * c + 2]);
      g = stance ? 0.0f : nv;
      mask = stance ? 0.0f : 1.0f;
    }
    e = fabsf(g * mask);
  }
  *eq = warp_sum(e);
  // soft row `lane` and, on lanes 0-3, row lane + 32, both on one pass
  const int r2 = lane + LANES < NS ? lane + LANES : lane;
  float mk1, mk2;
  const float p1 = soft_mask_penalty(s.P, kn.fl, lane, soft_value(s, w, kn, lane), &mk1);
  const float p2 = soft_mask_penalty(s.P, kn.fl, r2, soft_value(s, w, kn, r2), &mk2);
  *cp = warp_sum(lane + LANES < NS ? mk1 * p1 + mk2 * p2 : mk1 * p1);
}

// RK4 from the state xr (lane's component) over h, with k1 = f(xr) given:
// xr + h/6 (((k1 + 2 k2) + 2 k3) + k4), per component in rollout.py's order
__device__ float rk4_warp(const Block& s, Warp& w, int lane, float xr, float h, float k1,
                          Clock& ck) {
  const float hh = __fmul_rn(0.5f, h);
  w.x[lane] = __fadd_rn(xr, __fmul_rn(hh, k1));
  ck.mark(PH_INTEG);
  const float k2 = warp_flow<false>(s, w, lane, ck);
  ck.mark(PH_FLOWS);
  w.x[lane] = __fadd_rn(xr, __fmul_rn(hh, k2));
  ck.mark(PH_INTEG);
  const float k3 = warp_flow<false>(s, w, lane, ck);
  ck.mark(PH_FLOWS);
  w.x[lane] = __fadd_rn(xr, __fmul_rn(h, k3));
  ck.mark(PH_INTEG);
  const float k4 = warp_flow<false>(s, w, lane, ck);
  ck.mark(PH_FLOWS);
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(k1, __fmul_rn(2.0f, k2)), __fmul_rn(2.0f, k3)),
                              k4);
  const float out = __fadd_rn(xr, __fmul_rn(__fdiv_rn(h, 6.0f), sum));
  ck.mark(PH_INTEG);
  return out;
}

// ODE45 over [0, dt] from xr (lane's component; k0 = f(xr)); returns the
// new state's component, the accepted slots in *accepted.  The stage flows
// sit in w.ks (each lane its component); every decision is warp-uniform.
__device__ float ode45_warp(const Block& s, Warp& w, int lane, float xr, float k0, float dt,
                            float abs_tol, float rel_tol, float time_step, float h_min,
                            int max_substeps, int* accepted, Clock& ck) {
  const float h_floor = __fmul_rn(h_min, 1.000001f);
  float t = 0.0f, h = min_nan(time_step, dt), xk = xr;
  int acc = 0;
  w.ks[0][lane] = k0;
  for (int slot = 0; slot < max_substeps; ++slot) {
    const float remaining = __fsub_rn(dt, t);
    if (!(remaining > 1e-12f)) break;  // inactive from here on: nothing changes
    const float hs = clip_nan(h, h_min, max_nan(remaining, h_min));
#pragma unroll 1
    for (int st = 1; st < 7; ++st) {
      // stage st at xk + sum_j (hs a_sj) k_j, added in j's order
      float v = xk;
      for (int j = 0; j < st; ++j)
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(hs, c_A[st][j]), w.ks[j][lane]));
      w.x[lane] = v;
      ck.mark(PH_INTEG);
      w.ks[st][lane] = warp_flow<false>(s, w, lane, ck);
      ck.mark(PH_FLOWS);
    }
    float s5 = __fmul_rn(c_B5[0], w.ks[0][lane]), s4 = __fmul_rn(c_B4[0], w.ks[0][lane]);
#pragma unroll
    for (int j = 1; j < 7; ++j) {
      s5 = __fadd_rn(s5, __fmul_rn(c_B5[j], w.ks[j][lane]));
      s4 = __fadd_rn(s4, __fmul_rn(c_B4[j], w.ks[j][lane]));
    }
    const float x5 = __fadd_rn(xk, __fmul_rn(hs, s5));
    const float x4 = __fadd_rn(xk, __fmul_rn(hs, s4));
    const float scale = __fadd_rn(abs_tol, __fmul_rn(rel_tol, max_nan(fabsf(xk), fabsf(x5))));
    const float q = __fdiv_rn(__fsub_rn(x5, x4), scale);
    w.sq[lane] = __fmul_rn(q, q);
    __syncwarp();
    // the 22 squares summed in component order, on every lane
    float sq = 0.0f;
    for (int i = 0; i < NX; ++i) sq = __fadd_rn(sq, w.sq[i]);
    const float err = __fsqrt_rn(__fdiv_rn(sq, static_cast<float>(NX)));
    if (err <= 1.0f || hs <= h_floor) {
      t = __fadd_rn(t, hs);
      xk = x5;
      w.x[lane] = xk;
      ck.mark(PH_INTEG);
      w.ks[0][lane] = warp_flow<false>(s, w, lane, ck);  // the next slot's first stage
      ck.mark(PH_FLOWS);
      ++acc;
    }
    const float factor = clip_nan(__fmul_rn(0.9f, powf(err, -0.2f)), 0.2f, 5.0f);
    h = clip_nan(__fmul_rn(hs, factor), h_min, dt);
  }
  *accepted = acc;
  // one RK4 step over what the slots left (w.ks[0] = f(xk))
  const float residual = max_nan(__fsub_rn(dt, t), 0.0f);
  const float k_first = w.ks[0][lane];
  const bool finite = __all_sync(FULL, lane >= NX || isfinite(k_first));
  if (residual == 0.0f && finite) return xk;
  return rk4_warp(s, w, lane, xk, residual, k_first, ck);
}

__global__ void __launch_bounds__(LANES * (MAX_WARPS + 1), 1)
ddp_rollout_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                   const float* __restrict__ gQ, const float* __restrict__ gR,
                   const float* __restrict__ gx0, const float* __restrict__ gxb,
                   const float* __restrict__ gub, const float* __restrict__ gKfb,
                   const float* __restrict__ gkff, const float* __restrict__ galpha,
                   const float* __restrict__ gxn, const float* __restrict__ gfl,
                   const float* __restrict__ gfpr, const float* __restrict__ gfvr,
                   float* __restrict__ oxs, float* __restrict__ ous, float* __restrict__ ocost,
                   float* __restrict__ oeq, int* __restrict__ oslots, int n_alpha, int n_knots,
                   int integrator, int max_substeps, float dt, float abs_tol, float rel_tol,
                   float h_min) {
  __shared__ Block s;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / LANES, lane = tid % LANES;
  const long long b = blockIdx.x;
  // the rollouts' warps, then one that stages the knots' data
  const int warps = nt / LANES - 1;
  const bool producer = warp == warps;
  const int a = blockIdx.y * warps + warp;  // the step size
  const bool active = !producer && a < n_alpha;
  const bool closed = gKfb != nullptr;
  Clock ck;
  ck.start(b == 0 && blockIdx.y == 0 && tid == 0);

  for (int i = tid; i < N_CONSTS; i += nt) s.K[i] = gK[i];
  for (int i = tid; i < N_PARAMS; i += nt) s.P[i] = gP[i];
  for (int i = tid; i < NX * NX; i += nt) s.Q[i] = gQ[i];
  for (int i = tid; i < NU * NU; i += nt) s.R[i] = gR[i];
  if (producer)
    stage_knot(s.kn[0], gKfb, gkff, gxb, gub, gxn, gfl, gfpr, gfvr, b, 0, n_knots, lane, LANES);
  __syncthreads();
  if (tid < NJ) mv3(s.K + K_OROT + 9 * tid, s.K + K_AXIS + 3 * tid, s.axis[tid]);

  Warp& w = s.w[producer ? 0 : warp];
  const long long r = b * n_alpha + a;
  const float alpha = active ? galpha[a] : 0.0f;
  float xr = active && lane < NX ? gx0[b * NX + lane] : 0.0f;
  float acc_cost = 0.0f, acc_eq = 0.0f;
  for (int k = 0; k < n_knots; ++k) {
    cp_wait_all();
    __syncthreads();  // knot k staged; every warp done with knot k - 1
    if (producer) {
      if (k + 1 < n_knots)
        stage_knot(s.kn[(k + 1) & 1], gKfb, gkff, gxb, gub, gxn, gfl, gfpr, gfvr, b, k + 1,
                   n_knots, lane, LANES);
      continue;
    }
    ck.mark(PH_LOADS);
    if (!active) continue;
    const Knot& kn = s.kn[k & 1];

    // u_k: lane i forms row i of the feedback
    float ur;
    if (closed) {
      w.d[lane] = xr - kn.xb[lane < NX ? lane : 0];
      __syncwarp();
      float acc = 0.0f;
      if (lane < NU)
        for (int j = 0; j < NX; ++j) acc += kn.Kt[j * NU + lane] * w.d[j];
      ur = lane < NU ? __fadd_rn(__fadd_rn(kn.ub[lane], __fmul_rn(alpha, kn.kff[lane])), acc)
                     : 0.0f;
    } else {
      ur = lane < NU ? kn.ub[lane] : 0.0f;
    }
    ck.mark(PH_FEEDBACK);
    if (lane < NX) {
      oxs[(r * (n_knots + 1) + k) * NX + lane] = xr;
      ous[(r * n_knots + k) * NU + lane] = ur;
    }
    w.x[lane] = xr;
    w.u[lane] = ur;
    ck.mark(PH_LOADS);

    // the row pass: the flow at (x, u), the contact kinematics, the rows
    const float k0 = warp_flow<true>(s, w, lane, ck);
    float eq, cp;
    row_terms(s, w, kn, lane, &eq, &cp);
    ck.mark(PH_ROWS);
    // the stage cost 0.5 dx'Q dx + 0.5 du'R du + sum mask p
    w.d[lane] = lane < NX ? xr - kn.xn[lane] : 0.0f;
    w.du[lane] = lane < NU ? ur - u_nom(s.K, kn.fl, lane) : 0.0f;
    __syncwarp();
    float tq = 0.0f, tr = 0.0f;
    if (lane < NX) {
      float sq = 0.0f, sr = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        sq += w.d[i] * s.Q[i * NX + lane];
        sr += w.du[i] * s.R[i * NU + lane];
      }
      tq = sq * w.d[lane];
      tr = sr * w.du[lane];
    }
    const float cost = (0.5f * warp_sum(tq) + 0.5f * warp_sum(tr)) + cp;
    acc_cost += cost * dt;
    acc_eq += eq;
    ck.mark(PH_COST);

    // the next state
    int slots = 0;
    if (integrator == RK2) {
      w.x[lane] = __fadd_rn(xr, __fmul_rn(dt, k0));
      ck.mark(PH_INTEG);
      const float k1 = warp_flow<false>(s, w, lane, ck);
      ck.mark(PH_FLOWS);
      const float hdt = 0.5f * dt;
      xr = __fadd_rn(xr, __fmul_rn(hdt, __fadd_rn(k0, k1)));
    } else if (integrator == RK4) {
      xr = rk4_warp(s, w, lane, xr, dt, k0, ck);
    } else {
      xr = ode45_warp(s, w, lane, xr, k0, dt, abs_tol, rel_tol, dt, h_min, max_substeps, &slots,
                      ck);
    }
    ck.mark(PH_INTEG);
    if (lane == 0) oslots[r * n_knots + k] = slots;
  }
  if (active) {
    if (lane < NX) oxs[(r * (n_knots + 1) + n_knots) * NX + lane] = xr;
    if (lane == 0) {
      ocost[r] = acc_cost;
      oeq[r] = acc_eq / static_cast<float>(n_knots);
    }
  }
  ck.mark(PH_LOADS);
  ck.flush();
}

}  // namespace

// K and kff may both be NULL: the open loop u_k = u_bar_k (alphas unused).
// The interval dt is also ODE45's first step (the DDP's time_step); slots
// gets ODE45's accepted slots per knot (0 for RK2 and RK4).
extern "C" int hk_ddp_rollout(const float* consts, const float* params, const float* Q,
                              const float* R, const float* x_init, const float* xs_bar,
                              const float* us_bar, const float* K, const float* kff,
                              const float* alphas, const float* x_nom, const float* flags,
                              const float* fpr, const float* fvr, float* xs, float* us,
                              float* cost, float* eq, int* slots, int batch, int n_alpha,
                              int n_knots, int integrator, int max_substeps, float dt,
                              float abs_tol, float rel_tol, float h_min, void* stream) {
  if (batch < 1 || n_alpha < 1 || n_knots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = n_alpha < MAX_WARPS ? n_alpha : MAX_WARPS;
  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>((n_alpha + warps - 1) / warps));
  ddp_rollout_kernel<<<grid, LANES * (warps + 1), 0, static_cast<cudaStream_t>(stream)>>>(
      consts, params, Q, R, x_init, xs_bar, us_bar, K, kff, alphas, x_nom, flags, fpr, fvr, xs,
      us, cost, eq, slots, n_alpha, n_knots, integrator, max_substeps, dt, abs_tol, rel_tol,
      h_min);
  return static_cast<int>(cudaGetLastError());
}

#ifdef DDP_ROLLOUT_PHASE_CLOCKS
// The phase sums since the last call (DDP_PHASES of them), then zeroed.
extern "C" int hk_ddp_rollout_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ddp_phase_cycles, sizeof(ddp_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[DDP_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ddp_phase_cycles, zero, sizeof(zero)));
}
#endif
