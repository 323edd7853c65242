// B1: the scalarized SoA linearization and line-search merit of the SQP.
//
// Replaces hunter_bipedal_control_tpu/models/soa.py::linearization_arrays
// (:866), combined_rows_arrays (:605) and flow_arrays (:623), as
// ocp/problem.py::knot_linearization_batch (:465) and stage_merit_batch
// (:439) consume them inside solver/sqp.py (dt scaling, equality masking,
// the merit's defect and residual norms).  Two entry points, one launch
// each, whose knots' primal work runs on a warp's lanes (soa_warp.cuh, the
// flow and row terms B15 shares):
//
//   hk_soa_linearize: one block per (scenario, knot), five warps.  Warp 0
//     runs the primal chain on its lanes (soa_warp.cuh::warp_flow's row
//     pass, keeping the base block, the world inertias and the flow; then
//     every link's full velocity, the joints' world axes and anchors, the
//     16 equality rows and the xy soft rows' penalties) into shared memory,
//     while warps 1-3 form dx, du, Q' dx, R' du, the other 28 soft rows'
//     penalties and every entry of the Jacobians that depends on neither.
//     Then warp 4 runs the RK2 midpoint flow on its lanes and stores the
//     next state, while warps 0-3 (a named barrier of their own) form each
//     link's terms of the subtree sums, the sums over each joint's subtree,
//     the closed-form CMM columns per joint and euler angle, the 64 contact
//     Jacobian columns and their time derivatives, Vh, Vv, dvb, Jcom and
//     the products H, W, dvc, dhdot, each written straight into Jx_f,
//     flow_u, C, D, Jsoft_x and soft_u, all over shared memory; then warps
//     0-3 run the dense tail (A, B, the GGN quadratics) in 2x2 register
//     tiles and store C and D while warp 4 stores the rows, qx, qu and the
//     cost.
//   hk_soa_merit: a warp per (scenario, candidate, knot), MERIT_WARPS (2)
//     knots a block: the rows at x and the flow (warp_flow's row pass and
//     row_terms), the stage cost's quadratic forms by shuffles, |g mask|_1,
//     the flow at x + dt flow, the defect to the next knot; each knot's
//     three sums go to a scratch buffer, and the last block of each
//     (scenario, candidate) to finish (a __threadfence and an integer
//     ticket) adds them up in knot order and resets its ticket, in the same
//     launch: no float atomics, the same bits on every launch.
//
// Bound on the card: per knot the linearization reads 94 floats and writes
// 3,207 (13.2 KB; ~112 MB at B=128, N=66, ~33 us at 3.35 TB/s): bytes bound
// (chip_smoke.py::soa_lin_cost); it keeps every ingredient in shared memory
// and writes each output once.  One knot's primal chain is a latency-bound
// chain of dependent operations: on a warp's lanes it takes a few thousand
// cycles where one thread took tens of thousands.  The merit reads ~1 KB a
// knot and is latency bound at B=1 (106 knots, fewer than the card's 132
// SMs, all at once).
//
// Model constants come from the port's build_consts (ocp/soa_kernel.py) as
// a device buffer; the tree's topology (nj=10, L=11, nc=4) is compiled in
// (soa_model.cuh, shared with B8a's leg_ik.cu and B9's wbc_qp.cu),
// and hk_soa_topology hands it to the wrapper, which refuses a model whose
// topology differs.  True float32: no fast math; a singular 3x3 GE gives
// inf/NaN as soa.py::inv3 does, and a NaN knot makes only its own
// (scenario, candidate) merit NaN.  The chain's products are regrouped and
// its sums are shuffle trees (soa_warp.cuh), so the outputs differ from the
// plain version's by float32 rounding.
#include <cuda_runtime.h>

#include "soa_warp.cuh"

namespace {

// Measurement build only (profile_step soa_phases): clock64 cycles by phase
// of the linearization's block 0 (warp 0's lane 0; the midpoint flow on
// warp 4's lane 0, beside the later phases) and of the merit's scenario 0,
// candidate 0 (lane 0 of its first knot's warp; the reduction on the thread
// that runs it).
constexpr int LIN_PHASES = 10;   // load, chain, midpoint_flow, per_link, columns, h_w_dvc,
                                 // assembly, penalties, dense_tail, store_cost
constexpr int MERIT_PHASES = 6;  // load, rows, stage_cost, midpoint_flow, defect, reduction
#ifdef SOA_PHASE_CLOCKS
__device__ unsigned long long lin_phase_cycles[LIN_PHASES];
__device__ unsigned long long merit_phase_cycles[MERIT_PHASES];
template <int NP>
struct Clock {
  long long t;
  unsigned long long acc[NP];
  bool on;
  __device__ void start(bool o) {
    on = o;
    for (int i = 0; i < NP; ++i) acc[i] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    if (on) {
      const long long now = clock64();
      acc[p] += now - t;
      t = now;
    }
  }
  __device__ __forceinline__ void flow(int) {}
  __device__ __forceinline__ void restart() { t = clock64(); }
  __device__ void flush(unsigned long long* out) {
    if (on)
      for (int i = 0; i < NP; ++i) atomicAdd(out + i, acc[i]);
  }
};
#define SOA_CLOCK_OUT(name) name
#else
template <int NP>
struct Clock {
  __device__ void start(bool) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flow(int) {}
  __device__ __forceinline__ void restart() {}
  __device__ void flush(unsigned long long*) {}
};
#define SOA_CLOCK_OUT(name) nullptr
#endif
enum { LP_LOAD, LP_CHAIN, LP_MID, LP_LINK, LP_COLUMNS, LP_HWD, LP_ASSEMBLY, LP_PENALTIES,
       LP_TAIL, LP_STORE };
enum { MP_LOAD, MP_ROWS, MP_COST, MP_MID, MP_DEFECT, MP_REDUCE };

// ---------------------------------------------------------------------------
// the closed-form CMM columns (soa.py::_ang_col and the joint / euler loops
// of linearization_ingredients)
// ---------------------------------------------------------------------------

// W = Q - S pcom^T - o (S - M pcom)^T
__device__ void w_moment(const float* Q, const float* S, float M, const float* o,
                         const float* pcom, float* W) {
  float rs[3];
  for (int i = 0; i < 3; ++i) rs[i] = S[i] - M * pcom[i];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) W[3 * i + j] = (Q[3 * i + j] - S[i] * pcom[j]) - o[i] * rs[j];
}

__device__ void ang_col(const float* Isub, const float* Hsub, const float* W, const float* Y,
                        const float* sd, const float* S, float Mj, const float* pcom,
                        const float* vcom_m, float inv_m, const float* a, const float* adot,
                        const float* o, const float* odot, const float* om_lo, float* prim,
                        float* dual) {
  const float trW = tr3(W);
  float Ia[3], Wa[3];
  mv3(Isub, a, Ia);
  mv3(W, a, Wa);
  for (int i = 0; i < 3; ++i) prim[i] = (Ia[i] + trW * a[i]) + (-Wa[i]);
  float G[9], V[9], rsum[3], so[3], kx[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) G[3 * i + j] = Y[3 * i + j] - o[i] * sd[j];
  for (int i = 0; i < 3; ++i) rsum[i] = S[i] - Mj * pcom[i];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      V[3 * i + j] = (Y[3 * j + i] - sd[i] * pcom[j]) - odot[i] * rsum[j];
  for (int i = 0; i < 3; ++i) so[i] = S[i] - Mj * o[i];
  cross3(a, so, kx);
  float t1[3], aom[3], t2[3], Ga[3], t4[3], Wad[3], Va[3];
  cross3(a, Hsub, t1);
  cross3(a, om_lo, aom);
  mv3(Isub, aom, t2);
  mv3(G, a, Ga);
  cross3(kx, vcom_m, t4);
  mv3(W, adot, Wad);
  mv3(V, a, Va);
  const float trG = tr3(G), trV = tr3(V);
  for (int i = 0; i < 3; ++i)
    dual[i] = ((((t1[i] + (-t2[i])) + (Ga[i] - trG * a[i])) + (-inv_m) * t4[i])
               + (trW * adot[i] - Wad[i])) + (trV * a[i] - Va[i]);
}

// -Ab^-1 [lin; ang] as 6 values (soa.py::linearization_arrays::_ab_solve_neg)
__device__ void ab_solve_neg(const Rows* w, float inv_m, const float* lin, const float* ang,
                             float* out) {
  float t[3], At[3];
  mv3(w->iGE, ang, t);
  mv3(w->A12, t, At);
  for (int i = 0; i < 3; ++i) {
    out[i] = (-inv_m) * (lin[i] - At[i]);
    out[3 + i] = -t[i];
  }
}

// warps 0-3 of the linearization's block: the chain's warp and the columns
constexpr int COL_THREADS = 4 * LANES;
constexpr int MID_WARP = 4;                        // the midpoint flow's warp
constexpr int LIN_THREADS = COL_THREADS + LANES;

// per link, its terms of the subtree sums: m c, m c_dot, h (= I w), m c c',
// m c c_dot', the world inertia I
constexpr int LV = 36;

// a barrier of warps 0-3 alone (warp 4 runs the midpoint flow meanwhile)
__device__ __forceinline__ void sync_columns() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(COL_THREADS) : "memory");
}
// warps 0-3 signal that C, D and the soft rows' Jacobians are complete,
// warp 4 waits for it
__device__ __forceinline__ void columns_done() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(LIN_THREADS) : "memory");
}
__device__ __forceinline__ void wait_columns() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(LIN_THREADS) : "memory");
}

// what the chain keeps of its flow for the columns: the base's trig cache,
// the CoM, the base block's inverse and A12, the base velocity, the links'
// world inertias
struct KeepChain {
  Rows* w;
  __device__ __forceinline__ void base(int lane, const float* trig, const float* pcom,
                                       const float* iGE, const float* A12,
                                       const float* vb) const {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w->trig[i] = trig[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) w->pcom[i] = pcom[i];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        w->iGE[e] = iGE[e];
        w->A12[e] = A12[e];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) w->vb[i] = vb[i];
    }
  }
  __device__ __forceinline__ void inertia(int lane, const float* Iw) const {
#pragma unroll
    for (int e = 0; e < 9; ++e) w->Iw[lane][e] = Iw[e];
  }
};

// a flow's own warp state: its kinematics, joint transforms, state, contact
// velocities
struct FlowWarp {
  FlowKin k;
  float T[NJ][9];
  float x[LANES];
  float vc[NC][3];
};

// soa.py::combined_rows at one knot on warp 0's lanes, into w: the flow's
// row pass (its kinematics, contact points and velocities, the base block),
// then every link's full velocity (om = w0 + om_j, vo = v0 + w0 x (p - p0)
// + vo_j, as the row pass forms the contact links'), the joints' world axes
// and anchors, the equality rows and their masks, the soft rows
template <class Marks>
__device__ __forceinline__ void chain_warp(const float* K, const float* P, const float (*axis)[3],
                                           const float* x, const float* u, const float* fl,
                                           const float* fpr, const float* fvr, float (*T)[9],
                                           Rows& w, int lane, Marks& ck) {
  const float f = warp_flow<true>(K, axis, x, u, T, w, w.vc, lane, ck, KeepChain{&w});
  if (lane < NX) w.flow[lane] = f;
  if (lane < L) {
    float E[9], w0[3], dp[3], c[3];
    euler_E(w.trig, E);
    mv3(E, w.vb + 3, w0);
    for (int a = 0; a < 3; ++a) dp[a] = w.p[lane][a] - x[6 + a];
    cross3(w0, dp, c);
    for (int a = 0; a < 3; ++a) {
      w.om[lane][a] = w0[a] + w.om[lane][a];
      w.vo[lane][a] = (w.vb[a] + c[a]) + w.vo[lane][a];
    }
  }
  if (lane < 3 * NJ) {
    const int j = lane / 3, i = lane - 3 * j;
    const float* Rp = w.R[c_parent[j]] + 3 * i;
    w.aw[j][i] = Rp[0] * axis[j][0] + Rp[1] * axis[j][1] + Rp[2] * axis[j][2];
    w.anchor[j][i] = w.p[c_child[j]][i];
  }
  if (lane < NEQ) w.g[lane] = eq_row(P, fl, fpr, fvr, u, w.pc, w.vc, lane, &w.mask[lane]);
  __syncwarp();
}

// soft row r's penalty terms: mask dp, mask d2p, mask p
__device__ __forceinline__ void penalty_terms(const float* P, const float* fl, int r, float h,
                                              float* w1, float* w2, float* pm) {
  float mk, p, dp, d2p;
  soft_penalty(P, fl, r, h, &mk, &p, &dp, &d2p);
  w1[r] = mk * dp;
  w2[r] = mk * d2p;
  pm[r] = mk * p;
}

// the entries of Jx_f, flow_u, D, Jsoft_x and soft_u that do not depend on
// the chain or the columns (zeros, identities, 1 / m, the cone rows' input
// Jacobian from u, D's force columns from the flags), written by warps 1-2
// (t = 0..63) during the chain; the column phases write the others
__device__ __forceinline__ void constant_entries(const float* P, const float* u, const float* fl,
                                                 float inv_m, int t, float (*Jx)[NX],
                                                 float (*Ju)[NU], float (*Sx)[NX],
                                                 float (*Su)[NU], float (*Dm)[NU]) {
  constexpr int NT = 2 * LANES;
  // D's force columns: a swing foot's own force, nothing else
  for (int e = t; e < NEQ * 3 * NC; e += NT) {
    const int r = e / (3 * NC), c = e % (3 * NC), f = r / 4, a = r % 4;
    Dm[r][c] = (a < 3 && !(fl[f] > 0.5f) && c == 3 * f + a) ? 1.0f : 0.0f;
  }
  for (int e = t; e < NX * NX; e += NT) {
    const int r = e / NX, c = e % NX;
    if (r < 3 || r >= 12) {
      Jx[r][c] = 0.0f;
      Ju[r][c] = r < 3 ? ((c < 3 * NC && c % 3 == r) ? inv_m : 0.0f)
                       : ((c >= 3 * NC && c - 3 * NC == r - 12) ? 1.0f : 0.0f);
    } else if (r < 6) {
      if (c < 6) Jx[r][c] = 0.0f;
      if (c >= 3 * NC) Ju[r][c] = 0.0f;
    } else if (c < 3 * NC) {
      Ju[r][c] = 0.0f;
    }
  }
  for (int e = t; e < NS * NX; e += NT) {
    const int r = e / NX, c = e % NX;
    if (r >= 4 && r < 4 + 2 * NC) {
      if (c < 3 * NC) Su[r][c] = 0.0f;
      continue;
    }
    float sx = 0.0f, su = 0.0f;
    if (r < 4) {
      if (c < 3 * NC && c / 3 == r) {
        const float f0 = u[3 * r], f1 = u[3 * r + 1];
        const float s = sqrtf(f0 * f0 + f1 * f1 + P[P_CONE_REG]);
        const int kk = c % 3;
        su = (kk == 0) ? -f0 / s : (kk == 1) ? -f1 / s : P[P_MU_C];
      }
    } else if (r < 4 + 2 * NC + NJ) {
      sx = (c == 12 + (r - 4 - 2 * NC)) ? 1.0f : 0.0f;
    } else if (r < 4 + 2 * NC + 2 * NJ) {
      su = (c == 3 * NC + (r - 4 - 2 * NC - NJ)) ? 1.0f : 0.0f;
    } else {
      su = (c == 3 * (r - 4 - 2 * NC - 2 * NJ) + 2) ? 1.0f : 0.0f;
    }
    Sx[r][c] = sx;
    Su[r][c] = su;
  }
}

// three blocks an SM at least: at most 136 registers
__global__ void __launch_bounds__(LIN_THREADS, 3)
soa_linearize_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                     const float* __restrict__ gQ, const float* __restrict__ gR,
                     const float* __restrict__ gxs, const float* __restrict__ gus,
                     const float* __restrict__ gxn, const float* __restrict__ gfl,
                     const float* __restrict__ gfpr, const float* __restrict__ gfvr,
                     float* __restrict__ oxnext, float* __restrict__ oA, float* __restrict__ oB,
                     float* __restrict__ ocost, float* __restrict__ oqx, float* __restrict__ oqu,
                     float* __restrict__ oQxx, float* __restrict__ oQuu,
                     float* __restrict__ oQux, float* __restrict__ og, float* __restrict__ oC,
                     float* __restrict__ oD, float* __restrict__ omask, int n_knots, float dt) {
  __shared__ Rows wk;
  __shared__ FlowWarp wm;
  __shared__ float Tc[NJ][9];
  __shared__ float K[N_CONSTS], P[N_PARAMS], axis[NJ][3];
  __shared__ float x[NX], u[NU], xn[NX], fl[NC], fpr[NC * 3], fvr[NC * 3];
  __shared__ float lk[L][LV], sub[NJ + 1][LV];
  const float* vcom_m = sub[NJ] + 3;
  const float* Htot = sub[NJ] + 6;
  const float* Qall = sub[NJ] + 9;
  const float* Yall = sub[NJ] + 18;
  const float* Itot = sub[NJ] + 27;
  __shared__ float Ajl[NJ][3], Aja[NJ][3], dAl[NQ][3], dAa[NQ][3];
  __shared__ float Jc[NC][3][NQ], Jcd[NC][3][NQ];
  __shared__ float Vh[6][6], Vv[6][NJ], dvb[6][NQ], Jcom[3][NQ];
  __shared__ __align__(16) float Jx[NX][NX], Ju[NX][NU], Sx[NS][NX], Su[NS][NU];
  __shared__ float Cm[NEQ][NX], Dm[NEQ][NU];
  __shared__ float w1[NS], w2[NS], pm[NS], dx[NX], du[NU], dxQ[NX], duR[NU];

  const int tid = threadIdx.x, warp = tid / LANES, lane = tid % LANES;
  Clock<LIN_PHASES> ck;
  ck.start(blockIdx.x == 0 && tid == 0);
  const long long kn = blockIdx.x;                 // flat (scenario, knot)
  const long long b = kn / n_knots, k = kn - b * n_knots;
  const long long r1 = b * (n_knots + 1) + k;      // the knot in the N+1-knot arrays
  {
    // every global input in flight at once: the constants, the parameters
    // and the knot's 94 floats (x, x_nom, u, flags, foot references), a few
    // a thread, then into shared memory
    constexpr int KQ = (N_CONSTS + LIN_THREADS - 1) / LIN_THREADS;
    float kv[KQ];
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int i = tid + q * LIN_THREADS;
      kv[q] = i < N_CONSTS ? gK[i] : 0.0f;
    }
    const float pv = tid < N_PARAMS ? gP[tid] : 0.0f;
    float* dst;
    float v = 0.0f;
    const int t = tid;
    if (t < NX) v = gxs[r1 * NX + t], dst = x + t;
    else if (t < 2 * NX) v = gxn[r1 * NX + t - NX], dst = xn + t - NX;
    else if (t < 2 * NX + NU) v = gus[kn * NU + t - 2 * NX], dst = u + t - 2 * NX;
    else if (t < 2 * NX + NU + NC) v = gfl[r1 * NC + t - 2 * NX - NU], dst = fl + t - 2 * NX - NU;
    else if (t < 2 * NX + NU + 4 * NC)
      v = gfpr[r1 * NC * 3 + t - 2 * NX - NU - NC], dst = fpr + t - 2 * NX - NU - NC;
    else if (t < 2 * NX + NU + 7 * NC)
      v = gfvr[r1 * NC * 3 + t - 2 * NX - NU - 4 * NC], dst = fvr + t - 2 * NX - NU - 4 * NC;
    else dst = nullptr;
#pragma unroll
    for (int q = 0; q < KQ; ++q)
      if (tid + q * LIN_THREADS < N_CONSTS) K[tid + q * LIN_THREADS] = kv[q];
    if (tid < N_PARAMS) P[tid] = pv;
    if (dst != nullptr) *dst = v;
  }
  __syncthreads();
  joint_axes(K, axis, tid);  // warp 0's lanes: read by warp 0, then past the barrier
  ck.mark(LP_LOAD);

  // ---- the primal chain on warp 0, with the xy soft rows' penalties (the
  // rows that need it); meanwhile warps 1-3 form dx, du, Q' dx, R' du and
  // the other 28 soft rows' penalties ----
  constexpr int XY0 = 4, XY = 2 * NC;  // the xy rows 4..11
  if (warp == 0) {
    chain_warp(K, P, axis, x, u, fl, fpr, fvr, Tc, wk, lane, ck);
    if (lane < XY)
      penalty_terms(P, fl, XY0 + lane,
                    soft_value(P, fpr, fvr, x, u, wk.pc, wk.vc, XY0 + lane), w1, w2, pm);
  } else if (warp == 1) {
    if (lane < NX) dx[lane] = x[lane] - xn[lane];
    __syncwarp();
    if (lane < NX) {
      float sq = 0.0f;
      for (int i = 0; i < NX; ++i) sq += dx[i] * gQ[i * NX + lane];
      dxQ[lane] = sq;
    }
  } else if (warp == 2) {
    if (lane < NU) du[lane] = u[lane] - u_nom(K, fl, lane);
    __syncwarp();
    if (lane < NU) {
      float sq = 0.0f;
      for (int i = 0; i < NU; ++i) sq += du[i] * gR[i * NU + lane];
      duR[lane] = sq;
    }
  } else if (warp == 3 && lane < NS - XY) {
    const int r = lane < XY0 ? lane : lane + XY;
    penalty_terms(P, fl, r, soft_value(P, fpr, fvr, x, u, wk.pc, wk.vc, r), w1, w2, pm);
  }
  if (warp == 1 || warp == 2)
    constant_entries(P, u, fl, K[K_INVM], tid - LANES, Jx, Ju, Sx, Su, Dm);
  __syncthreads();
  ck.mark(LP_CHAIN);

  const float m = K[K_M], inv_m = K[K_INVM];
  // ---- the RK2 midpoint flow and the next state on warp 4; its lanes
  // leave the block here ----
  if (warp == MID_WARP) {
    Clock<LIN_PHASES> cm;
    cm.start(blockIdx.x == 0 && lane == 0);
    wm.x[lane] = lane < NX ? x[lane] + dt * wk.flow[lane] : 0.0f;
    const float k2 = warp_flow<false>(K, axis, wm.x, u, wm.T, wm.k, wm.vc, lane, cm);
    if (lane < NX) oxnext[kn * NX + lane] = x[lane] + (0.5f * dt) * (wk.flow[lane] + k2);
    cm.mark(LP_MID);
    // ---- once the columns are done, beside the dense tail: the rows and
    // masks, qx, qu and the cost ----
    wait_columns();
    cm.restart();
    if (lane < NEQ) {
      og[kn * NEQ + lane] = wk.g[lane] * wk.mask[lane];
      omask[kn * NEQ + lane] = wk.mask[lane];
    }
    if (lane < NX) {
      float swx = 0.0f, swu = 0.0f;
      for (int s = 0; s < NS; ++s) {
        swx += Sx[s][lane] * w1[s];
        swu += Su[s][lane] * w1[s];
      }
      oqx[kn * NX + lane] = dt * (dxQ[lane] + swx);
      oqu[kn * NU + lane] = dt * (duR[lane] + swu);
    }
    const float cq = warp_sum(lane < NX ? dxQ[lane] * dx[lane] : 0.0f);
    const float cr = warp_sum(lane < NU ? duR[lane] * du[lane] : 0.0f);
    const float cp = warp_sum(lane + LANES < NS ? pm[lane] + pm[lane + LANES] : pm[lane]);
    if (lane == 0) ocost[kn] = dt * ((0.5f * cq + 0.5f * cr) + cp);
    cm.mark(LP_STORE);
    cm.flush(SOA_CLOCK_OUT(lin_phase_cycles));
    return;
  }
  // ---- per link its terms of the subtree sums (m c, m c_dot, h = I w,
  // m c c', m c c_dot', I), c_dot = v_o + w x (c - p); the input Jacobian's
  // torque rows skew(p_c - p_com) / m ----
  for (int e = tid; e < L * LV + 3 * 3 * NC; e += COL_THREADS) {
    if (e >= L * LV) {
      // skew(r)[a][b] / m, r = p_c - p_com: 0 on the diagonal, else
      // +-r_k with k the third index (+ for b = a + 1 mod 3)
      const int f = e - L * LV, a = f / (3 * NC), c = f % (3 * NC);
      const int cc = c / 3, bb = c % 3, kk = 3 - a - bb;
      const float rk = wk.pc[cc][kk] - wk.pcom[kk];
      Ju[3 + a][c] = (a == bb ? 0.0f : (bb == (a + 1) % 3 ? -rk : rk)) / m;
      continue;
    }
    const int l = e / LV, v = e % LV;
    const float ml = K[K_MASS + l];
    // component b of the link CoM's velocity c_dot = v_o + w x (c - p)
    const auto cdot = [&](int b) {
      const int b1 = (b + 1) % 3, b2 = (b + 2) % 3;
      const float d1 = wk.com[l][b1] - wk.p[l][b1], d2 = wk.com[l][b2] - wk.p[l][b2];
      return wk.vo[l][b] + (wk.om[l][b1] * d2 - wk.om[l][b2] * d1);
    };
    float t;
    if (v < 3) {
      t = ml * wk.com[l][v];
    } else if (v < 6) {
      t = ml * cdot(v - 3);
    } else if (v < 9) {
      const float* I = wk.Iw[l] + 3 * (v - 6);
      t = I[0] * wk.om[l][0] + I[1] * wk.om[l][1] + I[2] * wk.om[l][2];
    } else if (v < 18) {
      t = ml * (wk.com[l][(v - 9) / 3] * wk.com[l][(v - 9) % 3]);
    } else if (v < 27) {
      t = ml * (wk.com[l][(v - 18) / 3] * cdot((v - 18) % 3));
    } else {
      t = wk.Iw[l][v - 27];
    }
    lk[l][v] = t;
  }
  sync_columns();
  // ---- their sums over each joint's subtree (links j + 1 to the leg's
  // last: the compiled tree, two legs of LEG_JOINTS) and over the whole
  // body, each in link order ----
  for (int e = tid; e < (NJ + 1) * LV; e += COL_THREADS) {
    const int j = e / LV, v = e % LV;  // j = NJ: the whole body
    const int lo = j < NJ ? j + 1 : 0, hi = j < NJ ? LEG_JOINTS * (j / LEG_JOINTS + 1) : L - 1;
    float sum = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (l >= lo && l <= hi) sum = sum + lk[l][v];
    sub[j][v] = sum;
  }
  sync_columns();
  ck.mark(LP_LINK);

  // ---- CMM joint columns, euler columns, contact Jacobian columns ----
  const float* pb = wk.p[0];
  const float* vbl = wk.vb;
  const float* thd = wk.vb + 3;
  const float cz = wk.trig[0], sz = wk.trig[1], cy = wk.trig[2], sy = wk.trig[3];
  const float zd = thd[0], yd = thd[1];
  const float Ec[3][3] = {{0.0f, 0.0f, 1.0f}, {-sz, cz, 0.0f}, {cz * cy, sz * cy, -sy}};
  const float Edc[3][3] = {{0.0f, 0.0f, 0.0f},
                           {-cz * zd, -sz * zd, 0.0f},
                           {-sz * zd * cy - cz * sy * yd, cz * zd * cy - sz * sy * yd, -cy * yd}};
  // row i of E or dE/dt by selects (a row index held in a thread's register
  // would put the tables in local memory)
  const auto row = [](const float (*M)[3], int i, float* out) {
    for (int k = 0; k < 3; ++k) out[k] = i == 0 ? M[0][k] : (i == 1 ? M[1][k] : M[2][k]);
  };
  if (tid < NJ) {
    const int j = tid;
    const float Mj = K[K_MSUB + j];
    const float* S = sub[j];
    const float* sd = sub[j] + 3;
    const float* Hs = sub[j] + 6;
    const float* Q = sub[j] + 9;
    const float* Y = sub[j] + 18;
    const float* Is = sub[j] + 27;
    const float* aj = wk.aw[j];
    const float* oj = wk.anchor[j];
    const float* odj = wk.vo[c_child[j]];
    float adj[3], W[9], prim[3], dual[3];
    cross3(wk.om[c_parent[j]], aj, adj);
    w_moment(Q, S, Mj, oj, wk.pcom, W);
    ang_col(Is, Hs, W, Y, sd, S, Mj, wk.pcom, vcom_m, inv_m, aj, adj, oj, odj,
            wk.om[c_child[j]], prim, dual);
    float so[3], sdo[3], l1[3], l2[3];
    for (int i = 0; i < 3; ++i) {
      so[i] = S[i] - Mj * oj[i];
      sdo[i] = sd[i] - Mj * odj[i];
    }
    cross3(aj, so, Ajl[j]);
    cross3(adj, so, l1);
    cross3(aj, sdo, l2);
    for (int i = 0; i < 3; ++i) {
      Aja[j][i] = prim[i];
      dAl[6 + j][i] = l1[i] + l2[i];
      dAa[6 + j][i] = dual[i];
    }
  } else if (tid < NJ + 3) {
    const int ie = tid - NJ;
    float Sall[3], W[9], prim[3], dual[3], dEv[3];
    for (int i = 0; i < 3; ++i) Sall[i] = m * wk.pcom[i];
    w_moment(Qall, Sall, m, pb, wk.pcom, W);
    float e_i[3], ed_i[3];
    row(Ec, ie, e_i);
    row(Edc, ie, ed_i);
    ang_col(Itot, Htot, W, Yall, vcom_m, Sall, m, wk.pcom, vcom_m, inv_m, e_i, ed_i, pb,
            vbl, wk.om[0], prim, dual);
    // dE_i theta_dot (i = z, y; zero for x)
    if (ie == 0) {
      dEv[0] = (-cz) * thd[1] + (-sz * cy) * thd[2];
      dEv[1] = (-sz) * thd[1] + (cz * cy) * thd[2];
      dEv[2] = 0.0f;
    } else if (ie == 1) {
      dEv[0] = (-cz * sy) * thd[2];
      dEv[1] = (-sz * sy) * thd[2];
      dEv[2] = (-cy) * thd[2];
    } else {
      dEv[0] = dEv[1] = dEv[2] = 0.0f;
    }
    float It[3], pp[3], vv[3], c1[3], c2[3];
    mv3(Itot, dEv, It);
    for (int i = 0; i < 3; ++i) {
      pp[i] = wk.pcom[i] - pb[i];
      vv[i] = inv_m * vcom_m[i] - vbl[i];
    }
    cross3(ed_i, pp, c1);
    cross3(e_i, vv, c2);
    for (int i = 0; i < 3; ++i) {
      dAa[3 + ie][i] = dual[i] + It[i];
      dAl[3 + ie][i] = m * (c1[i] + c2[i]);
    }
  } else if (tid >= 16 && tid < 16 + NC * NQ) {
    const int c = (tid - 16) / NQ, col = (tid - 16) % NQ;
    const int link = c_cparent[c];
    float jc[3] = {0.0f, 0.0f, 0.0f}, jd[3] = {0.0f, 0.0f, 0.0f};
    if (col < 3) {
      for (int i = 0; i < 3; ++i) jc[i] = i == col ? 1.0f : 0.0f;
    } else if (col < 6) {
      const int a = col - 3;
      float d[3], dv[3], t1[3], t2[3];
      for (int i = 0; i < 3; ++i) {
        d[i] = wk.pc[c][i] - pb[i];
        dv[i] = wk.vc[c][i] - vbl[i];
      }
      float e_a[3], ed_a[3];
      row(Ec, a, e_a);
      row(Edc, a, ed_a);
      cross3(e_a, d, jc);
      cross3(ed_a, d, t1);
      cross3(e_a, dv, t2);
      for (int i = 0; i < 3; ++i) jd[i] = t1[i] + t2[i];
    } else if (c_anc[link][col - 6]) {
      const int j = col - 6;
      float d[3], adj[3], dv[3], t1[3], t2[3];
      cross3(wk.om[c_parent[j]], wk.aw[j], adj);
      for (int i = 0; i < 3; ++i) {
        d[i] = wk.pc[c][i] - wk.anchor[j][i];
        dv[i] = wk.vc[c][i] - wk.vo[c_child[j]][i];
      }
      cross3(wk.aw[j], d, jc);
      cross3(adj, d, t1);
      cross3(wk.aw[j], dv, t2);
      for (int i = 0; i < 3; ++i) jd[i] = t1[i] + t2[i];
    }
    for (int i = 0; i < 3; ++i) {
      Jc[c][i][col] = jc[i];
      Jcd[c][i][col] = jd[i];
    }
  } else if (tid >= 16 + NC * NQ && tid < 16 + NC * NQ + 3) {
    const int i = tid - 16 - NC * NQ;   // base position columns: D_q[A v] = 0
    for (int a = 0; a < 3; ++a) dAl[i][a] = dAa[i][a] = 0.0f;
  }
  sync_columns();

  // ---- Vh = m Ab^-1, Vv, dvb, Jcom ----
  if (tid < 36) {
    const int r = tid / 6, c = tid % 6;
    float v;
    if (r < 3) {
      v = (c < 3) ? ((r == c) ? 1.0f : 0.0f)
                  : -(wk.A12[3 * r] * wk.iGE[c - 3] + wk.A12[3 * r + 1] * wk.iGE[c]
                      + wk.A12[3 * r + 2] * wk.iGE[3 + c]);
    } else {
      v = (c < 3) ? 0.0f : m * wk.iGE[3 * (r - 3) + c - 3];
    }
    Vh[r][c] = v;
    Jx[6 + r][c] = v;
  } else if (tid < 36 + NJ) {
    const int j = tid - 36;
    float o[6];
    ab_solve_neg(&wk, inv_m, Ajl[j], Aja[j], o);
    for (int r = 0; r < 6; ++r) {
      Vv[r][j] = o[r];
      Ju[6 + r][3 * NC + j] = o[r];
    }
  } else if (tid < 36 + NJ + NQ) {
    const int i = tid - 36 - NJ;
    float o[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (i >= 3) ab_solve_neg(&wk, inv_m, dAl[i], dAa[i], o);
    for (int r = 0; r < 6; ++r) {
      dvb[r][i] = o[r];
      Jx[6 + r][6 + i] = o[r];
    }
  } else if (tid < 36 + NJ + NQ + 3 * NQ) {
    const int e = tid - 36 - NJ - NQ;
    const int r = e / NQ, c = e % NQ;
    float v;
    if (c < 3) v = (r == c) ? 1.0f : 0.0f;
    else if (c < 6) v = inv_m * wk.A12[3 * r + c - 3];
    else v = inv_m * Ajl[c - 6][r];
    Jcom[r][c] = v;
  }
  sync_columns();
  ck.mark(LP_COLUMNS);

  // ---- H = Jc_b Vh, W = Jc_b Vv + Jc_j, dvc = Jcdot + Jc_b dvb, dhdot_ang,
  // each entry written where C, D, Jsoft_x, soft_u and Jx_f take it (the
  // foot's stance rows, its swing row, its xy soft rows; warps 1-2 wrote
  // the entries that do not depend on them during the chain) ----
  const float gxy = P[P_XY_GAIN], gn = P[P_POS_GAIN];
  constexpr int nH = NC * 3 * 6, nW = NC * 3 * NJ, nV = NC * 3 * NQ;
  for (int e = tid; e < nH + nW + nV + 3 * NQ; e += COL_THREADS) {
    if (e < nH + nW + nV) {
      // column kind: H (base columns of C / Jsoft_x), W (joint columns of D /
      // soft_u), dvc (C / Jsoft_x columns 6..)
      const int kind = e < nH ? 0 : (e < nH + nW ? 1 : 2);
      const int g = e - (kind == 0 ? 0 : (kind == 1 ? nH : nH + nW));
      const int n = kind == 0 ? 6 : (kind == 1 ? NJ : NQ);
      const int f = g / (3 * n), a = (g / n) % 3, col = g % n;
      const float* V = kind == 0 ? &Vh[0][col] : (kind == 1 ? &Vv[0][col] : &dvb[0][col]);
      const int vs = kind == 0 ? 6 : (kind == 1 ? NJ : NQ);  // V's row stride
      float sum = 0.0f;
      for (int l = 0; l < 6; ++l) sum += Jc[f][a][l] * V[l * vs];
      const bool stance = fl[f] > 0.5f, swing = fl[f] < 0.5f;
      if (kind == 1) {
        const float w = sum + Jc[f][a][6 + col];
        const int c = 3 * NC + col;
        Dm[4 * f + a][c] = stance ? w : 0.0f;
        if (a == 2) Dm[4 * f + 3][c] = swing ? w : 0.0f;
        if (a < 2) Su[4 + 2 * f + a][c] = w;
      } else {
        const float h = kind == 0 ? sum : Jcd[f][a][col] + sum;
        const int c = kind == 0 ? col : 6 + col;
        const float jc = kind == 0 ? 0.0f : Jc[f][a][col], jz = kind == 0 ? 0.0f : Jc[f][2][col];
        Cm[4 * f + a][c] = stance ? (kind == 0 ? h : h + ((a == 2) ? gxy * jz : 0.0f)) : 0.0f;
        if (a == 2) Cm[4 * f + 3][c] = swing ? (kind == 0 ? h : h + gn * jz) : 0.0f;
        if (a < 2) Sx[4 + 2 * f + a][c] = kind == 0 ? h : h + gxy * jc;
      }
    } else {
      // -(1/m) sum_c f_c x (Jc_c - Jcom)
      const int f = e - nH - nW - nV;
      const int a = f / NQ, v = f % NQ;
      float sum = 0.0f;
      for (int c = 0; c < NC; ++c) {
        float d[3], cr[3];
        for (int i = 0; i < 3; ++i) d[i] = Jc[c][i][v] - Jcom[i][v];
        cross3(u + 3 * c, d, cr);
        sum += cr[a];
      }
      Jx[3 + a][6 + v] = -sum / m;
    }
  }
  sync_columns();
  columns_done();
  ck.mark(LP_HWD);
  ck.mark(LP_ASSEMBLY);
  ck.mark(LP_PENALTIES);

  // ---- outputs: the dense tail (A, B, GGN quadratics), rows, masks ----
  // 2x2 tiles of the 22x22 outputs, one a thread (121 of 128): each input
  // entry read once a tile, in pairs; every sum in the order the plain
  // version's elementwise loop takes
  constexpr int TN = NX / 2;
  const float hdt2 = 0.5f * dt * dt;
  if (tid < TN * TN) {
    const int r0 = 2 * (tid / TN), c0 = 2 * (tid % TN);
    float sa[2][2] = {}, sb[2][2] = {}, qxx[2][2] = {}, quu[2][2] = {}, qux[2][2] = {};
    for (int l = 0; l < NX; ++l) {
      const float a[2] = {Jx[r0][l], Jx[r0 + 1][l]};
      const float2 bx = *reinterpret_cast<const float2*>(&Jx[l][c0]);
      const float2 bu = *reinterpret_cast<const float2*>(&Ju[l][c0]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sa[i][0] += a[i] * bx.x;
        sa[i][1] += a[i] * bx.y;
        sb[i][0] += a[i] * bu.x;
        sb[i][1] += a[i] * bu.y;
      }
    }
    for (int s = 0; s < NS; ++s) {
      const float w = w2[s];
      const float2 xr = *reinterpret_cast<const float2*>(&Sx[s][r0]);
      const float2 xc = *reinterpret_cast<const float2*>(&Sx[s][c0]);
      const float2 ur = *reinterpret_cast<const float2*>(&Su[s][r0]);
      const float2 uc = *reinterpret_cast<const float2*>(&Su[s][c0]);
      const float xw[2] = {xr.x * w, xr.y * w}, uw[2] = {ur.x * w, ur.y * w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qxx[i][0] += xw[i] * xc.x;
        qxx[i][1] += xw[i] * xc.y;
        quu[i][0] += uw[i] * uc.x;
        quu[i][1] += uw[i] * uc.y;
        qux[i][0] += uw[i] * xc.x;
        qux[i][1] += uw[i] * xc.y;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i, e = r * NX + c0;
      const long long o = kn * NX * NX + e;
      *reinterpret_cast<float2*>(oA + o) =
          make_float2(((r == c0 ? 1.0f : 0.0f) + dt * Jx[r][c0]) + hdt2 * sa[i][0],
                      ((r == c0 + 1 ? 1.0f : 0.0f) + dt * Jx[r][c0 + 1]) + hdt2 * sa[i][1]);
      *reinterpret_cast<float2*>(oB + o) = make_float2(dt * Ju[r][c0] + hdt2 * sb[i][0],
                                                       dt * Ju[r][c0 + 1] + hdt2 * sb[i][1]);
      *reinterpret_cast<float2*>(oQxx + o) =
          make_float2(dt * (gQ[e] + qxx[i][0]), dt * (gQ[e + 1] + qxx[i][1]));
      *reinterpret_cast<float2*>(oQuu + o) =
          make_float2(dt * (gR[e] + quu[i][0]), dt * (gR[e + 1] + quu[i][1]));
      *reinterpret_cast<float2*>(oQux + o) = make_float2(dt * qux[i][0], dt * qux[i][1]);
    }
  }
  ck.mark(LP_TAIL);
  // C and D, masked (they read nothing the tail writes: no barrier)
  for (int e = tid; e < NEQ * NX; e += COL_THREADS) {
    const int r = e / NX;
    oC[kn * NEQ * NX + e] = Cm[r][e % NX] * wk.mask[r];
    oD[kn * NEQ * NU + e] = Dm[r][e % NU] * wk.mask[r];
  }
  ck.mark(LP_STORE);
  ck.flush(SOA_CLOCK_OUT(lin_phase_cycles));
}

// ---------------------------------------------------------------------------
// the line search's merit: a warp per (scenario, candidate, knot)
// ---------------------------------------------------------------------------

constexpr int MERIT_WARPS = 2;  // knots a block
constexpr int MERIT_SUMS = 3;   // per knot: stage cost, |defect|_1, |g mask|_1

// a merit knot's warp state
struct MeritWarp {
  FlowKin k;
  float T[NJ][9];
  float x[LANES];   // the state a flow reads
  float u[LANES];   // the knot's input
  float d[LANES];   // x - x_nom
  float du[LANES];  // u - u_nom
  float vc[NC][3];
  float fl[NC], fpr[NC * 3], fvr[NC * 3];
  float axis[NJ][3];  // the joints' axes in their parents' frames
};

// ten blocks (20 warps) an SM: at most 102 registers
__global__ void __launch_bounds__(LANES * MERIT_WARPS, 10)
soa_merit_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                 const float* __restrict__ gQ, const float* __restrict__ gR,
                 const float* __restrict__ gxs, const float* __restrict__ gus,
                 const float* __restrict__ gxn, const float* __restrict__ gfl,
                 const float* __restrict__ gfpr, const float* __restrict__ gfvr,
                 float* part, int* tickets, float* __restrict__ ocost, float* __restrict__ ogm,
                 int n_cand, int n_knots, int groups, float dt) {
  __shared__ float K[N_CONSTS], P[N_PARAMS];
  __shared__ MeritWarp ws[MERIT_WARPS];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / LANES, lane = tid % LANES;
  const long long bc = blockIdx.x / groups;        // flat (scenario, candidate)
  const int k = static_cast<int>(blockIdx.x - bc * groups) * MERIT_WARPS + warp;
  const long long b = bc / n_cand;
  const bool active = k < n_knots;
  Clock<MERIT_PHASES> ck;
  ck.start(blockIdx.x == 0 && tid == 0);
  constexpr int KQ = (N_CONSTS + LANES * MERIT_WARPS - 1) / (LANES * MERIT_WARPS);
  float kv[KQ];
#pragma unroll
  for (int q = 0; q < KQ; ++q) {
    const int i = tid + q * LANES * MERIT_WARPS;
    kv[q] = i < N_CONSTS ? gK[i] : 0.0f;
  }
  const float pv = tid < N_PARAMS ? gP[tid] : 0.0f;
  MeritWarp& w = ws[warp];
  float xr = 0.0f, ur = 0.0f, xnom = 0.0f, xnext = 0.0f;
  if (active) {
    const float* xk = gxs + (bc * (n_knots + 1) + k) * NX;
    const long long r1 = b * (n_knots + 1) + k;
    if (lane < NX) {
      xr = xk[lane];
      xnext = xk[NX + lane];
      xnom = gxn[r1 * NX + lane];
      ur = gus[(bc * n_knots + k) * NU + lane];
    }
    if (lane < NC) w.fl[lane] = gfl[r1 * NC + lane];
    if (lane < NC * 3) {
      w.fpr[lane] = gfpr[r1 * NC * 3 + lane];
      w.fvr[lane] = gfvr[r1 * NC * 3 + lane];
    }
  }
  w.x[lane] = xr;
  w.u[lane] = ur;
#pragma unroll
  for (int q = 0; q < KQ; ++q)
    if (tid + q * LANES * MERIT_WARPS < N_CONSTS) K[tid + q * LANES * MERIT_WARPS] = kv[q];
  if (tid < N_PARAMS) P[tid] = pv;
  __syncthreads();
  joint_axes(K, w.axis, lane);  // each warp its own copy: no second block barrier
  ck.mark(MP_LOAD);

  if (active) {
    // the rows at x and the flow
    const float k0 = warp_flow<true>(K, w.axis, w.x, w.u, w.T, w.k, w.vc, lane, ck);
    float eq, cp;
    row_terms(P, w.fl, w.fpr, w.fvr, w.x, w.u, w.k.pc, w.vc, lane, &eq, &cp);
    ck.mark(MP_ROWS);
    // the stage cost 0.5 dx'Q dx + 0.5 du'R du + sum mask p
    w.d[lane] = lane < NX ? xr - xnom : 0.0f;
    w.du[lane] = lane < NU ? ur - u_nom(K, w.fl, lane) : 0.0f;
    __syncwarp();
    const float cost = quad_forms(gQ, gR, w.d, w.du, lane) + cp;
    ck.mark(MP_COST);
    // the RK2 next state (the flow at x + dt flow) and the defect to the next knot
    w.x[lane] = lane < NX ? xr + dt * k0 : 0.0f;
    const float k1 = warp_flow<false>(K, w.axis, w.x, w.u, w.T, w.k, w.vc, lane, ck);
    ck.mark(MP_MID);
    const float def =
        warp_sum(lane < NX ? fabsf(xnext - (xr + (0.5f * dt) * (k0 + k1))) : 0.0f);
    if (lane == 0) {
      float* pk = part + (bc * n_knots + k) * MERIT_SUMS;
      pk[0] = cost;
      pk[1] = def;
      pk[2] = eq;
      __threadfence();
    }
    ck.mark(MP_DEFECT);
  }
  ck.flush(SOA_CLOCK_OUT(merit_phase_cycles));

  // the last block of this (scenario, candidate) to finish adds its knots'
  // sums in knot order and resets the ticket for the next launch
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bc, 1) == groups - 1;
  __syncthreads();
  if (!last || warp != 0) return;
  Clock<MERIT_PHASES> cr;
  cr.start(bc == 0 && lane == 0);
  // a lane per knot loads its sums from L2 (the other blocks' writes,
  // fenced before their tickets), 32 knots at a time; every lane adds them
  // up in knot order by shuffles
  const float* pb = part + bc * n_knots * MERIT_SUMS;
  float c = 0.0f, d = 0.0f, e = 0.0f;
  for (int k0 = 0; k0 < n_knots; k0 += LANES) {
    const int kk = k0 + lane, n = min(LANES, n_knots - k0);
    float v[MERIT_SUMS] = {0.0f, 0.0f, 0.0f};
    if (kk < n_knots)
      for (int i = 0; i < MERIT_SUMS; ++i) v[i] = __ldcg(pb + MERIT_SUMS * kk + i);
    for (int j = 0; j < n; ++j) {
      c += __shfl_sync(FULL, v[0], j);
      d += __shfl_sync(FULL, v[1], j);
      e += __shfl_sync(FULL, v[2], j);
    }
  }
  if (lane == 0) {
    ocost[bc] = dt * c;
    ogm[bc] = d / n_knots + e / n_knots;
    tickets[bc] = 0;
  }
  cr.mark(MP_REDUCE);
  cr.flush(SOA_CLOCK_OUT(merit_phase_cycles));
}

}  // namespace

// The compiled topology and buffer sizes, for the wrapper to check a model
// against: [nj, L, nc, nx, nu, n_consts, n_params, parent (nj), child (nj),
// contact parent (nc), ancestor mask (L x nj)].  Returns the count written,
// or -1 if cap is too small.
extern "C" int hk_soa_topology(int* out, int cap) {
  const int n = 7 + 2 * NJ + NC + L * NJ;
  if (cap < n) return -1;
  int i = 0;
  out[i++] = NJ; out[i++] = L; out[i++] = NC; out[i++] = NX; out[i++] = NU;
  out[i++] = N_CONSTS; out[i++] = N_PARAMS;
  for (int j = 0; j < NJ; ++j) out[i++] = h_parent[j];
  for (int j = 0; j < NJ; ++j) out[i++] = h_child[j];
  for (int c = 0; c < NC; ++c) out[i++] = h_cparent[c];
  for (int k = 0; k < L; ++k)
    for (int j = 0; j < NJ; ++j) out[i++] = h_anc[k][j];
  return i;
}

extern "C" int hk_soa_linearize(const float* consts, const float* params, const float* Q,
                                const float* R, const float* xs, const float* us,
                                const float* x_nom, const float* flags, const float* fpr,
                                const float* fvr, float* xnext, float* A, float* B, float* cost,
                                float* qx, float* qu, float* Qxx, float* Quu, float* Qux,
                                float* g, float* C, float* D, float* mask, int batch,
                                int n_knots, float dt, void* stream) {
  const long long blocks = static_cast<long long>(batch) * n_knots;
  soa_linearize_kernel<<<static_cast<unsigned>(blocks), LIN_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      consts, params, Q, R, xs, us, x_nom, flags, fpr, fvr, xnext, A, B, cost, qx, qu, Qxx,
      Quu, Qux, g, C, D, mask, n_knots, dt);
  return static_cast<int>(cudaGetLastError());
}

// The merit's scratch per (scenario, candidate): floats of its knots' sums.
extern "C" int hk_soa_merit_partials(int n_knots) { return MERIT_SUMS * n_knots; }

// partials: hk_soa_merit_partials(n_knots) floats per (scenario,
// candidate), any contents; tickets: one int per (scenario, candidate), 0
// before the first launch, left 0 by every launch.
extern "C" int hk_soa_merit(const float* consts, const float* params, const float* Q,
                            const float* R, const float* xs, const float* us,
                            const float* x_nom, const float* flags, const float* fpr,
                            const float* fvr, float* partials, int* tickets, float* cost,
                            float* g_metric, int batch, int n_cand, int n_knots, float dt,
                            void* stream) {
  if (batch < 1 || n_cand < 1 || n_knots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (n_knots + MERIT_WARPS - 1) / MERIT_WARPS;
  const long long blocks = static_cast<long long>(batch) * n_cand * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  soa_merit_kernel<<<static_cast<unsigned>(blocks), LANES * MERIT_WARPS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      consts, params, Q, R, xs, us, x_nom, flags, fpr, fvr, partials, tickets, cost, g_metric,
      n_cand, n_knots, groups, dt);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SOA_PHASE_CLOCKS
// The phase sums since the last call (LIN_PHASES / MERIT_PHASES of them),
// then zeroed.
extern "C" int hk_soa_linearize_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, lin_phase_cycles, sizeof(lin_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[LIN_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(lin_phase_cycles, zero, sizeof(zero)));
}

extern "C" int hk_soa_merit_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, merit_phase_cycles, sizeof(merit_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[MERIT_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(merit_phase_cycles, zero, sizeof(zero)));
}
#endif
