// B1: the scalarized SoA linearization and line-search merit of the SQP.
//
// Replaces hunter_bipedal_control_tpu/models/soa.py::linearization_arrays
// (:866), combined_rows_arrays (:605) and flow_arrays (:623), as
// ocp/problem.py::knot_linearization_batch (:465) and stage_merit_batch
// (:439) consume them inside solver/sqp.py (dt scaling, equality masking,
// the merit's defect and residual norms).  Two entry points over shared
// __device__ functions:
//
//   hk_soa_linearize: one 128-thread block per (scenario, knot).  Thread 0
//     runs the scalar chain (FK, CMM base block, base velocity, velocity
//     pass, contact rows, 16 equality + 36 soft rows) into shared memory;
//     then the block computes the per-column ingredients (subtree sums and
//     the closed-form CMM columns per joint, the euler columns, the 64
//     contact Jacobian columns and their time derivatives), Vh, Vv, dvb,
//     Jcom, assembles Jx_f, flow_u, C, D, Jsoft_x, soft_u and runs the
//     dense tail (A, B, the GGN quadratics), all over shared memory; a
//     second thread evaluates the RK2 midpoint flow meanwhile.
//   hk_soa_merit: one 32-thread block per (scenario, candidate), a thread
//     per knot (strided): combined rows at x, the stage cost, the flow at
//     x + dt flow, the defect to the next knot; the block then reduces in a
//     fixed order (each thread's knots in order, then the threads in order).
//     Each thread's intermediates live in its own slice of dynamic shared
//     memory, not in spilled registers.
//
// Bound on the card: per knot the linearization reads 94 floats and writes
// 3,207 (13.2 KB; ~112 MB at B=128, N=66, ~33 us at 3.35 TB/s), and its
// dense tail is ~0.15 MFLOP (~19 us at 67 TFLOP/s fp32): bytes bound.  The
// design keeps every ingredient in shared memory and writes each output
// once.  The scalar chain is latency bound in one thread; spreading it over
// lanes is later work.
//
// Model constants come from the port's build_consts (ocp/soa_kernel.py) as
// a device buffer; the tree's topology (nj=10, L=11, nc=4) is compiled in
// (soa_model.cuh, shared with B8a's leg_ik.cu and B9's wbc_qp.cu),
// and hk_soa_topology hands it to the wrapper, which refuses a model whose
// topology differs.  True float32: no fast math; a singular 3x3 GE gives
// inf/NaN as soa.py::inv3 does.
#include <cuda_runtime.h>

#include "soa_model.cuh"

namespace {

constexpr int NQ = 6 + NJ;          // 16
constexpr int NX = 12 + NJ;         // 22
constexpr int NU = 3 * NC + NJ;     // 22
constexpr int NEQ = 4 * NC;         // 16
constexpr int NS = 4 + 2 * NC + 2 * NJ + NC;  // 36

// OCP parameters buffer layout
constexpr int P_XY_GAIN = 0, P_Z_REF = 1, P_POS_GAIN = 2, P_MU_C = 3, P_CONE_REG = 4,
              P_CONE_MU = 5, P_CONE_DELTA = 6, P_SWING_W = 7, P_POS_MU = 8, P_POS_DELTA = 9,
              P_VEL_MU = 10, P_VEL_DELTA = 11, P_F_MU = 12, P_F_DELTA = 13, P_FZ_MAX = 14,
              P_LOWER = 15, P_UPPER = P_LOWER + NJ, P_VLIM = P_UPPER + NJ,
              N_PARAMS = P_VLIM + NJ;

// ---------------------------------------------------------------------------
// one knot's primal quantities (soa.py::combined_rows / flow); the state's
// kinematics (Kin, fk_dev, base_velocity_dev) and the flow (FlowKin,
// contact_points_dev, flow_rows_dev, flow_dev) are soa_model.cuh's
// ---------------------------------------------------------------------------

struct Work : FlowKin {
  float vc[NC][3];
  float flow[NX];
  float g[NEQ];         // equality rows before masking
  float mask[NEQ];
  float soft[NS];
  float xmid[NX];       // RK2 midpoint state and its flow
  float k2[NX];
};

// soa.py::combined_rows at one knot: every primal quantity into w
__device__ void combined_rows_dev(const float* K, const float* P, const float* x,
                                  const float* u, const float* flags, const float* fpr,
                                  const float* fvr, Work* w) {
  const float* vj = u + 3 * NC;
  fk_dev(K, x + 6, w);
  base_velocity_dev(K, x, vj, w);
  velocity_pass_dev(w->vb, vj, w);
  contact_points_dev(K, w);
  for (int c = 0; c < NC; ++c) {
    const int k = c_cparent[c];
    float d[3], t[3];
    for (int i = 0; i < 3; ++i) d[i] = w->pc[c][i] - w->p[k][i];
    cross3(w->om[k], d, t);
    for (int i = 0; i < 3; ++i) w->vc[c][i] = w->vo[k][i] + t[i];
  }
  flow_rows_dev(K, u, w, w->flow);

  // equality rows (4 per foot) and masks
  const float gxy = P[P_XY_GAIN], gn = P[P_POS_GAIN];
  for (int c = 0; c < NC; ++c) {
    const bool stance = flags[c] > 0.5f;
    const float zvz = w->vc[c][2] + gxy * (w->pc[c][2] - P[P_Z_REF]);
    const float zv[3] = {w->vc[c][0], w->vc[c][1], zvz};
    for (int a = 0; a < 3; ++a) {
      w->g[4 * c + a] = stance ? zv[a] : u[3 * c + a];
      w->mask[4 * c + a] = 1.0f;
    }
    const float nv = (w->vc[c][2] - fvr[3 * c + 2]) + gn * (w->pc[c][2] - fpr[3 * c + 2]);
    w->g[4 * c + 3] = stance ? 0.0f : nv;
    w->mask[4 * c + 3] = stance ? 0.0f : 1.0f;
  }
  // soft rows: cone(nc), xy(2nc), qj(nj), vj(nj), fz(nc)
  for (int c = 0; c < NC; ++c) {
    const float f0 = u[3 * c], f1 = u[3 * c + 1];
    const float s = sqrtf(f0 * f0 + f1 * f1 + P[P_CONE_REG]);
    w->soft[c] = P[P_MU_C] * u[3 * c + 2] - s;
    for (int a = 0; a < 2; ++a)
      w->soft[4 + 2 * c + a] = (w->vc[c][a] - fvr[3 * c + a]) + gxy * (w->pc[c][a] - fpr[3 * c + a]);
    w->soft[4 + 2 * NC + 2 * NJ + c] = u[3 * c + 2];
  }
  for (int j = 0; j < NJ; ++j) {
    w->soft[4 + 2 * NC + j] = x[12 + j];
    w->soft[4 + 2 * NC + NJ + j] = vj[j];
  }
}

// ---------------------------------------------------------------------------
// soft penalties (ocp/penalties.py) per soft row: value, slope, curvature
// ---------------------------------------------------------------------------

__device__ void relaxed_barrier(float h, float mu, float delta, float* p, float* dp, float* d2p) {
  if (h > delta) {
    *p = -mu * logf(h);
    *dp = -mu / h;
    *d2p = mu / (h * h);
  } else {
    const float z = (h - 2.0f * delta) / delta;
    *p = mu * 0.5f * (z * z - 1.0f) - mu * logf(delta);
    *dp = mu * z / delta;
    *d2p = mu / (delta * delta);
  }
}

__device__ void double_sided(float h, float lo, float hi, float mu, float delta, float* p,
                             float* dp, float* d2p) {
  float p1, d1, dd1, p2, d2, dd2;
  relaxed_barrier(h - lo, mu, delta, &p1, &d1, &dd1);
  relaxed_barrier(hi - h, mu, delta, &p2, &d2, &dd2);
  *p = p1 + p2;
  *dp = d1 - d2;
  *d2p = dd1 + dd2;
}

// row r of the soft rows: (mask, p, dp, d2p)
__device__ void soft_penalty(const float* P, const float* flags, int r, float h, float* mask,
                             float* p, float* dp, float* d2p) {
  if (r < 4) {
    relaxed_barrier(h, P[P_CONE_MU], P[P_CONE_DELTA], p, dp, d2p);
    *mask = flags[r];
  } else if (r < 4 + 2 * NC) {
    const float wgt = P[P_SWING_W];
    *p = 0.5f * wgt * h * h;
    *dp = wgt * h;
    *d2p = wgt;
    *mask = 1.0f - flags[(r - 4) / 2];
  } else if (r < 4 + 2 * NC + NJ) {
    const int j = r - 4 - 2 * NC;
    double_sided(h, P[P_LOWER + j], P[P_UPPER + j], P[P_POS_MU], P[P_POS_DELTA], p, dp, d2p);
    *mask = 1.0f;
  } else if (r < 4 + 2 * NC + 2 * NJ) {
    const int j = r - 4 - 2 * NC - NJ;
    double_sided(h, -P[P_VLIM + j], P[P_VLIM + j], P[P_VEL_MU], P[P_VEL_DELTA], p, dp, d2p);
    *mask = 1.0f;
  } else {
    double_sided(h, 0.0f, P[P_FZ_MAX], P[P_F_MU], P[P_F_DELTA], p, dp, d2p);
    *mask = 1.0f;
  }
}

// weight-compensating input's force on foot c, axis a (utils.h:73-93)
__device__ __forceinline__ float u_nom(const float* K, const float* flags, int i) {
  if (i >= 3 * NC || i % 3 != 2) return 0.0f;
  float n = ((flags[0] + flags[1]) + flags[2]) + flags[3];
  n = fmaxf(n, 1.0f);
  return (K[K_M] * GRAVITY / n) * flags[i / 3];
}

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
__device__ void ab_solve_neg(const Work* w, float inv_m, const float* lin, const float* ang,
                             float* out) {
  float t[3], At[3];
  mv3(w->iGE, ang, t);
  mv3(w->A12, t, At);
  for (int i = 0; i < 3; ++i) {
    out[i] = (-inv_m) * (lin[i] - At[i]);
    out[3 + i] = -t[i];
  }
}

constexpr int LIN_THREADS = 128;

__global__ void __launch_bounds__(LIN_THREADS)
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
  __shared__ Work wk, wm;
  __shared__ float K[N_CONSTS], P[N_PARAMS];
  __shared__ float x[NX], u[NU], xn[NX], fl[NC], fpr[NC * 3], fvr[NC * 3];
  __shared__ float cdot[L][3], hk[L][3], vcom_m[3], Itot[9], Htot[3], Qall[9], Yall[9];
  __shared__ float Ajl[NJ][3], Aja[NJ][3], dAl[NQ][3], dAa[NQ][3];
  __shared__ float Jc[NC][3][NQ], Jcd[NC][3][NQ];
  __shared__ float Vh[6][6], Vv[6][NJ], dvb[6][NQ], Jcom[3][NQ];
  __shared__ float H[NC][3][6], Wm[NC][3][NJ], dvc[NC][3][NQ], dha[3][NQ];
  __shared__ float Jx[NX][NX], Ju[NX][NU], Cm[NEQ][NX], Dm[NEQ][NU], Sx[NS][NX], Su[NS][NU];
  __shared__ float w1[NS], w2[NS], pm[NS], dx[NX], du[NU], dxQ[NX], duR[NU];

  const int tid = threadIdx.x;
  const long long kn = blockIdx.x;                 // flat (scenario, knot)
  const long long b = kn / n_knots, k = kn - b * n_knots;
  const long long r1 = b * (n_knots + 1) + k;      // the knot in the N+1-knot arrays
  for (int i = tid; i < N_CONSTS; i += LIN_THREADS) K[i] = gK[i];
  for (int i = tid; i < N_PARAMS; i += LIN_THREADS) P[i] = gP[i];
  for (int i = tid; i < NX; i += LIN_THREADS) {
    x[i] = gxs[r1 * NX + i];
    xn[i] = gxn[r1 * NX + i];
  }
  for (int i = tid; i < NU; i += LIN_THREADS) u[i] = gus[kn * NU + i];
  for (int i = tid; i < NC; i += LIN_THREADS) fl[i] = gfl[r1 * NC + i];
  for (int i = tid; i < NC * 3; i += LIN_THREADS) {
    fpr[i] = gfpr[r1 * NC * 3 + i];
    fvr[i] = gfvr[r1 * NC * 3 + i];
  }
  __syncthreads();

  // ---- the primal chain ----
  if (tid == 0) combined_rows_dev(K, P, x, u, fl, fpr, fvr, &wk);
  __syncthreads();

  const float m = K[K_M], inv_m = K[K_INVM];
  // ---- the RK2 midpoint flow (a thread of the second warp), beside the
  // per-link velocity terms ----
  if (tid == 32) {
    for (int i = 0; i < NX; ++i) wm.xmid[i] = x[i] + dt * wk.flow[i];
    flow_dev(K, wm.xmid, u, &wm, wm.k2);
  }
  if (tid < L) {
    float d[3], c[3];
    for (int i = 0; i < 3; ++i) d[i] = wk.com[tid][i] - wk.p[tid][i];
    cross3(wk.om[tid], d, c);
    for (int i = 0; i < 3; ++i) cdot[tid][i] = wk.vo[tid][i] + c[i];
    mv3(wk.Iw[tid], wk.om[tid], hk[tid]);
  }
  __syncthreads();

  // ---- whole-body sums, each over the links in order ----
  if (tid < 9) {
    const int a = tid / 3, bb = tid % 3;
    float it = 0.0f, q = 0.0f, y = 0.0f;
    for (int l = 0; l < L; ++l) {
      const float ml = K[K_MASS + l];
      it = it + wk.Iw[l][tid];
      q = q + ml * (wk.com[l][a] * wk.com[l][bb]);
      y = y + ml * (wk.com[l][a] * cdot[l][bb]);
    }
    Itot[tid] = it;
    Qall[tid] = q;
    Yall[tid] = y;
  } else if (tid < 12) {
    const int i = tid - 9;
    float hs = 0.0f, vm = 0.0f;
    for (int l = 0; l < L; ++l) {
      hs = hs + hk[l][i];
      vm = vm + K[K_MASS + l] * cdot[l][i];
    }
    Htot[i] = hs;
    vcom_m[i] = vm;
  }
  __syncthreads();

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
  if (tid < NJ) {
    const int j = tid;
    const float Mj = K[K_MSUB + j];
    float S[3] = {0.0f, 0.0f, 0.0f}, sd[3] = {0.0f, 0.0f, 0.0f}, Hs[3] = {0.0f, 0.0f, 0.0f};
    float Q[9], Y[9], Is[9];
    for (int e = 0; e < 9; ++e) Q[e] = Y[e] = Is[e] = 0.0f;
    for (int l = 0; l < L; ++l) {
      if (!c_anc[l][j]) continue;
      const float ml = K[K_MASS + l];
      for (int a = 0; a < 3; ++a) {
        S[a] = S[a] + ml * wk.com[l][a];
        sd[a] = sd[a] + ml * cdot[l][a];
        Hs[a] = Hs[a] + hk[l][a];
        for (int c2 = 0; c2 < 3; ++c2) {
          Q[3 * a + c2] = Q[3 * a + c2] + ml * (wk.com[l][a] * wk.com[l][c2]);
          Y[3 * a + c2] = Y[3 * a + c2] + ml * (wk.com[l][a] * cdot[l][c2]);
        }
      }
      for (int e = 0; e < 9; ++e) Is[e] = Is[e] + wk.Iw[l][e];
    }
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
    ang_col(Itot, Htot, W, Yall, vcom_m, Sall, m, wk.pcom, vcom_m, inv_m, Ec[ie], Edc[ie], pb,
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
    cross3(Edc[ie], pp, c1);
    cross3(Ec[ie], vv, c2);
    for (int i = 0; i < 3; ++i) {
      dAa[3 + ie][i] = dual[i] + It[i];
      dAl[3 + ie][i] = m * (c1[i] + c2[i]);
    }
  } else if (tid >= 16 && tid < 16 + NC * NQ) {
    const int c = (tid - 16) / NQ, col = (tid - 16) % NQ;
    const int link = c_cparent[c];
    float jc[3] = {0.0f, 0.0f, 0.0f}, jd[3] = {0.0f, 0.0f, 0.0f};
    if (col < 3) {
      jc[col] = 1.0f;
    } else if (col < 6) {
      const int a = col - 3;
      float d[3], dv[3], t1[3], t2[3];
      for (int i = 0; i < 3; ++i) {
        d[i] = wk.pc[c][i] - pb[i];
        dv[i] = wk.vc[c][i] - vbl[i];
      }
      cross3(Ec[a], d, jc);
      cross3(Edc[a], d, t1);
      cross3(Ec[a], dv, t2);
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
  __syncthreads();

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
  } else if (tid < 36 + NJ) {
    const int j = tid - 36;
    float o[6];
    ab_solve_neg(&wk, inv_m, Ajl[j], Aja[j], o);
    for (int r = 0; r < 6; ++r) Vv[r][j] = o[r];
  } else if (tid < 36 + NJ + NQ) {
    const int i = tid - 36 - NJ;
    float o[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (i >= 3) ab_solve_neg(&wk, inv_m, dAl[i], dAa[i], o);
    for (int r = 0; r < 6; ++r) dvb[r][i] = o[r];
  } else if (tid < 36 + NJ + NQ + 3 * NQ) {
    const int e = tid - 36 - NJ - NQ;
    const int r = e / NQ, c = e % NQ;
    float v;
    if (c < 3) v = (r == c) ? 1.0f : 0.0f;
    else if (c < 6) v = inv_m * wk.A12[3 * r + c - 3];
    else v = inv_m * Ajl[c - 6][r];
    Jcom[r][c] = v;
  }
  __syncthreads();

  // ---- H = Jc_b Vh, W = Jc_b Vv + Jc_j, dvc = Jcdot + Jc_b dvb, dhdot_ang ----
  constexpr int nH = NC * 3 * 6, nW = NC * 3 * NJ, nV = NC * 3 * NQ;
  for (int e = tid; e < nH + nW + nV + 3 * NQ; e += LIN_THREADS) {
    if (e < nH) {
      const int c = e / 18, a = (e / 6) % 3, kk = e % 6;
      float s = 0.0f;
      for (int l = 0; l < 6; ++l) s += Jc[c][a][l] * Vh[l][kk];
      H[c][a][kk] = s;
    } else if (e < nH + nW) {
      const int f = e - nH;
      const int c = f / (3 * NJ), a = (f / NJ) % 3, j = f % NJ;
      float s = 0.0f;
      for (int l = 0; l < 6; ++l) s += Jc[c][a][l] * Vv[l][j];
      Wm[c][a][j] = s + Jc[c][a][6 + j];
    } else if (e < nH + nW + nV) {
      const int f = e - nH - nW;
      const int c = f / (3 * NQ), a = (f / NQ) % 3, v = f % NQ;
      float s = 0.0f;
      for (int l = 0; l < 6; ++l) s += Jc[c][a][l] * dvb[l][v];
      dvc[c][a][v] = Jcd[c][a][v] + s;
    } else {
      // -(1/m) sum_c f_c x (Jc_c - Jcom)
      const int f = e - nH - nW - nV;
      const int a = f / NQ, v = f % NQ;
      float s = 0.0f;
      for (int c = 0; c < NC; ++c) {
        float d[3], cr[3];
        for (int i = 0; i < 3; ++i) d[i] = Jc[c][i][v] - Jcom[i][v];
        cross3(u + 3 * c, d, cr);
        s += cr[a];
      }
      dha[a][v] = -s / m;
    }
  }
  __syncthreads();

  // ---- assemble Jx_f, flow_u, C, D, Jsoft_x, soft_u; penalties ----
  const float gxy = P[P_XY_GAIN], gn = P[P_POS_GAIN];
  for (int e = tid; e < NX * NX; e += LIN_THREADS) {
    const int r = e / NX, c = e % NX;
    float jx = 0.0f, ju = 0.0f;
    if (r < 3) {
      if (c < 3 * NC) ju = (c % 3 == r) ? inv_m : 0.0f;
    } else if (r < 6) {
      if (c >= 6) jx = dha[r - 3][c - 6];
      if (c < 3 * NC) {
        const int cc = c / 3, bb = c % 3, a = r - 3;
        float rr[3];
        for (int i = 0; i < 3; ++i) rr[i] = wk.pc[cc][i] - wk.pcom[i];
        const float sk[3][3] = {{0.0f, -rr[2], rr[1]}, {rr[2], 0.0f, -rr[0]},
                                {-rr[1], rr[0], 0.0f}};
        ju = sk[a][bb] / m;
      }
    } else if (r < 12) {
      jx = (c < 6) ? Vh[r - 6][c] : dvb[r - 6][c - 6];
      if (c >= 3 * NC) ju = Vv[r - 6][c - 3 * NC];
    } else if (c >= 3 * NC) {
      ju = (c - 3 * NC == r - 12) ? 1.0f : 0.0f;
    }
    Jx[r][c] = jx;
    Ju[r][c] = ju;
  }
  for (int e = tid; e < NEQ * NX; e += LIN_THREADS) {
    const int r = e / NX, c = e % NX;
    const int f = r / 4, a = r % 4;
    const bool stance = fl[f] > 0.5f, swing = fl[f] < 0.5f;
    float cv = 0.0f, dv = 0.0f;
    if (a < 3) {
      if (stance) cv = (c < 6) ? H[f][a][c]
                               : dvc[f][a][c - 6] + ((a == 2) ? gxy * Jc[f][2][c - 6] : 0.0f);
      if (c < 3 * NC) dv = stance ? 0.0f : ((c == 3 * f + a) ? 1.0f : 0.0f);
      else if (stance) dv = Wm[f][a][c - 3 * NC];
    } else if (swing) {
      cv = (c < 6) ? H[f][2][c] : dvc[f][2][c - 6] + gn * Jc[f][2][c - 6];
      if (c >= 3 * NC) dv = Wm[f][2][c - 3 * NC];
    }
    Cm[r][c] = cv;
    Dm[r][c] = dv;
  }
  for (int e = tid; e < NS * NX; e += LIN_THREADS) {
    const int r = e / NX, c = e % NX;
    float sx = 0.0f, su = 0.0f;
    if (r < 4) {
      if (c < 3 * NC && c / 3 == r) {
        const float f0 = u[3 * r], f1 = u[3 * r + 1];
        const float s = sqrtf(f0 * f0 + f1 * f1 + P[P_CONE_REG]);
        const int kk = c % 3;
        su = (kk == 0) ? -f0 / s : (kk == 1) ? -f1 / s : P[P_MU_C];
      }
    } else if (r < 4 + 2 * NC) {
      const int f = (r - 4) / 2, a = (r - 4) % 2;
      sx = (c < 6) ? H[f][a][c] : dvc[f][a][c - 6] + gxy * Jc[f][a][c - 6];
      if (c >= 3 * NC) su = Wm[f][a][c - 3 * NC];
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
  if (tid < NS) {
    float mk, p, dp, d2p;
    soft_penalty(P, fl, tid, wk.soft[tid], &mk, &p, &dp, &d2p);
    w1[tid] = mk * dp;
    w2[tid] = mk * d2p;
    pm[tid] = mk * p;
  } else if (tid >= 64 && tid < 64 + NX) {
    dx[tid - 64] = x[tid - 64] - xn[tid - 64];
  } else if (tid >= 96 && tid < 96 + NU) {
    du[tid - 96] = u[tid - 96] - u_nom(K, fl, tid - 96);
  }
  __syncthreads();

  // ---- outputs: the dense tail (A, B, GGN quadratics), rows, masks ----
  const float hdt2 = 0.5f * dt * dt;
  for (int e = tid; e < NX * NX; e += LIN_THREADS) {
    const int r = e / NX, c = e % NX;
    float sa = 0.0f, sb = 0.0f, qxx = 0.0f, quu = 0.0f, qux = 0.0f;
    for (int l = 0; l < NX; ++l) {
      sa += Jx[r][l] * Jx[l][c];
      sb += Jx[r][l] * Ju[l][c];
    }
    for (int s = 0; s < NS; ++s) {
      qxx += Sx[s][r] * w2[s] * Sx[s][c];
      quu += Su[s][r] * w2[s] * Su[s][c];
      qux += Su[s][r] * w2[s] * Sx[s][c];
    }
    const long long o = kn * NX * NX + e;
    oA[o] = ((r == c ? 1.0f : 0.0f) + dt * Jx[r][c]) + hdt2 * sa;
    oB[o] = dt * Ju[r][c] + hdt2 * sb;
    oQxx[o] = dt * (gQ[e] + qxx);
    oQuu[o] = dt * (gR[e] + quu);
    oQux[o] = dt * qux;
  }
  for (int e = tid; e < NEQ * NX; e += LIN_THREADS) {
    const int r = e / NX;
    oC[kn * NEQ * NX + e] = Cm[r][e % NX] * wk.mask[r];
    oD[kn * NEQ * NU + e] = Dm[r][e % NU] * wk.mask[r];
  }
  if (tid < NEQ) {
    og[kn * NEQ + tid] = wk.g[tid] * wk.mask[tid];
    omask[kn * NEQ + tid] = wk.mask[tid];
  } else if (tid >= 32 && tid < 32 + NX) {
    const int j = tid - 32;
    float sq = 0.0f, sw = 0.0f;
    for (int i = 0; i < NX; ++i) sq += dx[i] * gQ[i * NX + j];
    for (int s = 0; s < NS; ++s) sw += Sx[s][j] * w1[s];
    dxQ[j] = sq;
    oqx[kn * NX + j] = dt * (sq + sw);
    oxnext[kn * NX + j] = x[j] + (0.5f * dt) * (wk.flow[j] + wm.k2[j]);
  } else if (tid >= 64 && tid < 64 + NU) {
    const int j = tid - 64;
    float sq = 0.0f, sw = 0.0f;
    for (int i = 0; i < NU; ++i) sq += du[i] * gR[i * NU + j];
    for (int s = 0; s < NS; ++s) sw += Su[s][j] * w1[s];
    duR[j] = sq;
    oqu[kn * NU + j] = dt * (sq + sw);
  }
  __syncthreads();
  if (tid == 0) {
    float cq = 0.0f, cr = 0.0f, cp = 0.0f;
    for (int i = 0; i < NX; ++i) cq += dxQ[i] * dx[i];
    for (int i = 0; i < NU; ++i) cr += duR[i] * du[i];
    for (int s = 0; s < NS; ++s) cp += pm[s];
    ocost[kn] = dt * ((0.5f * cq + 0.5f * cr) + cp);
  }
}

// ---------------------------------------------------------------------------
// the line search's merit: per (scenario, candidate), a thread per knot
// ---------------------------------------------------------------------------

constexpr int MERIT_THREADS = 32;
// each thread's Work slice, an odd number of floats apart (the threads'
// same fields fall in different banks)
constexpr int WS = static_cast<int>(sizeof(Work) / sizeof(float)) | 1;
constexpr int MERIT_FIXED = N_CONSTS + N_PARAMS + NX * NX + NU * NU + 3 * MERIT_THREADS;
constexpr size_t MERIT_SMEM = sizeof(float) * (MERIT_FIXED + static_cast<size_t>(MERIT_THREADS) * WS);

__global__ void __launch_bounds__(MERIT_THREADS)
soa_merit_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                 const float* __restrict__ gQ, const float* __restrict__ gR,
                 const float* __restrict__ gxs, const float* __restrict__ gus,
                 const float* __restrict__ gxn, const float* __restrict__ gfl,
                 const float* __restrict__ gfpr, const float* __restrict__ gfvr,
                 float* __restrict__ ocost, float* __restrict__ ogm, int n_cand, int n_knots,
                 float dt) {
  extern __shared__ float smem[];
  float* K = smem;
  float* P = K + N_CONSTS;
  float* Q = P + N_PARAMS;
  float* R = Q + NX * NX;
  float* part = R + NU * NU;
  const int tid = threadIdx.x;
  Work* w = reinterpret_cast<Work*>(smem + MERIT_FIXED + tid * WS);
  for (int i = tid; i < N_CONSTS; i += MERIT_THREADS) K[i] = gK[i];
  for (int i = tid; i < N_PARAMS; i += MERIT_THREADS) P[i] = gP[i];
  for (int i = tid; i < NX * NX; i += MERIT_THREADS) Q[i] = gQ[i];
  for (int i = tid; i < NU * NU; i += MERIT_THREADS) R[i] = gR[i];
  __syncthreads();

  const long long bc = blockIdx.x;              // flat (scenario, candidate)
  const long long b = bc / n_cand;
  float acc_cost = 0.0f, acc_def = 0.0f, acc_eq = 0.0f;
  for (int k = tid; k < n_knots; k += MERIT_THREADS) {
    const float* x = gxs + (bc * (n_knots + 1) + k) * NX;
    const float* u = gus + (bc * n_knots + k) * NU;
    const long long r1 = b * (n_knots + 1) + k;
    const float* xn = gxn + r1 * NX;
    const float* fl = gfl + r1 * NC;
    combined_rows_dev(K, P, x, u, fl, gfpr + r1 * NC * 3, gfvr + r1 * NC * 3, w);
    // stage cost: 0.5 dx'Q dx + 0.5 du'R du + sum mask p
    float cq = 0.0f, cr = 0.0f, cp = 0.0f;
    for (int j = 0; j < NX; ++j) {
      float s = 0.0f;
      for (int i = 0; i < NX; ++i) s += (x[i] - xn[i]) * Q[i * NX + j];
      cq += s * (x[j] - xn[j]);
    }
    for (int j = 0; j < NU; ++j) {
      float s = 0.0f;
      for (int i = 0; i < NU; ++i) s += (u[i] - u_nom(K, fl, i)) * R[i * NU + j];
      cr += s * (u[j] - u_nom(K, fl, j));
    }
    for (int r = 0; r < NS; ++r) {
      float mk, p, dp, d2p;
      soft_penalty(P, fl, r, w->soft[r], &mk, &p, &dp, &d2p);
      cp += mk * p;
    }
    acc_cost += (0.5f * cq + 0.5f * cr) + cp;
    float eq = 0.0f;
    for (int r = 0; r < NEQ; ++r) eq += fabsf(w->g[r] * w->mask[r]);
    acc_eq += eq;
    // RK2 next state (the flow at x + dt flow) and the defect to the next knot;
    // flow_dev leaves w->flow alone
    for (int i = 0; i < NX; ++i) w->xmid[i] = x[i] + dt * w->flow[i];
    flow_dev(K, w->xmid, u, w, w->k2);
    float def = 0.0f;
    for (int i = 0; i < NX; ++i)
      def += fabsf(x[NX + i] - (x[i] + (0.5f * dt) * (w->flow[i] + w->k2[i])));
    acc_def += def;
  }
  part[tid] = acc_cost;
  part[MERIT_THREADS + tid] = acc_def;
  part[2 * MERIT_THREADS + tid] = acc_eq;
  __syncthreads();
  if (tid == 0) {
    float c = 0.0f, d = 0.0f, e = 0.0f;
    for (int t = 0; t < MERIT_THREADS; ++t) {
      c += part[t];
      d += part[MERIT_THREADS + t];
      e += part[2 * MERIT_THREADS + t];
    }
    ocost[bc] = dt * c;
    ogm[bc] = d / n_knots + e / n_knots;
  }
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

extern "C" int hk_soa_merit(const float* consts, const float* params, const float* Q,
                            const float* R, const float* xs, const float* us,
                            const float* x_nom, const float* flags, const float* fpr,
                            const float* fvr, float* cost, float* g_metric, int batch,
                            int n_cand, int n_knots, float dt, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(soa_merit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(MERIT_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(batch) * n_cand;
  soa_merit_kernel<<<static_cast<unsigned>(blocks), MERIT_THREADS, MERIT_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      consts, params, Q, R, xs, us, x_nom, flags, fpr, fvr, cost, g_metric, n_cand, n_knots,
      dt);
  return static_cast<int>(cudaGetLastError());
}
