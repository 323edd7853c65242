// One knot's primal rows and stage cost on the SoA model (soa.py::
// combined_rows, ocp/problem.py's stage cost): the OCP parameters buffer's
// layout (ocp/soa_kernel.py::params_buffer writes it), the flow, the 16
// equality rows and their masks, the 36 soft rows and their penalties, the
// weight-compensating input and the stage cost.  Shared by B1
// (soa_linearize.cu) and B15 (ddp_rollout.cu).
#pragma once

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

struct Rows : FlowKin {
  float vc[NC][3];
  float flow[NX];
  float g[NEQ];         // equality rows before masking
  float mask[NEQ];
  float soft[NS];
};

// soa.py::combined_rows at one knot: every primal quantity into w
__device__ void combined_rows_dev(const float* K, const float* P, const float* x,
                                  const float* u, const float* flags, const float* fpr,
                                  const float* fvr, Rows* w) {
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

// the stage cost 0.5 dx'Q dx + 0.5 du'R du + sum mask p at one knot, from
// the rows combined_rows_dev left in w (x_nom xn, flags fl)
__device__ float stage_cost_dev(const float* K, const float* P, const float* Q, const float* R,
                                const float* x, const float* u, const float* xn,
                                const float* fl, const Rows* w) {
  float dx[NX], du[NU];
  for (int i = 0; i < NX; ++i) dx[i] = x[i] - xn[i];
  for (int i = 0; i < NU; ++i) du[i] = u[i] - u_nom(K, fl, i);
  float cq = 0.0f, cr = 0.0f, cp = 0.0f;
  for (int j = 0; j < NX; ++j) {
    float s = 0.0f;
    for (int i = 0; i < NX; ++i) s += dx[i] * Q[i * NX + j];
    cq += s * dx[j];
  }
  for (int j = 0; j < NU; ++j) {
    float s = 0.0f;
    for (int i = 0; i < NU; ++i) s += du[i] * R[i * NU + j];
    cr += s * du[j];
  }
  for (int r = 0; r < NS; ++r) {
    float mk, p, dp, d2p;
    soft_penalty(P, fl, r, w->soft[r], &mk, &p, &dp, &d2p);
    cp += mk * p;
  }
  return (0.5f * cq + 0.5f * cr) + cp;
}

}  // namespace
