// One knot's primal rows on the SoA model (soa.py::combined_rows,
// ocp/problem.py's stage cost): the OCP parameters buffer's layout
// (ocp/soa_kernel.py::params_buffer writes it), a knot's primal quantities
// (the flow, the 16 equality rows and their masks), the soft rows'
// penalties and the weight-compensating input.  Shared by B1
// (soa_linearize.cu) and B15 (ddp_rollout.cu) through soa_warp.cuh, which
// forms the rows on a warp's lanes.
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
// one knot's primal quantities (soa.py::combined_rows / flow) as B1's chain
// leaves them (soa_linearize.cu::chain_warp); the state's kinematics (Kin)
// and the flow (FlowKin) are soa_model.cuh's
// ---------------------------------------------------------------------------

struct Rows : FlowKin {
  float vc[NC][3];
  float flow[NX];
  float g[NEQ];         // equality rows before masking
  float mask[NEQ];
};

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

}  // namespace
