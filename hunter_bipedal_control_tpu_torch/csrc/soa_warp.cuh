// One knot's centroidal flow and row terms on a warp's lanes: the warp-level
// forms of soa_model.cuh's kinematics and soa_rows.cuh's rows, shared by B15
// (ddp_rollout.cu: the rollouts' row pass and integrator stages) and B1
// (soa_linearize.cu: the linearization's primal chain and midpoint flow, the
// merit's rows and flows).
//
// A flow on a warp (B9's kinematics): the joints' local transforms on lanes
// 0-9 and the base on lane 10, the two legs' chains side by side, three lanes
// each (lane 3 g + i a row of the running rotation, soa_model.cuh::
// leg_chain_dev's products row by row, with the base-fixed velocity pass),
// the 11 links' world inertias, CoM, momentum and base-block terms on their
// own lanes summed by half-warp shuffles, the base block's 3x3 inverse on
// every lane of the lower half, the contact points on lanes 16-19
// meanwhile, the contact torques on lanes 0-3; the row pass adds the contact
// links' full velocities (om = w0 + om_j, vo = v0 + w0 x (p - p0) + vo_j) and
// the contact velocities on lanes 0-3, the 16 equality rows on lanes 0-15
// and the 36 soft rows with their penalties over the lanes.  The FK's
// products are regrouped (R (R_origin rod), as B9's chain does) and the sums
// are shuffle trees, so the flows and costs differ from the scalar chain's
// (soa_model.cuh's fk_dev, base_velocity_dev, flow_dev) by float32
// rounding.
//
// Each caller keeps the model's constants (K, and the joints' axes in their
// parents' frames) where its block shares them, and each warp's state (the
// kinematics, the joints' local transforms, the state and input a flow
// reads, the contact velocities) in its own layout; the functions take
// pointers to both.
#pragma once

#include "soa_rows.cuh"

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(NX <= LANES && NU <= LANES && NEQ <= LANES, "a lane per component");
static_assert(L <= 16 && NC <= 4, "a half warp per link, four contact lanes");

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

// one of six values by a lane's index 0..5, without local memory
__device__ __forceinline__ float pick6(const float* v, int i) {
  float r = v[0];
#pragma unroll
  for (int e = 1; e < 6; ++e) r = i == e ? v[e] : r;
  return r;
}

// the joints' axes in their parents' frames, R_origin axis (lanes 0-9)
__device__ __forceinline__ void joint_axes(const float* K, float (*axis)[3], int tid) {
  if (tid < NJ) mv3(K + K_OROT + 9 * tid, K + K_AXIS + 3 * tid, axis[tid]);
}

// the phase marks a flow makes on the row pass, for a caller's clock build:
// after the chains, after the base velocity, after the contact velocities
enum { FLOW_FK, FLOW_BASE, FLOW_VEL };

// what a flow leaves besides its outputs and the kinematics in FlowKin:
// nothing.  A caller that needs more passes a type with these two hooks:
// base() on every lane once the base velocity is known (the values are
// those of the lower half's lanes), inertia() on each link's lane (< L)
// with its world inertia.
struct KeepNone {
  __device__ __forceinline__ void base(int, const float*, const float*, const float*,
                                       const float*, const float*) const {}
  __device__ __forceinline__ void inertia(int, const float*) const {}
};

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

// soa.py::flow at (x, u) on one warp: lane i (< NX) returns component i.
// K and axis: the model's constants and the joints' axes (joint_axes);
// T: the warp's joints' local transforms; k: its kinematics (base-fixed
// velocity pass in om / vo).  ROWS (the row pass) also leaves the contact
// points in k.pc and the contact velocities in vc, and marks ck's phases
// (ck.flow(FLOW_*)).  Starts and ends with a warp barrier, so the caller may
// write x before and after.
template <bool ROWS, class Marks, class Keep = KeepNone>
__device__ float warp_flow(const float* K, const float (*axis)[3], const float* x,
                           const float* u, float (*T)[9], FlowKin& k, float (*vc)[3], int lane,
                           Marks& ck, const Keep& keep = Keep()) {
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
    mm3(K + K_OROT + 9 * lane, rod, T[lane]);
  } else if (lane == NJ) {
    float t[3];
    mv3(R0, K + K_COML, t);
    for (int e = 0; e < 9; ++e) k.R[0][e] = R0[e];
    for (int i = 0; i < 3; ++i) {
      k.p[0][i] = p0[i];
      k.com[0][i] = p0[i] + t[i];
      k.om[0][i] = k.vo[0][i] = 0.0f;
    }
  }
  __syncwarp();
  // the legs' chains side by side, with the base-fixed velocity pass
  chains_warp(K, T, axis, u + 3 * NC, lane, R0, p0, &k);
  __syncwarp();
  if constexpr (ROWS) ck.flow(FLOW_FK);
  // per link (lanes 0-10): its world inertia and m c; the contact points
  // (lanes 16-19)
  const int kl = lane;
  const float mk = lane < L ? K[K_MASS + kl] : 0.0f;
  float mc[3] = {0.0f, 0.0f, 0.0f}, Iw[9];
  if (lane < L) {
    link_inertia_world(K, k.R[kl], kl, Iw);
    keep.inertia(lane, Iw);
    for (int a = 0; a < 3; ++a) mc[a] = mk * k.com[kl][a];
  } else if (lane >= 16 && lane < 16 + NC) {
    const int c = lane - 16, kk = c_cparent[c];
    float t[3];
    mv3(k.R[kk], K + K_CPOS + 3 * c, t);
    for (int a = 0; a < 3; ++a) k.pc[c][a] = k.p[kk][a] + t[a];
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
    for (int a = 0; a < 3; ++a) r1[a] = k.com[kl][a] - k.p[kl][a];
    cross3(k.om[kl], r1, c);
    for (int a = 0; a < 3; ++a) {
      cdot[a] = k.vo[kl][a] + c[a];
      r[a] = k.com[kl][a] - pcom[a];
      d[a] = k.com[kl][a] - p0[a];
    }
    mv3(Iw, k.om[kl], t);
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
  keep.base(lane, trig, pcom, iGE, A12, vb);
  if constexpr (ROWS) ck.flow(FLOW_BASE);
  __syncwarp();  // the contact points
  // the contact forces' torques about the CoM (lanes 0-3, summed)
  float tq[3] = {0.0f, 0.0f, 0.0f};
  if (lane < NC) {
    float r[3];
    for (int a = 0; a < 3; ++a) r[a] = k.pc[lane][a] - pcom[a];
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
        om[a] = w0[a] + k.om[kk][a];
        dp[a] = k.p[kk][a] - p0[a];
      }
      cross3(w0, dp, c);
      for (int a = 0; a < 3; ++a) {
        vo[a] = (vb[a] + c[a]) + k.vo[kk][a];
        d[a] = k.pc[lane][a] - k.p[kk][a];
      }
      cross3(om, d, cv);
      for (int a = 0; a < 3; ++a) vc[lane][a] = vo[a] + cv[a];
    }
    ck.flow(FLOW_VEL);
  }
  __syncwarp();
  return out;
}

// equality row r (< NEQ, soa.py::combined_rows' order: foot r / 4, its
// three velocity rows and its swing row) before masking, and its mask, from
// the row pass's contact points pc and velocities vc
__device__ __forceinline__ float eq_row(const float* P, const float* fl, const float* fpr,
                                        const float* fvr, const float* u, const float (*pc)[3],
                                        const float (*vc)[3], int r, float* mask_out) {
  const int c = r / 4, a = r % 4;
  const bool stance = fl[c] > 0.5f;
  float g, mask = 1.0f;
  if (a < 3) {
    const float zv = a < 2 ? vc[c][a] : vc[c][2] + P[P_XY_GAIN] * (pc[c][2] - P[P_Z_REF]);
    g = stance ? zv : u[3 * c + a];
  } else {
    const float nv = (vc[c][2] - fvr[3 * c + 2]) + P[P_POS_GAIN] * (pc[c][2] - fpr[3 * c + 2]);
    g = stance ? 0.0f : nv;
    mask = stance ? 0.0f : 1.0f;
  }
  *mask_out = mask;
  return g;
}

// the soft row r's value h (soa.py::combined_rows' order: cone, xy, qj, vj, fz)
__device__ __forceinline__ float soft_value(const float* P, const float* fpr, const float* fvr,
                                            const float* x, const float* u,
                                            const float (*pc)[3], const float (*vc)[3], int r) {
  if (r < NC) {
    const float f0 = u[3 * r], f1 = u[3 * r + 1];
    return P[P_MU_C] * u[3 * r + 2] - sqrtf(f0 * f0 + f1 * f1 + P[P_CONE_REG]);
  }
  if (r < 4 + 2 * NC) {
    const int c = (r - 4) / 2, a = (r - 4) % 2;
    return (vc[c][a] - fvr[3 * c + a]) + P[P_XY_GAIN] * (pc[c][a] - fpr[3 * c + a]);
  }
  if (r < 4 + 2 * NC + NJ) return x[12 + r - 4 - 2 * NC];
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
// and sum mask p over the 36 soft rows (lane r and r + 32), warp sums; the
// knot's references fl, fpr, fvr, the row pass's pc and vc
__device__ __forceinline__ void row_terms(const float* P, const float* fl, const float* fpr,
                                          const float* fvr, const float* x, const float* u,
                                          const float (*pc)[3], const float (*vc)[3], int lane,
                                          float* eq, float* cp) {
  float e = 0.0f;
  if (lane < NEQ) {
    float mask;
    const float g = eq_row(P, fl, fpr, fvr, u, pc, vc, lane, &mask);
    e = fabsf(g * mask);
  }
  *eq = warp_sum(e);
  // soft row `lane` and, on lanes 0-3, row lane + 32, both on one pass
  const int r2 = lane + LANES < NS ? lane + LANES : lane;
  float mk1, mk2;
  const float p1 = soft_mask_penalty(P, fl, lane, soft_value(P, fpr, fvr, x, u, pc, vc, lane),
                                     &mk1);
  const float p2 = soft_mask_penalty(P, fl, r2, soft_value(P, fpr, fvr, x, u, pc, vc, r2), &mk2);
  *cp = warp_sum(lane + LANES < NS ? mk1 * p1 + mk2 * p2 : mk1 * p1);
}

// the stage cost's quadratic forms 0.5 dx'Q dx + 0.5 du'R du with dx, du
// one component a lane (d, du: the warp's rows, lane's slot written), as
// (Q' dx)_j dx_j on lane j summed by shuffles; Q, R row-major, nx = nu = 22
__device__ __forceinline__ float quad_forms(const float* Q, const float* R, const float* d,
                                            const float* du, int lane) {
  float tq = 0.0f, tr = 0.0f;
  if (lane < NX) {
    float sq = 0.0f, sr = 0.0f;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      sq += d[i] * Q[i * NX + lane];
      sr += du[i] * R[i * NU + lane];
    }
    tq = sq * d[lane];
    tr = sr * du[lane];
  }
  return 0.5f * warp_sum(tq) + 0.5f * warp_sum(tr);
}

}  // namespace
