// The compiled model of the SoA kernels: the Hunter biped's tree topology
// (nj = 10 joints, L = 11 links, nc = 4 contact frames), the layout of the
// constants buffer that ocp/soa_kernel.py::consts_buffer writes from
// models/soa.py::build_consts, the 3-vector / 3x3 helpers, and one state's
// kinematics (FK, world inertias, the CoM and the momentum about it, the
// base velocity from the centroidal momentum, the velocity pass) and its
// centroidal flow.  Shared by B1 (soa_linearize.cu), B8a (leg_ik.cu), B12
// (kalman_update.cu), B13 (sensing.cu), B14 (centroidal_flow.cu) and,
// through rbd_dynamics.cuh, B9-B11; soa_kernel.py::check_topology refuses a
// model whose topology differs from this one.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NJ = 10;
constexpr int L = 11;
constexpr int NC = 4;
constexpr float GRAVITY = 9.81f;

#define SOA_PARENT {0, 1, 2, 3, 4, 0, 6, 7, 8, 9}
#define SOA_CHILD {1, 2, 3, 4, 5, 6, 7, 8, 9, 10}
#define SOA_CPARENT {5, 10, 5, 10}
// ancestor mask (L x NJ): joint j moves link k
#define SOA_ANC {                                              \
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, {1, 0, 0, 0, 0, 0, 0, 0, 0, 0}, \
    {1, 1, 0, 0, 0, 0, 0, 0, 0, 0}, {1, 1, 1, 0, 0, 0, 0, 0, 0, 0}, \
    {1, 1, 1, 1, 0, 0, 0, 0, 0, 0}, {1, 1, 1, 1, 1, 0, 0, 0, 0, 0}, \
    {0, 0, 0, 0, 0, 1, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 1, 1, 0, 0, 0}, \
    {0, 0, 0, 0, 0, 1, 1, 1, 0, 0}, {0, 0, 0, 0, 0, 1, 1, 1, 1, 0}, \
    {0, 0, 0, 0, 0, 1, 1, 1, 1, 1}}

const int h_parent[NJ] = SOA_PARENT;
const int h_child[NJ] = SOA_CHILD;
const int h_cparent[NC] = SOA_CPARENT;
const int h_anc[L][NJ] = SOA_ANC;
__constant__ int c_parent[NJ] = SOA_PARENT;
__constant__ int c_child[NJ] = SOA_CHILD;
__constant__ int c_cparent[NC] = SOA_CPARENT;
__constant__ int c_anc[L][NJ] = SOA_ANC;

// constants buffer layout (ocp/soa_kernel.py::consts_buffer writes it)
constexpr int K_OPOS = 0;                 // (NJ, 3) joint origin positions
constexpr int K_OROT = K_OPOS + NJ * 3;   // (NJ, 9) joint origin rotations
constexpr int K_AXIS = K_OROT + NJ * 9;   // (NJ, 3) joint axes
constexpr int K_RK = K_AXIS + NJ * 3;     // (NJ, 9) skew(axis)
constexpr int K_RKK = K_RK + NJ * 9;      // (NJ, 9) skew(axis)^2
constexpr int K_COML = K_RKK + NJ * 9;    // (L, 3) link CoMs
constexpr int K_MASS = K_COML + L * 3;    // (L,) link masses
constexpr int K_INER = K_MASS + L;        // (L, 9) link inertias
constexpr int K_CPOS = K_INER + L * 9;    // (NC, 3) contact offsets
constexpr int K_M = K_CPOS + NC * 3;      // total mass
constexpr int K_INVM = K_M + 1;           // 1 / total mass
constexpr int K_MSUB = K_INVM + 1;        // (NJ,) subtree masses
constexpr int N_CONSTS = K_MSUB + NJ;

// ---------------------------------------------------------------------------
// 3-vector / 3x3 helpers (row-major); outputs may not alias inputs
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void mv3(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float tr3(const float* M) { return M[0] + M[4] + M[8]; }

// closed-form 3x3 inverse via the adjugate (soa.py::inv3)
__device__ void inv3(const float* M, float* out) {
  const float c00 = M[4] * M[8] - M[5] * M[7];
  const float c01 = M[5] * M[6] - M[3] * M[8];
  const float c02 = M[3] * M[7] - M[4] * M[6];
  const float det = M[0] * c00 + M[1] * c01 + M[2] * c02;
  const float inv_det = 1.0f / det;
  const float c10 = M[2] * M[7] - M[1] * M[8];
  const float c11 = M[0] * M[8] - M[2] * M[6];
  const float c12 = M[1] * M[6] - M[0] * M[7];
  const float c20 = M[1] * M[5] - M[2] * M[4];
  const float c21 = M[2] * M[3] - M[0] * M[5];
  const float c22 = M[0] * M[4] - M[1] * M[3];
  out[0] = inv_det * c00; out[1] = inv_det * c10; out[2] = inv_det * c20;
  out[3] = inv_det * c01; out[4] = inv_det * c11; out[5] = inv_det * c21;
  out[6] = inv_det * c02; out[7] = inv_det * c12; out[8] = inv_det * c22;
}

// ---------------------------------------------------------------------------
// one state's kinematics (B1 and B9)
// ---------------------------------------------------------------------------

// euler-rate map E (omega = E dtheta_zyx) from the trig cache
__device__ __forceinline__ void euler_E(const float* trig, float* E) {
  const float cz = trig[0], sz = trig[1], cy = trig[2], sy = trig[3];
  E[0] = 0.0f; E[1] = -sz; E[2] = cz * cy;
  E[3] = 0.0f; E[4] = cz;  E[5] = sz * cy;
  E[6] = 1.0f; E[7] = 0.0f; E[8] = -sy;
}

// one state's kinematics: FK, world inertias, the base momentum block and
// the base velocity (soa.py::combined_rows / flow)
struct Kin {
  float R[L][9];        // world_R_link
  float p[L][3];        // link origins
  float com[L][3];      // link CoMs (world)
  float aw[NJ][3];      // joint axes (world)
  float anchor[NJ][3];  // joint anchors (world)
  float trig[4];        // cz, sz, cy, sy of the base euler angles
  float Iw[L][9];       // world inertias
  float pcom[3];
  float om[L][3];       // full velocity pass (scratch of the joint-only pass first)
  float vo[L][3];
  float A12[9], GE[9], iGE[9];
  float vb[6];          // base velocity [p_dot; theta_dot]
};

__device__ void fk_dev(const float* K, const float* q, Kin* w) {
  const float cz = cosf(q[3]), sz = sinf(q[3]);
  const float cy = cosf(q[4]), sy = sinf(q[4]);
  const float cx = cosf(q[5]), sx = sinf(q[5]);
  w->trig[0] = cz; w->trig[1] = sz; w->trig[2] = cy; w->trig[3] = sy;
  float* R0 = w->R[0];
  R0[0] = cz * cy; R0[1] = cz * sy * sx - sz * cx; R0[2] = cz * sy * cx + sz * sx;
  R0[3] = sz * cy; R0[4] = sz * sy * sx + cz * cx; R0[5] = sz * sy * cx - cz * sx;
  R0[6] = -sy;     R0[7] = cy * sx;                R0[8] = cy * cx;
  w->p[0][0] = q[0]; w->p[0][1] = q[1]; w->p[0][2] = q[2];
  for (int j = 0; j < NJ; ++j) {
    const int par = c_parent[j], ch = c_child[j];
    float Ror[9], t[3], rod[9];
    mm3(w->R[par], K + K_OROT + 9 * j, Ror);
    mv3(w->R[par], K + K_OPOS + 3 * j, t);
    float por[3];
    for (int i = 0; i < 3; ++i) por[i] = w->p[par][i] + t[i];
    mv3(Ror, K + K_AXIS + 3 * j, w->aw[j]);
    const float cj = cosf(q[6 + j]), sj = sinf(q[6 + j]);
    const float u = 1.0f - cj;
    for (int e = 0; e < 9; ++e)
      rod[e] = ((e % 4 == 0) ? 1.0f : 0.0f) + sj * K[K_RK + 9 * j + e] + u * K[K_RKK + 9 * j + e];
    mm3(Ror, rod, w->R[ch]);
    for (int i = 0; i < 3; ++i) {
      w->p[ch][i] = por[i];
      w->anchor[j][i] = por[i];
    }
  }
  for (int k = 0; k < L; ++k) {
    float t[3];
    mv3(w->R[k], K + K_COML + 3 * k, t);
    for (int i = 0; i < 3; ++i) w->com[k][i] = w->p[k][i] + t[i];
  }
}

// ---------------------------------------------------------------------------
// the chain per leg (B9): the tree is the base and two legs of NJ / 2 joints,
// joint j of leg g = j / LEG_JOINTS with parent link j (the base for the
// leg's first joint) and child link j + 1 (SOA_PARENT, SOA_CHILD)
// ---------------------------------------------------------------------------

constexpr int LEG_JOINTS = NJ / 2;

// the base's trig cache (cz, sz, cy, sy), rotation and position from q
// (fk_dev's first lines)
__device__ __forceinline__ void base_pose_dev(const float* q, float* trig, float* R0,
                                              float* p0) {
  const float cz = cosf(q[3]), sz = sinf(q[3]);
  const float cy = cosf(q[4]), sy = sinf(q[4]);
  const float cx = cosf(q[5]), sx = sinf(q[5]);
  trig[0] = cz; trig[1] = sz; trig[2] = cy; trig[3] = sy;
  R0[0] = cz * cy; R0[1] = cz * sy * sx - sz * cx; R0[2] = cz * sy * cx + sz * sx;
  R0[3] = sz * cy; R0[4] = sz * sy * sx + cz * cx; R0[5] = sz * sy * cx - cz * sx;
  R0[6] = -sy;     R0[7] = cy * sx;                R0[8] = cy * cx;
  p0[0] = q[0]; p0[1] = q[1]; p0[2] = q[2];
}

// joint j's local transform at angle qj: T = R_origin rod(qj) (Rodrigues)
// and its axis in the parent's frame, a = R_origin axis (9 + 3 floats)
__device__ __forceinline__ void joint_local_dev(const float* K, int j, float qj, float* T,
                                                float* a) {
  const float cj = cosf(qj), sj = sinf(qj);
  const float u = 1.0f - cj;
  float rod[9];
  for (int e = 0; e < 9; ++e)
    rod[e] = ((e % 4 == 0) ? 1.0f : 0.0f) + sj * K[K_RK + 9 * j + e] + u * K[K_RKK + 9 * j + e];
  mm3(K + K_OROT + 9 * j, rod, T);
  mv3(K + K_OROT + 9 * j, K + K_AXIS + 3 * j, a);
}

// leg g's chain from the base's rotation R0 and position p0 and its velocity
// om0, vo0 (zeros for the base-fixed pass) with joint velocities vj, given
// each joint's local transform T (9 floats a joint) and axis a (3):
// the leg's links' R, p, com, om, vo and its joints' aw, anchor into w, the
// running frame kept in registers; per joint R_child = R T, p_child = p + R
// origin, aw = R a on the chain (fk_dev's products regrouped, its velocity
// pass's arithmetic)
__device__ void leg_chain_dev(const float* K, const float* T, const float* a, const float* vj,
                              int g, const float* R0, const float* p0, const float* om0,
                              const float* vo0, Kin* w) {
  float R[9], p[3], om[3], vo[3];
  for (int e = 0; e < 9; ++e) R[e] = R0[e];
  for (int i = 0; i < 3; ++i) {
    p[i] = p0[i];
    om[i] = om0[i];
    vo[i] = vo0[i];
  }
#pragma unroll 1
  for (int n = 0; n < LEG_JOINTS; ++n) {
    const int j = LEG_JOINTS * g + n, ch = j + 1;
    float t[3], por[3], aw[3], Rc[9];
    mv3(R, K + K_OPOS + 3 * j, t);
    mv3(R, a + 3 * j, aw);
    mm3(R, T + 9 * j, Rc);
    for (int i = 0; i < 3; ++i) por[i] = p[i] + t[i];
    float dp[3], c[3];
    for (int i = 0; i < 3; ++i) dp[i] = por[i] - p[i];
    cross3(om, dp, c);
    for (int i = 0; i < 3; ++i) {
      vo[i] = vo[i] + c[i];
      om[i] = om[i] + vj[j] * aw[i];
      p[i] = por[i];
    }
    for (int e = 0; e < 9; ++e) R[e] = Rc[e];
    float tc[3];
    mv3(R, K + K_COML + 3 * ch, tc);
    for (int e = 0; e < 9; ++e) w->R[ch][e] = R[e];
    for (int i = 0; i < 3; ++i) {
      w->p[ch][i] = p[i];
      w->anchor[j][i] = p[i];
      w->aw[j][i] = aw[i];
      w->com[ch][i] = p[i] + tc[i];
      w->om[ch][i] = om[i];
      w->vo[ch][i] = vo[i];
    }
  }
}

// link k's world inertia R I R^T (world_inertias_dev's for one link)
__device__ __forceinline__ void link_inertia_world(const float* K, const float* R, int k,
                                                   float* Iw) {
  float RI[9];
  mm3(R, K + K_INER + 9 * k, RI);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Iw[3 * i + j] = RI[3 * i] * R[3 * j] + RI[3 * i + 1] * R[3 * j + 1]
                      + RI[3 * i + 2] * R[3 * j + 2];
}

// world inertias R I R^T of every link
__device__ void world_inertias_dev(const float* K, Kin* w) {
  for (int k = 0; k < L; ++k) {
    float RI[9];
    mm3(w->R[k], K + K_INER + 9 * k, RI);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        w->Iw[k][3 * i + j] = RI[3 * i] * w->R[k][3 * j] + RI[3 * i + 1] * w->R[k][3 * j + 1]
                              + RI[3 * i + 2] * w->R[k][3 * j + 2];
  }
}

// the whole-body CoM w->pcom from the link CoMs
__device__ void com_position_dev(const float* K, Kin* w) {
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < L; ++k)
    for (int i = 0; i < 3; ++i) acc[i] = acc[i] + K[K_MASS + k] * w->com[k][i];
  for (int i = 0; i < 3; ++i) w->pcom[i] = K[K_INVM] * acc[i];
}

// the momentum of the velocity pass in w->om / w->vo about the CoM w->pcom
// (after world_inertias_dev): hl = sum_k m_k c_dot_k,
// ha = sum_k I_k w_k + (c_k - p_com) x m_k c_dot_k
__device__ void momentum_about_com_dev(const float* K, const Kin* w, float* hl, float* ha) {
  for (int i = 0; i < 3; ++i) hl[i] = ha[i] = 0.0f;
  for (int k = 0; k < L; ++k) {
    const float mk = K[K_MASS + k];
    float r1[3], c[3], cdot[3], r[3], t[3], cr[3];
    for (int i = 0; i < 3; ++i) r1[i] = w->com[k][i] - w->p[k][i];
    cross3(w->om[k], r1, c);
    for (int i = 0; i < 3; ++i) {
      cdot[i] = w->vo[k][i] + c[i];
      hl[i] = hl[i] + mk * cdot[i];
      r[i] = w->com[k][i] - w->pcom[i];
    }
    mv3(w->Iw[k], w->om[k], t);
    cross3(r, cdot, cr);
    for (int i = 0; i < 3; ++i) ha[i] = (ha[i] + t[i]) + mk * cr[i];
  }
}

// CoM, world inertias, base momentum block and the base velocity solving
// Ab vb = m h - Aj vj (soa.py::base_velocity_from_momentum); leaves the
// joint-only velocity pass in w->om / w->vo
__device__ void base_velocity_dev(const float* K, const float* h, const float* vj, Kin* w) {
  const float m = K[K_M], inv_m = K[K_INVM];
  com_position_dev(K, w);
  world_inertias_dev(K, w);
  // joint momentum by a base-fixed velocity pass
  for (int i = 0; i < 3; ++i) w->om[0][i] = w->vo[0][i] = 0.0f;
  for (int j = 0; j < NJ; ++j) {
    const int par = c_parent[j], ch = c_child[j];
    float dp[3], c[3];
    for (int i = 0; i < 3; ++i) dp[i] = w->anchor[j][i] - w->p[par][i];
    cross3(w->om[par], dp, c);
    for (int i = 0; i < 3; ++i) {
      w->vo[ch][i] = w->vo[par][i] + c[i];
      w->om[ch][i] = w->om[par][i] + vj[j] * w->aw[j][i];
    }
  }
  float hl[3], ha[3];
  momentum_about_com_dev(K, w, hl, ha);
  // base block: GE = (Itot + tr(W) I - W) E, A12 = -m skew(pcom - pb) E
  float Itot[9], W[9], E[9], G[9];
  for (int e = 0; e < 9; ++e) Itot[e] = W[e] = 0.0f;
  for (int k = 0; k < L; ++k) {
    float d[3], r[3];
    for (int i = 0; i < 3; ++i) {
      d[i] = w->com[k][i] - w->p[0][i];
      r[i] = w->com[k][i] - w->pcom[i];
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        Itot[3 * i + j] = Itot[3 * i + j] + w->Iw[k][3 * i + j];
        W[3 * i + j] = W[3 * i + j] + K[K_MASS + k] * (d[i] * r[j]);
      }
  }
  const float trW = tr3(W);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      G[3 * i + j] = (Itot[3 * i + j] + (i == j ? trW : 0.0f)) - W[3 * i + j];
  euler_E(w->trig, E);
  mm3(G, E, w->GE);
  float s[3], sk[9], sE[9];
  for (int i = 0; i < 3; ++i) s[i] = w->pcom[i] - w->p[0][i];
  sk[0] = 0.0f;  sk[1] = -s[2]; sk[2] = s[1];
  sk[3] = s[2];  sk[4] = 0.0f;  sk[5] = -s[0];
  sk[6] = -s[1]; sk[7] = s[0];  sk[8] = 0.0f;
  mm3(sk, E, sE);
  for (int e = 0; e < 9; ++e) w->A12[e] = -m * sE[e];
  inv3(w->GE, w->iGE);
  float rl[3], ra[3], x2[3], t[3];
  for (int i = 0; i < 3; ++i) {
    rl[i] = m * h[i] - hl[i];
    ra[i] = m * h[3 + i] - ha[i];
  }
  mv3(w->iGE, ra, x2);
  mv3(w->A12, x2, t);
  for (int i = 0; i < 3; ++i) {
    w->vb[i] = inv_m * (rl[i] - t[i]);
    w->vb[3 + i] = x2[i];
  }
}

// the full velocity pass: every link's angular velocity w->om and origin
// velocity w->vo from the base velocity vb = [p_dot; theta_dot] and the
// joint velocities vj (vb may be w->vb)
__device__ void velocity_pass_dev(const float* vb, const float* vj, Kin* w) {
  float E[9];
  euler_E(w->trig, E);
  mv3(E, vb + 3, w->om[0]);
  for (int i = 0; i < 3; ++i) w->vo[0][i] = vb[i];
  for (int j = 0; j < NJ; ++j) {
    const int par = c_parent[j], ch = c_child[j];
    float dp[3], c[3];
    for (int i = 0; i < 3; ++i) dp[i] = w->anchor[j][i] - w->p[par][i];
    cross3(w->om[par], dp, c);
    for (int i = 0; i < 3; ++i) {
      w->vo[ch][i] = w->vo[par][i] + c[i];
      w->om[ch][i] = w->om[par][i] + vj[j] * w->aw[j][i];
    }
  }
}

// ---------------------------------------------------------------------------
// the centroidal flow (soa.py::flow; B1's merit and midpoint, B14's RK2)
// ---------------------------------------------------------------------------

// one state's kinematics and its contact points
struct FlowKin : Kin {
  float pc[NC][3];
};

__device__ void contact_points_dev(const float* K, FlowKin* w) {
  for (int c = 0; c < NC; ++c) {
    const int k = c_cparent[c];
    float t[3];
    mv3(w->R[k], K + K_CPOS + 3 * c, t);
    for (int i = 0; i < 3; ++i) w->pc[c][i] = w->p[k][i] + t[i];
  }
}

// centroidal flow rows [hdot_lin; hdot_ang; vb; vj] from pc, pcom, vb
__device__ void flow_rows_dev(const float* K, const float* u, const FlowKin* w, float* out) {
  const float inv_m = K[K_INVM];
  float fs[3], ha[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 3; ++i) fs[i] = ((u[i] + u[3 + i]) + u[6 + i]) + u[9 + i];
  for (int c = 0; c < NC; ++c) {
    float r[3], cr[3];
    for (int i = 0; i < 3; ++i) r[i] = w->pc[c][i] - w->pcom[i];
    cross3(r, u + 3 * c, cr);
    for (int i = 0; i < 3; ++i) ha[i] = ha[i] + cr[i];
  }
  out[0] = inv_m * fs[0];
  out[1] = inv_m * fs[1];
  out[2] = inv_m * fs[2] + (-GRAVITY);
  for (int i = 0; i < 3; ++i) out[3 + i] = inv_m * ha[i];
  for (int i = 0; i < 6; ++i) out[6 + i] = w->vb[i];
  for (int j = 0; j < NJ; ++j) out[12 + j] = u[12 + j];
}

// soa.py::flow at (x, u) into out; uses w's kinematic fields as scratch
__device__ void flow_dev(const float* K, const float* x, const float* u, FlowKin* w,
                         float* out) {
  fk_dev(K, x + 6, w);
  base_velocity_dev(K, x, u + 3 * NC, w);
  contact_points_dev(K, w);
  flow_rows_dev(K, u, w, out);
}

}  // namespace
