// B12: one update of the leg-odometry Kalman filter (18 states, 28
// measurements).
//
// Replaces hunter_bipedal_control_tpu/estim/kalman.py::kalman_update
// (:91-173): the relative foot kinematics at a zero base, the prediction,
// the contact-gated noise, the innovation and its 28 x 28 covariance, the
// solve (B6's gj_inverse use of :158-159), the update, the covariance's
// symmetrization and xy conditioning, as the port's
// estim/kalman.py::kalman_update_plain computes them.
//
// One 256-thread block per scenario, in seven phases over shared memory:
//   1. lane 0 runs the chain at a zero base (q = [0, zyx, joints], v = [0,
//      Euler rates of omega_world, joint rates]; rbd_dynamics.cuh); lane 32
//      the world acceleration R(quat -> zyx) a + g; 4 lanes the contact
//      gates 1 + (hs - 1)(1 - clamp(flag, 0, 1));
//   2. a lane per contact its point and J v (contact_columns); lanes per
//      entry Pm = A P A' + diag(q) with A = [I, dt I; 0, I] on the base
//      block; 18 lanes x_pred = A x + B accel;
//   3. 28 lanes the innovation ey = y - C x_pred, y = [-p_feet + radius
//      e_z (12), -v_feet (12), feet heights (4)]; lanes per entry the
//      tableau [Ssy | ey | C | 0], Ssy = C Pm C' + diag(r), and Pm C';
//      C (kalman.py::_structure_matrices) is implicit: row r < 12 is
//      e_{r mod 3} - e_{6 + r}, r < 24 e_{3 + (r - 12) mod 3}, r < 28
//      e_{8 + 3 (r - 24)};
//   4. the block's threads eliminate the tableau by gj.cuh's Gauss-Jordan
//      (pivots in the natural order, each + 1e-30, as the JAX package's
//      gj_inverse adds it), leaving [I | Ssy^-1 ey | Ssy^-1 C | 0]; the
//      inverse is never formed;
//   5. 18 lanes x_new = x_pred + Pm C' Ssy^-1 ey; lanes per entry
//      G = I - Pm C' Ssy^-1 C;
//   6. lanes per entry P_new = G Pm;
//   7. lanes per entry the symmetrized P_new, and where det of its xy
//      block > 1e-6 the xy conditioning (the xy rows and columns outside
//      the block zeroed, the block divided by 10).
// Nothing is clamped or branched on the data beyond the gates' clamp and
// the conditioning's test (a NaN det fails it, as in the plain version).
//
// Work: per scenario 383 floats in, 342 out.  The function needs ~55k
// floating-point operations per scenario (chip_smoke.py::kalman_cost), most
// of them the 28-row elimination; at B=1 the kernel is latency bound (28
// elimination steps of two barriers each).
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too; KalmanParams' eight scalars from one float32 buffer
// (estim/kalman.py::params_buffer).  True float32: no fast math.
#include <cuda_runtime.h>

#include "gj.cuh"
#include "rbd_dynamics.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NS = 18;          // states
constexpr int NM = 28;          // measurements
constexpr int TW = 2 * NM;      // tableau width: [Ssy | ey | C | 0]

// KalmanParams' fields in order (estim/kalman.py::params_buffer)
constexpr int P_RADIUS = 0, P_IMU_POS = 1, P_IMU_VEL = 2, P_FOOT_PROC = 3, P_FOOT_POS = 4,
              P_FOOT_VEL = 5, P_FOOT_H = 6, P_HS = 7, N_KF_PARAMS = 8;

// row r of C: its nonzero columns and coefficients; returns their count
__device__ __forceinline__ int c_row(int r, int* col, float* coef) {
  if (r < 12) {
    col[0] = r % 3;
    coef[0] = 1.0f;
    col[1] = 6 + r;
    coef[1] = -1.0f;
    return 2;
  }
  col[0] = r < 24 ? 3 + (r - 12) % 3 : 8 + 3 * (r - 24);
  coef[0] = 1.0f;
  return 1;
}

__device__ __forceinline__ float c_entry(int r, int j) {
  int col[2];
  float coef[2];
  const int n = c_row(r, col, coef);
  float v = 0.0f;
  for (int t = 0; t < n; ++t) v = col[t] == j ? coef[t] : v;
  return v;
}

__global__ void __launch_bounds__(THREADS)
kalman_update_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                     const float* __restrict__ gzyx, const float* __restrict__ gqj,
                     const float* __restrict__ gvj, const float* __restrict__ gom,
                     const float* __restrict__ gquat, const float* __restrict__ gacc,
                     const float* __restrict__ gfl, const float* __restrict__ gx,
                     const float* __restrict__ gPc, const float* __restrict__ gfh, float dt,
                     float* __restrict__ ox, float* __restrict__ oP) {
  __shared__ State s;
  __shared__ float K[N_CONSTS], P[N_KF_PARAMS];
  __shared__ float zyx[3], qj[NJ], vj[NJ], om[3], quat[4], accl[3], fl[NC], fh[NC];
  __shared__ float x[NS], Pc[NS][NS];
  __shared__ float acc[3], gate[NC], xp[NS], Pm[NS][NS];
  __shared__ float T[NM][TW];
  __shared__ float PmCt[NS][NM], G[NS][NS], Pn[NS][NS];
  __shared__ float colb[NM], prow[TW];

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  for (int i = tid; i < N_CONSTS; i += THREADS) K[i] = gK[i];
  for (int i = tid; i < NS * NS; i += THREADS) Pc[i / NS][i % NS] = gPc[b * NS * NS + i];
  if (tid < N_KF_PARAMS) P[tid] = gP[tid];
  if (tid < 3) {
    zyx[tid] = gzyx[b * 3 + tid];
    om[tid] = gom[b * 3 + tid];
    accl[tid] = gacc[b * 3 + tid];
  }
  if (tid < NJ) {
    qj[tid] = gqj[b * NJ + tid];
    vj[tid] = gvj[b * NJ + tid];
  }
  if (tid < NC) {
    quat[tid] = gquat[b * 4 + tid];
    fl[tid] = gfl[b * NC + tid];
    fh[tid] = gfh[b * NC + tid];
  }
  if (tid < NS) x[tid] = gx[b * NS + tid];
  __syncthreads();

  // ---- 1. the chain at a zero base, the world acceleration, the gates ----
  if (tid == 0) {
    float q[NQ];
    for (int a = 0; a < 3; ++a) {
      q[a] = 0.0f;
      q[3 + a] = zyx[a];
      s.v[a] = 0.0f;
    }
    for (int j = 0; j < NJ; ++j) {
      q[6 + j] = qj[j];
      s.v[6 + j] = vj[j];
    }
    euler_rates_dev(zyx, om, s.v + 3);
    state_chain(K, q, &s);
  } else if (tid == 32) {
    // quaternion (x, y, z, w) -> ZYX Euler -> world_R_body
    const float qx = quat[0], qy = quat[1], qz = quat[2], qw = quat[3];
    const float yaw = atan2f(2.0f * (qw * qz + qx * qy), 1.0f - 2.0f * (qy * qy + qz * qz));
    float sp = 2.0f * (qw * qy - qz * qx);
    sp = sp < -1.0f ? -1.0f : (sp > 1.0f ? 1.0f : sp);
    const float pitch = asinf(sp);
    const float roll = atan2f(2.0f * (qw * qx + qy * qz), 1.0f - 2.0f * (qx * qx + qy * qy));
    const float cz = cosf(yaw), sz = sinf(yaw), cy = cosf(pitch), sy = sinf(pitch);
    const float cx = cosf(roll), sx = sinf(roll);
    const float R[9] = {cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                        sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                        -sy,     cy * sx,                cy * cx};
    float a[3];
    mv3(R, accl, a);
    for (int i = 0; i < 3; ++i) acc[i] = a[i] + (i == 2 ? -GRAVITY : 0.0f);
  } else if (tid >= 64 && tid < 64 + NC) {
    const int c = tid - 64;
    float wc = fl[c];
    wc = wc < 0.0f ? 0.0f : (wc > 1.0f ? 1.0f : wc);
    gate[c] = 1.0f + (P[P_HS] - 1.0f) * (1.0f - wc);
  }
  __syncthreads();

  // ---- 2. the contacts, Pm, x_pred ----
  if (tid < NC) contact_columns(K, &s, tid);
  for (int e = tid; e < NS * NS; e += THREADS) {
    const int i = e / NS, j = e % NS;
    // (A P)[i][j], then (A P A')[i][j]
    const float ap = Pc[i][j] + (i < 3 ? dt * Pc[i + 3][j] : 0.0f);
    float apa = ap;
    if (j < 3) apa = apa + dt * (Pc[i][j + 3] + (i < 3 ? dt * Pc[i + 3][j + 3] : 0.0f));
    float qd = 0.0f;
    if (i == j) {
      if (i < 3) qd = (dt / 20.0f) * P[P_IMU_POS];
      else if (i < 6) qd = (dt * GRAVITY / 20.0f) * P[P_IMU_VEL];
      else qd = (dt * P[P_FOOT_PROC]) * gate[(i - 6) / 3];
    }
    Pm[i][j] = apa + qd;
  }
  if (tid >= 128 && tid < 128 + NS) {
    const int i = tid - 128;
    float v = x[i];
    if (i < 3) v = (v + dt * x[i + 3]) + (0.5f * dt * dt) * acc[i];
    else if (i < 6) v = v + dt * acc[i - 3];
    xp[i] = v;
  }
  __syncthreads();

  // ---- 3. the innovation, the tableau [Ssy | ey | C | 0], Pm C' ----
  if (tid < NM) {
    const int r = tid;
    float y;
    if (r < 12) y = -s.pc[r / 3][r % 3] + (r % 3 == 2 ? P[P_RADIUS] : 0.0f);
    else if (r < 24) y = -s.vc[(r - 12) / 3][(r - 12) % 3];
    else y = fh[r - 24];
    int col[2];
    float coef[2];
    const int n = c_row(r, col, coef);
    float cx = 0.0f;
    for (int t = 0; t < n; ++t) cx = cx + coef[t] * xp[col[t]];
    T[r][NM] = y - cx;
  }
  for (int e = tid; e < NM * TW; e += THREADS) {
    const int r = e / TW, j = e % TW;
    if (j < NM) {
      int cr[2], cs[2];
      float fr[2], fs[2];
      const int nr = c_row(r, cr, fr), ns = c_row(j, cs, fs);
      float acc2 = 0.0f;
      for (int u = 0; u < ns; ++u) {
        float cpm = 0.0f;   // (C Pm)[r][cs[u]]
        for (int t = 0; t < nr; ++t) cpm = cpm + fr[t] * Pm[cr[t]][cs[u]];
        acc2 = acc2 + fs[u] * cpm;
      }
      float rd = 0.0f;
      if (r == j) {
        if (r < 12) rd = P[P_FOOT_POS] * gate[r / 3];
        else if (r < 24) rd = P[P_FOOT_VEL] * gate[(r - 12) / 3];
        else rd = P[P_FOOT_H] * gate[r - 24];
      }
      T[r][j] = acc2 + rd;
    } else if (j > NM) {
      T[r][j] = j <= NM + NS ? c_entry(r, j - NM - 1) : 0.0f;
    }
  }
  for (int e = tid; e < NS * NM; e += THREADS) {
    const int i = e / NM, r = e % NM;
    int col[2];
    float coef[2];
    const int n = c_row(r, col, coef);
    float v = 0.0f;
    for (int t = 0; t < n; ++t) v = v + coef[t] * Pm[i][col[t]];
    PmCt[i][r] = v;
  }
  __syncthreads();

  // ---- 4. Gauss-Jordan on the tableau ----
  gj_eliminate_n<true>(&T[0][0], NM, TW, true, colb, prow, tid, THREADS);

  // ---- 5. x_new, G = I - Pm C' Ssy^-1 C ----
  if (tid < NS) {
    float v = 0.0f;
    for (int r = 0; r < NM; ++r) v = v + PmCt[tid][r] * T[r][NM];
    ox[b * NS + tid] = xp[tid] + v;
  }
  for (int e = tid; e < NS * NS; e += THREADS) {
    const int i = e / NS, j = e % NS;
    float v = 0.0f;
    for (int r = 0; r < NM; ++r) v = v + PmCt[i][r] * T[r][NM + 1 + j];
    G[i][j] = (i == j ? 1.0f : 0.0f) - v;
  }
  __syncthreads();

  // ---- 6. P_new = G Pm ----
  for (int e = tid; e < NS * NS; e += THREADS) {
    const int i = e / NS, j = e % NS;
    float v = 0.0f;
    for (int k = 0; k < NS; ++k) v = v + G[i][k] * Pm[k][j];
    Pn[i][j] = v;
  }
  __syncthreads();

  // ---- 7. symmetrization, xy conditioning ----
  const float p00 = Pn[0][0], p11 = Pn[1][1];
  const float p01 = 0.5f * (Pn[0][1] + Pn[1][0]);
  const bool cond = p00 * p11 - p01 * p01 > 1e-6f;
  for (int e = tid; e < NS * NS; e += THREADS) {
    const int i = e / NS, j = e % NS;
    float v = 0.5f * (Pn[i][j] + Pn[j][i]);
    if (cond) {
      if (i < 2 && j < 2) v = v / 10.0f;
      else if (i < 2 || j < 2) v = 0.0f;
    }
    oP[b * NS * NS + e] = v;
  }
}

}  // namespace

extern "C" int hk_kalman_update(const float* consts, const float* params, const float* zyx,
                                const float* joint_pos, const float* joint_vel,
                                const float* omega_world, const float* quat_xyzw,
                                const float* accel_local, const float* contact_flags,
                                const float* x_hat, const float* P, const float* feet_heights,
                                float* x_new, float* P_new, int batch, float dt, void* stream) {
  kalman_update_kernel<<<static_cast<unsigned>(batch), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      consts, params, zyx, joint_pos, joint_vel, omega_world, quat_xyzw, accel_local,
      contact_flags, x_hat, P, feet_heights, dt, x_new, P_new);
  return static_cast<int>(cudaGetLastError());
}
