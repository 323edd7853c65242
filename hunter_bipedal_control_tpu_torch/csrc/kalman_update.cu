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
// Design: a warp per scenario at every batch, four scenarios a block (the
// grid's last block may hold fewer); each warp works in its own shared
// memory with __syncwarp between phases and no block barrier:
//   1. P, x, the sensors, the chain's constants and KalmanParams to the
//      warp's shared memory, coalesced (one global latency);
//   2. the chain at a zero base: one sincosf on lanes 0-15 (the joint
//      angles, the base's zyx, the yaw, pitch and roll of the IMU
//      quaternion); a lane per joint its local transform T = R_origin
//      rod(q_j) and axis R_origin a_j, lane 10 E(zyx) and the Euler rates of
//      omega_world, lane 11 the world acceleration R(quat) a + g, lanes 12-15
//      the contact gates 1 + (hs - 1)(1 - clamp(flag, 0, 1)); then the two
//      legs side by side on three lanes each, a row of the running rotation
//      a lane (soa_model.cuh::leg_chain_dev's products row by row): the
//      joints' anchors and world axes and the four contact points.  Only
//      what the filter reads is formed: no velocity pass, world inertia,
//      dE/dt, dJ/dt v or stored Jacobian;
//   3. each contact's J v on eight lanes, two of its 13 Euler-rate and joint
//      columns a lane (a joint of the other leg enters as its column times
//      0, as in the plain version, so a NaN spreads as it does there),
//      summed by shuffles; the measurement y = [-p_feet + radius e_z (12),
//      -v_feet (12), feet heights (4)];
//   4. Pm = A P A' + diag(q) with A = [I, dt I; 0, I] on the base block, by
//      rows on lanes 0-17, and x_pred = A x + B accel;
//   5. Pm C' and the tableau [Ssy | ey | C] from C's known structure (row r
//      of C, kalman.py::_structure_matrices: e_{r mod 3} - e_{6 + r} for
//      r < 12, e_{3 + (r - 12) mod 3} for r < 24, e_{8 + 3 (r - 24)} below),
//      the row index fixed at compile time, the lane's own row or column
//      resolved once: lane j holds column j of the tableau in registers
//      (Ssy's for j < 28, ey on lane 28, C's columns 0-2 on lanes 29-31) and
//      lanes 0-14 C's columns 3-17 beside it; Ssy = (C Pm) C' + diag(r) and
//      ey = y - C x_pred grouped as the plain version's products are;
//   6. Gauss-Jordan on the tableau by shuffles, no barrier (gj.cuh's
//      semantics: pivots in the natural order, each + 1e-30 as the JAX
//      package's gj_inverse adds it, the pivot row divided by its pivot as
//      IEEE division rounds it, then the rank-1 update of every other row):
//      per pivot the pivot column arrives from its lane, one correctly
//      rounded reciprocal of the pivot and an FMA correction give each
//      quotient (pivot_quotient); the rows rotate through the registers so
//      that the loop stays rolled.
//      After 15 pivots lanes 0-14's Ssy columns are dead and their C columns
//      take their place: the last 13 pivots update one column a lane.  The
//      inverse is never formed;
//   7. the 19 lanes that hold Ssy^-1 ey and Ssy^-1 C form x_new = x_pred +
//      Pm C' Ssy^-1 ey and the columns of G = I - Pm C' Ssy^-1 C, Pm C' read
//      as float4 broadcasts, the 18 rows' sums side by side;
//   8. lane l < 18 forms column l of P_new = G Pm, likewise;
//   9. the symmetrized P_new and, where det of its xy block > 1e-6, the xy
//      conditioning (the xy rows and columns outside the block zeroed, the
//      block divided by 10); x_new and P_new stored, coalesced.
// Every sum but J v's runs in the plain version's index order, each product
// and sum rounded once by FMA; nothing is clamped or branched on the data
// beyond the gates' clamp and the conditioning's test (a NaN det fails it,
// as in the plain version).  The outputs differ from the plain version by
// float32 rounding.
//
// Work: per scenario 383 floats in, 342 out (the bound is set by these bytes
// at every batch: 0.0035 ms at B=4096 on an H100); ~55k floating-point
// operations (chip_smoke.py::kalman_cost), most of them the 28-row
// elimination.  At B=1 the kernel is latency bound: the 28 pivots (each 28
// shuffles, a reciprocal and 27 or 54 FMAs), the chain and the loads lead.
// Every phase stores its results after its last shared-memory load, so that
// the compiler may issue a phase's loads together.
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too; KalmanParams' eight scalars from one float32 buffer
// (estim/kalman.py::params_buffer).  True float32: no fast math.
#include <cuda_runtime.h>

#include "soa_model.cuh"

namespace {

constexpr int LANES = 32;
constexpr int WARPS = 4;        // scenarios a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int NS = 18;          // states
constexpr int NM = 28;          // measurements
constexpr int NV = 6 + NJ;      // Jacobian columns
constexpr int NB = NS - 3;      // C's columns 3-17: lanes 0-14's second column
constexpr int GL = 20;          // G's row pitch (float4 rows)
constexpr int PL = 19;          // P_new's row pitch (its transpose read without bank conflicts)

// KalmanParams' fields in order (estim/kalman.py::params_buffer)
constexpr int P_RADIUS = 0, P_IMU_POS = 1, P_IMU_VEL = 2, P_FOOT_PROC = 3, P_FOOT_POS = 4,
              P_FOOT_VEL = 5, P_FOOT_H = 6, P_HS = 7, N_KF_PARAMS = 8;

// the sensors and x in the warp's shared memory
constexpr int I_ZYX = 0, I_QJ = I_ZYX + 3, I_VJ = I_QJ + NJ, I_OM = I_VJ + NJ,
              I_QUAT = I_OM + 3, I_ACC = I_QUAT + 4, I_FL = I_ACC + 3, I_FH = I_FL + NC,
              I_X = I_FH + NC, N_IN = I_X + NS;

// the constants the chain reads: the joints' origins, rotations, axes and
// Rodrigues terms (the head of B1's buffer, K_OPOS to K_RKK's end)
constexpr int N_KJ = K_RKK + 9 * NJ;

// one scenario's shared memory
struct __align__(16) Scenario {
  float P[NS * GL];      // P in (rows of NS); then G (rows of GL)
  float Pm[NS * NS];
  float PmCt[NS * NM];   // Pm C'; then P_new (rows of PL)
  float in[N_IN + 1];
  float K[N_KJ], cpos[NC * 3], prm[N_KF_PARAMS];
  float T[NJ][12];       // joint j's local transform and its axis in the parent's frame
  float anchor[NJ][3], aw[NJ][3], pc[NC][3];
  float E[9], thd[3], acc[3], gate[NC];
  float y[NM], xp[NS], xn[NS];
};
static_assert(NS * GL % 4 == 0 && (NS * GL + NS * NS) % 4 == 0, "float4 rows of G and Pm C'");
static_assert(NS * PL <= NS * NM, "P_new fits Pm C'");

// Measurement build only (profile_step kalman_phases): -DKF_PHASE_CLOCKS
// sums block 0's clock64 cycles (thread 0: scenario 0's lane 0) by phase.
enum { PH_LOAD, PH_CHAIN, PH_CONTACTS, PH_PM, PH_INNOV, PH_ELIM, PH_XNEW_G, PH_PNEW, PH_STORES,
       KF_PHASES };
#ifdef KF_PHASE_CLOCKS
__device__ unsigned long long kf_phase_cycles[KF_PHASES];
#define KF_PHASE(p)                              \
  if (blockIdx.x == 0 && threadIdx.x == 0) {     \
    const long long now = clock64();             \
    kf_phase_cycles[p] += now - t_phase;         \
    t_phase = now;                               \
  }
#else
#define KF_PHASE(p)
#endif

// row r of C: +1 in column c_a(r) and, for r < 12 (c_two), -1 in c_b(r);
// with the row known at compile time these fold to constants
__host__ __device__ constexpr int c_a(int r) {
  return r < 12 ? r % 3 : (r < 24 ? 3 + (r - 12) % 3 : 8 + 3 * (r - 24));
}
__host__ __device__ constexpr int c_b(int r) { return r < 12 ? 6 + r : c_a(r); }
__host__ __device__ constexpr bool c_two(int r) { return r < 12; }

// column c of C (28 entries)
__device__ __forceinline__ void c_column(int c, float* v) {
#pragma unroll
  for (int q = 0; q < NM; ++q)
    v[q] = c == c_a(q) ? 1.0f : ((c_two(q) && c == c_b(q)) ? -1.0f : 0.0f);
}

// the pivot row's entry num / pval as IEEE division rounds it, from the
// correctly rounded reciprocal y = 1 / pval (one division a pivot, the same
// on every lane): q = num y, then one correction by the exact residual
// num - pval q (Markstein: RN(q + (num - pval q) y) is the correctly
// rounded quotient when y is, for a finite, nonzero pivot whose quotient
// and reciprocal stay in the normal range; a zero numerator keeps its
// signed zero).  No lane takes a division's slow path, and none diverges.
__device__ __forceinline__ float pivot_quotient(float num, float pval, float y) {
  const float q = num * y;
  const float r = fmaf(-pval, q, num);
  return num == 0.0f ? q : fmaf(r, y, q);
}

// one Gauss-Jordan step on the tableau's columns A (and Bc with TWO): pivot
// k, whose column cv came from lane k; row k is A[0] on entry and the rows
// rotate by one (row k last, in its divided form).  The step ends by
// shuffling lane k + 1's updated column into cv, the next step's pivot
// column (28 shuffles a step: with 54 or 27 FMAs they set its time).
template <bool TWO>
__device__ __forceinline__ void gj_step(float* A, float* Bc, float* cv, int k) {
  const float pval = cv[0] + 1e-30f;
  const float y = __frcp_rn(pval);
  const float pa = pivot_quotient(A[0], pval, y);
  const float pb = TWO ? pivot_quotient(Bc[0], pval, y) : 0.0f;
  const int next = (k + 1) & (LANES - 1);
#pragma unroll
  for (int q = 1; q < NM; ++q) {
    A[q - 1] = A[q] - cv[q] * pa;
    if (TWO) Bc[q - 1] = Bc[q] - cv[q] * pb;
    cv[q - 1] = __shfl_sync(FULL, A[q - 1], next);
  }
  A[NM - 1] = pa;
  if (TWO) Bc[NM - 1] = pb;
  cv[NM - 1] = __shfl_sync(FULL, pa, next);
}

__global__ void __launch_bounds__(LANES * WARPS)
kalman_update_kernel(const float* __restrict__ gK, const float* __restrict__ gprm,
                     const float* __restrict__ gzyx, const float* __restrict__ gqj,
                     const float* __restrict__ gvj, const float* __restrict__ gom,
                     const float* __restrict__ gquat, const float* __restrict__ gacc,
                     const float* __restrict__ gfl, const float* __restrict__ gx,
                     const float* __restrict__ gP, const float* __restrict__ gfh, int batch,
                     float dt, float* __restrict__ ox, float* __restrict__ oP) {
  __shared__ Scenario scenarios[WARPS];
  const int lane = threadIdx.x % LANES;
  const long long b = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / LANES;
  if (b >= batch) return;  // the whole warp: no barrier waits for it
  Scenario& s = scenarios[threadIdx.x / LANES];
#ifdef KF_PHASE_CLOCKS
  long long t_phase = clock64();
#endif

  // ---- 1. the loads ----
  const float* Pg = gP + b * NS * NS;
#pragma unroll
  for (int i = lane; i < NS * NS; i += LANES) s.P[i] = Pg[i];
  if (lane < 3) {
    s.in[I_ZYX + lane] = gzyx[b * 3 + lane];
    s.in[I_OM + lane] = gom[b * 3 + lane];
    s.in[I_ACC + lane] = gacc[b * 3 + lane];
  }
  if (lane < NJ) {
    s.in[I_QJ + lane] = gqj[b * NJ + lane];
    s.in[I_VJ + lane] = gvj[b * NJ + lane];
  }
  if (lane < NC) {
    s.in[I_QUAT + lane] = gquat[b * 4 + lane];
    s.in[I_FL + lane] = gfl[b * NC + lane];
    s.in[I_FH + lane] = gfh[b * NC + lane];
  }
  if (lane < NS) s.in[I_X + lane] = gx[b * NS + lane];
#pragma unroll
  for (int i = lane; i < N_KJ; i += LANES) s.K[i] = gK[i];
  if (lane < NC * 3) s.cpos[lane] = gK[K_CPOS + lane];
  if (lane < N_KF_PARAMS) s.prm[lane] = gprm[lane];
  __syncwarp();
  KF_PHASE(PH_LOAD);
  const float* K = s.K;
  const float* prm = s.prm;

  // ---- 2. the chain at a zero base ----
  // lanes 0-9 the joint angles, 10-12 the base's zyx, 13-15 yaw, pitch and
  // roll of the quaternion (x, y, z, w): one sincosf for all
  float ang = 0.0f;
  if (lane < NJ) {
    ang = s.in[I_QJ + lane];
  } else if (lane < NJ + 3) {
    ang = s.in[I_ZYX + lane - NJ];
  } else if (lane < NJ + 6) {
    const float qx = s.in[I_QUAT], qy = s.in[I_QUAT + 1], qz = s.in[I_QUAT + 2],
                qw = s.in[I_QUAT + 3];
    if (lane == NJ + 4) {
      float sp = 2.0f * (qw * qy - qz * qx);
      sp = sp < -1.0f ? -1.0f : (sp > 1.0f ? 1.0f : sp);
      ang = asinf(sp);
    } else {
      const bool yaw = lane == NJ + 3;
      ang = atan2f(yaw ? 2.0f * (qw * qz + qx * qy) : 2.0f * (qw * qx + qy * qz),
                   yaw ? 1.0f - 2.0f * (qy * qy + qz * qz) : 1.0f - 2.0f * (qx * qx + qy * qy));
    }
  }
  float sa, ca;
  sincosf(ang, &sa, &ca);
  const float cz = __shfl_sync(FULL, ca, NJ), sz = __shfl_sync(FULL, sa, NJ);
  const float cy = __shfl_sync(FULL, ca, NJ + 1), sy = __shfl_sync(FULL, sa, NJ + 1);
  const float cx = __shfl_sync(FULL, ca, NJ + 2), sx = __shfl_sync(FULL, sa, NJ + 2);
  const float cq0 = __shfl_sync(FULL, ca, NJ + 3), sq0 = __shfl_sync(FULL, sa, NJ + 3);
  const float cq1 = __shfl_sync(FULL, ca, NJ + 4), sq1 = __shfl_sync(FULL, sa, NJ + 4);
  const float cq2 = __shfl_sync(FULL, ca, NJ + 5), sq2 = __shfl_sync(FULL, sa, NJ + 5);
  if (lane < NJ) {
    // soa_model.cuh::joint_local_dev from the lane's sine and cosine
    const float* Ko = K + K_OROT + 9 * lane;
    const float u = 1.0f - ca;
    float rod[9], T[9], a[3];
#pragma unroll
    for (int e = 0; e < 9; ++e)
      rod[e] = ((e % 4 == 0) ? 1.0f : 0.0f) + sa * K[K_RK + 9 * lane + e]
               + u * K[K_RKK + 9 * lane + e];
    mm3(Ko, rod, T);
    mv3(Ko, K + K_AXIS + 3 * lane, a);
#pragma unroll
    for (int e = 0; e < 9; ++e) s.T[lane][e] = T[e];
#pragma unroll
    for (int i = 0; i < 3; ++i) s.T[lane][9 + i] = a[i];
  } else if (lane == NJ) {
    // E(zyx), and the Euler rates E(zyx)^-1 omega_world (rbd_dynamics.cuh::euler_rates_dev)
    const float trig[4] = {cz, sz, cy, sy};
    euler_E(trig, s.E);
    const float ty = sy / cy;
    const float Einv[9] = {cz * ty, sz * ty, 1.0f, -sz, cz, 0.0f, cz / cy, sz / cy, 0.0f};
    mv3(Einv, s.in + I_OM, s.thd);
  } else if (lane == NJ + 1) {
    // the world acceleration R(yaw, pitch, roll) a + g
    const float R[9] = {cq0 * cq1, cq0 * sq1 * sq2 - sq0 * cq2, cq0 * sq1 * cq2 + sq0 * sq2,
                        sq0 * cq1, sq0 * sq1 * sq2 + cq0 * cq2, sq0 * sq1 * cq2 - cq0 * sq2,
                        -sq1,      cq1 * sq2,                   cq1 * cq2};
    float a[3];
    mv3(R, s.in + I_ACC, a);
#pragma unroll
    for (int i = 0; i < 3; ++i) s.acc[i] = a[i] + (i == 2 ? -GRAVITY : 0.0f);
  } else if (lane < NJ + 2 + NC) {
    const int c = lane - NJ - 2;
    float wc = s.in[I_FL + c];
    wc = wc < 0.0f ? 0.0f : (wc > 1.0f ? 1.0f : wc);
    s.gate[c] = 1.0f + (prm[P_HS] - 1.0f) * (1.0f - wc);
  }
  __syncwarp();
  // the legs side by side: lane 3 g + i holds row i of leg g's running
  // rotation (the base's at first) and component i of its position
  if (lane < 6) {
    const int g = lane < 3 ? 0 : 1, i = lane - 3 * g;
    float r0 = i == 0 ? cz * cy : (i == 1 ? sz * cy : -sy);
    float r1 = i == 0 ? cz * sy * sx - sz * cx : (i == 1 ? sz * sy * sx + cz * cx : cy * sx);
    float r2 = i == 0 ? cz * sy * cx + sz * sx : (i == 1 ? sz * sy * cx - cz * sx : cy * cx);
    // (the anchors and axes stored after the chain: no store sits between
    // the joints' loads)
    float p = 0.0f, anc[LEG_JOINTS], awv[LEG_JOINTS];
#pragma unroll
    for (int n = 0; n < LEG_JOINTS; ++n) {
      const int j = LEG_JOINTS * g + n;
      const float* o = K + K_OPOS + 3 * j;
      const float* Tj = s.T[j];
      const float t = r0 * o[0] + r1 * o[1] + r2 * o[2];
      awv[n] = r0 * Tj[9] + r1 * Tj[10] + r2 * Tj[11];
      const float c0 = r0 * Tj[0] + r1 * Tj[3] + r2 * Tj[6];
      const float c1 = r0 * Tj[1] + r1 * Tj[4] + r2 * Tj[7];
      const float c2 = r0 * Tj[2] + r1 * Tj[5] + r2 * Tj[8];
      p = p + t;
      anc[n] = p;
      r0 = c0, r1 = c1, r2 = c2;
    }
#pragma unroll
    for (int n = 0; n < LEG_JOINTS; ++n) {
      s.anchor[LEG_JOINTS * g + n][i] = anc[n];
      s.aw[LEG_JOINTS * g + n][i] = awv[n];
    }
    // the leg's contact points on its last link (SOA_CPARENT: 0 and 2 on
    // link 5, 1 and 3 on link 10)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* cp = s.cpos + 3 * (g + 2 * h);
      s.pc[g + 2 * h][i] = p + (r0 * cp[0] + r1 * cp[1] + r2 * cp[2]);
    }
  }
  __syncwarp();
  KF_PHASE(PH_CHAIN);

  // ---- 3. J v of each contact: lane 8 c + t its columns 3 + t and 11 + t
  // (the Euler-rate columns 3-5 about the base origin, joint j's column
  // 6 + j about its anchor), summed over the eight lanes; y ----
  {
    const int c = lane >> 3, t = lane & 7;
    const float x[3] = {s.pc[c][0], s.pc[c][1], s.pc[c][2]};
    float part[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 3 + t + 8 * h;
      if (col < NV) {
        float ax[3], r[3], vi, mask;
        if (col < 6) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            ax[a] = s.E[3 * a + col - 3];
            r[a] = x[a];
          }
          vi = s.thd[col - 3];
          mask = 1.0f;
        } else {
          const int j = col - 6;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            ax[a] = s.aw[j][a];
            r[a] = x[a] - s.anchor[j][a];
          }
          vi = s.in[I_VJ + j];
          mask = (j >= LEG_JOINTS) == ((c & 1) == 1) ? 1.0f : 0.0f;  // the contact's leg
        }
        float l[3];
        cross3(ax, r, l);
#pragma unroll
        for (int a = 0; a < 3; ++a) part[a] = part[a] + (l[a] * mask) * vi;
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
#pragma unroll
      for (int a = 0; a < 3; ++a) part[a] = part[a] + __shfl_xor_sync(FULL, part[a], o);
    if (t < 3) {
      const float pa = t == 0 ? x[0] : (t == 1 ? x[1] : x[2]);
      const float va = t == 0 ? part[0] : (t == 1 ? part[1] : part[2]);
      s.y[3 * c + t] = -pa + (t == 2 ? prm[P_RADIUS] : 0.0f);
      s.y[12 + 3 * c + t] = -va;
    } else if (t == 3) {
      s.y[24 + c] = s.in[I_FH + c];
    }
  }
  __syncwarp();
  KF_PHASE(PH_CONTACTS);

  // ---- 4. Pm = A P A' + diag(q) by rows, lane j its column j; x_pred ----
  if (lane < NS) {
    const int j = lane;
    // j < 3: A's dt column adds dt (A P)[i][j + 3]; and the lane's entry of
    // diag(q) (the rows' values stored after the last load)
    const int j3 = j < 3 ? j + 3 : j;
    const float qd = j < 3 ? (dt / 20.0f) * prm[P_IMU_POS]
                           : (j < 6 ? (dt * GRAVITY / 20.0f) * prm[P_IMU_VEL]
                                    : (dt * prm[P_FOOT_PROC]) * s.gate[j < 6 ? 0 : (j - 6) / 3]);
    float pm[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      // (A P)[i][j], then (A P A')[i][j]
      const float ap = s.P[i * NS + j] + (i < 3 ? dt * s.P[(i + 3) * NS + j] : 0.0f);
      const float ap3 = s.P[i * NS + j3] + (i < 3 ? dt * s.P[(i + 3) * NS + j3] : 0.0f);
      pm[i] = (j < 3 ? ap + dt * ap3 : ap) + (i == j ? qd : 0.0f);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) s.Pm[i * NS + j] = pm[i];
    float v = s.in[I_X + j];
    if (j < 3) v = (v + dt * s.in[I_X + j + 3]) + (0.5f * dt * dt) * s.acc[j];
    else if (j < 6) v = v + dt * s.acc[j - 3];
    s.xp[j] = v;
  }
  __syncwarp();
  KF_PHASE(PH_PM);

  // ---- 5. Pm C' and the tableau's columns ----
  // lane r < 28: row r of C (+1 in ra, -1 in rb with two), resolved once
  // (rs = 0 leaves the +1 alone: rb = ra then; its x 0 term is exact)
  const int r = lane < NM ? lane : 0;
  const int ra = c_a(r), rb = c_b(r);
  const float rs = c_two(r) ? 1.0f : 0.0f;
  float A[NM], Bc[NM];
  if (lane < NM) {
    // Pm's columns ra and rb in registers: column r of Pm C' and Ssy's
    // column r, (C Pm C')[q][r] = (C Pm)[q][ra] - rs (C Pm)[q][rb], and r_r
    // on the diagonal
    float pa[NS], pb[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      pa[k] = s.Pm[k * NS + ra];
      pb[k] = s.Pm[k * NS + rb];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) s.PmCt[i * NM + r] = pa[i] - rs * pb[i];
    const int g = r < 12 ? r / 3 : (r < 24 ? (r - 12) / 3 : r - 24);
    const float rd = prm[r < 12 ? P_FOOT_POS : (r < 24 ? P_FOOT_VEL : P_FOOT_H)] * s.gate[g];
#pragma unroll
    for (int q = 0; q < NM; ++q) {
      const float cpa = c_two(q) ? pa[c_a(q)] - pa[c_b(q)] : pa[c_a(q)];
      const float cpb = c_two(q) ? pb[c_a(q)] - pb[c_b(q)] : pb[c_a(q)];
      A[q] = (cpa - rs * cpb) + (q == r ? rd : 0.0f);
    }
  } else if (lane == NM) {
    // ey = y - C x_pred
#pragma unroll
    for (int q = 0; q < NM; ++q) {
      const float cxp = c_two(q) ? s.xp[c_a(q)] - s.xp[c_b(q)] : s.xp[c_a(q)];
      A[q] = s.y[q] - cxp;
    }
  } else {
    c_column(lane - NM - 1, A);
  }
  if (lane < NB) {
    c_column(3 + lane, Bc);
  } else {
#pragma unroll
    for (int q = 0; q < NM; ++q) Bc[q] = 0.0f;
  }
  __syncwarp();
  KF_PHASE(PH_INNOV);

  // ---- 6. Gauss-Jordan on [Ssy | ey | C] ----
  float cv[NM];
#pragma unroll
  for (int q = 0; q < NM; ++q) cv[q] = __shfl_sync(FULL, A[q], 0);
#pragma unroll 1
  for (int k = 0; k < NB; ++k) gj_step<true>(A, Bc, cv, k);
  if (lane < NB) {
#pragma unroll
    for (int q = 0; q < NM; ++q) A[q] = Bc[q];
  }
#pragma unroll 1
  for (int k = NB; k < NM; ++k) gj_step<false>(A, Bc, cv, k);
  KF_PHASE(PH_ELIM);

  // ---- 7. x_new = x_pred + Pm C' Ssy^-1 ey (lane 28) and G's column c =
  // e_c - Pm C' Ssy^-1 C e_c (lanes 0-14: c = 3 + lane; 29-31: c = lane - 29) ----
  // (each row's sum over r in order, the 18 rows' sums side by side, the
  // stores after the last load)
  if (lane < NB || lane >= NM) {
    const int c = lane < NB ? 3 + lane : (lane > NM ? lane - NM - 1 : 0);  // lane 28: unused
    float v[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) v[i] = 0.0f;
#pragma unroll
    for (int q4 = 0; q4 < NM / 4; ++q4) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float4 p = reinterpret_cast<const float4*>(s.PmCt + i * NM)[q4];
        v[i] = v[i] + p.x * A[4 * q4];
        v[i] = v[i] + p.y * A[4 * q4 + 1];
        v[i] = v[i] + p.z * A[4 * q4 + 2];
        v[i] = v[i] + p.w * A[4 * q4 + 3];
      }
    }
    if (lane == NM) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s.xn[i] = s.xp[i] + v[i];
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) s.P[i * GL + c] = (i == c ? 1.0f : 0.0f) - v[i];
    }
  }
  __syncwarp();
  KF_PHASE(PH_XNEW_G);

  // ---- 8. P_new = G Pm, lane l < 18 its column l (the rows side by side) ----
  if (lane < NS) {
    float pm[NS], v[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      pm[k] = s.Pm[k * NS + lane];
      v[k] = 0.0f;
    }
#pragma unroll
    for (int k4 = 0; k4 < (NS + 3) / 4; ++k4) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float4 gv = reinterpret_cast<const float4*>(s.P + i * GL)[k4];
        const float gk[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * k4 + e < NS) v[i] = v[i] + gk[e] * pm[4 * k4 + e];
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) s.PmCt[i * PL + lane] = v[i];
  }
  __syncwarp();
  KF_PHASE(PH_PNEW);

  // ---- 9. symmetrization, xy conditioning, stores ----
  const float* Pn = s.PmCt;
  const float p00 = Pn[0], p11 = Pn[PL + 1];
  const float p01 = 0.5f * (Pn[1] + Pn[PL]);
  const bool cond = p00 * p11 - p01 * p01 > 1e-6f;
  if (lane < NS) {
    const int l = lane;
    float* o = oP + b * NS * NS;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float v = 0.5f * (Pn[i * PL + l] + Pn[l * PL + i]);
      if (cond) {
        if (i < 2 && l < 2) v = v / 10.0f;
        else if (i < 2 || l < 2) v = 0.0f;
      }
      o[i * NS + l] = v;
    }
    ox[b * NS + l] = s.xn[l];
  }
  KF_PHASE(PH_STORES);
}

}  // namespace

extern "C" int hk_kalman_update(const float* consts, const float* params, const float* zyx,
                                const float* joint_pos, const float* joint_vel,
                                const float* omega_world, const float* quat_xyzw,
                                const float* accel_local, const float* contact_flags,
                                const float* x_hat, const float* P, const float* feet_heights,
                                float* x_new, float* P_new, int batch, float dt, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(batch) + WARPS - 1) / WARPS;
  kalman_update_kernel<<<static_cast<unsigned>(blocks), LANES * WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      consts, params, zyx, joint_pos, joint_vel, omega_world, quat_xyzw, accel_local,
      contact_flags, x_hat, P, feet_heights, batch, dt, x_new, P_new);
  return static_cast<int>(cudaGetLastError());
}

#ifdef KF_PHASE_CLOCKS
// The phase sums since the last call (KF_PHASES of them), then zeroed.
extern "C" int hk_kalman_update_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, kf_phase_cycles, sizeof(kf_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[KF_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(kf_phase_cycles, zero, sizeof(zero)));
}
#endif
