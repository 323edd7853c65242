// B8a: the reference prep's two-pass leg IK in one launch per MPC step.
//
// Replaces hunter_bipedal_control_tpu/solver/mpc.py::_joint_reference
// (:56-93): two passes of refs/ik.py::compute_ik (:152) over every sample of
// every scenario, pass 1 from the default joints and pass 2 from each
// sample's own pass-1 result, each pass a translation IK (translation_ik,
// :61, trans_it steps) then a rotation IK in the null space of the
// translation Jacobian (rotation_ik, :99, rot_it steps), over _toe_state
// (:40) and _damped_solve (:50, B6's IK use).  The plain version is the
// port's refs/ik.py::joint_reference_ik_plain.
//
// The split per leg is exact: the IK writes the joints q[6:] only, so the
// base pose q[0:6] is fixed throughout; each leg is a chain of five joints
// from the base (static_assert below), so a toe's placement and its
// Jacobian's leg block (columns 6 + 5 leg .. 6 + 5 leg + 4 of the
// whole-body contact Jacobian) depend on the base pose and that leg's
// joints alone; the 5x5 damped systems, the step, the clamp to the joint
// limits and the keep-if-improved test on the error norm are all per leg.
//
// Design: eight lanes a leg, a (scenario, sample)'s two legs in one half
// warp, two samples a warp; the lanes of a leg exchange data by
// __shfl_sync within their group of eight, with no barrier.  Lane `pos` of
// a leg's group holds one element of the leg's chain: pos 0 the base
// (rotation_zyx(pose[3:6]), pose[0:3]), pos 1 + j joint j (its origin
// offset and the local factor T_j = R_origin_j rod_j(q_j) = KA_j + s_j KB_j
// + (1 - c_j) KC_j, with KA = R_origin, KB = R_origin skew(axis), KC =
// R_origin skew(axis)^2 formed once per launch: the joint's 33 constants
// live in the lane's registers), pos 6 the contact frame's offset (its
// rotation is identity, which models/soa.py::build_consts asserts), pos 7
// the identity.  A toe evaluation:
//   1. each joint lane takes sincosf of its angle and forms T_j;
//   2. the chain as an inclusive shuffle scan over the eight elements
//      (offsets 1, 2, 4; (Ra, pa) o (Rb, pb) = (Ra Rb, pa + Ra pb)): lane
//      1 + j ends with joint j's anchor and rotation, lane 6 with the toe;
//   3. the toe's position and rotation go to every lane of the leg, and
//      joint lane j forms its own Jacobian column (axis_w x (p_toe -
//      anchor); axis_w), axis_w = R_j axis_j.
// The damped solves: joint lane a holds row a of J'J + damp I and of J'e
// (each entry a dot of two columns, the other lanes' columns by shuffles),
// and Gauss-Jordan eliminates [A | J'e] in the natural order in registers:
// per pivot k the pivot row arrives from lane 1 + k, every other row less
// it times A_ak / (A_kk + 1e-30) (the +1e-30 of gj_inverse(pivot=True),
// gj.cuh), the rows not normalized on the way, each right-hand side divided
// by its own pivot + 1e-30 at the end; the inverse is never formed.  The
// rotation step works in the toe's local frame (R' J), projects through N
// = I - Jlin' inv3(Jlin Jlin' + damp I) Jlin (inv3: the adjugate,
// soa_model.cuh), lane a holding column a of N and of Jang N and, for the
// step d = -N w, row a of N (the same products), and measures the error
// with log3 as models/spatial.py::log3 does (clamped acos, the theta < 1e-6
// branch).  The error norms, the keep-if-improved tests and log3 are
// computed on every lane of the leg from the same broadcast values, so the
// leg's lanes agree bit for bit.  The toe at the best joints is kept, so
// the rotation IK and pass 2 start without evaluating it again (the plain
// version evaluates it again at the same joints, with the same result).
// The sums are taken in other orders than the plain version's, so the
// outputs differ from it by float32 rounding.  A batch whose sample count
// is odd leaves the last warp's second half idle: it runs on sample 0's
// data, takes part in every shuffle and writes nothing.
//
// Bound on the card: per leg, 11 toe evaluations and 10 damped steps over
// both passes, ~13k float operations (chip_smoke.py::ik_cost); ~23 MFLOP
// at B=128, S=7, well under a microsecond at 67 TFLOP/s, and a few hundred
// bytes per sample.  Each leg's two passes are one dependent chain and the
// legs are few (12 at B=1, 1,792 at B=128), so the kernel is latency
// bound: eight lanes a leg shorten the chain, blocks of one warp spread the
// warps over the SMs, and every value stays in registers.  At 141
// registers a thread the register file holds 14 such warps an SM, under
// the 32 blocks an SM may hold, so wider blocks could only round that down.
//
// Model constants: the B1 buffer (ocp/soa_kernel.py::consts_buffer), the
// topology compiled in from soa_model.cuh; the wrapper refuses a model of
// another topology (soa_kernel.check_topology).  The joint limits, the step,
// the damping and the iteration counts are arguments.  True float32: no
// fast math; a singular system gives inf/NaN as the plain version does, and
// the clamp and the min of the error norms propagate NaN as torch's do.
// On request the kernel also writes every keep-if-improved test, so that a
// check can tell a test decided the other way in float32 from an error.
#include <climits>

#include <cuda_runtime.h>

#include "soa_model.cuh"

namespace {

constexpr int LEG_NJ = 5;
constexpr int N_LEGS = 2;
constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 8;                   // lanes a leg
constexpr int TOE = LEG_NJ + 1;            // the lane whose scan ends at the toe
constexpr int SAMPLES_PER_WARP = LANES / (N_LEGS * GROUP);

constexpr int kParent[NJ] = SOA_PARENT;
constexpr int kChild[NJ] = SOA_CHILD;
constexpr int kCParent[NC] = SOA_CPARENT;

// leg l: joints LEG_NJ l .. LEG_NJ l + 4 form a chain from the base to the
// parent link of contact frame l (the toe)
constexpr bool legs_are_chains() {
  for (int l = 0; l < N_LEGS; ++l) {
    if (kParent[LEG_NJ * l] != 0) return false;
    for (int i = 1; i < LEG_NJ; ++i)
      if (kParent[LEG_NJ * l + i] != kChild[LEG_NJ * l + i - 1]) return false;
    if (kCParent[l] != kChild[LEG_NJ * l + LEG_NJ - 1]) return false;
  }
  return true;
}
static_assert(NJ == N_LEGS * LEG_NJ && NC >= N_LEGS && legs_are_chains(),
              "leg_ik: each leg must be a chain of LEG_NJ joints from the base to its toe");
static_assert(TOE + 1 < GROUP, "leg_ik: a leg's chain elements must fit its lanes");

// Measurement build only (profile_step leg_ik_phases): problem 0's clock64
// cycles by phase, summed over the launch (lane 0 of block 0; the leg's
// lanes run in lockstep).
enum { PH_SETUP, PH_LOCAL, PH_CHAIN, PH_JACOBIAN, PH_TSOLVE, PH_PROJECTOR, PH_RSOLVE, PH_ERR,
       PH_STORE };
#ifdef LEG_IK_PHASE_CLOCKS
constexpr int IK_PHASES = PH_STORE + 1;
__device__ unsigned long long ik_phase_cycles[IK_PHASES];
struct Clock {
  long long t;
  unsigned long long acc[IK_PHASES];
  bool on;
  __device__ void start(bool o) {
    on = o;
    for (int i = 0; i < IK_PHASES; ++i) acc[i] = 0;
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
      for (int i = 0; i < IK_PHASES; ++i) ik_phase_cycles[i] += acc[i];
  }
};
#else
struct Clock {
  __device__ void start(bool) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ void flush() {}
};
#endif

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // NaN stays NaN, as torch.clamp
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);  // NaN wins, as torch.minimum
}

__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float from(float v, int pos) {
  return __shfl_sync(FULL, v, pos, GROUP);
}

// the lane's chain element: T = KA + s KB + (1 - c) KC for its angle, and
// its offset (the base: KA = Rb, KB = KC = 0, angle 0; see the header)
struct Element {
  float KA[9], KB[9], KC[9], off[3], axis[3];
};

// a toe evaluation as every lane of the leg holds it: the toe's position
// and rotation (the same on every lane), and on joint lane 1 + a the
// Jacobian's column a (rows 0:3 linear, 3:6 angular)
struct Toe {
  float p[3], R[9], col[6];
};

__device__ __forceinline__ void select_toe(bool take, const Toe& a, Toe& b) {
#pragma unroll
  for (int k = 0; k < 3; ++k) b.p[k] = take ? a.p[k] : b.p[k];
#pragma unroll
  for (int e = 0; e < 9; ++e) b.R[e] = take ? a.R[e] : b.R[e];
#pragma unroll
  for (int k = 0; k < 6; ++k) b.col[k] = take ? a.col[k] : b.col[k];
}

// the toe of the leg at the lane's angle q (0 on the lanes without a joint)
__device__ __forceinline__ void toe_eval(const Element& el, float q, int pos, Toe& t,
                                         Clock& clk) {
  float s, c;
  sincosf(q, &s, &c);
  const float u = 1.0f - c;
  float R[9], p[3];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = el.KA[e] + s * el.KB[e] + u * el.KC[e];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = el.off[k];
  clk.mark(PH_LOCAL);
#pragma unroll
  for (int d = 1; d < GROUP; d <<= 1) {
    float Ra[9], pa[3], Rn[9], pn[3];
#pragma unroll
    for (int e = 0; e < 9; ++e) Ra[e] = __shfl_up_sync(FULL, R[e], d, GROUP);
#pragma unroll
    for (int k = 0; k < 3; ++k) pa[k] = __shfl_up_sync(FULL, p[k], d, GROUP);
    mm3(Ra, R, Rn);
    mv3(Ra, p, pn);
    const bool take = pos >= d;
#pragma unroll
    for (int e = 0; e < 9; ++e) R[e] = take ? Rn[e] : R[e];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = take ? pa[k] + pn[k] : p[k];
  }
  clk.mark(PH_CHAIN);
#pragma unroll
  for (int k = 0; k < 3; ++k) t.p[k] = from(p[k], TOE);
#pragma unroll
  for (int e = 0; e < 9; ++e) t.R[e] = from(R[e], TOE);
  float aw[3], r[3];
  mv3(R, el.axis, aw);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = t.p[k] - p[k];
  cross3(aw, r, t.col);
#pragma unroll
  for (int k = 0; k < 3; ++k) t.col[3 + k] = aw[k];
  clk.mark(PH_JACOBIAN);
}

// Gauss-Jordan on [A | b], row a of it on joint lane 1 + a (see the
// header): returns x_a on that lane.  The other lanes divide 1 where a row
// divides its entries: a zero dividend would send a division, and with it
// the warp, down its slow path.
__device__ __forceinline__ float gj_rows(float (&A)[LEG_NJ], float b, int a) {
  const bool row = a >= 0 && a < LEG_NJ;
  float piv = 1.0f;
#pragma unroll
  for (int k = 0; k < LEG_NJ; ++k) {
    const float pk = from(A[k], 1 + k) + 1e-30f;
    float rk[LEG_NJ];
#pragma unroll
    for (int j = k + 1; j < LEG_NJ; ++j) rk[j] = from(A[j], 1 + k);
    const float bk = from(b, 1 + k);
    const bool own = a == k;
    const float f = (row ? A[k] : 1.0f) / pk;
#pragma unroll
    for (int j = k + 1; j < LEG_NJ; ++j) A[j] = own ? A[j] : A[j] - f * rk[j];
    b = own ? b : b - f * bk;
    piv = own ? pk : piv;
  }
  return (row ? b : 1.0f) / piv;
}

// row a of G' G + damp I and of G' e, G's columns (3 rows) one on each joint
// lane, then the solve: refs/ik.py::_damped_solve's d_a on joint lane 1 + a
__device__ __forceinline__ float damped_solve(const float* g, const float* e, float damp,
                                              int a) {
  float A[LEG_NJ];
#pragma unroll
  for (int c = 0; c < LEG_NJ; ++c) {
    float gc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) gc[k] = from(g[k], 1 + c);
    A[c] = dot3(g, gc) + (c == a ? damp : 0.0f);
  }
  return gj_rows(A, dot3(g, e), a);
}

// models/spatial.py::log3 of Rd' R
__device__ __forceinline__ void rot_err(const float* Rd, const float* R, float* w) {
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[3 * i + j] = Rd[i] * R[j] + Rd[3 + i] * R[3 + j] + Rd[6 + i] * R[6 + j];
  const float c = clamp_nan(0.5f * (M[0] + M[4] + M[8] - 1.0f), -1.0f, 1.0f);
  const float theta = acosf(c);
  const float scale = theta < 1e-6f ? 1.0f + theta * theta / 6.0f : theta / sinf(theta);
  w[0] = scale * (0.5f * (M[7] - M[5]));
  w[1] = scale * (0.5f * (M[2] - M[6]));
  w[2] = scale * (0.5f * (M[3] - M[1]));
}

// the rotation step's d_a = -(N w)_a on joint lane 1 + a: the local-frame
// Jacobians, the projector, w by the damped solve of (Jang N) w = err
__device__ __forceinline__ float rotation_step(const Toe& t, const float* err, float damp,
                                               int a, Clock& clk) {
  float L[3], Ga[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    L[i] = t.R[i] * t.col[0] + t.R[3 + i] * t.col[1] + t.R[6 + i] * t.col[2];
    Ga[i] = t.R[i] * t.col[3] + t.R[3 + i] * t.col[4] + t.R[6 + i] * t.col[5];
  }
  // Jlin Jlin' + damp I over every joint's local column
  float Lb[LEG_NJ][3];
#pragma unroll
  for (int c = 0; c < LEG_NJ; ++c)
#pragma unroll
    for (int k = 0; k < 3; ++k) Lb[c][k] = from(L[k], 1 + c);
  float JJt[9], iJ[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = i; k < 3; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < LEG_NJ; ++c) acc = acc + Lb[c][i] * Lb[c][k];
      JJt[3 * i + k] = acc + (i == k ? damp : 0.0f);
      JJt[3 * k + i] = JJt[3 * i + k];
    }
  inv3(JJt, iJ);
  // column a of T = inv3(.) Jlin and of N = I - Jlin' T
  float T[3], N[LEG_NJ];
#pragma unroll
  for (int i = 0; i < 3; ++i) T[i] = iJ[3 * i] * L[0] + iJ[3 * i + 1] * L[1] + iJ[3 * i + 2] * L[2];
#pragma unroll
  for (int c = 0; c < LEG_NJ; ++c)
    N[c] = (c == a ? 1.0f : 0.0f) - (Lb[c][0] * T[0] + Lb[c][1] * T[1] + Lb[c][2] * T[2]);
  // column a of G = Jang N
  float G[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < LEG_NJ; ++c) {
#pragma unroll
    for (int i = 0; i < 3; ++i) G[i] = G[i] + from(Ga[i], 1 + c) * N[c];
  }
  clk.mark(PH_PROJECTOR);
  const float w = damped_solve(G, err, damp, a);
  // row a of N (the products lane c formed for its column) times w
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < LEG_NJ; ++c) {
    float Tc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) Tc[k] = from(T[k], 1 + c);
    const float n_ac = (c == a ? 1.0f : 0.0f) - (L[0] * Tc[0] + L[1] * Tc[1] + L[2] * Tc[2]);
    acc = acc + n_ac * from(w, 1 + c);
  }
  return -acc;
}

__global__ void __launch_bounds__(LANES, 1)
leg_ik_kernel(const float* __restrict__ K, const float* __restrict__ lower,
              const float* __restrict__ upper, const float* __restrict__ poses,
              const float* __restrict__ warm, const float* __restrict__ des,
              const float* __restrict__ R_des,
              float* __restrict__ qj1, float* __restrict__ qref,
              unsigned char* __restrict__ kept, int n_samples, long long n_bs,
              int trans_it, int rot_it, float step, float damp) {
  const int lane = threadIdx.x & (LANES - 1);
  const long long warp = blockIdx.x;  // blocks of one warp
  const int pos = lane & (GROUP - 1);
  const int leg = (lane / GROUP) % N_LEGS;
  const long long bs_lane = warp * SAMPLES_PER_WARP + lane / (N_LEGS * GROUP);
  const bool live = bs_lane < n_bs;
  const long long bs = live ? bs_lane : 0;  // scenario * n_samples + sample
  const long long b = bs / n_samples;
  const long long n_legs = N_LEGS * n_bs;
  const long long t = bs * N_LEGS + leg;   // the (sample, leg) problem
  const int a = pos - 1;                    // this lane's joint of the leg
  const bool joint = a >= 0 && a < LEG_NJ;
  Clock clk;
  clk.start(blockIdx.x == 0 && threadIdx.x == 0);

  const float* pose = poses + bs * 6;
  float des_k[3], Rd[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) des_k[k] = des[t * 3 + k];
#pragma unroll
  for (int e = 0; e < 9; ++e) Rd[e] = R_des[b * 9 + e];
  Element el;
  float lo = 0.0f, hi = 0.0f, q = 0.0f;
  if (joint) {
    const int j = LEG_NJ * leg + a;
    const float* Ro = K + K_OROT + 9 * j;
#pragma unroll
    for (int e = 0; e < 9; ++e) el.KA[e] = Ro[e];
    mm3(Ro, K + K_RK + 9 * j, el.KB);
    mm3(Ro, K + K_RKK + 9 * j, el.KC);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      el.off[k] = K[K_OPOS + 3 * j + k];
      el.axis[k] = K[K_AXIS + 3 * j + k];
    }
    lo = lower[j];
    hi = upper[j];
    q = warm[b * NJ + j];
  } else {
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      el.KA[e] = (e % 4 == 0) ? 1.0f : 0.0f;
      el.KB[e] = 0.0f;
      el.KC[e] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      el.off[k] = pos == TOE ? K[K_CPOS + 3 * leg + k] : 0.0f;
      el.axis[k] = 0.0f;
    }
    if (pos == 0) {
      // models/spatial.py::rotation_zyx of the base's ZYX Euler angles
      float sz, cz, sy, cy, sx, cx;
      sincosf(pose[3], &sz, &cz);
      sincosf(pose[4], &sy, &cy);
      sincosf(pose[5], &sx, &cx);
      el.KA[0] = cz * cy; el.KA[1] = cz * sy * sx - sz * cx; el.KA[2] = cz * sy * cx + sz * sx;
      el.KA[3] = sz * cy; el.KA[4] = sz * sy * sx + cz * cx; el.KA[5] = sz * sy * cx - cz * sx;
      el.KA[6] = -sy;     el.KA[7] = cy * sx;                el.KA[8] = cy * cx;
#pragma unroll
      for (int k = 0; k < 3; ++k) el.off[k] = pose[k];
    }
  }
  clk.mark(PH_SETUP);

  Toe best, cur;       // the toe at the best joints q and at the iterate qc
  toe_eval(el, q, pos, best, clk);
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    unsigned char* kp = kept ? kept + static_cast<long long>(pass) * (trans_it + rot_it) * n_legs + t
                             : nullptr;
    const bool write_kept = kp != nullptr && live && pos == 0;
    // refs/ik.py::translation_ik
    float qc = q, err[3];
    cur = best;
#pragma unroll
    for (int k = 0; k < 3; ++k) err[k] = cur.p[k] - des_k[k];
    float best_err = norm3(err);
    clk.mark(PH_ERR);
#pragma unroll 1
    for (int it = 0; it < trans_it; ++it) {
      const float d = damped_solve(cur.col, err, damp, a);
      qc = joint ? clamp_nan(qc + step * (-d), lo, hi) : qc;
      clk.mark(PH_TSOLVE);
      toe_eval(el, qc, pos, cur, clk);
#pragma unroll
      for (int k = 0; k < 3; ++k) err[k] = cur.p[k] - des_k[k];
      const float e = norm3(err);
      const bool better = e < best_err;
      if (write_kept) kp[it * n_legs] = better;
      q = better ? qc : q;
      select_toe(better, cur, best);
      best_err = min_nan(e, best_err);
      clk.mark(PH_ERR);
    }
    // refs/ik.py::rotation_ik
    float w3[3];
    qc = q;
    cur = best;
    rot_err(Rd, cur.R, w3);
    best_err = norm3(w3);
    clk.mark(PH_ERR);
#pragma unroll 1
    for (int it = 0; it < rot_it; ++it) {
      const float d = rotation_step(cur, w3, damp, a, clk);
      qc = joint ? clamp_nan(qc + step * d, lo, hi) : qc;
      clk.mark(PH_RSOLVE);
      toe_eval(el, qc, pos, cur, clk);
      rot_err(Rd, cur.R, w3);
      const float e = norm3(w3);
      const bool better = e < best_err;
      if (write_kept) kp[(trans_it + it) * n_legs] = better;
      q = better ? qc : q;
      select_toe(better, cur, best);
      best_err = min_nan(e, best_err);
      clk.mark(PH_ERR);
    }
    if (live && joint) (pass == 0 ? qj1 : qref)[bs * NJ + LEG_NJ * leg + a] = q;
    clk.mark(PH_STORE);
  }
  clk.flush();
}

}  // namespace

// poses (B, S, 6), warm (B, NJ), des (B, S, 2, 3), R_des (B, 3, 3), the
// joint limits lower, upper (NJ) -> qj1, qref (B, S, NJ) and, if kept is
// not null, every keep-if-improved test (2, trans_it + rot_it, B, S, 2).
// 2 B S must fit a C int (2^31 - 1), as the wrapper checks.
extern "C" int hk_leg_ik(const float* consts, const float* lower, const float* upper,
                         const float* poses, const float* warm, const float* des,
                         const float* R_des, float* qj1, float* qref, unsigned char* kept,
                         int batch, int n_samples, int trans_it, int rot_it, float step,
                         float damp, void* stream) {
  const long long n = static_cast<long long>(batch) * n_samples;
  if (batch < 1 || n_samples < 1 || trans_it < 0 || rot_it < 0 || N_LEGS * n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>((n + SAMPLES_PER_WARP - 1) / SAMPLES_PER_WARP);
  leg_ik_kernel<<<warps, LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, lower, upper, poses, warm, des, R_des, qj1, qref, kept, n_samples, n, trans_it,
      rot_it, step, damp);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LEG_IK_PHASE_CLOCKS
// The phase sums since the last call (IK_PHASES of them), then zeroed.
extern "C" int hk_leg_ik_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ik_phase_cycles, sizeof(ik_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[IK_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ik_phase_cycles, zero, sizeof(zero)));
}
#endif
