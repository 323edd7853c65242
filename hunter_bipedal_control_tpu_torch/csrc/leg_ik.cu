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
// One thread per (scenario, sample, leg) runs both passes in series.  The
// split per leg is exact: the IK writes the joints q[6:] only, so the base
// pose q[0:6] is fixed throughout; each leg is a chain of five joints from
// the base (static_assert below), so a toe's placement and its Jacobian's
// leg block (columns 6 + 5 leg .. 6 + 5 leg + 4 of the whole-body contact
// Jacobian) depend on the base pose and that leg's joints alone; the 5x5
// damped systems, the step, the clamp to the joint limits and the
// keep-if-improved test on the error norm are all per leg.  The plain
// version runs whole-body FK for both legs at once, so the two differ only
// in rounding.
//
// Per step, as the JAX functions: the toe's world position and rotation
// (the leg chain from rotation_zyx(pose[3:6]), then the contact frame's
// offset; its rotation is identity, which models/soa.py::build_consts
// asserts), the 6x5 LOCAL_WORLD_ALIGNED Jacobian block (axis x (p_toe -
// anchor); axis), the damped 5x5 normal system J'J + damp I inverted by
// Gauss-Jordan with natural-order pivots and the +1e-30 of
// gj_inverse(pivot=True) (gj.cuh, B6's device code), the step, the clamp,
// the toe at the new joints and keep-if-improved.  The rotation step works
// in the toe's local frame (R' J), projects through I - Jlin'
// inv3(Jlin Jlin' + damp I) Jlin, and measures the error with log3 as
// models/spatial.py::log3 does (clamped acos, the theta < 1e-6 branch).
// The toe at the new joints also serves the next step (the plain version
// evaluates it again at the same joints, with the same result).
//
// Bound on the card: per leg and pass, 7 toe evaluations, 3 translation
// and 2 rotation steps, ~11k float operations (chip_smoke.py::ik_cost);
// ~40 MFLOP at B=128, S=7, well under a microsecond at 67 TFLOP/s, and a
// few hundred bytes per sample.  The chain is serial within a thread and
// the threads are few (1,792 at B=128), so the kernel is latency bound: one
// warp per block spreads the warps over the SMs; the per-thread state lives
// in registers and, past 255 of them, in local memory.
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

#include "gj.cuh"
#include "soa_model.cuh"

namespace {

constexpr int LEG_NJ = 5;
constexpr int N_LEGS = 2;
constexpr int IK_THREADS = 32;

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

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // NaN stays NaN, as torch.clamp
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);  // NaN wins, as torch.minimum
}

__device__ __forceinline__ float norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

struct Toe {
  float p[3];             // world position
  float R[9];             // world rotation
  float J[6][LEG_NJ];     // rows 0:3 linear, 3:6 angular, the leg's columns
};

// the toe of leg `leg` at the leg's joints q, from the base placement (Rb, pb)
__device__ void toe_state(const float* K, const float* Rb, const float* pb, int leg,
                          const float* q, Toe* t) {
  float R[9], p[3], aw[LEG_NJ][3], anchor[LEG_NJ][3];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = Rb[e];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = pb[k];
#pragma unroll
  for (int i = 0; i < LEG_NJ; ++i) {
    const int j = LEG_NJ * leg + i;
    float Ror[9], off[3], rod[9];
    mm3(R, K + K_OROT + 9 * j, Ror);
    mv3(R, K + K_OPOS + 3 * j, off);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = p[k] + off[k];
      anchor[i][k] = p[k];
    }
    mv3(Ror, K + K_AXIS + 3 * j, aw[i]);
    const float c = cosf(q[i]), s = sinf(q[i]);
    const float u = 1.0f - c;
#pragma unroll
    for (int e = 0; e < 9; ++e)
      rod[e] = ((e % 4 == 0) ? 1.0f : 0.0f) + s * K[K_RK + 9 * j + e] + u * K[K_RKK + 9 * j + e];
    mm3(Ror, rod, R);
  }
  float off[3];
  mv3(R, K + K_CPOS + 3 * leg, off);
#pragma unroll
  for (int k = 0; k < 3; ++k) t->p[k] = p[k] + off[k];
#pragma unroll
  for (int e = 0; e < 9; ++e) t->R[e] = R[e];
#pragma unroll
  for (int i = 0; i < LEG_NJ; ++i) {
    float r[3], lin[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = t->p[k] - anchor[i][k];
    cross3(aw[i], r, lin);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t->J[k][i] = lin[k];
      t->J[3 + k][i] = aw[i][k];
    }
  }
}

// models/spatial.py::log3 of Rd' R
__device__ void rot_err(const float* Rd, const float* R, float* w) {
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

// d = inv(G' G + damp I) G' e for G (3 x 5), e (3): refs/ik.py::_damped_solve
__device__ void damped_solve(const float (*G)[LEG_NJ], const float* e, float damp, float* d) {
  constexpr int W = 2 * LEG_NJ;
  float M[LEG_NJ * W], col[LEG_NJ], prow[W], rhs[LEG_NJ];
#pragma unroll
  for (int a = 0; a < LEG_NJ; ++a) {
#pragma unroll
    for (int c = 0; c < LEG_NJ; ++c) {
      M[a * W + c] = G[0][a] * G[0][c] + G[1][a] * G[1][c] + G[2][a] * G[2][c]
                     + (a == c ? damp : 0.0f);
      M[a * W + LEG_NJ + c] = (a == c) ? 1.0f : 0.0f;
    }
    rhs[a] = G[0][a] * e[0] + G[1][a] * e[1] + G[2][a] * e[2];
  }
  gj_eliminate<LEG_NJ, W, false>(M, true, col, prow, 0, 1);
#pragma unroll
  for (int a = 0; a < LEG_NJ; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < LEG_NJ; ++c) acc = acc + M[a * W + LEG_NJ + c] * rhs[c];
    d[a] = acc;
  }
}

struct Leg {
  const float* K;
  float Rb[9], pb[3];     // base placement (fixed)
  float lo[LEG_NJ], hi[LEG_NJ];
  float des[3];           // toe target position
  float Rd[9];            // toe target rotation
  int leg;
  float step, damp;
};

// refs/ik.py::translation_ik for one leg: q in = start, out = best; each
// step's keep-if-improved test goes to kept[it * stride] if kept is given
__device__ void translation_ik(const Leg& g, float* q, int iters, unsigned char* kept,
                               long long stride) {
  Toe t;
  float cur[LEG_NJ];
#pragma unroll
  for (int a = 0; a < LEG_NJ; ++a) cur[a] = q[a];
  toe_state(g.K, g.Rb, g.pb, g.leg, cur, &t);
  float err[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) err[k] = t.p[k] - g.des[k];
  float best_err = norm3(err);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float d[LEG_NJ];
    damped_solve(t.J, err, g.damp, d);
#pragma unroll
    for (int a = 0; a < LEG_NJ; ++a)
      cur[a] = clamp_nan(cur[a] + g.step * (-d[a]), g.lo[a], g.hi[a]);
    toe_state(g.K, g.Rb, g.pb, g.leg, cur, &t);
#pragma unroll
    for (int k = 0; k < 3; ++k) err[k] = t.p[k] - g.des[k];
    const float e = norm3(err);
    if (kept) kept[it * stride] = e < best_err;
    if (e < best_err) {
#pragma unroll
      for (int a = 0; a < LEG_NJ; ++a) q[a] = cur[a];
    }
    best_err = min_nan(e, best_err);
  }
}

// refs/ik.py::rotation_ik for one leg, as translation_ik
__device__ void rotation_ik(const Leg& g, float* q, int iters, unsigned char* kept,
                            long long stride) {
  Toe t;
  float cur[LEG_NJ], w3[3];
#pragma unroll
  for (int a = 0; a < LEG_NJ; ++a) cur[a] = q[a];
  toe_state(g.K, g.Rb, g.pb, g.leg, cur, &t);
  rot_err(g.Rd, t.R, w3);
  float best_err = norm3(w3);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // local-frame Jacobians R' J
    float Jlin[3][LEG_NJ], Jang[3][LEG_NJ];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int a = 0; a < LEG_NJ; ++a) {
        Jlin[i][a] = t.R[i] * t.J[0][a] + t.R[3 + i] * t.J[1][a] + t.R[6 + i] * t.J[2][a];
        Jang[i][a] = t.R[i] * t.J[3][a] + t.R[3 + i] * t.J[4][a] + t.R[6 + i] * t.J[5][a];
      }
    // null-space projector N = I - Jlin' inv3(Jlin Jlin' + damp I) Jlin
    float JJt[9], iJ[9], T[3][LEG_NJ], N[LEG_NJ][LEG_NJ];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int a = 0; a < LEG_NJ; ++a) acc = acc + Jlin[i][a] * Jlin[k][a];
        JJt[3 * i + k] = acc + (i == k ? g.damp : 0.0f);
      }
    inv3(JJt, iJ);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int a = 0; a < LEG_NJ; ++a)
        T[i][a] = iJ[3 * i] * Jlin[0][a] + iJ[3 * i + 1] * Jlin[1][a] + iJ[3 * i + 2] * Jlin[2][a];
#pragma unroll
    for (int a = 0; a < LEG_NJ; ++a)
#pragma unroll
      for (int c = 0; c < LEG_NJ; ++c)
        N[a][c] = (a == c ? 1.0f : 0.0f)
                  - (Jlin[0][a] * T[0][c] + Jlin[1][a] * T[1][c] + Jlin[2][a] * T[2][c]);
    // w = damped solve of (Jang N) w = log3(Rd' R); step d = -N w
    float G[3][LEG_NJ], w[LEG_NJ];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < LEG_NJ; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int a = 0; a < LEG_NJ; ++a) acc = acc + Jang[i][a] * N[a][c];
        G[i][c] = acc;
      }
    damped_solve(G, w3, g.damp, w);
#pragma unroll
    for (int a = 0; a < LEG_NJ; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < LEG_NJ; ++c) acc = acc + N[a][c] * w[c];
      cur[a] = clamp_nan(cur[a] + g.step * (-acc), g.lo[a], g.hi[a]);
    }
    toe_state(g.K, g.Rb, g.pb, g.leg, cur, &t);
    rot_err(g.Rd, t.R, w3);
    const float e = norm3(w3);
    if (kept) kept[it * stride] = e < best_err;
    if (e < best_err) {
#pragma unroll
      for (int a = 0; a < LEG_NJ; ++a) q[a] = cur[a];
    }
    best_err = min_nan(e, best_err);
  }
}

__global__ void __launch_bounds__(IK_THREADS)
leg_ik_kernel(const float* __restrict__ K, const float* __restrict__ lower,
              const float* __restrict__ upper, const float* __restrict__ poses,
              const float* __restrict__ warm, const float* __restrict__ des,
              const float* __restrict__ R_des,
              float* __restrict__ qj1, float* __restrict__ qref,
              unsigned char* __restrict__ kept, int n_samples, int n_threads, int trans_it,
              int rot_it, float step, float damp) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  const int leg = static_cast<int>(t % N_LEGS);
  const long long bs = t / N_LEGS;      // scenario * n_samples + sample
  const long long b = bs / n_samples;
  Leg g;
  g.K = K;
  g.leg = leg;
  g.step = step;
  g.damp = damp;
  const float* pose = poses + bs * 6;
  // models/spatial.py::rotation_zyx of the base's ZYX Euler angles
  const float cz = cosf(pose[3]), sz = sinf(pose[3]);
  const float cy = cosf(pose[4]), sy = sinf(pose[4]);
  const float cx = cosf(pose[5]), sx = sinf(pose[5]);
  g.Rb[0] = cz * cy; g.Rb[1] = cz * sy * sx - sz * cx; g.Rb[2] = cz * sy * cx + sz * sx;
  g.Rb[3] = sz * cy; g.Rb[4] = sz * sy * sx + cz * cx; g.Rb[5] = sz * sy * cx - cz * sx;
  g.Rb[6] = -sy;     g.Rb[7] = cy * sx;                g.Rb[8] = cy * cx;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.pb[k] = pose[k];
    g.des[k] = des[(bs * N_LEGS + leg) * 3 + k];
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) g.Rd[e] = R_des[b * 9 + e];
  float q[LEG_NJ];
#pragma unroll
  for (int a = 0; a < LEG_NJ; ++a) {
    const int j = LEG_NJ * leg + a;
    g.lo[a] = lower[j];
    g.hi[a] = upper[j];
    q[a] = warm[b * NJ + j];
  }
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    unsigned char* k = kept ? kept + static_cast<long long>(pass) * (trans_it + rot_it) * n_threads
                                  + t
                            : nullptr;
    translation_ik(g, q, trans_it, k, n_threads);
    rotation_ik(g, q, rot_it, k ? k + static_cast<long long>(trans_it) * n_threads : nullptr,
                n_threads);
    float* out = (pass == 0 ? qj1 : qref) + bs * NJ + LEG_NJ * leg;
#pragma unroll
    for (int a = 0; a < LEG_NJ; ++a) out[a] = q[a];
  }
}

}  // namespace

// poses (B, S, 6), warm (B, NJ), des (B, S, 2, 3), R_des (B, 3, 3), the
// joint limits lower, upper (NJ) -> qj1, qref (B, S, NJ) and, if kept is
// not null, every keep-if-improved test (2, trans_it + rot_it, B, S, 2).
// One thread per (scenario, sample, leg): 2 B S must fit the int thread
// index (2^31 - 1).
extern "C" int hk_leg_ik(const float* consts, const float* lower, const float* upper,
                         const float* poses, const float* warm, const float* des,
                         const float* R_des, float* qj1, float* qref, unsigned char* kept,
                         int batch, int n_samples, int trans_it, int rot_it, float step,
                         float damp, void* stream) {
  const long long n = static_cast<long long>(N_LEGS) * batch * n_samples;
  if (batch < 1 || n_samples < 1 || trans_it < 0 || rot_it < 0 || n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((n + IK_THREADS - 1) / IK_THREADS);
  leg_ik_kernel<<<blocks, IK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, lower, upper, poses, warm, des, R_des, qj1, qref, kept, n_samples,
      static_cast<int>(n), trans_it, rot_it, step, damp);
  return static_cast<int>(cudaGetLastError());
}
