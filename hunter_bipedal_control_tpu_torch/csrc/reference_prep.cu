// B8b: the MPC step's reference prep, minus its IK (B8a), in two launches.
//
// hk_swing_plan (B8b1) replaces, per scenario, everything of
// hunter_bipedal_control_tpu/solver/mpc.py::prepare_references (:96-134)
// before the IK: _current_feet (:137; models/kinematics.py::fk :79 and
// contact_positions :144), refs/swing_planner.py::update_planner (:202-325:
// the commanded contacts at init_time + 0.001, the latest stance positions,
// gait/mode_schedule.py::swing_windows :209, the next middle times,
// _raibert_foothold :113 for every (leg, phase), the fresh-window scans,
// _swing_nodes :133 and _stance_nodes :190) and _joint_reference's
// sampling (:56-93: the S sample times, refs/targets.py::_interp :34 of the
// target's states and inputs there, the toe targets by foot_reference :328
// and refs/splines.py::eval_piecewise :38, R_des by
// models/spatial.py::rotation_zyx).  It writes the new planner state, the
// swing node arrays and windows (SwingRefs) and exactly the tensors
// refs/ik.py::leg_ik (B8a) takes.
//
// hk_knot_refs (B8b2) replaces the rest of prepare_references after the
// IK, one thread per (scenario, knot): the knot time init_time + k (H / N),
// the contact flags by mode_at_time (:188), the four contacts' foot
// position and velocity by foot_reference, and x_nom, the interpolation of
// the IK-modified target (the sample states with joints 12..21 from B8a's
// joint_refs, formed on the fly) at the knot; it also writes those
// modified sample states, so the modified target needs no concatenation.
// The plain versions are the port's solver/mpc.py::swing_plan_plain and
// knot_refs_plain (today's torch code of update_planner, foot_reference,
// _interp and the rest).
//
// hk_contact_class (B16) is the full-order loop's contact classification
// at one tick (the JAX package's runtime/sim_loop.py:172-202, inside its
// jitted scan: gait/mode_schedule.py::swing_windows :209 over the period's
// span, phase_index_at_time :205, estim/contact.py::classify_contact :103
// and early_late_contact_flags :123), a thread per (scenario, leg); its
// plain version is estim/contact.py::contact_class_plain.  It shares
// B8b1's window search (contact_window), so the two cannot drift apart.
// It reads ~0.7 KB of schedule per scenario and writes 12 bytes: bytes
// bound, a few µs of launch at any batch.
//
// Exactness.  Every decision of the prep compares float32 times: the
// phase of a time (searchsorted(right) over the event times), the
// target's and the splines' segments, stops + 1e-6, init_time < e,
// e > m_prev + 1e-9, stops >= last_real_event - 1e-9.  The float32 plain
// version rounds after every torch operation, and a time that lands on a
// gait event flips a phase if one rounding differs (the float32 ulp at
// t = 16-32 s is 1.9e-6, above the 1e-6 offset).  So every time is
// computed here with __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn in
// torch's order (nvcc would contract a*b + c into an FMA), with each
// Python constant rounded to float32 from its double as torch rounds it,
// and the searches are torch's binary search: the decisions equal the
// float32 plain version's on the card bit for bit.  torch on CUDA divides a
// tensor by a Python number as a product with the number's float32
// reciprocal (1.0f / b, formed on the host), so the kernel does too where
// the plain version divides by a number (the sample steps i / (S - 1), the
// stance splines' thirds, |z| / 9.81); on the CPU torch divides exactly, so
// those times can differ from the CPU plain version's by an ulp.  An ulp
// matters downstream: the IK's rank-3 systems amplify it up to ~1e6, and
// the MPC step's far-from-nominal scenarios are ill-conditioned
// (chip_smoke.py's main-path check).  The values (positions, velocities,
// rotations) use the same operations as
// torch; the FK (soa_model.cuh, contracted), cosf/sinf and the order of the
// 3x3 products' sums may differ from torch's.
//
// Bound on the card: B8b1 writes ~37 KB per scenario (the three swing
// node arrays are 33 KB of it) and does ~0.1 MFLOP; B8b2 writes ~0.2 KB per
// knot (chip_smoke.py::swing_plan_cost, knot_refs_cost): a few µs at
// B=128, bytes bound.  The work is a few hundred dependent operations per
// thread, so both kernels are latency bound far above that; B8b1 runs one
// 256-thread block per scenario (a thread per (leg, phase), 228 of 256,
// with the schedule, target, windows and candidates in shared memory, one
// thread for the FK of x_init), B8b2 128-thread blocks over (scenario,
// knot).  Shared inputs (a schedule, target, command or default joints
// broadcast over the batch by expand) are read by a batch stride, 0 for
// those, so the step spends no copy on them.
//
// Model constants: B1's buffer (ocp/soa_kernel.py::consts_buffer, which
// checks the topology).  True float32: no fast math.  Mode numbers outside
// 0..3 give NaN flags (torch raises on them).
#include <cuda_runtime.h>

#include "soa_model.cuh"

namespace {

constexpr int MAX_PHASES = 56;
constexpr int P1 = MAX_PHASES + 1;
constexpr int NLEG = 4;
constexpr int NAX = 3;
constexpr int NNODE = 4;
constexpr int NODE_STRIDE = NAX * NNODE;  // floats per (leg, phase)
constexpr int NXS = 12 + NJ;              // state width
constexpr int NUS = 12 + NJ;              // input width
constexpr int MAX_T = 16;                 // target nodes staged in shared memory
                                          // (reference_prep.py's MAX_TARGET_NODES)
constexpr int PLAN_THREADS = 256;
constexpr int KNOT_THREADS = 128;
constexpr int CLASS_THREADS = 128;
constexpr int N_PLAN_DEC_FIXED = 1 + 4 * NLEG * P1;  // + 8 per sample
constexpr int N_KNOT_DEC = 2 + NLEG * NAX;
static_assert(NC == NLEG, "reference_prep: the swing planner plans the 4 contacts");
static_assert(NLEG * P1 <= PLAN_THREADS, "reference_prep: a thread per (leg, phase)");

// torch's rounding of each Python constant: the double, then float32
constexpr float BIG = static_cast<float>(1e9);
constexpr float HALF_BIG = static_cast<float>(1e9 / 2);
constexpr float CMD_DT = static_cast<float>(0.001);
constexpr float NEXT_EPS = static_cast<float>(1e-6);
constexpr float TAIL_EPS = static_cast<float>(1e-9);
constexpr float INTERP_EPS = static_cast<float>(1e-9);
constexpr float DT_MIN = static_cast<float>(1e-6);
constexpr float RAIBERT_K = static_cast<float>(0.03);
constexpr float EARLY_MARGIN = static_cast<float>(0.009);  // early_late_contact_flags' 9 ms
// torch's CUDA reciprocals of the Python divisors 9.81 and 3
constexpr float INV_G = 1.0f / static_cast<float>(9.81);
constexpr float INV_3 = 1.0f / 3.0f;
// _swing_nodes' tuned shape, refs/swing_planner.py's XY_SHAPE and Z_SHAPE
// (tests/test_torch_prep.py holds the two equal)
constexpr float XY_A1 = static_cast<float>(0.417), XY_A1C = static_cast<float>(1 - 0.417);
constexpr float XY_L1 = static_cast<float>(0.650), XY_L1C = static_cast<float>(1 - 0.650);
constexpr float XY_K1 = static_cast<float>(1.770);
constexpr float Z_A1 = static_cast<float>(0.251), Z_A1C = static_cast<float>(1 - 0.251);
constexpr float Z_L1 = static_cast<float>(0.749), Z_K1 = static_cast<float>(1.338);
constexpr float Z_A2 = static_cast<float>(0.630), Z_A2C = static_cast<float>(1 - 0.630);
constexpr float Z_L2 = static_cast<float>(0.570), Z_L2C = static_cast<float>(1 - 0.570);
constexpr float Z_K2L2 = static_cast<float>(1.633 * 0.570);
constexpr float Z_K3L2 = static_cast<float>(0.000 * 0.570);

// MODE_CONTACTS: FLY, R, L, STANCE over [L_toe, R_toe, L_heel, R_heel]
__constant__ float kModeContacts[4][NLEG] = {
    {0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f, 1.0f},
    {1.0f, 0.0f, 1.0f, 0.0f}, {1.0f, 1.0f, 1.0f, 1.0f}};

// one rounding per operation, as torch's separate operations round
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp / maximum / minimum: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp01(float x) { return clamp_max(clamp_min(x, 0.0f), 1.0f); }
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__device__ __forceinline__ float mode_contact(long long mode, int leg) {
  return (mode >= 0 && mode < 4) ? kModeContacts[mode][leg] : __int_as_float(0x7fc00000);
}

// torch.searchsorted(a[0:n], v, right=True): the first i with a[i] > v
__device__ int upper_bound(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] > v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// targets.py::_interp's segment (clamped to 0..n-2) and weight at t
__device__ __forceinline__ int segment(const float* times, int n, float t) {
  const int i = upper_bound(times, n, t) - 1;
  return i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
}
__device__ __forceinline__ float weight(const float* times, int i, float t) {
  const float den = clamp_min(sub_rn(times[i + 1], times[i]), INTERP_EPS);
  return clamp01(div_rn(sub_rn(t, times[i]), den));
}
// (1 - w) v0 + w v1
__device__ __forceinline__ float lerp_rn(float v0, float v1, float w) {
  return add_rn(mul_rn(sub_rn(1.0f, w), v0), mul_rn(w, v1));
}

// models/spatial.py::rotation_zyx in torch's order
__device__ void rotation_zyx_rn(float z, float y, float x, float* R) {
  const float cz = cosf(z), sz = sinf(z), cy = cosf(y), sy = sinf(y);
  const float cx = cosf(x), sx = sinf(x);
  R[0] = mul_rn(cz, cy);
  R[1] = sub_rn(mul_rn(mul_rn(cz, sy), sx), mul_rn(sz, cx));
  R[2] = add_rn(mul_rn(mul_rn(cz, sy), cx), mul_rn(sz, sx));
  R[3] = mul_rn(sz, cy);
  R[4] = add_rn(mul_rn(mul_rn(sz, sy), sx), mul_rn(cz, cx));
  R[5] = sub_rn(mul_rn(mul_rn(sz, sy), cx), mul_rn(cz, sx));
  R[6] = -sy;
  R[7] = mul_rn(cy, sx);
  R[8] = mul_rn(cy, cx);
}

__device__ __forceinline__ float dot3_rn(const float* r, const float* v) {
  return add_rn(add_rn(mul_rn(r[0], v[0]), mul_rn(r[1], v[1])), mul_rn(r[2], v[2]));
}

// splines.py::eval_piecewise of one 4-node spline at t: position, velocity;
// the segment it took in *seg
__device__ void eval_spline(const float* tn, const float* pn, const float* vn, float t,
                            float* pos, float* vel, int* seg) {
  int i = upper_bound(tn, NNODE, t) - 1;
  i = i < 0 ? 0 : (i > NNODE - 2 ? NNODE - 2 : i);
  const float t0 = tn[i], t1 = tn[i + 1];
  const float p0 = pn[i], v0 = vn[i], p1 = pn[i + 1], v1 = vn[i + 1];
  const float dt = clamp_min(sub_rn(t1, t0), DT_MIN);
  const float dv0 = mul_rn(v0, dt), dv1 = mul_rn(v1, dt);
  const float b = dv0;
  const float c = -sub_rn(add_rn(add_rn(mul_rn(3.0f, p0), mul_rn(2.0f, dv0)), dv1),
                          mul_rn(3.0f, p1));
  const float d = sub_rn(add_rn(add_rn(mul_rn(2.0f, p0), dv0), dv1), mul_rn(2.0f, p1));
  const float s = clamp01(div_rn(sub_rn(t, t0), dt));
  *pos = add_rn(add_rn(add_rn(p0, mul_rn(b, s)), mul_rn(mul_rn(c, s), s)),
                mul_rn(mul_rn(mul_rn(d, s), s), s));
  *vel = div_rn(add_rn(add_rn(b, mul_rn(mul_rn(2.0f, c), s)),
                       mul_rn(mul_rn(mul_rn(3.0f, d), s), s)), dt);
  *seg = i;
}

// one scenario's planner state in shared memory
struct Plan {
  float ev[MAX_PHASES];
  long long mode[P1];
  float tt[MAX_T];
  float ts[MAX_T][NXS];
  float tu[MAX_T][NUS];
  float init, final_t, h_start, h_end, last_real;
  float swing_height, swing_time_scale, next_z, yaw_lead;
  float pose[6];                       // the target's pose at init_time
  float vl[3], half_lin[3], sym_k[3], pcent[3];
  float latest[NLEG][3];
  float start[NLEG][P1], stop[NLEG][P1], mid[NLEG][P1], e_el[NLEG][P1];
  unsigned char elig[NLEG][P1], fresh[NLEG][P1];
  int idx1[NLEG][P1], idx2[NLEG][P1];
  float cand[NLEG][P1][3];
  FlowKin kin;                         // FK of x_init (one thread)
};

// the 3 axes' 4-node splines of (leg, phase p), axis `a`: _swing_nodes for a
// swing phase, _stance_nodes for a stance phase (the swing planner's refs)
__device__ void leg_nodes(const Plan& P, int leg, int p, int a, float* tn, float* pn,
                          float* vn) {
  const float s = P.start[leg][p], e = P.stop[leg][p];
  const int i1 = P.idx1[leg][p], i2 = P.idx2[leg][p];
  const float* next = i1 >= 0 ? P.cand[leg][i1] : P.latest[leg];
  if (mode_contact(P.mode[p], leg) < 0.5f) {
    const float* last = i2 >= 0 ? P.cand[leg][i2] : P.latest[leg];
    const float dt = sub_rn(e, s);
    if (a < 2) {
      const float p0 = last[a], p1 = next[a];
      tn[0] = s;
      tn[1] = add_rn(mul_rn(XY_A1C, s), mul_rn(XY_A1, e));
      tn[2] = e;
      tn[3] = e;
      pn[0] = p0;
      pn[1] = add_rn(mul_rn(XY_L1C, p0), mul_rn(XY_L1, p1));
      pn[2] = p1;
      pn[3] = p1;
      vn[0] = 0.0f;
      vn[1] = div_rn(mul_rn(XY_K1, sub_rn(p1, p0)), clamp_min(dt, DT_MIN));
      vn[2] = 0.0f;
      vn[3] = 0.0f;
    } else {
      const float z0 = last[2], z1 = next[2];
      const float scaling = clamp_max(div_rn(dt, P.swing_time_scale), 1.0f);
      const float max_z = add_rn(max_nan(z0, z1), mul_rn(scaling, P.swing_height));
      const float den2 = clamp_min(mul_rn(Z_A2C, dt), DT_MIN);
      tn[0] = s;
      tn[1] = add_rn(mul_rn(Z_A1C, s), mul_rn(Z_A1, e));
      tn[2] = add_rn(mul_rn(Z_A2C, s), mul_rn(Z_A2, e));
      tn[3] = e;
      pn[0] = z0;
      pn[1] = mul_rn(Z_L1, max_z);
      pn[2] = add_rn(mul_rn(Z_L2, max_z), mul_rn(Z_L2C, z1));
      pn[3] = z1;
      vn[0] = 0.0f;
      vn[1] = div_rn(mul_rn(Z_K1, mul_rn(Z_L1, sub_rn(max_z, z0))),
                     clamp_min(mul_rn(Z_A1, dt), DT_MIN));
      vn[2] = div_rn(mul_rn(Z_K2L2, sub_rn(z1, max_z)), den2);
      vn[3] = div_rn(mul_rn(Z_K3L2, sub_rn(z1, max_z)), den2);
    }
  } else {
    tn[0] = s;
    tn[1] = mul_rn(add_rn(mul_rn(2.0f, s), e), INV_3);
    tn[2] = mul_rn(add_rn(s, mul_rn(2.0f, e)), INV_3);
    tn[3] = e;
#pragma unroll
    for (int n = 0; n < NNODE; ++n) {
      pn[n] = next[a];
      vn[n] = 0.0f;
    }
  }
}

// gait/mode_schedule.py::swing_windows for one (leg, phase p): the start
// and stop of the contiguous run of phases around p in which the leg's
// contact flag stays the same, the first phase starting at h_start and the
// stops clipped to h_end (B8b1 and B16 share it)
__device__ __forceinline__ void contact_window(const float* ev, const long long* mode, int leg,
                                               int p, float h_start, float h_end, float* start,
                                               float* stop) {
  int qf = p;
  while (qf > 0 && mode_contact(mode[qf - 1], leg) == mode_contact(mode[qf], leg)) --qf;
  int qb = p;
  while (qb < P1 - 1 && mode_contact(mode[qb + 1], leg) == mode_contact(mode[qb], leg)) ++qb;
  *start = qf == 0 ? h_start : ev[qf - 1];
  *stop = min_nan(qb < MAX_PHASES ? ev[qb] : BIG, h_end);
}

__device__ __forceinline__ int phase_of(const float* ev, float t) {
  const int p = upper_bound(ev, MAX_PHASES, t);
  return p > P1 - 1 ? P1 - 1 : p;
}

__global__ void __launch_bounds__(PLAN_THREADS)
swing_plan_kernel(const float* __restrict__ K, const float* __restrict__ gx, int sx,
                  const float* __restrict__ ginit, int sinit,
                  const float* __restrict__ gev, int sev,
                  const long long* __restrict__ gmode, int smode,
                  const float* __restrict__ gtt, int stt,
                  const float* __restrict__ gts, int sts,
                  const float* __restrict__ gtu, int stu, int T,
                  const float* __restrict__ gcmd, int scmd,
                  const float* __restrict__ gdj, int sdj,
                  const float* __restrict__ glat, int slat,
                  const float* __restrict__ cfg_swing_height,
                  const float* __restrict__ cfg_swing_time_scale,
                  const float* __restrict__ cfg_feet_bias,
                  const float* __restrict__ cfg_next_z,
                  const float* __restrict__ cfg_yaw_lead,
                  const float* __restrict__ cfg_vel_fb, float horizon, int S,
                  float* __restrict__ o_latest, float* __restrict__ o_ntimes,
                  float* __restrict__ o_npos, float* __restrict__ o_nvel,
                  float* __restrict__ o_start, float* __restrict__ o_stop,
                  float* __restrict__ o_cs, float* __restrict__ o_Ts,
                  float* __restrict__ o_states, float* __restrict__ o_inputs,
                  float* __restrict__ o_poses, float* __restrict__ o_des,
                  float* __restrict__ o_Rdes, float* __restrict__ o_warm,
                  int* __restrict__ o_dec) {
  __shared__ Plan P;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const float* x = gx + b * sx;
  const float* ev_g = gev + b * sev;
  const long long* mode_g = gmode + b * smode;
  const float* cmd = gcmd + b * scmd;
  int* dec = o_dec ? o_dec + b * (N_PLAN_DEC_FIXED + 8 * S) : nullptr;

  // ---- stage the schedule and the target; one thread runs the FK ----
  for (int i = tid; i < MAX_PHASES; i += PLAN_THREADS) P.ev[i] = ev_g[i];
  for (int i = tid; i < P1; i += PLAN_THREADS) P.mode[i] = mode_g[i];
  for (int i = tid; i < T; i += PLAN_THREADS) P.tt[i] = gtt[b * stt + i];
  for (int i = tid; i < T * NXS; i += PLAN_THREADS)
    P.ts[i / NXS][i % NXS] = gts[b * sts + i];
  for (int i = tid; i < T * NUS; i += PLAN_THREADS)
    P.tu[i / NUS][i % NUS] = gtu[b * stu + i];
  if (tid == 0) {
    fk_dev(K, x + 6, &P.kin);
    contact_points_dev(K, &P.kin);
  }
  __syncthreads();

  // ---- the scenario's scalars (update_planner's head) ----
  if (tid == 0) {
    const float init = ginit[b * sinit];
    const float final_t = add_rn(init, horizon);
    const float hz = sub_rn(final_t, init);
    P.init = init;
    P.final_t = final_t;
    P.h_start = sub_rn(init, hz);
    P.h_end = add_rn(final_t, hz);
    float last = -BIG;
    for (int i = 0; i < MAX_PHASES; ++i) last = max_nan(last, P.ev[i] < HALF_BIG ? P.ev[i] : -BIG);
    P.last_real = last;
    P.swing_height = *cfg_swing_height;
    P.swing_time_scale = *cfg_swing_time_scale;
    P.next_z = *cfg_next_z;
    P.yaw_lead = *cfg_yaw_lead;
    // the commanded contacts just after init_time, the latest stance positions
    const int cmd_phase = upper_bound(P.ev, MAX_PHASES, add_rn(init, CMD_DT));
    const float* prev = glat + b * slat;
    for (int l = 0; l < NLEG; ++l) {
      const bool stance = mode_contact(P.mode[cmd_phase], l) > 0.5f;
      for (int k = 0; k < 2; ++k) {
        P.latest[l][k] = stance ? P.kin.pc[l][k] : prev[3 * l + k];
        o_latest[(b * NLEG + l) * 3 + k] = P.latest[l][k];
      }
      P.latest[l][2] = P.next_z;
      o_latest[(b * NLEG + l) * 3 + 2] = P.next_z;
    }
    if (dec) dec[0] = cmd_phase;
    // the target at init_time, the measured velocity feedback, the command
    const int i = segment(P.tt, T, init);
    const float w = weight(P.tt, i, init);
    float cv[3];
    for (int j = 0; j < 6; ++j) P.pose[j] = lerp_rn(P.ts[i][6 + j], P.ts[i + 1][6 + j], w);
    const float fb = *cfg_vel_fb;
    for (int j = 0; j < 3; ++j) {
      const float c = lerp_rn(P.ts[i][j], P.ts[i + 1][j], w);
      cv[j] = add_rn(c, mul_rn(fb, sub_rn(x[j], c)));
    }
    float R[9], vcl[3], vca[3];
    rotation_zyx_rn(P.pose[3], P.pose[4], P.pose[5], R);
    for (int j = 0; j < 3; ++j) {
      vcl[j] = dot3_rn(R + 3 * j, cmd);
      vca[j] = dot3_rn(R + 3 * j, cmd + 3);
    }
    const float vl[3] = {cv[0], cv[1], 0.0f};
    const float cr[3] = {sub_rn(mul_rn(vl[1], vca[2]), mul_rn(vl[2], vca[1])),
                         sub_rn(mul_rn(vl[2], vca[0]), mul_rn(vl[0], vca[2])),
                         sub_rn(mul_rn(vl[0], vca[1]), mul_rn(vl[1], vca[0]))};
    const float cf = mul_rn(0.5f, sqrtf(mul_rn(fabsf(P.pose[2]), INV_G)));
    for (int j = 0; j < 3; ++j) {
      P.vl[j] = vl[j];
      P.half_lin[j] = add_rn(mul_rn(0.5f, vl[j]), mul_rn(0.5f, vcl[j]));
      P.sym_k[j] = mul_rn(RAIBERT_K, sub_rn(vl[j], vcl[j]));
      P.pcent[j] = mul_rn(cf, cr[j]);
    }
  }
  __syncthreads();

  const bool lane = tid < NLEG * P1;
  const int leg = tid / P1, p = tid % P1;

  // ---- swing_windows: the contact window around each (leg, phase) ----
  if (lane) {
    const float c = mode_contact(P.mode[p], leg);
    contact_window(P.ev, P.mode, leg, p, P.h_start, P.h_end, &P.start[leg][p], &P.stop[leg][p]);
    const long long o = (b * NLEG + leg) * P1 + p;
    o_start[o] = P.start[leg][p];
    o_stop[o] = P.stop[leg][p];
    o_cs[o] = c;
  }
  __syncthreads();

  // ---- the next middle time and the Raibert candidate of each (leg, phase) ----
  if (lane) {
    const float e = P.stop[leg][p];
    const int nxt = phase_of(P.ev, add_rn(e, NEXT_EPS));
    const bool tail = e >= sub_rn(P.last_real, TAIL_EPS);
    const float mid_t = tail ? e : mul_rn(0.5f, add_rn(e, P.stop[leg][nxt]));
    const float q_t = add_rn(mid_t, P.yaw_lead);
    const int i = segment(P.tt, T, q_t);
    const float w = weight(P.tt, i, q_t);
    float ang[3], R[9], rb[3];
    for (int j = 0; j < 3; ++j) ang[j] = lerp_rn(P.ts[i][9 + j], P.ts[i + 1][9 + j], w);
    rotation_zyx_rn(ang[0], ang[1], ang[2], R);
    const float* bias = cfg_feet_bias + 3 * leg;
    for (int j = 0; j < 3; ++j) rb[j] = dot3_rn(R + 3 * j, bias);
    const float dt_sh = sub_rn(e, P.init), dt_sym = sub_rn(mid_t, e);
    for (int j = 0; j < 2; ++j) {
      const float sh = add_rn(mul_rn(dt_sh, P.half_lin[j]), rb[j]);
      const float sym = add_rn(mul_rn(dt_sym, P.vl[j]), P.sym_k[j]);
      P.cand[leg][p][j] = add_rn(add_rn(add_rn(P.pose[j], sh), sym), P.pcent[j]);
    }
    P.cand[leg][p][2] = P.next_z;
    const bool elig = mode_contact(P.mode[p], leg) < 0.5f && P.init < e;
    P.elig[leg][p] = elig;
    P.e_el[leg][p] = elig ? e : -BIG;
    P.mid[leg][p] = mid_t;
    if (dec) {
      const int o = 1 + leg * P1 + p;
      dec[o] = nxt;
      dec[o + NLEG * P1] = tail;
      dec[o + 2 * NLEG * P1] = i;
    }
  }
  __syncthreads();

  // ---- the fresh swing windows ahead of init_time (cummax scans) ----
  if (lane) {
    float m_prev = -BIG;
    for (int q = 0; q < p; ++q) m_prev = max_nan(m_prev, P.e_el[leg][q]);
    const float e = P.stop[leg][p];
    const bool fresh = P.elig[leg][p] && e > add_rn(m_prev, TAIL_EPS);
    P.fresh[leg][p] = fresh;
    if (dec) dec[1 + 3 * NLEG * P1 + leg * P1 + p] = fresh;
  }
  __syncthreads();
  if (lane) {
    int i1 = -1;
    for (int q = p; q >= 0 && i1 < 0; --q)
      if (P.fresh[leg][q]) i1 = q;
    int i2 = -1;
    for (int q = i1 - 1; q >= 0 && i2 < 0; --q)
      if (P.fresh[leg][q]) i2 = q;
    P.idx1[leg][p] = i1;
    P.idx2[leg][p] = i1 >= 0 ? i2 : -1;
  }
  __syncthreads();

  // ---- the swing node arrays (SwingRefs) ----
  if (lane) {
    const long long o = ((b * NLEG + leg) * P1 + p) * NODE_STRIDE;
    for (int a = 0; a < NAX; ++a) {
      float tn[NNODE], pn[NNODE], vn[NNODE];
      leg_nodes(P, leg, p, a, tn, pn, vn);
      for (int n = 0; n < NNODE; ++n) {
        o_ntimes[o + a * NNODE + n] = tn[n];
        o_npos[o + a * NNODE + n] = pn[n];
        o_nvel[o + a * NNODE + n] = vn[n];
      }
    }
  }

  // ---- the IK's inputs: the sample times, the target there, toe targets ----
  if (tid < S) {
    const int s = tid;
    float t;
    if (s == S - 1) {
      t = P.final_t;
    } else {
      const float inv = div_rn(1.0f, static_cast<float>(S - 1));
      const float step = mul_rn(static_cast<float>(s), inv);
      t = add_rn(mul_rn(P.init, sub_rn(1.0f, step)), mul_rn(P.final_t, step));
    }
    o_Ts[b * S + s] = t;
    const int i = segment(P.tt, T, t);
    const float w = weight(P.tt, i, t);
    const long long row = b * S + s;
    for (int j = 0; j < NXS; ++j) {
      const float v = lerp_rn(P.ts[i][j], P.ts[i + 1][j], w);
      o_states[row * NXS + j] = v;
      if (j >= 6 && j < 12) o_poses[row * 6 + j - 6] = v;
    }
    for (int j = 0; j < NUS; ++j) o_inputs[row * NUS + j] = lerp_rn(P.tu[i][j], P.tu[i + 1][j], w);
    const int ph = phase_of(P.ev, t);
    if (dec) {
      dec[N_PLAN_DEC_FIXED + s] = i;
      dec[N_PLAN_DEC_FIXED + S + s] = ph;
    }
    for (int l = 0; l < 2; ++l)
      for (int a = 0; a < NAX; ++a) {
        float tn[NNODE], pn[NNODE], vn[NNODE], pos, vel;
        int seg;
        leg_nodes(P, l, ph, a, tn, pn, vn);
        eval_spline(tn, pn, vn, t, &pos, &vel, &seg);
        o_des[(row * 2 + l) * 3 + a] = pos;
        if (dec) dec[N_PLAN_DEC_FIXED + 2 * S + (s * 2 + l) * NAX + a] = seg;
      }
  }
  if (tid == PLAN_THREADS - 1) {
    float R[9];
    rotation_zyx_rn(x[9], x[10], x[11], R);
    for (int e = 0; e < 9; ++e) o_Rdes[b * 9 + e] = R[e];
  }
  if (tid >= PLAN_THREADS - 1 - NJ && tid < PLAN_THREADS - 1) {
    const int j = tid - (PLAN_THREADS - 1 - NJ);
    o_warm[b * NJ + j] = gdj[b * sdj + j];
  }
}

__global__ void __launch_bounds__(KNOT_THREADS)
knot_refs_kernel(const float* __restrict__ ginit, int sinit,
                 const float* __restrict__ gev, int sev,
                 const long long* __restrict__ gmode, int smode,
                 const float* __restrict__ ntimes, const float* __restrict__ npos,
                 const float* __restrict__ nvel, const float* __restrict__ Ts,
                 const float* __restrict__ states, const float* __restrict__ jrefs,
                 int batch, int K1, int S, float h_over_n,
                 float* __restrict__ o_times, float* __restrict__ o_xnom,
                 float* __restrict__ o_flags, float* __restrict__ o_fpos,
                 float* __restrict__ o_fvel, float* __restrict__ o_mod,
                 int* __restrict__ o_dec) {
  const long long idx = static_cast<long long>(blockIdx.x) * KNOT_THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * K1) return;
  const long long b = idx / K1;
  const int k = static_cast<int>(idx % K1);
  const float* ev = gev + b * sev;
  const long long* mode = gmode + b * smode;
  const float t = add_rn(ginit[b * sinit], mul_rn(static_cast<float>(k), h_over_n));
  o_times[idx] = t;
  int* dec = o_dec ? o_dec + idx * N_KNOT_DEC : nullptr;

  // the contact flags (mode_at_time) and the foot references (foot_reference)
  const int ph = upper_bound(ev, MAX_PHASES, t);
  for (int l = 0; l < NLEG; ++l) o_flags[idx * NLEG + l] = mode_contact(mode[ph], l);
  const int p = ph > P1 - 1 ? P1 - 1 : ph;
  for (int l = 0; l < NLEG; ++l)
    for (int a = 0; a < NAX; ++a) {
      const long long o = ((b * NLEG + l) * P1 + p) * NODE_STRIDE + a * NNODE;
      float pos, vel;
      int seg;
      eval_spline(ntimes + o, npos + o, nvel + o, t, &pos, &vel, &seg);
      o_fpos[(idx * NLEG + l) * NAX + a] = pos;
      o_fvel[(idx * NLEG + l) * NAX + a] = vel;
      if (dec) dec[2 + l * NAX + a] = seg;
    }

  // x_nom: the modified target (sample states, joints from the IK) at t
  const float* tb = Ts + b * S;
  const int i = segment(tb, S, t);
  const float w = weight(tb, i, t);
  const float* r0 = states + (b * S + i) * NXS;
  const float* r1 = r0 + NXS;
  const float* j0 = jrefs + (b * S + i) * NJ;
  const float* j1 = j0 + NJ;
  for (int j = 0; j < NXS; ++j) {
    const bool joint = j >= 12 && j < 12 + NJ;
    o_xnom[idx * NXS + j] = lerp_rn(joint ? j0[j - 12] : r0[j], joint ? j1[j - 12] : r1[j], w);
  }
  if (dec) {
    dec[0] = ph;
    dec[1] = i;
  }
  // the modified target's sample states, one row per knot thread
  for (int r = k; r < S; r += K1)
    for (int j = 0; j < NXS; ++j) {
      const bool joint = j >= 12 && j < 12 + NJ;
      o_mod[(b * S + r) * NXS + j] =
          joint ? jrefs[(b * S + r) * NJ + j - 12] : states[(b * S + r) * NXS + j];
    }
}

// B16: the full-order loop's contact classification at one tick, a thread
// per (scenario, leg): the phase of tt, the leg's window around it over the
// period's span [t - H, t + 2H] (contact_window), frac, classify_contact
// and early_late_contact_flags, in torch's order with one rounding per
// operation
__global__ void __launch_bounds__(CLASS_THREADS)
contact_class_kernel(const float* __restrict__ gev, int sev, const long long* __restrict__ gmode,
                     int smode, const float* __restrict__ t_period,
                     const float* __restrict__ tt, const float* __restrict__ cmd,
                     const float* __restrict__ est, const float* __restrict__ threshold,
                     int batch, float horizon, float horizon2, bool* __restrict__ o_est,
                     bool* __restrict__ o_early, bool* __restrict__ o_late) {
  const long long idx = static_cast<long long>(blockIdx.x) * CLASS_THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * NLEG) return;
  const long long b = idx / NLEG;
  const int leg = static_cast<int>(idx % NLEG);
  const float* ev = gev + b * sev;
  const float t = tt[b], tp = t_period[b];
  float start, stop;
  contact_window(ev, gmode + b * smode, leg, upper_bound(ev, MAX_PHASES, t),
                 sub_rn(tp, horizon), add_rn(tp, horizon2), &start, &stop);
  const float frac = div_rn(sub_rn(t, start), clamp_min(sub_rn(stop, start), DT_MIN));
  // the estimated z force of leg i % 2 (est_forces[:, 2] or [:, 8])
  const bool force = est[b * 16 + (leg % 2 ? 8 : 2)] > *threshold;
  const float c = cmd[b * NLEG + leg];
  const bool swing = c < 0.5f, stance = c > 0.5f;
  const bool contact = (swing && frac > 0.75f) || (stance && frac < 0.25f) ? force : stance;
  o_est[idx] = contact;
  o_early[idx] = swing && contact && frac > 0.75f && sub_rn(stop, t) > EARLY_MARGIN;
  o_late[idx] = stance && !contact && frac < 0.25f;
}

}  // namespace

extern "C" int hk_contact_class(const float* ev, const long long* modes, const float* t_period,
                                const float* tt, const float* cmd_contact,
                                const float* est_forces, const float* threshold, bool* o_est,
                                bool* o_early, bool* o_late, int sev, int smode, int batch,
                                float horizon, float horizon2, void* stream) {
  const long long n = static_cast<long long>(batch) * NLEG;
  if (batch < 1 || n > 2147483647LL * CLASS_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + CLASS_THREADS - 1) / CLASS_THREADS);
  contact_class_kernel<<<blocks, CLASS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ev, sev, modes, smode, t_period, tt, cmd_contact, est_forces, threshold, batch, horizon,
      horizon2, o_est, o_early, o_late);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hk_swing_plan(const float* consts, const float* x, const float* init,
                             const float* ev, const long long* modes, const float* tt,
                             const float* ts, const float* tu, const float* cmd,
                             const float* dj, const float* latest, const float* swing_height,
                             const float* swing_time_scale, const float* feet_bias,
                             const float* next_z, const float* yaw_lead, const float* vel_fb,
                             float* o_latest, float* o_ntimes, float* o_npos, float* o_nvel,
                             float* o_start, float* o_stop, float* o_cs, float* o_Ts,
                             float* o_states, float* o_inputs, float* o_poses, float* o_des,
                             float* o_Rdes, float* o_warm, int* o_dec, int sx, int sinit,
                             int sev, int smode, int stt, int sts, int stu, int scmd, int sdj,
                             int slat, int batch, int T, int S, float horizon, void* stream) {
  if (batch < 1 || batch > 2147483647 || T < 2 || T > MAX_T || S < 2 ||
      S > PLAN_THREADS - 1 - NJ)
    return static_cast<int>(cudaErrorInvalidValue);
  swing_plan_kernel<<<batch, PLAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, x, sx, init, sinit, ev, sev, modes, smode, tt, stt, ts, sts, tu, stu, T, cmd,
      scmd, dj, sdj, latest, slat, swing_height, swing_time_scale, feet_bias, next_z, yaw_lead,
      vel_fb, horizon, S, o_latest, o_ntimes, o_npos, o_nvel, o_start, o_stop, o_cs, o_Ts,
      o_states, o_inputs, o_poses, o_des, o_Rdes, o_warm, o_dec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hk_knot_refs(const float* init, const float* ev, const long long* modes,
                            const float* ntimes, const float* npos, const float* nvel,
                            const float* Ts, const float* states, const float* jrefs,
                            float* o_times, float* o_xnom, float* o_flags, float* o_fpos,
                            float* o_fvel, float* o_mod, int* o_dec, int sinit, int sev,
                            int smode, int batch, int K1, int S, float h_over_n,
                            void* stream) {
  const long long n = static_cast<long long>(batch) * K1;
  if (batch < 1 || K1 < 1 || S < 2 || n > 2147483647LL * KNOT_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + KNOT_THREADS - 1) / KNOT_THREADS);
  knot_refs_kernel<<<blocks, KNOT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      init, sinit, ev, sev, modes, smode, ntimes, npos, nvel, Ts, states, jrefs, batch, K1, S,
      h_over_n, o_times, o_xnom, o_flags, o_fpos, o_fvel, o_mod, o_dec);
  return static_cast<int>(cudaGetLastError());
}
