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
// plain version is estim/contact.py::contact_class_plain.  Its window
// search (contact_window) walks the phases; B8b1 finds the same bounds by
// prefix scans, and tests/test_torch_prep.py holds both to swing_windows
// (and the card's decisions to the float32 plain version's), so the two
// cannot drift apart.
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
// torch's order (nvcc would contract a*b + c into an FMA; B8b1 forms a
// quotient of two tensors' values from a correctly rounded reciprocal and
// one FMA correction, quot_rn, which rounds as IEEE division), with each
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
// torch; the FK (soa_model.cuh's fk_dev operations, contracted), cosf/sinf
// and the order of the 3x3 products' sums may differ from torch's.
//
// Bound on the card: B8b1 writes ~37 KB per scenario (the three swing
// node arrays are 33 KB of it) and does ~0.05 MFLOP; B8b2 writes ~0.2 KB per
// knot (chip_smoke.py::swing_plan_cost, knot_refs_cost): a few µs at
// B=128, bytes bound.  The work is a few hundred dependent operations per
// thread, so both kernels are latency bound far above that.  B8b1 runs one
// block of eight warps per scenario, with every input it reads and its
// node arrays staged in shared memory: a warp per leg (two phases a lane;
// the windows, the fresh test and the fresh phases' indices as prefix
// scans by shuffles, with no walk over the phases), update_planner's head
// on a warp's lanes, the FK of x_init on a warp of its own (the legs'
// chains side by side, fk_dev's operations), the samples on two warps
// ((sample, component) and (sample, leg, axis) lanes); the legs wait for
// the head and the FK only where they read them, and each leg's part of
// a node array goes out as one float4 run.  B8b2 runs 128-thread blocks
// over (scenario, knot).  Shared inputs (a schedule, target, command or
// default joints broadcast over the batch by expand) are read by a batch
// stride, 0 for those, so the step spends no copy on them.
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

// MODE_CONTACTS (FLY, R, L, STANCE over [L_toe, R_toe, L_heel, R_heel]) of a
// mode: the right (odd) legs touch in R and STANCE (the mode's bit 0), the
// left (even) ones in L and STANCE (bit 1); NaN outside 0..3
__device__ __forceinline__ float mode_contact(long long mode, int leg) {
  return (mode >= 0 && mode < 4) ? static_cast<float>((mode >> ((leg & 1) ? 0 : 1)) & 1)
                                 : __int_as_float(0x7fc00000);
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
  float cz, sz, cy, sy, cx, sx;  // sincosf: sinf's and cosf's bits, one reduction
  sincosf(z, &sz, &cz);
  sincosf(y, &sy, &cy);
  sincosf(x, &sx, &cx);
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

// gait/mode_schedule.py::swing_windows for one (leg, phase p): the start
// and stop of the contiguous run of phases around p in which the leg's
// contact flag stays the same, the first phase starting at h_start and the
// stops clipped to h_end, by walking the phases (B16; B8b1 finds the same
// bounds by its scans, and the tests hold both to swing_windows)
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

// ---- B8b1: one block of eight warps per scenario ----
//
// Every input the block reads is loaded at once (each thread's loads
// issued before its stores) into shared memory.  Warps 0-3 each own a
// leg's 57 phases, two a lane (lane l: phases 2l and 2l + 1; phase 57 on
// and lanes 29-31 are phantoms that write nothing): the windows, the
// candidates, the fresh test and the fresh phases' indices are scans over
// the leg's phases by shuffles, each lane's swing nodes are staged in
// shared memory and the leg's part of each node array goes out as one
// float4 run.  Warp 4 runs update_planner's head over its lanes, warp 5 the
// FK of x_init (the joints' sines on ten lanes, the two legs' chains on a
// lane each), warps 6-7 the samples; the legs meet the head and the FK
// only where they read them, and the samples' toe targets meet legs 0
// and 1 (named barriers; no block barrier).
constexpr int WARP = 32;
constexpr unsigned ALL = 0xffffffffu;
constexpr int W_HEAD = NLEG, W_FK = NLEG + 1, W_SAMPLE = NLEG + 2;  // warps
constexpr int SAMPLE_THREADS = PLAN_THREADS - W_SAMPLE * WARP;      // warps 6 and 7
constexpr int MAX_S = PLAN_THREADS - 1 - NJ;  // the C interface's limit on samples
constexpr int NODE_FLOATS = NLEG * P1 * NODE_STRIDE;  // one node array, one scenario
constexpr int N_KFK = K_RKK + 9 * NJ;         // the FK's joint constants (B1's buffer head)
constexpr int BAR_HEAD = 1, BAR_FK = 2, BAR_SAMPLE = 3, BAR_DES = 4;  // named barriers
constexpr int LEG_HEAD_THREADS = (NLEG + 1) * WARP;      // the legs and one warp
constexpr int DES_THREADS = 2 * WARP + SAMPLE_THREADS;   // legs 0 and 1, the samples
constexpr int LEG_F4 = P1 * NODE_STRIDE / 4;             // a leg's part of a node array
static_assert(PLAN_THREADS == 8 * WARP && 2 * WARP >= P1, "eight warps, two phases a lane");
// the load's ranges of threads: an event time, a target time, x_init, the
// command, the latest stance positions, the feet's bias, the contact
// offsets, the six scalars (init time, swing configuration)
constexpr int M_TT = MAX_PHASES, M_X = M_TT + MAX_T, M_CMD = M_X + NXS, M_PREV = M_CMD + 6,
              M_BIAS = M_PREV + NLEG * 3, M_CPOS = M_BIAS + NLEG * 3, M_SC = M_CPOS + NC * 3,
              M_END = M_SC + 6;
static_assert(M_END <= PLAN_THREADS && N_KFK <= 2 * PLAN_THREADS && N_KFK >= PLAN_THREADS &&
              MAX_T * NXS <= 2 * PLAN_THREADS, "the load's ranges");
static_assert(NODE_FLOATS % 4 == 0 && NODE_STRIDE % 4 == 0, "float4 node rows");
static_assert(NJ == 2 * LEG_JOINTS && NC == 4, "two legs of five joints, contacts g and g + 2");

// a named barrier: bar_sync waits for `n` threads, bar_arrive counts this
// warp's without waiting (a producer's release of what it wrote before)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// num / den as IEEE division rounds it (torch's tensor / tensor), from the
// correctly rounded reciprocal y of den: q = num y, then one correction by
// the exact residual num - den q (Markstein, as B12's pivot_quotient).  A
// zero numerator, a reciprocal of zero (den infinite) and a q that is not
// finite take q as it is: IEEE's signed zero, NaN or infinity.  No lane
// takes a division's slow path, and one y serves every quotient by den.
__device__ __forceinline__ float quot_y(float num, float den, float y) {
  const float q = __fmul_rn(num, y);
  const float r = __fmaf_rn(-den, q, num);
  return (num == 0.0f || y == 0.0f || !(fabsf(q) <= 3.402823466e38f)) ? q
                                                                       : __fmaf_rn(r, y, q);
}
__device__ __forceinline__ float quot_rn(float num, float den) {
  return quot_y(num, den, __frcp_rn(den));
}

// targets.py::_interp's weight at t in segment i (the quotient by quot_rn)
__device__ __forceinline__ float weight_q(const float* times, int i, float t) {
  const float den = clamp_min(sub_rn(times[i + 1], times[i]), INTERP_EPS);
  return clamp01(quot_rn(sub_rn(t, times[i]), den));
}

// one scenario's inputs and staged outputs in shared memory
struct __align__(16) Plan {
  float node[3][NODE_FLOATS];  // times, positions, velocities: (leg, phase, axis, node)
  float ts[MAX_T][NXS], tu[MAX_T][NUS];
  float kfk[N_KFK], cpos[NC * 3];
  float jc[NJ], js[NJ];          // the joints' cosines and sines at x_init
  float ev[MAX_PHASES], tt[MAX_T];
  long long mode[P1];
  float x[NXS], cmd[6], prev[NLEG * 3], bias[NLEG * 3];
  float init, swing_height, swing_time_scale, next_z, yaw_lead, vel_fb;
  float head[10];                // pose, half_lin, vl, sym_k, pcent: x and y
  float latest[NLEG][3];
  float stop[NLEG][P1];
  float2 cand[NLEG][P1];         // the Raibert candidates' x and y (z is next_z)
  float st[MAX_S], sw[MAX_S];    // the samples' times and target weights
  int si[MAX_S], sph[MAX_S];     // and segments and phases
};
enum { H_POSE, H_HALF = 2, H_VL = 4, H_SYM = 6, H_PCENT = 8 };

// inclusive prefix max (suffix min) over the warp's lanes by shuffles
__device__ __forceinline__ int scan_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const int u = __shfl_up_sync(ALL, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}
__device__ __forceinline__ int scan_min_back(int v, int lane) {
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const int u = __shfl_down_sync(ALL, v, o);
    if (lane + o < WARP) v = min(v, u);
  }
  return v;
}
// the same for max_nan over floats (associative: a NaN anywhere gives NaN)
__device__ __forceinline__ float scan_max_nan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const float u = __shfl_up_sync(ALL, v, o);
    if (lane >= o) v = max_nan(u, v);
  }
  return v;
}

// the swing nodes of (leg, phase) from its window [s, e], its fresh
// phases' candidates (i1, i2; -1: the latest stance position) and the
// leg's latest stance position, staged at `o` in the three node arrays:
// _swing_nodes for a swing phase, _stance_nodes for a stance phase, in
// torch's order with one rounding per operation (the quotients by quot_y,
// one reciprocal a divisor)
__device__ __forceinline__ void phase_nodes(Plan& P, int leg, float c, float s, float e, int i1,
                                            int i2, int o) {
  float tn[NAX][NNODE], pn[NAX][NNODE], vn[NAX][NNODE];
  const float* lat = P.latest[leg];
  const float2 cn = P.cand[leg][i1 < 0 ? 0 : i1];
  const float next[3] = {i1 >= 0 ? cn.x : lat[0], i1 >= 0 ? cn.y : lat[1],
                         i1 >= 0 ? P.next_z : lat[2]};
  if (c < 0.5f) {
    const float2 cl = P.cand[leg][i2 < 0 ? 0 : i2];
    const float last[3] = {i2 >= 0 ? cl.x : lat[0], i2 >= 0 ? cl.y : lat[1],
                           i2 >= 0 ? P.next_z : lat[2]};
    const float dt = sub_rn(e, s);
    const float dxy = clamp_min(dt, DT_MIN), yxy = __frcp_rn(dxy);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float p0 = last[a], p1 = next[a];
      tn[a][0] = s;
      tn[a][1] = add_rn(mul_rn(XY_A1C, s), mul_rn(XY_A1, e));
      tn[a][2] = e;
      tn[a][3] = e;
      pn[a][0] = p0;
      pn[a][1] = add_rn(mul_rn(XY_L1C, p0), mul_rn(XY_L1, p1));
      pn[a][2] = p1;
      pn[a][3] = p1;
      vn[a][0] = 0.0f;
      vn[a][1] = quot_y(mul_rn(XY_K1, sub_rn(p1, p0)), dxy, yxy);
      vn[a][2] = 0.0f;
      vn[a][3] = 0.0f;
    }
    const float z0 = last[2], z1 = next[2];
    const float scaling = clamp_max(quot_rn(dt, P.swing_time_scale), 1.0f);
    const float max_z = add_rn(max_nan(z0, z1), mul_rn(scaling, P.swing_height));
    const float den1 = clamp_min(mul_rn(Z_A1, dt), DT_MIN);
    const float den2 = clamp_min(mul_rn(Z_A2C, dt), DT_MIN), y2 = __frcp_rn(den2);
    tn[2][0] = s;
    tn[2][1] = add_rn(mul_rn(Z_A1C, s), mul_rn(Z_A1, e));
    tn[2][2] = add_rn(mul_rn(Z_A2C, s), mul_rn(Z_A2, e));
    tn[2][3] = e;
    pn[2][0] = z0;
    pn[2][1] = mul_rn(Z_L1, max_z);
    pn[2][2] = add_rn(mul_rn(Z_L2, max_z), mul_rn(Z_L2C, z1));
    pn[2][3] = z1;
    vn[2][0] = 0.0f;
    vn[2][1] = quot_rn(mul_rn(Z_K1, mul_rn(Z_L1, sub_rn(max_z, z0))), den1);
    vn[2][2] = quot_y(mul_rn(Z_K2L2, sub_rn(z1, max_z)), den2, y2);
    // Z_K3L2 is 0: a signed zero (or NaN) over den2, as IEEE divides it
    vn[2][3] = quot_y(mul_rn(Z_K3L2, sub_rn(z1, max_z)), den2, y2);
  } else {
    const float t1 = mul_rn(add_rn(mul_rn(2.0f, s), e), INV_3);
    const float t2 = mul_rn(add_rn(s, mul_rn(2.0f, e)), INV_3);
#pragma unroll
    for (int a = 0; a < NAX; ++a) {
      tn[a][0] = s;
      tn[a][1] = t1;
      tn[a][2] = t2;
      tn[a][3] = e;
#pragma unroll
      for (int n = 0; n < NNODE; ++n) {
        pn[a][n] = next[a];
        vn[a][n] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NAX; ++a) {
    *reinterpret_cast<float4*>(&P.node[0][o + a * NNODE]) =
        make_float4(tn[a][0], tn[a][1], tn[a][2], tn[a][3]);
    *reinterpret_cast<float4*>(&P.node[1][o + a * NNODE]) =
        make_float4(pn[a][0], pn[a][1], pn[a][2], pn[a][3]);
    *reinterpret_cast<float4*>(&P.node[2][o + a * NNODE]) =
        make_float4(vn[a][0], vn[a][1], vn[a][2], vn[a][3]);
  }
}

// Measurement build only (profile_step swing_plan_phases): -DSP_PHASE_CLOCKS
// sums block 0's clock64 cycles by phase in registers, added to the device
// sums once at the end: on thread 0 (leg 0's lane 0) the loads, the
// windows, the candidates, the wait for the head, the fresh test with the
// candidates' last terms, the fresh phases' indices, the wait for the FK,
// the nodes, the leg's stores and, after a closing barrier of this build,
// the wait for the other warps ("samples"): the block's time; and the FK's
// and the head's own cycles on their warps' lane 0 from the loads' end.
enum { PH_LOAD, PH_FK, PH_HEAD, PH_WINDOWS, PH_CAND, PH_FRESH, PH_IDX, PH_NODES, PH_SAMPLES,
       PH_STORES, PH_FK_OWN, PH_HEAD_OWN, SP_PHASES };
#ifdef SP_PHASE_CLOCKS
__device__ unsigned long long sp_phase_cycles[SP_PHASES];
#define SP_PHASE(p)                              \
  if (blockIdx.x == 0 && threadIdx.x == 0) {     \
    const long long now = clock64();             \
    sp_acc[p] += now - t_phase;                  \
    t_phase = now;                               \
  }
#define SP_OWN(p) \
  if (blockIdx.x == 0 && lane == 0) sp_acc[p] += clock64() - t_phase;
#define SP_END() __syncthreads()
#define SP_FLUSH()                                                               \
  if (blockIdx.x == 0)                                                           \
    for (int q = 0; q < SP_PHASES; ++q)                                          \
      if (sp_acc[q]) atomicAdd(&sp_phase_cycles[q], static_cast<unsigned long long>(sp_acc[q]));
#else
#define SP_PHASE(p)
#define SP_OWN(p)
#define SP_END()
#define SP_FLUSH()
#endif

// torch.searchsorted(a[0:n], v, right=True) on a sorted a (n < 2^K): the
// count of leading entries not above v, in K fixed halving steps with no
// branch, so that a lane's searches overlap (upper_bound's result on any
// sorted a without NaN)
template <int K>
__device__ __forceinline__ int upper_bound_steps(const float* a, int n, float v) {
  int lo = 0;
#pragma unroll
  for (int s = 1 << (K - 1); s > 0; s >>= 1) {
    const int i = lo + s - 1;
    lo = (i < n && !(a[min(i, n - 1)] > v)) ? lo + s : lo;
  }
  return lo;
}
// targets.py::_interp's segment of the staged target times (T <= 16)
__device__ __forceinline__ int segment_steps(const float* times, int n, float t) {
  const int i = upper_bound_steps<5>(times, n, t) - 1;
  return i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
}
static_assert(MAX_T < 32 && MAX_PHASES < 64, "the searches' steps");

__device__ __forceinline__ int phase_of(const float* ev, float t) {
  const int p = upper_bound_steps<6>(ev, MAX_PHASES, t);
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
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid % WARP;
  const long long b = blockIdx.x;
  int* dec = o_dec ? o_dec + b * (N_PLAN_DEC_FIXED + 8 * S) : nullptr;
#ifdef SP_PHASE_CLOCKS
  long long t_phase = clock64();
  long long sp_acc[SP_PHASES] = {};
#endif

  // ---- 1. every input the block reads, staged in shared memory ----
  // each thread issues its loads (at most seven) before it stores any:
  // the target's states and inputs, the FK's constants, a mode, and one
  // more value: an event time, a target time, x_init, the command, a
  // latest stance position, a foot's bias, a contact offset or a scalar
  const int tn = T * NXS, t2 = tid + PLAN_THREADS;
  const float vs0 = tid < tn ? gts[b * sts + tid] : 0.0f;
  const float vs1 = t2 < tn ? gts[b * sts + t2] : 0.0f;
  const float vu0 = tid < tn ? gtu[b * stu + tid] : 0.0f;
  const float vu1 = t2 < tn ? gtu[b * stu + t2] : 0.0f;
  const float vk0 = K[tid], vk1 = t2 < N_KFK ? K[t2] : 0.0f;
  const long long vm = tid < P1 ? gmode[b * smode + tid] : 0;
  const float* src = nullptr;
  float* dst = nullptr;
  if (tid < M_TT) {
    src = gev + b * sev + tid, dst = &P.ev[tid];
  } else if (tid < M_TT + T) {
    src = gtt + b * stt + tid - M_TT, dst = &P.tt[tid - M_TT];
  } else if (tid >= M_X && tid < M_CMD) {
    src = gx + b * sx + tid - M_X, dst = &P.x[tid - M_X];
  } else if (tid >= M_CMD && tid < M_PREV) {
    src = gcmd + b * scmd + tid - M_CMD, dst = &P.cmd[tid - M_CMD];
  } else if (tid >= M_PREV && tid < M_BIAS) {
    src = glat + b * slat + tid - M_PREV, dst = &P.prev[tid - M_PREV];
  } else if (tid >= M_BIAS && tid < M_CPOS) {
    src = cfg_feet_bias + tid - M_BIAS, dst = &P.bias[tid - M_BIAS];
  } else if (tid >= M_CPOS && tid < M_SC) {
    src = K + K_CPOS + tid - M_CPOS, dst = &P.cpos[tid - M_CPOS];
  } else if (tid >= M_SC && tid < M_END) {
    const int k = tid - M_SC;
    src = k == 0 ? ginit + b * sinit
          : k == 1 ? cfg_swing_height
          : k == 2 ? cfg_swing_time_scale
          : k == 3 ? cfg_next_z
          : k == 4 ? cfg_yaw_lead
                   : cfg_vel_fb;
    dst = k == 0 ? &P.init
          : k == 1 ? &P.swing_height
          : k == 2 ? &P.swing_time_scale
          : k == 3 ? &P.next_z
          : k == 4 ? &P.yaw_lead
                   : &P.vel_fb;
  }
  const float vo = src ? *src : 0.0f;
  if (tid < tn) {
    (&P.ts[0][0])[tid] = vs0;
    (&P.tu[0][0])[tid] = vu0;
  }
  if (t2 < tn) {
    (&P.ts[0][0])[t2] = vs1;
    (&P.tu[0][0])[t2] = vu1;
  }
  P.kfk[tid] = vk0;
  if (t2 < N_KFK) P.kfk[t2] = vk1;
  if (tid < P1) P.mode[tid] = vm;
  if (dst) *dst = vo;
  __syncthreads();
  SP_PHASE(PH_LOAD);
  const float init = P.init;
  const float final_t = add_rn(init, horizon);
  const float hz = sub_rn(final_t, init);
  const float h_start = sub_rn(init, hz), h_end = add_rn(final_t, hz);

  if (warp < NLEG) {
    // ---- 2. swing_windows: the last contact change at or before each
    // phase (prefix max) and the first at or after it (suffix min) ----
    const int g = warp, pa = 2 * lane, pb = pa + 1;
    const bool va = pa < P1, vb = pb < P1;
    const float ca = va ? mode_contact(P.mode[pa], g) : 0.0f;
    const float cb = vb ? mode_contact(P.mode[pb], g) : 0.0f;
    const float c_before = __shfl_up_sync(ALL, cb, 1);   // phase pa - 1
    const float c_after = __shfl_down_sync(ALL, ca, 1);  // phase pb + 1
    const int fa = (pa == 0 || ca != c_before) ? pa : -1;
    const int fb = ca != cb ? pb : fa;
    int f_ex = __shfl_up_sync(ALL, scan_max(fb, lane), 1);
    f_ex = lane == 0 ? -1 : f_ex;
    const int qfa = max(f_ex, fa), qfb = max(f_ex, fb);
    const bool ba = pa == P1 - 1 || ca != cb;
    const bool bb = vb && (pb == P1 - 1 || cb != c_after);
    const int bb_mark = bb ? pb : P1;
    const int b_lane = !va ? P1 : (ba ? pa : bb_mark);
    int b_ex = __shfl_down_sync(ALL, scan_min_back(b_lane, lane), 1);
    b_ex = lane == WARP - 1 ? P1 : b_ex;
    const int qba = ba ? pa : min(b_ex, bb_mark), qbb = min(b_ex, bb_mark);
    // phantoms take the init time (read nothing out of range, write nothing)
    const float sa = !va ? init : (qfa == 0 ? h_start : P.ev[qfa - 1]);
    const float sb = !vb ? init : (qfb == 0 ? h_start : P.ev[qfb - 1]);
    const float ea = !va ? init : min_nan(qba < MAX_PHASES ? P.ev[qba] : BIG, h_end);
    const float eb = !vb ? init : min_nan(qbb < MAX_PHASES ? P.ev[qbb] : BIG, h_end);
    const long long o = (b * NLEG + g) * P1;
    if (va) {
      P.stop[g][pa] = ea;
      o_start[o + pa] = sa;
      o_stop[o + pa] = ea;
      o_cs[o + pa] = ca;
    }
    if (vb) {
      P.stop[g][pb] = eb;
      o_start[o + pb] = sb;
      o_stop[o + pb] = eb;
      o_cs[o + pb] = cb;
    }
    // the last real event, a warp reduction
    float last = max_nan(pa < MAX_PHASES && P.ev[pa] < HALF_BIG ? P.ev[pa] : -BIG,
                         pb < MAX_PHASES && P.ev[pb] < HALF_BIG ? P.ev[pb] : -BIG);
#pragma unroll
    for (int m = WARP / 2; m > 0; m >>= 1) last = max_nan(last, __shfl_xor_sync(ALL, last, m));
    __syncwarp();
    SP_PHASE(PH_WINDOWS);

    // ---- 3. the next middle time and the Raibert candidate's terms that
    // need no head: the target's rotation there and the rotated bias ----
    const float* bias = P.bias + 3 * g;
    float e2[2] = {ea, eb}, mid[2], rb[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e = e2[h];
      const int nxt = phase_of(P.ev, add_rn(e, NEXT_EPS));
      const bool tail = e >= sub_rn(last, TAIL_EPS);
      mid[h] = tail ? e : mul_rn(0.5f, add_rn(e, P.stop[g][nxt]));
      const float q_t = add_rn(mid[h], P.yaw_lead);
      const int i = segment_steps(P.tt, T, q_t);
      const float w = weight_q(P.tt, i, q_t);
      float R[9];
      rotation_zyx_rn(lerp_rn(P.ts[i][9], P.ts[i + 1][9], w),
                      lerp_rn(P.ts[i][10], P.ts[i + 1][10], w),
                      lerp_rn(P.ts[i][11], P.ts[i + 1][11], w), R);
      rb[h][0] = dot3_rn(R, bias);
      rb[h][1] = dot3_rn(R + 3, bias);
      const int p = pa + h;
      if (dec && p < P1) {
        const int od = 1 + g * P1 + p;
        dec[od] = nxt;
        dec[od + NLEG * P1] = tail;
        dec[od + 2 * NLEG * P1] = i;
      }
    }
    SP_PHASE(PH_CAND);
    bar_sync(BAR_HEAD, LEG_HEAD_THREADS);
    SP_PHASE(PH_HEAD);

    // ---- 4. the candidates; the fresh swing windows ahead of init_time
    // (an exclusive prefix max of the eligible stops) ----
    const float* H = P.head;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e = e2[h];
      const float dt_sh = sub_rn(e, init), dt_sym = sub_rn(mid[h], e);
      float cd[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float sh = add_rn(mul_rn(dt_sh, H[H_HALF + j]), rb[h][j]);
        const float sym = add_rn(mul_rn(dt_sym, H[H_VL + j]), H[H_SYM + j]);
        cd[j] = add_rn(add_rn(add_rn(H[H_POSE + j], sh), sym), H[H_PCENT + j]);
      }
      if (pa + h < P1) P.cand[g][pa + h] = make_float2(cd[0], cd[1]);
    }
    const bool ela = va && ca < 0.5f && init < ea, elb = vb && cb < 0.5f && init < eb;
    const float ma = ela ? ea : -BIG, mb = elb ? eb : -BIG;
    float m_ex = __shfl_up_sync(ALL, scan_max_nan(max_nan(ma, mb), lane), 1);
    m_ex = lane == 0 ? -BIG : max_nan(-BIG, m_ex);
    const bool fra = ela && ea > add_rn(m_ex, TAIL_EPS);
    const bool frb = elb && eb > add_rn(max_nan(m_ex, ma), TAIL_EPS);
    if (dec) {
      const int od = 1 + 3 * NLEG * P1 + g * P1;
      if (va) dec[od + pa] = fra;
      if (vb) dec[od + pb] = frb;
    }
    SP_PHASE(PH_FRESH);

    // ---- 5. i1, i2: the last and second-to-last fresh phase <= p ----
    const int ka = fra ? pa : -1, kb = frb ? pb : ka;
    int k_ex = __shfl_up_sync(ALL, scan_max(kb, lane), 1);
    k_ex = lane == 0 ? -1 : k_ex;
    const int i1a = max(k_ex, ka), i1b = max(k_ex, kb);
    // the last fresh phase before q: lane q/2's exclusive prefix (q even)
    // or its phase pa's inclusive one (q odd)
    const int sra = __shfl_sync(ALL, k_ex, max(i1a, 0) >> 1);
    const int s1a = __shfl_sync(ALL, i1a, max(i1a, 0) >> 1);
    const int srb = __shfl_sync(ALL, k_ex, max(i1b, 0) >> 1);
    const int s1b = __shfl_sync(ALL, i1a, max(i1b, 0) >> 1);
    const int i2a = i1a < 0 ? -1 : ((i1a & 1) ? s1a : sra);
    const int i2b = i1b < 0 ? -1 : ((i1b & 1) ? s1b : srb);
    __syncwarp();  // the candidates
    SP_PHASE(PH_IDX);
    bar_sync(BAR_FK, LEG_HEAD_THREADS);
    SP_PHASE(PH_FK);

    // ---- 6. the swing node arrays (SwingRefs): staged, then the leg's
    // part of each array out as one contiguous float4 run ----
    if (va) phase_nodes(P, g, ca, sa, ea, i1a, i2a, (g * P1 + pa) * NODE_STRIDE);
    if (vb) phase_nodes(P, g, cb, sb, eb, i1b, i2b, (g * P1 + pb) * NODE_STRIDE);
    __syncwarp();
    if (g < 2) bar_arrive(BAR_DES, DES_THREADS);  // legs 0 and 1: the toe targets' nodes
    SP_PHASE(PH_NODES);
#pragma unroll 4
    for (int k = lane; k < 3 * LEG_F4; k += WARP) {
      const int a = k / LEG_F4, q = g * LEG_F4 + k - a * LEG_F4;
      float* const out = a == 0 ? o_ntimes : (a == 1 ? o_npos : o_nvel);
      reinterpret_cast<float4*>(out + b * NODE_FLOATS)[q] =
          reinterpret_cast<const float4*>(P.node[a])[q];
    }
    SP_PHASE(PH_STORES);
  } else if (warp == W_HEAD) {
    // ---- update_planner's head: the target at init_time (a lerp a lane),
    // the command's rotation (a row a lane), the Raibert terms ----
#ifdef SP_PHASE_CLOCKS
    t_phase = clock64();
#endif
    const int i = segment_steps(P.tt, T, init);
    const float w = weight_q(P.tt, i, init);
    const int j = lane < 6 ? 6 + lane : lane - 6;  // pose (lanes 0-5), velocity (6-8)
    float v = lerp_rn(P.ts[i][j < NXS ? j : 0], P.ts[i + 1][j < NXS ? j : 0], w);
    if (lane >= 6 && lane < 9) v = add_rn(v, mul_rn(P.vel_fb, sub_rn(P.x[j], v)));
    const float yaw = __shfl_sync(ALL, v, 3), pitch = __shfl_sync(ALL, v, 4);
    const float roll = __shfl_sync(ALL, v, 5), pz = __shfl_sync(ALL, v, 2);
    float R[9];
    rotation_zyx_rn(yaw, pitch, roll, R);
    // row `lane` of R (lanes 0-2), selected without local memory
    const float row[3] = {lane == 1 ? R[3] : (lane == 2 ? R[6] : R[0]),
                          lane == 1 ? R[4] : (lane == 2 ? R[7] : R[1]),
                          lane == 1 ? R[5] : (lane == 2 ? R[8] : R[2])};
    const float vcl = dot3_rn(row, P.cmd), vca = dot3_rn(row, P.cmd + 3);
    const float vcl_j = __shfl_sync(ALL, vcl, lane & 1);
    const float vca0 = __shfl_sync(ALL, vca, 0), vca1 = __shfl_sync(ALL, vca, 1);
    const float vca2 = __shfl_sync(ALL, vca, 2);
    const float vl0 = __shfl_sync(ALL, v, 6), vl1 = __shfl_sync(ALL, v, 7), vl2 = 0.0f;
    if (lane < 2) {
      const float vl = lane ? vl1 : vl0;
      const float cr = lane ? sub_rn(mul_rn(vl2, vca0), mul_rn(vl0, vca2))
                            : sub_rn(mul_rn(vl1, vca2), mul_rn(vl2, vca1));
      const float cf = mul_rn(0.5f, sqrtf(mul_rn(fabsf(pz), INV_G)));
      P.head[H_POSE + lane] = v;
      P.head[H_HALF + lane] = add_rn(mul_rn(0.5f, vl), mul_rn(0.5f, vcl_j));
      P.head[H_VL + lane] = vl;
      P.head[H_SYM + lane] = mul_rn(RAIBERT_K, sub_rn(vl, vcl_j));
      P.head[H_PCENT + lane] = mul_rn(cf, cr);
    }
    __syncwarp();
    SP_OWN(PH_HEAD_OWN);
    bar_arrive(BAR_HEAD, LEG_HEAD_THREADS);
  } else if (warp == W_FK) {
    // ---- the FK of x_init: the joints' sines on ten lanes, each leg's
    // chain on a lane (fk_dev's operations in its order, the legs apart),
    // the contact points g and g + 2 of leg g; the latest stance positions
    // at the commanded contacts just after init_time ----
#ifdef SP_PHASE_CLOCKS
    t_phase = clock64();
#endif
    if (lane < NJ) {
      P.jc[lane] = cosf(P.x[12 + lane]);
      P.js[lane] = sinf(P.x[12 + lane]);
    }
    __syncwarp();
    if (lane < 2) {
      const int g = lane;
      float trig[4], R[9], p[3];
      base_pose_dev(P.x + 6, trig, R, p);
#pragma unroll
      for (int n = 0; n < LEG_JOINTS; ++n) {
        const int jj = LEG_JOINTS * g + n;
        float Ror[9], t[3], rod[9];
        mm3(R, P.kfk + K_OROT + 9 * jj, Ror);
        mv3(R, P.kfk + K_OPOS + 3 * jj, t);
        const float cj = P.jc[jj], sj = P.js[jj];
        const float u = 1.0f - cj;
        for (int e = 0; e < 9; ++e)
          rod[e] = ((e % 4 == 0) ? 1.0f : 0.0f) + sj * P.kfk[K_RK + 9 * jj + e] +
                   u * P.kfk[K_RKK + 9 * jj + e];
        mm3(Ror, rod, R);
        for (int i = 0; i < 3; ++i) p[i] = p[i] + t[i];
      }
      const int cmd_phase = upper_bound_steps<6>(P.ev, MAX_PHASES, add_rn(init, CMD_DT));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = g + 2 * k;
        float t[3];
        mv3(R, P.cpos + 3 * c, t);
        const bool stance = mode_contact(P.mode[cmd_phase], c) > 0.5f;
        const float lat[3] = {stance ? p[0] + t[0] : P.prev[3 * c],
                              stance ? p[1] + t[1] : P.prev[3 * c + 1], P.next_z};
        for (int i = 0; i < 3; ++i) {
          P.latest[c][i] = lat[i];
          o_latest[(b * NLEG + c) * 3 + i] = lat[i];
        }
      }
      if (dec && g == 0) dec[0] = cmd_phase;
    }
    __syncwarp();
    SP_OWN(PH_FK_OWN);
    bar_arrive(BAR_FK, LEG_HEAD_THREADS);
  } else {
    // ---- the IK's inputs: the sample times, their segments, weights and
    // phases (warp 6); R_des and the warm joints (warp 7); then the
    // target's states and inputs there on (sample, component) lanes ----
    const int u = tid - W_SAMPLE * WARP;
    if (warp == W_SAMPLE) {
      for (int s = lane; s < S; s += WARP) {
        float t;
        if (s == S - 1) {
          t = final_t;
        } else {
          const float inv = div_rn(1.0f, static_cast<float>(S - 1));
          const float step = mul_rn(static_cast<float>(s), inv);
          t = add_rn(mul_rn(init, sub_rn(1.0f, step)), mul_rn(final_t, step));
        }
        const int i = segment_steps(P.tt, T, t);
        const int ph = phase_of(P.ev, t);
        P.st[s] = t;
        P.si[s] = i;
        P.sw[s] = weight_q(P.tt, i, t);
        P.sph[s] = ph;
        o_Ts[b * S + s] = t;
        if (dec) {
          dec[N_PLAN_DEC_FIXED + s] = i;
          dec[N_PLAN_DEC_FIXED + S + s] = ph;
        }
      }
    } else if (lane < 9) {
      float R[9];
      rotation_zyx_rn(P.x[9], P.x[10], P.x[11], R);
      float r = R[0];
#pragma unroll
      for (int e = 1; e < 9; ++e) r = lane == e ? R[e] : r;
      o_Rdes[b * 9 + lane] = r;
    } else if (lane < 9 + NJ) {
      o_warm[b * NJ + lane - 9] = gdj[b * sdj + lane - 9];
    }
    bar_sync(BAR_SAMPLE, SAMPLE_THREADS);
    const int n = S * NXS;
    for (int k = u; k < 2 * n; k += SAMPLE_THREADS) {
      const bool in = k >= n;
      const int r = in ? k - n : k, s = r / NXS, j = r % NXS, i = P.si[s];
      const float* src = in ? &P.tu[0][0] : &P.ts[0][0];
      const float v = lerp_rn(src[i * NXS + j], src[(i + 1) * NXS + j], P.sw[s]);
      (in ? o_inputs : o_states)[b * n + r] = v;
      if (!in && j >= 6 && j < 12) o_poses[(b * S + s) * 6 + j - 6] = v;
    }
    // ---- the toe targets of legs 0 and 1 on (sample, leg, axis) lanes ----
    bar_sync(BAR_DES, DES_THREADS);
    for (int v = u; v < 6 * S; v += SAMPLE_THREADS) {
      const int s = v / 6, l = (v % 6) / NAX, a = v % NAX;
      const int o = (l * P1 + P.sph[s]) * NODE_STRIDE + a * NNODE;
      float pos, vel;
      int seg;
      eval_spline(&P.node[0][o], &P.node[1][o], &P.node[2][o], P.st[s], &pos, &vel, &seg);
      o_des[b * 6 * S + v] = pos;
      if (dec) dec[N_PLAN_DEC_FIXED + 2 * S + v] = seg;
    }
  }
  SP_END();
  SP_PHASE(PH_SAMPLES);
  SP_FLUSH();
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
  if (batch < 1 || batch > 2147483647 || T < 2 || T > MAX_T || S < 2 || S > MAX_S)
    return static_cast<int>(cudaErrorInvalidValue);
  // the node arrays are written as float4 runs
  const unsigned long long nodes = reinterpret_cast<unsigned long long>(o_ntimes) |
                                   reinterpret_cast<unsigned long long>(o_npos) |
                                   reinterpret_cast<unsigned long long>(o_nvel);
  if (nodes % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  swing_plan_kernel<<<batch, PLAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, x, sx, init, sinit, ev, sev, modes, smode, tt, stt, ts, sts, tu, stu, T, cmd,
      scmd, dj, sdj, latest, slat, swing_height, swing_time_scale, feet_bias, next_z, yaw_lead,
      vel_fb, horizon, S, o_latest, o_ntimes, o_npos, o_nvel, o_start, o_stop, o_cs, o_Ts,
      o_states, o_inputs, o_poses, o_des, o_Rdes, o_warm, o_dec);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SP_PHASE_CLOCKS
// The phase sums since the last call (SP_PHASES of them), then zeroed.
extern "C" int hk_swing_plan_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sp_phase_cycles, sizeof(sp_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[SP_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(sp_phase_cycles, zero, sizeof(zero)));
}
#endif

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
