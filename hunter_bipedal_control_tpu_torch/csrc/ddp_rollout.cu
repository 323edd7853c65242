// B15: the DDP's nonlinear closed-loop rollouts, every (scenario, step
// size) in one launch.
//
// Replaces hunter_bipedal_control_tpu/solver/ddp.py::solve's
// rollout_closed (:78-96) and reroll (:189-194), over
// solver/rollout.py::rollout_step (:127): ode45_step (:98) with
// _dopri_substeps (:60), rk4_step (:118) and sqp.py::rk2_step (:134), and
// with ocp/problem.py::stage_cost_value (:259) and eq_constraints (:149),
// as the port's solver/ddp.py::closed_rollout_plain computes them.  Per
// knot k of a rollout:
//   u_k = (u_bar_k + alpha kff_k) + K_k (x_k - x_bar_k)   (u_bar_k without K)
//   cost += dt * stage cost(x_k, u_k),  eq += |g mask|_1,
//   x_{k+1} = RK2 | RK4 | ODE45 over [0, dt] under u_k;
// then eq /= N.  The rows' flow is the integrator's first stage.
//
// ODE45 is the JAX package's bounded Dormand-Prince 5(4): at most
// max_substeps slots, each advancing, retrying with a smaller step or doing
// nothing, then one RK4 step over the residual.  The slot loop stops once
// the interval is covered (an inactive slot changes nothing), and the RK4
// finish is skipped where the residual is 0 and its first flow is finite
// (it then returns its start exactly).  Every operation a decision follows
// (the stage sums and candidates, the error norm's squares summed in
// component order, t + hs, dt - t, the clips, err^-0.2) is rounded as torch
// rounds it, one operation at a time (__fadd_rn and its kin: no
// contraction into FMAs), in the JAX package's order, and every clip and
// max keeps NaN as jnp.clip does, so a diverging step size behaves as in
// the plain versions; the decisions are warp-uniform.
//
// Design: a block per scenario (a grid row per 8 step sizes), a warp per
// step size and one more warp that stages the knots.  The model's
// constants, the OCP's parameters, Q and R are loaded once per block; each
// knot's data (K_k transposed, kff_k, x_bar_k, u_bar_k, x_nom, flags, the
// foot references: 600 floats) is copied once per block into shared memory
// by that warp's cp.async, the next knot's while this one computes, one
// block barrier a knot.  A warp's lanes own the 22 components
// of the state and the input: lane i forms u_i's feedback row, the
// integrators' axpys, RK4's combine and ODE45's stage sums per component in
// the plain version's order, and the quadratic forms as (Q' dx)_j dx_j on
// lane j summed by shuffles.  The flows, the row terms and the quadratic
// forms are soa_warp.cuh's, which B1 shares: the FK's products regrouped
// and the sums shuffle trees, so the flows and costs differ from the plain
// version by float32 rounding.
//
// Bound on the card: bytes (~0.5 KB per knot and rollout) and operations
// are far below the card's rates (chip_smoke.py::ddp_rollout_cost); each
// rollout is one dependent chain of flows, so the kernel is latency bound:
// one warp per rollout walks the chain with ~22 lanes busy.
//
// True float32: no fast math; a singular 3x3 base block gives inf/NaN as
// soa.py::inv3 does and a NaN state spreads as it does in the plain version.
#include <cuda_runtime.h>

#include <math.h>

#include "soa_warp.cuh"

namespace {

constexpr int MAX_WARPS = 8;  // step sizes per block
constexpr int RK2 = 0, RK4 = 1;  // 2: ODE45

// Measurement build only (profile_step ddp_rollout_phases): rollout 0's
// clock64 cycles by phase, summed over its knots (thread 0 of block 0).
constexpr int DDP_PHASES = 9;  // loads, feedback, fk, base_velocity, velocity_contacts,
                               // row_terms, stage_cost, flows, integrator
enum { PH_LOADS, PH_FEEDBACK, PH_FK, PH_BASE, PH_VEL, PH_ROWS, PH_COST, PH_FLOWS, PH_INTEG };
#ifdef DDP_ROLLOUT_PHASE_CLOCKS
__device__ unsigned long long ddp_phase_cycles[DDP_PHASES];
struct Clock {
  long long t;
  unsigned long long acc[DDP_PHASES];
  bool on;
  __device__ void start(bool o) {
    on = o;
    for (int i = 0; i < DDP_PHASES; ++i) acc[i] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    if (on) {
      const long long now = clock64();
      acc[p] += now - t;
      t = now;
    }
  }
  __device__ __forceinline__ void flow(int p) { mark(PH_FK + p); }
  __device__ void flush() {
    if (on)
      for (int i = 0; i < DDP_PHASES; ++i) ddp_phase_cycles[i] += acc[i];
  }
};
#else
struct Clock {
  __device__ void start(bool) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flow(int) {}
  __device__ void flush() {}
};
#endif

// Dormand-Prince RK5(4) tableau (solver/rollout.py), rounded to float as
// JAX's weak typing and torch's scalar operands round it
#define F(v) static_cast<float>(v)
__constant__ float c_A[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {F(1.0 / 5), 0, 0, 0, 0, 0},
    {F(3.0 / 40), F(9.0 / 40), 0, 0, 0, 0},
    {F(44.0 / 45), F(-56.0 / 15), F(32.0 / 9), 0, 0, 0},
    {F(19372.0 / 6561), F(-25360.0 / 2187), F(64448.0 / 6561), F(-212.0 / 729), 0, 0},
    {F(9017.0 / 3168), F(-355.0 / 33), F(46732.0 / 5247), F(49.0 / 176), F(-5103.0 / 18656), 0},
    {F(35.0 / 384), 0.0f, F(500.0 / 1113), F(125.0 / 192), F(-2187.0 / 6784), F(11.0 / 84)}};
__constant__ float c_B5[7] = {F(35.0 / 384), 0.0f, F(500.0 / 1113), F(125.0 / 192),
                              F(-2187.0 / 6784), F(11.0 / 84), 0.0f};
__constant__ float c_B4[7] = {F(5179.0 / 57600), 0.0f, F(7571.0 / 16695), F(393.0 / 640),
                              F(-92097.0 / 339200), F(187.0 / 2100), F(1.0 / 40)};
#undef F

// one knot's data, staged once per block
struct Knot {
  float Kt[NX * NU];  // K_k transposed: Kt[j][i] = K_k[i][j]
  float kff[NU];
  float xb[NX];
  float ub[NU];
  float xn[NX];
  float fl[NC];
  float fpr[NC * 3];
  float fvr[NC * 3];
};

// one rollout's (warp's) working set; per-component rows have a slot per lane
struct Warp {
  FlowKin k;            // the flow's kinematics
  float T[NJ][9];       // the joints' local transforms
  float x[LANES];       // the state a flow reads
  float u[LANES];       // the knot's input
  float d[LANES];       // x - x_bar, then x - x_nom
  float du[LANES];      // u - u_nom
  float sq[LANES];      // ODE45's squared scaled errors
  float ks[7][LANES];   // the stage flows
  float vc[NC][3];      // the contact velocities
};

struct Block {
  float K[N_CONSTS];
  float P[N_PARAMS];
  float Q[NX * NX];
  float R[NU * NU];
  float axis[NJ][3];    // the joints' axes in their parents' frames
  Knot kn[2];
  Warp w[MAX_WARPS];
};

// jnp.maximum / jnp.minimum / jnp.clip: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float clip_nan(float a, float lo, float hi) {
  return min_nan(max_nan(a, lo), hi);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, int tid, int nt) {
  for (int e = tid; e < n; e += nt) cp_async4(dst + e, src + e);
}

// knot k of scenario b into d, by the block's threads (one commit group)
__device__ void stage_knot(Knot& d, const float* gKfb, const float* gkff, const float* gxb,
                           const float* gub, const float* gxn, const float* gfl,
                           const float* gfpr, const float* gfvr, long long b, int k, int n_knots,
                           int tid, int nt) {
  const long long kb = b * n_knots + k;        // the knot in (B, N) arrays
  const long long r1 = b * (n_knots + 1) + k;  // and in (B, N+1) arrays
  if (gKfb != nullptr) {
    const float* Kk = gKfb + kb * NU * NX;
    for (int e = tid; e < NU * NX; e += nt) {
      const int i = e / NX, j = e - NX * (e / NX);
      cp_async4(&d.Kt[j * NU + i], Kk + e);
    }
    copy_async(d.kff, gkff + kb * NU, NU, tid, nt);
    copy_async(d.xb, gxb + r1 * NX, NX, tid, nt);
  }
  copy_async(d.ub, gub + kb * NU, NU, tid, nt);
  copy_async(d.xn, gxn + r1 * NX, NX, tid, nt);
  copy_async(d.fl, gfl + r1 * NC, NC, tid, nt);
  copy_async(d.fpr, gfpr + r1 * NC * 3, NC * 3, tid, nt);
  copy_async(d.fvr, gfvr + r1 * NC * 3, NC * 3, tid, nt);
  cp_commit();
}

// the flow at (w.x, w.u) on the rollout's warp (soa_warp.cuh::warp_flow)
template <bool ROWS>
__device__ __forceinline__ float rollout_flow(const Block& s, Warp& w, int lane, Clock& ck) {
  return warp_flow<ROWS>(s.K, s.axis, w.x, w.u, w.T, w.k, w.vc, lane, ck);
}

// RK4 from the state xr (lane's component) over h, with k1 = f(xr) given:
// xr + h/6 (((k1 + 2 k2) + 2 k3) + k4), per component in rollout.py's order
__device__ float rk4_warp(const Block& s, Warp& w, int lane, float xr, float h, float k1,
                          Clock& ck) {
  const float hh = __fmul_rn(0.5f, h);
  w.x[lane] = __fadd_rn(xr, __fmul_rn(hh, k1));
  ck.mark(PH_INTEG);
  const float k2 = rollout_flow<false>(s, w, lane, ck);
  ck.mark(PH_FLOWS);
  w.x[lane] = __fadd_rn(xr, __fmul_rn(hh, k2));
  ck.mark(PH_INTEG);
  const float k3 = rollout_flow<false>(s, w, lane, ck);
  ck.mark(PH_FLOWS);
  w.x[lane] = __fadd_rn(xr, __fmul_rn(h, k3));
  ck.mark(PH_INTEG);
  const float k4 = rollout_flow<false>(s, w, lane, ck);
  ck.mark(PH_FLOWS);
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(k1, __fmul_rn(2.0f, k2)), __fmul_rn(2.0f, k3)),
                              k4);
  const float out = __fadd_rn(xr, __fmul_rn(__fdiv_rn(h, 6.0f), sum));
  ck.mark(PH_INTEG);
  return out;
}

// ODE45 over [0, dt] from xr (lane's component; k0 = f(xr)); returns the
// new state's component, the accepted slots in *accepted.  The stage flows
// sit in w.ks (each lane its component); every decision is warp-uniform.
__device__ float ode45_warp(const Block& s, Warp& w, int lane, float xr, float k0, float dt,
                            float abs_tol, float rel_tol, float time_step, float h_min,
                            int max_substeps, int* accepted, Clock& ck) {
  const float h_floor = __fmul_rn(h_min, 1.000001f);
  float t = 0.0f, h = min_nan(time_step, dt), xk = xr;
  int acc = 0;
  w.ks[0][lane] = k0;
  for (int slot = 0; slot < max_substeps; ++slot) {
    const float remaining = __fsub_rn(dt, t);
    if (!(remaining > 1e-12f)) break;  // inactive from here on: nothing changes
    const float hs = clip_nan(h, h_min, max_nan(remaining, h_min));
#pragma unroll 1
    for (int st = 1; st < 7; ++st) {
      // stage st at xk + sum_j (hs a_sj) k_j, added in j's order
      float v = xk;
      for (int j = 0; j < st; ++j)
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(hs, c_A[st][j]), w.ks[j][lane]));
      w.x[lane] = v;
      ck.mark(PH_INTEG);
      w.ks[st][lane] = rollout_flow<false>(s, w, lane, ck);
      ck.mark(PH_FLOWS);
    }
    float s5 = __fmul_rn(c_B5[0], w.ks[0][lane]), s4 = __fmul_rn(c_B4[0], w.ks[0][lane]);
#pragma unroll
    for (int j = 1; j < 7; ++j) {
      s5 = __fadd_rn(s5, __fmul_rn(c_B5[j], w.ks[j][lane]));
      s4 = __fadd_rn(s4, __fmul_rn(c_B4[j], w.ks[j][lane]));
    }
    const float x5 = __fadd_rn(xk, __fmul_rn(hs, s5));
    const float x4 = __fadd_rn(xk, __fmul_rn(hs, s4));
    const float scale = __fadd_rn(abs_tol, __fmul_rn(rel_tol, max_nan(fabsf(xk), fabsf(x5))));
    const float q = __fdiv_rn(__fsub_rn(x5, x4), scale);
    w.sq[lane] = __fmul_rn(q, q);
    __syncwarp();
    // the 22 squares summed in component order, on every lane
    float sq = 0.0f;
    for (int i = 0; i < NX; ++i) sq = __fadd_rn(sq, w.sq[i]);
    const float err = __fsqrt_rn(__fdiv_rn(sq, static_cast<float>(NX)));
    if (err <= 1.0f || hs <= h_floor) {
      t = __fadd_rn(t, hs);
      xk = x5;
      w.x[lane] = xk;
      ck.mark(PH_INTEG);
      w.ks[0][lane] = rollout_flow<false>(s, w, lane, ck);  // the next slot's first stage
      ck.mark(PH_FLOWS);
      ++acc;
    }
    const float factor = clip_nan(__fmul_rn(0.9f, powf(err, -0.2f)), 0.2f, 5.0f);
    h = clip_nan(__fmul_rn(hs, factor), h_min, dt);
  }
  *accepted = acc;
  // one RK4 step over what the slots left (w.ks[0] = f(xk))
  const float residual = max_nan(__fsub_rn(dt, t), 0.0f);
  const float k_first = w.ks[0][lane];
  const bool finite = __all_sync(FULL, lane >= NX || isfinite(k_first));
  if (residual == 0.0f && finite) return xk;
  return rk4_warp(s, w, lane, xk, residual, k_first, ck);
}

__global__ void __launch_bounds__(LANES * (MAX_WARPS + 1), 1)
ddp_rollout_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                   const float* __restrict__ gQ, const float* __restrict__ gR,
                   const float* __restrict__ gx0, const float* __restrict__ gxb,
                   const float* __restrict__ gub, const float* __restrict__ gKfb,
                   const float* __restrict__ gkff, const float* __restrict__ galpha,
                   const float* __restrict__ gxn, const float* __restrict__ gfl,
                   const float* __restrict__ gfpr, const float* __restrict__ gfvr,
                   float* __restrict__ oxs, float* __restrict__ ous, float* __restrict__ ocost,
                   float* __restrict__ oeq, int* __restrict__ oslots, int n_alpha, int n_knots,
                   int integrator, int max_substeps, float dt, float abs_tol, float rel_tol,
                   float h_min) {
  __shared__ Block s;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / LANES, lane = tid % LANES;
  const long long b = blockIdx.x;
  // the rollouts' warps, then one that stages the knots' data
  const int warps = nt / LANES - 1;
  const bool producer = warp == warps;
  const int a = blockIdx.y * warps + warp;  // the step size
  const bool active = !producer && a < n_alpha;
  const bool closed = gKfb != nullptr;
  Clock ck;
  ck.start(b == 0 && blockIdx.y == 0 && tid == 0);

  for (int i = tid; i < N_CONSTS; i += nt) s.K[i] = gK[i];
  for (int i = tid; i < N_PARAMS; i += nt) s.P[i] = gP[i];
  for (int i = tid; i < NX * NX; i += nt) s.Q[i] = gQ[i];
  for (int i = tid; i < NU * NU; i += nt) s.R[i] = gR[i];
  if (producer)
    stage_knot(s.kn[0], gKfb, gkff, gxb, gub, gxn, gfl, gfpr, gfvr, b, 0, n_knots, lane, LANES);
  __syncthreads();
  joint_axes(s.K, s.axis, tid);

  Warp& w = s.w[producer ? 0 : warp];
  const long long r = b * n_alpha + a;
  const float alpha = active ? galpha[a] : 0.0f;
  float xr = active && lane < NX ? gx0[b * NX + lane] : 0.0f;
  float acc_cost = 0.0f, acc_eq = 0.0f;
  for (int k = 0; k < n_knots; ++k) {
    cp_wait_all();
    __syncthreads();  // knot k staged; every warp done with knot k - 1
    if (producer) {
      if (k + 1 < n_knots)
        stage_knot(s.kn[(k + 1) & 1], gKfb, gkff, gxb, gub, gxn, gfl, gfpr, gfvr, b, k + 1,
                   n_knots, lane, LANES);
      continue;
    }
    ck.mark(PH_LOADS);
    if (!active) continue;
    const Knot& kn = s.kn[k & 1];

    // u_k: lane i forms row i of the feedback
    float ur;
    if (closed) {
      w.d[lane] = xr - kn.xb[lane < NX ? lane : 0];
      __syncwarp();
      float acc = 0.0f;
      if (lane < NU)
        for (int j = 0; j < NX; ++j) acc += kn.Kt[j * NU + lane] * w.d[j];
      ur = lane < NU ? __fadd_rn(__fadd_rn(kn.ub[lane], __fmul_rn(alpha, kn.kff[lane])), acc)
                     : 0.0f;
    } else {
      ur = lane < NU ? kn.ub[lane] : 0.0f;
    }
    ck.mark(PH_FEEDBACK);
    if (lane < NX) {
      oxs[(r * (n_knots + 1) + k) * NX + lane] = xr;
      ous[(r * n_knots + k) * NU + lane] = ur;
    }
    w.x[lane] = xr;
    w.u[lane] = ur;
    ck.mark(PH_LOADS);

    // the row pass: the flow at (x, u), the contact kinematics, the rows
    const float k0 = rollout_flow<true>(s, w, lane, ck);
    float eq, cp;
    row_terms(s.P, kn.fl, kn.fpr, kn.fvr, w.x, w.u, w.k.pc, w.vc, lane, &eq, &cp);
    ck.mark(PH_ROWS);
    // the stage cost 0.5 dx'Q dx + 0.5 du'R du + sum mask p
    w.d[lane] = lane < NX ? xr - kn.xn[lane] : 0.0f;
    w.du[lane] = lane < NU ? ur - u_nom(s.K, kn.fl, lane) : 0.0f;
    __syncwarp();
    const float cost = quad_forms(s.Q, s.R, w.d, w.du, lane) + cp;
    acc_cost += cost * dt;
    acc_eq += eq;
    ck.mark(PH_COST);

    // the next state
    int slots = 0;
    if (integrator == RK2) {
      w.x[lane] = __fadd_rn(xr, __fmul_rn(dt, k0));
      ck.mark(PH_INTEG);
      const float k1 = rollout_flow<false>(s, w, lane, ck);
      ck.mark(PH_FLOWS);
      const float hdt = 0.5f * dt;
      xr = __fadd_rn(xr, __fmul_rn(hdt, __fadd_rn(k0, k1)));
    } else if (integrator == RK4) {
      xr = rk4_warp(s, w, lane, xr, dt, k0, ck);
    } else {
      xr = ode45_warp(s, w, lane, xr, k0, dt, abs_tol, rel_tol, dt, h_min, max_substeps, &slots,
                      ck);
    }
    ck.mark(PH_INTEG);
    if (lane == 0) oslots[r * n_knots + k] = slots;
  }
  if (active) {
    if (lane < NX) oxs[(r * (n_knots + 1) + n_knots) * NX + lane] = xr;
    if (lane == 0) {
      ocost[r] = acc_cost;
      oeq[r] = acc_eq / static_cast<float>(n_knots);
    }
  }
  ck.mark(PH_LOADS);
  ck.flush();
}

}  // namespace

// K and kff may both be NULL: the open loop u_k = u_bar_k (alphas unused).
// The interval dt is also ODE45's first step (the DDP's time_step); slots
// gets ODE45's accepted slots per knot (0 for RK2 and RK4).
extern "C" int hk_ddp_rollout(const float* consts, const float* params, const float* Q,
                              const float* R, const float* x_init, const float* xs_bar,
                              const float* us_bar, const float* K, const float* kff,
                              const float* alphas, const float* x_nom, const float* flags,
                              const float* fpr, const float* fvr, float* xs, float* us,
                              float* cost, float* eq, int* slots, int batch, int n_alpha,
                              int n_knots, int integrator, int max_substeps, float dt,
                              float abs_tol, float rel_tol, float h_min, void* stream) {
  if (batch < 1 || n_alpha < 1 || n_knots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = n_alpha < MAX_WARPS ? n_alpha : MAX_WARPS;
  const dim3 grid(static_cast<unsigned>(batch),
                  static_cast<unsigned>((n_alpha + warps - 1) / warps));
  ddp_rollout_kernel<<<grid, LANES * (warps + 1), 0, static_cast<cudaStream_t>(stream)>>>(
      consts, params, Q, R, x_init, xs_bar, us_bar, K, kff, alphas, x_nom, flags, fpr, fvr, xs,
      us, cost, eq, slots, n_alpha, n_knots, integrator, max_substeps, dt, abs_tol, rel_tol,
      h_min);
  return static_cast<int>(cudaGetLastError());
}

#ifdef DDP_ROLLOUT_PHASE_CLOCKS
// The phase sums since the last call (DDP_PHASES of them), then zeroed.
extern "C" int hk_ddp_rollout_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ddp_phase_cycles, sizeof(ddp_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[DDP_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ddp_phase_cycles, zero, sizeof(zero)));
}
#endif
