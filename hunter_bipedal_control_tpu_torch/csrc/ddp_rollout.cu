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
// then eq /= N.  The stage rows and cost are B1's (soa_rows.cuh), the flow
// B1's (soa_model.cuh::flow_dev); the row pass's flow is the integrator's
// first stage.
//
// ODE45 is the JAX package's bounded Dormand-Prince 5(4): at most
// max_substeps slots, each advancing, retrying with a smaller step or doing
// nothing, then one RK4 step over the residual.  The slot loop stops once
// the interval is covered (an inactive slot changes nothing), and the RK4
// finish is skipped where the residual is 0 and its first flow is finite
// (it then returns its start exactly).  Every operation a decision follows
// (t + hs, dt - t, the clips, the stage sums, the error norm, err^-0.2) is
// rounded as torch rounds it, one operation at a time (__fadd_rn and its kin:
// no contraction into FMAs), in the JAX package's order, and every clip and
// max keeps NaN as jnp.clip does, so a diverging step size behaves as in the
// plain versions.
//
// Design: one thread per (scenario, step size) walks the N knots in order,
// 32 threads per block; each thread's rows, stage flows and states live in
// its own slice of dynamic shared memory (an odd number of floats apart),
// beside the model's constants, the OCP's parameters, Q and R.  Per knot
// the rows and cost take ~1 flow and ~1k multiply-adds, RK2 one more flow,
// RK4 three more, ODE45 six more per slot and one more per accepted slot:
// the work is one serial chain per rollout, latency bound at any batch (the
// bytes, ~0.5 KB per knot and rollout, and operations are far below the
// card's rates; chip_smoke.py::ddp_rollout_cost).  On an H100 the chain
// runs ~6x above one lane's issue rate (2.0 ms for six RK2 rollouts of 53
// knots, PERF.md).  Spreading a rollout's links over a warp's lanes, and
// several step sizes per block, are later work.
//
// True float32: no fast math; a singular 3x3 GE gives inf/NaN as
// soa.py::inv3 does and a NaN state spreads as it does in the plain version.
#include <cuda_runtime.h>

#include <math.h>

#include "soa_rows.cuh"

namespace {

constexpr int ROLL_THREADS = 32;
constexpr int RK2 = 0, RK4 = 1;  // 2: ODE45

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

// one rollout's working set
struct Roll : Rows {
  float x[NX];       // the knot's state, then the next knot's
  float u[NU];
  float xk[NX];      // ODE45's slot state
  float xi[NX];      // a stage's state
  float x5[NX];      // ODE45's 5th-order candidate
  float ks[7][NX];   // the stage flows
};

constexpr int WS = static_cast<int>(sizeof(Roll) / sizeof(float)) | 1;
constexpr int ROLL_FIXED = N_CONSTS + N_PARAMS + NX * NX + NU * NU;
constexpr size_t ROLL_SMEM =
    sizeof(float) * (ROLL_FIXED + static_cast<size_t>(ROLL_THREADS) * WS);

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

// out = base + h * k, elementwise, rounded per operation
__device__ __forceinline__ void axpy(const float* base, float h, const float* k, float* out) {
  for (int i = 0; i < NX; ++i) out[i] = __fadd_rn(base[i], __fmul_rn(h, k[i]));
}

// x + h * (((k1 + 2 k2) + 2 k3) + k4) into out (rollout.py's RK4 sum)
__device__ void rk4_combine(const float* x, float h, const float (*ks)[NX], float* out) {
  for (int i = 0; i < NX; ++i) {
    const float s = __fadd_rn(__fadd_rn(__fadd_rn(ks[0][i], __fmul_rn(2.0f, ks[1][i])),
                                        __fmul_rn(2.0f, ks[2][i])),
                              ks[3][i]);
    out[i] = __fadd_rn(x[i], __fmul_rn(h, s));
  }
}

// RK4 from x over h with ks[0] = f(x) given: x + h/6 (k1 + 2 k2 + 2 k3 + k4)
__device__ void rk4_from(const float* K, const float* x, const float* u, float h, Roll* w,
                         float* out) {
  const float hh = __fmul_rn(0.5f, h);
  axpy(x, hh, w->ks[0], w->xi);
  flow_dev(K, w->xi, u, w, w->ks[1]);
  axpy(x, hh, w->ks[1], w->xi);
  flow_dev(K, w->xi, u, w, w->ks[2]);
  axpy(x, h, w->ks[2], w->xi);
  flow_dev(K, w->xi, u, w, w->ks[3]);
  rk4_combine(x, __fdiv_rn(h, 6.0f), w->ks, out);
}

// ODE45 over [0, dt] from w->x (w->ks[0] = f(w->x) given) into w->x;
// returns the accepted slots.  Each slot's first stage is f(xk), kept in
// w->ks[0] from the last accepted slot (or the rows' pass)
__device__ int ode45_dev(const float* K, const float* u, float dt, float abs_tol, float rel_tol,
                         float time_step, float h_min, int max_substeps, Roll* w) {
  const float h_floor = __fmul_rn(h_min, 1.000001f);
  float t = 0.0f, h = min_nan(time_step, dt);
  int accepted = 0;
  for (int i = 0; i < NX; ++i) w->xk[i] = w->x[i];
  for (int slot = 0; slot < max_substeps; ++slot) {
    const float remaining = __fsub_rn(dt, t);
    if (!(remaining > 1e-12f)) break;  // inactive from here on: nothing changes
    const float hs = clip_nan(h, h_min, max_nan(remaining, h_min));
    for (int s = 1; s < 7; ++s) {
      // stage s at xk + sum_j (hs a_sj) k_j, added in j's order
      for (int i = 0; i < NX; ++i) {
        float v = w->xk[i];
        for (int j = 0; j < s; ++j) v = __fadd_rn(v, __fmul_rn(__fmul_rn(hs, c_A[s][j]), w->ks[j][i]));
        w->xi[i] = v;
      }
      flow_dev(K, w->xi, u, w, w->ks[s]);
    }
    float sq = 0.0f;
    for (int i = 0; i < NX; ++i) {
      float s5 = __fmul_rn(c_B5[0], w->ks[0][i]), s4 = __fmul_rn(c_B4[0], w->ks[0][i]);
      for (int j = 1; j < 7; ++j) {
        s5 = __fadd_rn(s5, __fmul_rn(c_B5[j], w->ks[j][i]));
        s4 = __fadd_rn(s4, __fmul_rn(c_B4[j], w->ks[j][i]));
      }
      const float x5 = __fadd_rn(w->xk[i], __fmul_rn(hs, s5));
      const float x4 = __fadd_rn(w->xk[i], __fmul_rn(hs, s4));
      const float scale = __fadd_rn(abs_tol, __fmul_rn(rel_tol, max_nan(fabsf(w->xk[i]), fabsf(x5))));
      const float q = __fdiv_rn(__fsub_rn(x5, x4), scale);
      sq = __fadd_rn(sq, __fmul_rn(q, q));
      w->x5[i] = x5;
    }
    const float err = __fsqrt_rn(__fdiv_rn(sq, static_cast<float>(NX)));
    if (err <= 1.0f || hs <= h_floor) {
      t = __fadd_rn(t, hs);
      for (int i = 0; i < NX; ++i) w->xk[i] = w->x5[i];
      flow_dev(K, w->xk, u, w, w->ks[0]);  // the next slot's first stage
      ++accepted;
    }
    const float factor = clip_nan(__fmul_rn(0.9f, powf(err, -0.2f)), 0.2f, 5.0f);
    h = clip_nan(__fmul_rn(hs, factor), h_min, dt);
  }
  // one RK4 step over what the slots left (w->ks[0] = f(xk))
  const float residual = max_nan(__fsub_rn(dt, t), 0.0f);
  bool finite = true;
  for (int i = 0; i < NX; ++i) finite = finite && isfinite(w->ks[0][i]);
  if (residual == 0.0f && finite) {
    for (int i = 0; i < NX; ++i) w->x[i] = w->xk[i];
  } else {
    rk4_from(K, w->xk, u, residual, w, w->x);
  }
  return accepted;
}

__global__ void __launch_bounds__(ROLL_THREADS)
ddp_rollout_kernel(const float* __restrict__ gK, const float* __restrict__ gP,
                   const float* __restrict__ gQ, const float* __restrict__ gR,
                   const float* __restrict__ gx0, const float* __restrict__ gxb,
                   const float* __restrict__ gub, const float* __restrict__ gKfb,
                   const float* __restrict__ gkff, const float* __restrict__ galpha,
                   const float* __restrict__ gxn, const float* __restrict__ gfl,
                   const float* __restrict__ gfpr, const float* __restrict__ gfvr,
                   float* __restrict__ oxs, float* __restrict__ ous, float* __restrict__ ocost,
                   float* __restrict__ oeq, int* __restrict__ oslots, int batch, int n_alpha,
                   int n_knots, int integrator, int max_substeps, float dt, float abs_tol,
                   float rel_tol, float h_min) {
  extern __shared__ float smem[];
  float* K = smem;
  float* P = K + N_CONSTS;
  float* Q = P + N_PARAMS;
  float* R = Q + NX * NX;
  const int tid = threadIdx.x;
  for (int i = tid; i < N_CONSTS; i += ROLL_THREADS) K[i] = gK[i];
  for (int i = tid; i < N_PARAMS; i += ROLL_THREADS) P[i] = gP[i];
  for (int i = tid; i < NX * NX; i += ROLL_THREADS) Q[i] = gQ[i];
  for (int i = tid; i < NU * NU; i += ROLL_THREADS) R[i] = gR[i];
  __syncthreads();

  const long long r = static_cast<long long>(blockIdx.x) * ROLL_THREADS + tid;
  if (r >= static_cast<long long>(batch) * n_alpha) return;
  const long long b = r / n_alpha;
  const float alpha = galpha[r - b * n_alpha];
  Roll* w = reinterpret_cast<Roll*>(smem + ROLL_FIXED + tid * WS);
  for (int i = 0; i < NX; ++i) w->x[i] = gx0[b * NX + i];

  float acc_cost = 0.0f, acc_eq = 0.0f;
  for (int k = 0; k < n_knots; ++k) {
    const long long kb = b * n_knots + k;        // the knot in (B, N) arrays
    const long long r1 = b * (n_knots + 1) + k;  // and in (B, N+1) arrays
    const float* ub = gub + kb * NU;
    if (gKfb == nullptr) {
      for (int i = 0; i < NU; ++i) w->u[i] = ub[i];
    } else {
      const float* xb = gxb + r1 * NX;
      const float* Kk = gKfb + kb * NU * NX;
      const float* kff = gkff + kb * NU;
      for (int i = 0; i < NX; ++i) w->xi[i] = w->x[i] - xb[i];
      for (int i = 0; i < NU; ++i) {
        float s = 0.0f;
        for (int j = 0; j < NX; ++j) s += Kk[i * NX + j] * w->xi[j];
        w->u[i] = __fadd_rn(__fadd_rn(ub[i], __fmul_rn(alpha, kff[i])), s);
      }
    }
    float* xo = oxs + (r * (n_knots + 1) + k) * NX;
    float* uo = ous + (r * n_knots + k) * NU;
    for (int i = 0; i < NX; ++i) xo[i] = w->x[i];
    for (int i = 0; i < NU; ++i) uo[i] = w->u[i];

    const float* xn = gxn + r1 * NX;
    const float* fl = gfl + r1 * NC;
    combined_rows_dev(K, P, w->x, w->u, fl, gfpr + r1 * NC * 3, gfvr + r1 * NC * 3, w);
    acc_cost += stage_cost_dev(K, P, Q, R, w->x, w->u, xn, fl, w) * dt;
    float eq = 0.0f;
    for (int i = 0; i < NEQ; ++i) eq += fabsf(w->g[i] * w->mask[i]);
    acc_eq += eq;

    // the next state; the rows' flow is f(x, u), the first stage
    for (int i = 0; i < NX; ++i) w->ks[0][i] = w->flow[i];
    int slots = 0;
    if (integrator == RK2) {
      axpy(w->x, dt, w->ks[0], w->xi);
      flow_dev(K, w->xi, w->u, w, w->ks[1]);
      const float hdt = 0.5f * dt;
      for (int i = 0; i < NX; ++i)
        w->x[i] = __fadd_rn(w->x[i], __fmul_rn(hdt, __fadd_rn(w->ks[0][i], w->ks[1][i])));
    } else if (integrator == RK4) {
      rk4_from(K, w->x, w->u, dt, w, w->x5);
      for (int i = 0; i < NX; ++i) w->x[i] = w->x5[i];
    } else {
      slots = ode45_dev(K, w->u, dt, abs_tol, rel_tol, dt, h_min, max_substeps, w);
    }
    oslots[r * n_knots + k] = slots;
  }
  float* xo = oxs + (r * (n_knots + 1) + n_knots) * NX;
  for (int i = 0; i < NX; ++i) xo[i] = w->x[i];
  ocost[r] = acc_cost;
  oeq[r] = acc_eq / static_cast<float>(n_knots);
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
  cudaError_t err = cudaFuncSetAttribute(ddp_rollout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(ROLL_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(batch) * n_alpha;
  const unsigned blocks = static_cast<unsigned>((n + ROLL_THREADS - 1) / ROLL_THREADS);
  ddp_rollout_kernel<<<blocks, ROLL_THREADS, ROLL_SMEM, static_cast<cudaStream_t>(stream)>>>(
      consts, params, Q, R, x_init, xs_bar, us_bar, K, kff, alphas, x_nom, flags, fpr, fvr, xs,
      us, cost, eq, slots, batch, n_alpha, n_knots, integrator, max_substeps, dt, abs_tol,
      rel_tol, h_min);
  return static_cast<int>(cudaGetLastError());
}
