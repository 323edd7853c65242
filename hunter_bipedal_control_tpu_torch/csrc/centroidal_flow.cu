// B14: the dummy loop's plant and its per-tick state conversion, as two
// kernels over the centroidal model.
//
// hk_dummy_step (B14a) replaces hunter_bipedal_control_tpu/backends/
// dummy.py::dummy_step (:28), RK2 over models/centroidal.py::flow_map
// (:126), as the port's backends/dummy.py::dummy_step_plain computes it:
//   k1 = f(x, u),  k2 = f(x + dt k1, u),  x' = x + dt/2 (k1 + k2),
// each f by soa_model.cuh::flow_dev (FK, the CoM, the base velocity from
// the momentum by the CMM base block's closed form, the contact points,
// the flow rows), the chain B1 evaluates at every knot.
//
// hk_state_input_to_v (B14b) replaces hunter_bipedal_control_tpu/models/
// centroidal.py::state_input_to_v (:113) with base_velocity_from_momentum
// (:103) and base_block_solve (:80): FK of x[6:], v_b from
// A_b v_b = m h - A_j v_j (soa_model.cuh::base_velocity_dev: the joint-only
// momentum by a base-fixed velocity pass, then the block-triangular closed
// form), v = [v_b; u[12:]].  Given an rbd buffer it also writes
// models/centroidal.py::q_v_to_rbd_state of (x[6:], v), the tick's measured
// state of the dummy loop: [theta, p, qj, E(theta) theta_dot, p_dot, qj_dot].
//
// One thread per scenario, 32 threads (one warp) per block; the block
// stages the model's constants in shared memory, each thread keeps its
// state's kinematics (soa_model.cuh's FlowKin, ~1.8 KB) in local memory,
// which the L1 cache holds.  Work per scenario: B14a reads 44 floats,
// writes 22 and needs ~11k operations; B14b reads 32, writes 16 (48 with
// the rbd state) and needs ~5k (chip_smoke.py::dummy_cost,
// state_v_cost): at a sweep's B=4096 B14a is operation bound and B14b
// bytes bound; both are latency bound at B=1 (one serial chain in one
// thread; a warp's lanes per link is later work).
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too.  True float32: no fast math; a singular 3x3 GE gives inf/NaN
// as the plain inv3 does, and a NaN state spreads as it does in the plain
// versions.
#include <cuda_runtime.h>

#include "soa_model.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int NQ = 6 + NJ;          // 16
constexpr int NX = 12 + NJ;         // 22
constexpr int NU = 3 * NC + NJ;     // 22
constexpr int NRBD = 2 * NQ;        // 32

__device__ __forceinline__ void load_consts(const float* gK, float* K) {
  for (int i = threadIdx.x; i < N_CONSTS; i += THREADS) K[i] = gK[i];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
dummy_step_kernel(const float* __restrict__ gK, const float* __restrict__ gx,
                  const float* __restrict__ gu, int batch, float dt, float* __restrict__ ox) {
  __shared__ float K[N_CONSTS];
  load_consts(gK, K);
  const long long b = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= batch) return;
  float x[NX], u[NU], k1[NX], xm[NX], k2[NX];
  for (int i = 0; i < NX; ++i) x[i] = gx[b * NX + i];
  for (int i = 0; i < NU; ++i) u[i] = gu[b * NU + i];
  FlowKin w;
  flow_dev(K, x, u, &w, k1);
  for (int i = 0; i < NX; ++i) xm[i] = x[i] + dt * k1[i];
  flow_dev(K, xm, u, &w, k2);
  const float hdt = 0.5f * dt;
  for (int i = 0; i < NX; ++i) ox[b * NX + i] = x[i] + hdt * (k1[i] + k2[i]);
}

__global__ void __launch_bounds__(THREADS)
state_input_to_v_kernel(const float* __restrict__ gK, const float* __restrict__ gx,
                        const float* __restrict__ gu, int batch, float* __restrict__ ov,
                        float* __restrict__ orbd) {
  __shared__ float K[N_CONSTS];
  load_consts(gK, K);
  const long long b = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= batch) return;
  float x[NX], vj[NJ];
  for (int i = 0; i < NX; ++i) x[i] = gx[b * NX + i];
  for (int j = 0; j < NJ; ++j) vj[j] = gu[b * NU + 3 * NC + j];
  Kin w;
  fk_dev(K, x + 6, &w);
  base_velocity_dev(K, x, vj, &w);
  float* v = ov + b * NQ;
  for (int i = 0; i < 6; ++i) v[i] = w.vb[i];
  for (int j = 0; j < NJ; ++j) v[6 + j] = vj[j];
  if (orbd == nullptr) return;
  float E[9], om[3];
  euler_E(w.trig, E);
  mv3(E, w.vb + 3, om);
  float* r = orbd + b * NRBD;
  for (int i = 0; i < 3; ++i) {
    r[i] = x[9 + i];
    r[3 + i] = x[6 + i];
    r[NQ + i] = om[i];
    r[NQ + 3 + i] = w.vb[i];
  }
  for (int j = 0; j < NJ; ++j) {
    r[6 + j] = x[12 + j];
    r[NQ + 6 + j] = vj[j];
  }
}

unsigned blocks(int batch) { return static_cast<unsigned>((batch + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int hk_dummy_step(const float* consts, const float* x, const float* u, float* x_out,
                             int batch, float dt, void* stream) {
  dummy_step_kernel<<<blocks(batch), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, x, u, batch, dt, x_out);
  return static_cast<int>(cudaGetLastError());
}

// rbd may be NULL: then only v is written
extern "C" int hk_state_input_to_v(const float* consts, const float* x, const float* u, float* v,
                                   float* rbd, int batch, void* stream) {
  state_input_to_v_kernel<<<blocks(batch), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, x, u, batch, v, rbd);
  return static_cast<int>(cudaGetLastError());
}
