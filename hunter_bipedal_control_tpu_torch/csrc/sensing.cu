// B13: the full-order loop's sensing, as two kernels.
//
// hk_synth_imu (B13a) replaces hunter_bipedal_control_tpu/backends/
// fullorder.py::synth_imu (:199), the IMU readings of the simulated base
// link, as the port's backends/fullorder.py::synth_imu_plain computes them:
// R(zyx), the quaternion (x, y, z, w) of the same angles, the world angular
// velocity w_w = E(zyx) theta_dot, the local one R' w_w and the specific
// force R' (a_lin + 9.81 e_z).  It also writes w_w, which the noiseless
// loop feeds the Kalman filter.  It reads no model constant.
//
// hk_rbd_to_centroidal (B13b) replaces hunter_bipedal_control_tpu/models/
// centroidal.py::rbd_state_to_centroidal (:198) with its
// centroidal_momentum_matrix (:34): the rbd state to (q, v) in the
// Euler-rate form (rbd_dynamics.cuh::rbd_to_qv), FK, the world inertias,
// the velocity pass, then h = A v as the links' momenta about the CoM
// (soa_model.cuh::momentum_about_com_dev):
//   p_com = sum_k m_k c_k / m,  h_lin = sum_k m_k c_dot_k,
//   h_ang = sum_k I_k w_k + (c_k - p_com) x m_k c_dot_k,
// and x = [h / m, p, theta, qj].  No 6 x 16 A is formed.
//
// One thread per scenario, 32 threads (one warp) per block; the block
// stages the model's constants in shared memory, each thread keeps its
// state's kinematics (soa_model.cuh's Kin, ~1.7 KB) in local memory, which
// the L1 cache holds.  Work per scenario: B13a reads 9 floats, writes 13
// and needs ~100 operations; B13b reads 32, writes 22 and needs ~4.5k
// (chip_smoke.py::imu_cost, centroidal_cost).  At a sweep's B=4096 both
// are bytes bound; at B=1 both are latency bound: one serial chain in one
// thread.  Splitting B13b's chain over a warp's lanes
// (a lane per link, a shuffle reduction) is later work.
//
// Model constants come from B1's constants buffer
// (ocp/soa_kernel.py::consts_buffer), whose topology check guards this
// kernel too.  True float32: no fast math; nothing is clamped or branched
// on the data, so a NaN state spreads as it does in the plain versions.
#include <cuda_runtime.h>

#include "rbd_dynamics.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int NRBD = 2 * NQ;    // 32
constexpr int NX = 12 + NJ;     // 22

__global__ void __launch_bounds__(THREADS)
synth_imu_kernel(const float* __restrict__ gq, const float* __restrict__ gv,
                 const float* __restrict__ gacc, int acc_stride, int batch,
                 float* __restrict__ oquat,
                 float* __restrict__ oom_l, float* __restrict__ oacc_l,
                 float* __restrict__ oom_w) {
  const long long b = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= batch) return;
  const float* q = gq + b * NQ;
  const float* v = gv + b * NQ;
  const float* a = gacc + b * acc_stride;
  const float cz = cosf(q[3]), sz = sinf(q[3]);
  const float cy = cosf(q[4]), sy = sinf(q[4]);
  const float cx = cosf(q[5]), sx = sinf(q[5]);
  const float R[9] = {cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                      sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                      -sy,     cy * sx,                cy * cx};
  // the quaternion of the half angles (spatial.py::zyx_to_quat)
  const float hcz = cosf(0.5f * q[3]), hsz = sinf(0.5f * q[3]);
  const float hcy = cosf(0.5f * q[4]), hsy = sinf(0.5f * q[4]);
  const float hcx = cosf(0.5f * q[5]), hsx = sinf(0.5f * q[5]);
  float* quat = oquat + b * 4;
  quat[0] = hcz * hcy * hsx - hsz * hsy * hcx;
  quat[1] = hcz * hsy * hcx + hsz * hcy * hsx;
  quat[2] = hsz * hcy * hcx - hcz * hsy * hsx;
  quat[3] = hcz * hcy * hcx + hsz * hsy * hsx;
  const float trig[4] = {cz, sz, cy, sy};
  float E[9], om_w[3];
  euler_E(trig, E);
  mv3(E, v + 3, om_w);
  const float f[3] = {a[0], a[1], a[2] + GRAVITY};
  for (int i = 0; i < 3; ++i) {
    oom_w[b * 3 + i] = om_w[i];
    oom_l[b * 3 + i] = (R[i] * om_w[0] + R[3 + i] * om_w[1]) + R[6 + i] * om_w[2];
    oacc_l[b * 3 + i] = (R[i] * f[0] + R[3 + i] * f[1]) + R[6 + i] * f[2];
  }
}

__global__ void __launch_bounds__(THREADS)
rbd_to_centroidal_kernel(const float* __restrict__ gK, const float* __restrict__ grbd,
                         int batch, float* __restrict__ ox) {
  __shared__ float K[N_CONSTS];
  for (int i = threadIdx.x; i < N_CONSTS; i += THREADS) K[i] = gK[i];
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (b >= batch) return;
  float q[NQ], v[NQ], hl[3], ha[3];
  rbd_to_qv(grbd + b * NRBD, q, v);
  Kin w;
  fk_dev(K, q, &w);
  com_position_dev(K, &w);
  world_inertias_dev(K, &w);
  velocity_pass_dev(v, v + 6, &w);
  momentum_about_com_dev(K, &w, hl, ha);
  float* x = ox + b * NX;
  const float m = K[K_M];
  for (int i = 0; i < 3; ++i) {
    x[i] = hl[i] / m;
    x[3 + i] = ha[i] / m;
  }
  for (int i = 0; i < NQ; ++i) x[6 + i] = q[i];
}

unsigned blocks(int batch) { return static_cast<unsigned>((batch + THREADS - 1) / THREADS); }

}  // namespace

// base_acc: rows of acc_stride floats, the first three the linear acceleration
extern "C" int hk_synth_imu(const float* q, const float* v, const float* base_acc,
                            int acc_stride, float* quat, float* omega_local, float* accel_local,
                            float* omega_world, int batch, void* stream) {
  synth_imu_kernel<<<blocks(batch), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, v, base_acc, acc_stride, batch, quat, omega_local, accel_local, omega_world);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hk_rbd_to_centroidal(const float* consts, const float* rbd, float* x, int batch,
                                    void* stream) {
  rbd_to_centroidal_kernel<<<blocks(batch), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      consts, rbd, batch, x);
  return static_cast<int>(cudaGetLastError());
}
