// B6: batched small (n <= 16) inverse by Gauss-Jordan.
//
// Replaces hunter_bipedal_control_tpu/ops/linalg.py::gj_inverse (on the MPC
// step: the 5x5 damped normal systems of the leg IK, refs/ik.py:50-58).
//
// Bound on the card: at the main path's shape (B*7*2 = 1,792 matrices of
// 5x5 per launch) the work is about 1 MFLOP and 0.36 MB of traffic, far
// below both roofs: launch latency and one pass over the data dominate.  Design: one
// thread per matrix, the n x 2n tableau in the thread's own registers or
// local memory, no shared memory and no barrier.
// Each thread reads its matrix row by row; at these sizes the loads are
// not worth coalescing.
#include <cuda_runtime.h>

#include "gj.cuh"

template <int N>
__global__ void gj_inverse_kernel(const float* __restrict__ A, float* __restrict__ out,
                                  int batch, int pivot) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch) return;
  constexpr int W = 2 * N;
  float M[N * W];
  float col[N];
  float prow[W];
  const float* a = A + static_cast<long long>(t) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      M[i * W + j] = a[i * N + j];
      M[i * W + N + j] = (i == j) ? 1.0f : 0.0f;
    }
  }
  gj_eliminate<N, W, false>(M, pivot != 0, col, prow, 0, 1);
  float* o = out + static_cast<long long>(t) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) o[i * N + j] = M[i * W + N + j];
  }
}

template <int N>
static void launch(const float* A, float* out, int batch, int pivot, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  gj_inverse_kernel<N><<<blocks, threads, 0, s>>>(A, out, batch, pivot);
}

extern "C" int hk_gj_inverse(const float* A, float* out, int batch, int n, int pivot,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch<1>(A, out, batch, pivot, s); break;
    case 2: launch<2>(A, out, batch, pivot, s); break;
    case 3: launch<3>(A, out, batch, pivot, s); break;
    case 4: launch<4>(A, out, batch, pivot, s); break;
    case 5: launch<5>(A, out, batch, pivot, s); break;
    case 6: launch<6>(A, out, batch, pivot, s); break;
    case 7: launch<7>(A, out, batch, pivot, s); break;
    case 8: launch<8>(A, out, batch, pivot, s); break;
    case 9: launch<9>(A, out, batch, pivot, s); break;
    case 10: launch<10>(A, out, batch, pivot, s); break;
    case 11: launch<11>(A, out, batch, pivot, s); break;
    case 12: launch<12>(A, out, batch, pivot, s); break;
    case 13: launch<13>(A, out, batch, pivot, s); break;
    case 14: launch<14>(A, out, batch, pivot, s); break;
    case 15: launch<15>(A, out, batch, pivot, s); break;
    case 16: launch<16>(A, out, batch, pivot, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
