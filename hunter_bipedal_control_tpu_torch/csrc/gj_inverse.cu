// B6: batched small (n <= 32) inverse by Gauss-Jordan.
//
// Replaces hunter_bipedal_control_tpu/ops/linalg.py::gj_inverse.  Its uses:
// the 5x5 damped normal systems of the leg IK on the MPC step
// (refs/ik.py:50-58), and on the control tick the 28x28 Kalman innovation
// covariance (estim/kalman.py:158-159) and the momentum observer's 5x5
// per-leg systems (estim/contact.py:92-93).
//
// Bound on the card: far below both roofs at these shapes (IK: 1,792 5x5
// matrices per launch, ~1 MFLOP and 0.36 MB; Kalman at B = 1: one 28x28,
// ~0.09 MFLOP and 6 KB): launch latency and one pass over the data
// dominate.  Design: for n <= 16, one thread per matrix, the n x 2n tableau
// in the thread's own registers or local memory, no shared memory and no
// barrier; each thread reads its matrix row by row, and at these sizes the
// loads are not worth coalescing.  For 16 < n <= 32, one kernel for every
// n: one block of 256 threads per matrix with the tableau in a fixed 32 x 64
// shared array (8 KB), each elimination step split over the block (the
// cooperative elimination that B2 uses too).
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

// The tableau of the block kernel: up to 32 rows of 64 columns (8 KB).
constexpr int BLOCK_MAX_N = 32;
constexpr int BLOCK_LD = 2 * BLOCK_MAX_N;

__global__ void __launch_bounds__(256)
gj_inverse_block_kernel(const float* __restrict__ A, float* __restrict__ out, int n, int pivot) {
  __shared__ float M[BLOCK_MAX_N * BLOCK_LD];
  __shared__ float col[BLOCK_MAX_N];
  __shared__ float prow[BLOCK_LD];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const float* a = A + b * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    M[i * BLOCK_LD + j] = a[idx];
    M[i * BLOCK_LD + n + j] = (i == j) ? 1.0f : 0.0f;
  }
  __syncthreads();
  gj_eliminate_n<true>(M, n, BLOCK_LD, pivot != 0, col, prow, tid, blockDim.x);
  float* o = out + b * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    o[idx] = M[i * BLOCK_LD + n + j];
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
    default:
      if (n < 1 || n > BLOCK_MAX_N) return static_cast<int>(cudaErrorInvalidValue);
      gj_inverse_block_kernel<<<batch, 256, 0, s>>>(A, out, n, pivot);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
