// B2: per-knot equality projection of the SQP's LQ data.
//
// Replaces hunter_bipedal_control_tpu/solver/sqp.py::project_knot (with
// ops/linalg.py::gj_inverse and bsmm, the JAX package's broadcast small
// matmul).  Per knot, with m = 16 equality rows and nx = nu = 22:
//   G   = D D' + diag(1 - mask) + proj_reg I,  G^-1 by Gauss-Jordan
//   D+  = D' G^-1,   X = D+ [g C D],   e = -X0,  E = -X1,  P = I - X2
//   YQ  = Quu [e E P],  BU = B [e E P],  T = [E P]' [Quu e + qu, Quu E, Qux, Quu P]
// and the reduced LQ data (A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P).
// The kernel computes these products in this order, as the reference does,
// and every entry of Qxx_t, Qww and Qwx as it does (no symmetry assumed);
// T's block E' Quu P, which no output reads, is not formed.
//
// Bound on the card: 8,448 knots at the bench shape read 12.9 KB and write
// 13.9 KB each (~226 MB in all, ~68 us at 3.35 TB/s) for ~0.27 MFLOP each
// (~2.3 GFLOP, ~34 us at 67 TFLOP/s fp32): memory bound, with a latency
// chain per knot (the 16 pivots of the Gram's elimination) that decides the
// time at B=1.  Design:
//  - four warps a knot; a persistent grid (the card's SMs times the blocks
//    that fit one) walks the knots, each block staging the next knot's
//    inputs in the other half of a double buffer in shared memory by
//    cp.async while it computes this one, so no global load is on a
//    knot's chain but the first;
//  - the inputs land in the layouts the products read: rows padded to 24
//    floats (16-byte aligned, zero pads), [C | D] side by side, [Quu; B]
//    stacked;
//  - warp 0 forms the Gram, eliminates [G | I] and forms D+ in registers:
//    lane j holds column j of the tableau (lanes 16-31 G^-1's columns), the
//    pivot column travels by shuffles, no barrier inside, the rows rotating
//    through the registers so that the loop stays rolled; warps 1-3 stage
//    the next knot meanwhile;
//  - every product in register tiles (2x6 X, 4x6 [Quu; B] [E | P], 4x6 T),
//    the operands read as float4 / float2 from shared memory, each tile's
//    operand sources fixed before its inner loop.  g rides in the pad
//    column 22 of [C | D], so the same tiles carry e = -D+ g in U's column
//    22, Quu e and B e in YQ's and BU's, E' Qe, P' Qe in T's and, in T's
//    row 22, e' Qux: no thread computes a vector apart;
//  - each output written once from the registers that hold it; A_t, d_t,
//    qx_t and Qxx_t add their inputs on the way out, Qxx_t, Qwx and qx_t
//    after one barrier (E' Qux's transpose, the blocks T's other tiles hold);
//  - the code stays small (loops rolled where they are not products): at
//    B=1 each SM runs it once, from a cold instruction cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NX = 22;
constexpr int NU = 22;
constexpr int NM = 16;
constexpr int W = 24;           // a 22-wide row, padded to 16 bytes
constexpr int W2 = 2 * W;       // [C | D], [E | P] and [Quu E | Quu P] rows
constexpr int THREADS = 128;    // four warps a knot
constexpr unsigned FULL = 0xffffffffu;

// One knot's inputs in shared memory (floats): [C g | D] (16 x 48: C at
// 0-21, g at 22, D at 24-45), mask, [Quu; B] (44 x 24), Qux (24 x 24, pad
// rows zero), d, qx, qu, and A and Qxx as they are (22 x 22, read only on
// the way out).
constexpr int CG = NX;          // g's column in [C g | D], and e's in U
constexpr int O_CD = 0;
constexpr int O_MASK = O_CD + NM * W2;
constexpr int O_QB = O_MASK + NM;
constexpr int O_QUX = O_QB + (NU + NX) * W;
constexpr int O_D = O_QUX + W * W;
constexpr int O_QX = O_D + W;
constexpr int O_QU = O_QX + W;
constexpr int O_A = O_QU + W;
constexpr int O_QXX = O_A + NX * NX;
constexpr int KNOT = O_QXX + NX * NX;
// The work arrays after the two input buffers: U = [E e | P] and YQ =
// [Quu E, Qe | Quu P] (24 x 48, Qe = Quu e + qu in column 22; rows 22-23
// zero: the pads of the products' depth), D+ (24 x 16), sigma.  T's
// E' [Quu E, Qe], [E e]' Qux and P' [Quu E, Qe] (24 x 24 each) take the head
// of the knot's own input buffer, dead by then.
constexpr int O_U = 2 * KNOT;
constexpr int O_YQ = O_U + W * W2;
constexpr int O_DP = O_YQ + W * W2;
constexpr int O_SIG = O_DP + W * NM;
constexpr int SMEM = O_SIG + 4;
static_assert(SMEM % 4 == 0, "zeroed as float4");
static_assert(KNOT % 4 == 0 && O_QB % 4 == 0 && O_QUX % 4 == 0 && O_A % 2 == 0 &&
              O_U % 4 == 0 && O_DP % 4 == 0, "aligned arrays");
static_assert(SMEM * 4 <= 48 * 1024, "static shared memory");
static_assert(3 * W * W <= O_QUX, "T's blocks fit the dead head of a buffer");

// Measurement build only (profile_step project_phases): -DPROJ_PHASE_CLOCKS
// sums block 0's clock64 cycles (thread 0, warp 0's lane 0) by phase over
// the knots it runs, and counts those knots.
enum { PH_LOAD, PH_GRAM, PH_ELIM, PH_DPLUS, PH_XU, PH_YQBU, PH_T, PH_STORES, PH_KNOTS };
#ifdef PROJ_PHASE_CLOCKS
__device__ unsigned long long proj_phase_cycles[PH_KNOTS + 1];
#define PROJ_PHASE(p)                                \
  if (blockIdx.x == 0 && threadIdx.x == 0) {         \
    const long long now = clock64();                 \
    proj_phase_cycles[p] += now - t_phase;           \
    t_phase = now;                                   \
  }
#else
#define PROJ_PHASE(p)
#endif

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// ROWS rows of WID floats (WID even), contiguous at src, to rows of pitch LD
// at dst: 8-byte copies where every input is 8-byte aligned (VEC), else 4.
// The loops stay rolled: the kernel's code must fit the instruction cache.
template <bool VEC, int ROWS, int WID, int LD>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int t, int nthr) {
  constexpr int E = VEC ? 2 : 1, PER = WID / E;
#pragma unroll 1
  for (int idx = t; idx < ROWS * PER; idx += nthr) {
    const int r = idx / PER, c = (idx - r * PER) * E;
    if (VEC) {
      cp8(dst + r * LD + c, src + r * WID + c);
    } else {
      cp4(dst + r * LD + c, src + r * WID + c);
    }
  }
}

struct Inputs {
  const float *A, *B, *d, *qx, *qu, *Qxx, *Quu, *Qux, *g, *C, *D, *mask;
};
struct Outputs {
  float *A, *B, *d, *qx, *qw, *Qxx, *Qww, *Qwx, *E, *e, *P;
};

// knot k's inputs into the buffer at b, by threads t of nthr (not committed);
// the pads the products read as depth (D's columns 22-23, [Quu; B]'s columns
// 22-23) and C's last pad zeroed, as T's blocks of the knot before wrote there
template <bool VEC>
__device__ __forceinline__ void stage(const Inputs& in, long long k, float* b, int t, int nthr) {
#pragma unroll 1
  for (int i = t; i < NM + NU + NX; i += nthr) {
    float* p = i < NM ? b + O_CD + i * W2 + W + NU : b + O_QB + (i - NM) * W + NU;
    p[0] = 0.0f;
    p[1] = 0.0f;
    if (i < NM) b[O_CD + i * W2 + CG + 1] = 0.0f;
  }
  copy_rows<VEC, NM, NX, W2>(b + O_CD, in.C + k * NM * NX, t, nthr);
  copy_rows<false, NM, 1, W2>(b + O_CD + CG, in.g + k * NM, t, nthr);
  copy_rows<VEC, NM, NU, W2>(b + O_CD + W, in.D + k * NM * NU, t, nthr);
  copy_rows<VEC, NU, NU, W>(b + O_QB, in.Quu + k * NU * NU, t, nthr);
  copy_rows<VEC, NX, NU, W>(b + O_QB + NU * W, in.B + k * NX * NU, t, nthr);
  copy_rows<VEC, NU, NX, W>(b + O_QUX, in.Qux + k * NU * NX, t, nthr);
  copy_rows<VEC, 1, NX * NX, NX * NX>(b + O_A, in.A + k * NX * NX, t, nthr);
  copy_rows<VEC, 1, NX * NX, NX * NX>(b + O_QXX, in.Qxx + k * NX * NX, t, nthr);
  copy_rows<VEC, 1, NM, NM>(b + O_MASK, in.mask + k * NM, t, nthr);
  copy_rows<VEC, 1, NX, NX>(b + O_D, in.d + k * NX, t, nthr);
  copy_rows<VEC, 1, NX, NX>(b + O_QX, in.qx + k * NX, t, nthr);
  copy_rows<VEC, 1, NU, NU>(b + O_QU, in.qu + k * NU, t, nthr);
}

// the thread's index, read anew where it is used: the tiles' indices and
// addresses are then not kept (or spilled) across the knot loop
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// four blocks an SM: up to 128 registers a thread (five, at 96, measured
// no faster on an H100)
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
project_knot_kernel(Inputs in, Outputs out, int n_knots, float proj_reg, float hess_reg,
                    int pivot) {
  __shared__ __align__(16) float sm[SMEM];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
#ifdef PROJ_PHASE_CLOCKS
  long long t_phase = clock64();
#endif
  // every pad zero before the first copy lands; the copies never touch them
#pragma unroll 1
  for (int i = tid; i < SMEM / 4; i += THREADS)
    reinterpret_cast<float4*>(sm)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  long long k = blockIdx.x;
  if (k < n_knots) stage<VEC>(in, k, sm, tid, THREADS);
  cp_commit();
  float* U = sm + O_U;
  float* YQ = sm + O_YQ;
  float* Dp = sm + O_DP;

#pragma unroll 1
  for (int cur = 0; k < n_knots; k += gridDim.x, cur ^= 1) {
    const float* b = sm + cur * KNOT;
    cp_wait_all();
    __syncthreads();
    PROJ_PHASE(PH_LOAD);
#ifdef PROJ_PHASE_CLOCKS
    if (blockIdx.x == 0 && tid == 0) proj_phase_cycles[PH_KNOTS] += 1;
#endif
    const long long next = k + gridDim.x;

    // ---- warp 0: the Gram, its elimination and D+, in registers; warps 1-3
    // stage the next knot
    if (warp == 0) {
      const int col = lane & 15, half = lane >> 4;
      const float* Dr = b + O_CD + W;  // D's row r at Dr + r * W2
      float own[12];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 v = ld4(Dr + col * W2 + 12 * half + 4 * q);
        own[4 * q] = v.x, own[4 * q + 1] = v.y, own[4 * q + 2] = v.z, own[4 * q + 3] = v.w;
      }
      // lane j (< 16) and lane j + 16 sum halves of column j of D D'
      float m[NM];
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 v = ld4(Dr + i * W2 + 12 * half + 4 * q);
          acc += v.x * own[4 * q];
          acc += v.y * own[4 * q + 1];
          acc += v.z * own[4 * q + 2];
          acc += v.w * own[4 * q + 3];
        }
        m[i] = acc + __shfl_xor_sync(FULL, acc, 16);
      }
      // the tableau [G | I]: lane j < 16 holds G's column j, lane 16 + c I's column c
      const float dg = 1.0f - b[O_MASK + col];
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        const float gi = (i == col) ? (m[i] + dg) + proj_reg : m[i];
        m[i] = half ? ((i == col) ? 1.0f : 0.0f) : gi;
      }
      PROJ_PHASE(PH_GRAM);
      // Gauss-Jordan, pivots in the natural order (gj.cuh's semantics): row k
      // divided by its pivot (+1e-30 with pivot; + -0 leaves it as it is),
      // then every other row updated by its entry in column k, which lane k
      // holds.  The rows rotate by one a step, so that row k is m[0] at step
      // k and the loop stays rolled; after 16 steps they are in order again.
      const float tiny = pivot ? 1e-30f : -0.0f;
#pragma unroll 1
      for (int kk = 0; kk < NM; ++kk) {
        // column kk first (independent of the division), then the division
        float cv[NM];
#pragma unroll
        for (int i = 0; i < NM; ++i) cv[i] = __shfl_sync(FULL, m[i], kk);
        const float pval = cv[0] + tiny;
        // a zero over a finite, nonzero pivot is the signed zero the division
        // gives, without the division's slow path (~280 cycles on an H100
        // when any lane takes it, ~60 when none does)
        const float num = m[0];
        float prow;
        if (num == 0.0f && fabsf(pval) != 0.0f && fabsf(pval) != INFINITY) {
          prow = num * pval;
        } else {
          prow = num / pval;
        }
#pragma unroll
        for (int i = 1; i < NM; ++i) m[i - 1] = m[i] - cv[i] * prow;
        m[NM - 1] = prow;
      }
      PROJ_PHASE(PH_ELIM);
      // G^-1's column col on both halves; D+[a][col] = sum_r D[r][a] G^-1[r][col],
      // rows a in [12 half, 12 half + 12) (rows 22, 23 are never read)
#pragma unroll
      for (int r = 0; r < NM; ++r) m[r] = __shfl_sync(FULL, m[r], lane | 16);
      float acc[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int r = 0; r < NM; ++r) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 v = ld4(Dr + r * W2 + 12 * half + 4 * q);
          acc[4 * q] += v.x * m[r];
          acc[4 * q + 1] += v.y * m[r];
          acc[4 * q + 2] += v.z * m[r];
          acc[4 * q + 3] += v.w * m[r];
        }
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) Dp[(12 * half + i) * NM + col] = acc[i];
    } else {
      if (tid == 32) {
        float s = 0.0f;
        for (int i = 0; i < NU; ++i) s += b[O_QB + i * W + i];
        sm[O_SIG] = 1.0f + s / NU;
      }
      if (next < n_knots) stage<VEC>(in, next, sm + (cur ^ 1) * KNOT, tid - 32, THREADS - 32);
      cp_commit();
    }
    __syncthreads();
    PROJ_PHASE(PH_DPLUS);

    // ---- X = D+ [C g | D] in 2 x 6 tiles (88 threads): U = [E e | P] =
    // [-X_C, -X_g | I - X_D], E, e and P out
    if (const int t = thread_index(); t < 88) {
      const int tm = t >> 3, tn = t & 7;
      const int a0 = 2 * tm, n0 = 6 * tn, c0 = 6 * (tn & 3);
      float acc[2][6];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[i][j] = 0.0f;
      const float* L = Dp + a0 * NM;
      const float* R = b + O_CD + n0;
#pragma unroll
      for (int r = 0; r < NM; r += 4) {
        const float4 l0 = ld4(L + r), l1 = ld4(L + NM + r);
        const float la[2][4] = {{l0.x, l0.y, l0.z, l0.w}, {l1.x, l1.y, l1.z, l1.w}};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* row = R + (r + q) * W2;
          const float2 x = ld2(row), y = ld2(row + 2), z = ld2(row + 4);
          const float rv[6] = {x.x, x.y, y.x, y.y, z.x, z.y};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j) acc[i][j] += la[i][q] * rv[j];
        }
      }
      const bool isP = tn >= 4;
      float* gout = (isP ? out.P : out.E) + k * NU * NX;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int a = a0 + i;
        float v[6];
#pragma unroll
        for (int j = 0; j < 6; ++j)
          v[j] = isP ? ((a == c0 + j) ? 1.0f : 0.0f) - acc[i][j] : -acc[i][j];
#pragma unroll
        for (int j = 0; j < 6; j += 2) {
          st2(U + a * W2 + n0 + j, v[j], v[j + 1]);
          if (c0 + j < NX) st2(gout + a * NX + c0 + j, v[j], v[j + 1]);
        }
        if (!isP && c0 + 4 == CG) out.e[k * NU + a] = v[4];
      }
    }
    __syncthreads();
    PROJ_PHASE(PH_XU);

    // ---- [Quu; B] [E e | P] in 4 x 6 tiles (88 threads): Quu E, Quu e + qu
    // and Quu P to YQ, A_t = A + B E, d_t = d + B e and B_t = B P out
    if (const int t = thread_index(); t < 88) {
      const int tm = t >> 3, tn = t & 7;
      const int m0 = 4 * tm, n0 = 6 * tn, c0 = 6 * (tn & 3);
      float acc[4][6];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[i][j] = 0.0f;
      const float* L = b + O_QB + m0 * W;
      const float* R = U + n0;
#pragma unroll 1
      for (int r = 0; r < W; r += 4) {
        float la[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 l = ld4(L + i * W + r);
          la[i][0] = l.x, la[i][1] = l.y, la[i][2] = l.z, la[i][3] = l.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* row = R + (r + q) * W2;
          const float2 x = ld2(row), y = ld2(row + 2), z = ld2(row + 4);
          const float rv[6] = {x.x, x.y, y.x, y.y, z.x, z.y};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j) acc[i][j] += la[i][q] * rv[j];
        }
      }
      const bool isP = tn >= 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + i;
        const bool eCol = !isP && c0 + 4 == CG;  // column j = 4 is e's
        if (m < NU) {
          if (eCol) acc[i][4] = acc[i][4] + b[O_QU + m];
#pragma unroll
          for (int j = 0; j < 6; j += 2) st2(YQ + m * W2 + n0 + j, acc[i][j], acc[i][j + 1]);
        } else {
          const int row = m - NU;
#pragma unroll
          for (int j = 0; j < 6; j += 2) {
            const int c = c0 + j;
            if (c >= NX) continue;
            if (isP) {
              st2(out.B + k * NX * NU + row * NU + c, acc[i][j], acc[i][j + 1]);
            } else {
              const float2 a = ld2(b + O_A + row * NX + c);
              st2(out.A + k * NX * NX + row * NX + c, a.x + acc[i][j], a.y + acc[i][j + 1]);
            }
          }
          if (eCol) out.d[k * NX + row] = b[O_D + row] + acc[i][4];
        }
      }
    }
    __syncthreads();
    PROJ_PHASE(PH_YQBU);

    // ---- T's blocks in 4 x 6 tiles, one product each (threads 0-119): rows
    // of [E e]' or P' (U's columns), columns of [Quu E, Qe], Qux or Quu P.
    // E' [Quu E, Qe], [E e]' Qux and P' [Quu E, Qe] go to shared memory (the
    // dead head of this knot's buffer), qw = P' Qe and Qww = P' Quu P +
    // sigma (I - P) + hess_reg I out; E' Qux and P' Qux stay in registers for
    // the sums after the barrier.
    float* tsh = sm + cur * KNOT;  // [C g | D], mask and [Quu; B] are dead now
    float acc[4][6];
    const int t5 = thread_index();
    const int tt = t5 < 48 ? t5 : t5 - 48;
    const int seg = tt / 24, r0 = 4 * ((tt % 24) >> 2), c0 = 6 * (tt & 3);
    const bool rowsE = t5 < 48;
    if (t5 < 120) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[i][j] = 0.0f;
      const float* L = U + (rowsE ? 0 : W) + r0;
      const float* R = seg == 1 ? b + O_QUX + c0 : YQ + (seg == 2 ? W : 0) + c0;
      const int ldr = seg == 1 ? W : W2;
#pragma unroll 2
      for (int i = 0; i < NU; ++i) {
        const float4 l = ld4(L + i * W2);
        const float* row = R + i * ldr;
        const float2 x = ld2(row), y = ld2(row + 2), z = ld2(row + 4);
        const float lv[4] = {l.x, l.y, l.z, l.w}, rv[6] = {x.x, x.y, y.x, y.y, z.x, z.y};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 6; ++c) acc[r][c] += lv[r] * rv[c];
      }
      if (seg == 2) {
        const float sigma = sm[O_SIG];
        float* o = out.Qww + k * NU * NU;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = r0 + r;
          if (p >= NU) continue;
#pragma unroll
          for (int c = 0; c < 6; c += 2) {
            const int cc = c0 + c;
            if (cc >= NU) continue;
            float v[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float eye = (p == cc + h) ? 1.0f : 0.0f;
              v[h] = (acc[r][c + h] + sigma * (eye - U[p * W2 + W + cc + h])) + hess_reg * eye;
            }
            st2(o + p * NU + cc, v[0], v[1]);
          }
        }
      } else if (seg == 0 || rowsE) {
        // E' [Quu E, Qe], [E e]' Qux, P' [Quu E, Qe]: 24 x 24 each, in that order
        float* t = tsh + (rowsE ? seg : 2) * W * W;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 6; c += 2) st2(t + (r0 + r) * W + c0 + c, acc[r][c], acc[r][c + 1]);
        if (!rowsE && c0 + 4 == CG) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (r0 + r < NU) out.qw[k * NU + r0 + r] = acc[r][4];
        }
      }
    }
    __syncthreads();
    PROJ_PHASE(PH_T);

    // ---- Qxx_t = Qxx + E' Quu E + E' Qux + (E' Qux)' and Qwx = P' Quu E +
    // P' Qux, by the threads that hold E' Qux and P' Qux; qx_t = qx + E' Qe
    // + Qux' e by those that hold E' Qe
    if (rowsE && seg == 0 && c0 + 4 == CG) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = r0 + r;
        if (rr < NX) out.qx[k * NX + rr] = (b[O_QX + rr] + acc[r][4]) + tsh[W * W + CG * W + rr];
      }
    }
    if (seg == 1 && t5 < 120) {
      const float* t0 = tsh + (rowsE ? 0 : 2) * W * W;
      float* o = rowsE ? out.Qxx + k * NX * NX : out.Qwx + k * NU * NX;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rr = r0 + r;
        if (rr >= NX) continue;
#pragma unroll
        for (int c = 0; c < 6; c += 2) {
          const int cc = c0 + c;
          if (cc >= NX) continue;
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float first = t0[rr * W + cc + h];
            v[h] = rowsE ? ((b[O_QXX + rr * NX + cc + h] + first) + acc[r][c + h]) +
                               tsh[W * W + (cc + h) * W + rr]
                         : first + acc[r][c + h];
          }
          st2(o + rr * NX + cc, v[0], v[1]);
        }
      }
    }
    PROJ_PHASE(PH_STORES);
  }
}

// blocks a persistent grid keeps on the card: its SMs times the blocks one
// SM holds, per device (both instances take the same resources)
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0, per = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, project_knot_kernel<true>, THREADS, 0) !=
          cudaSuccess)
    return 0;
  const int n = sms * (per > 0 ? per : 1);
  if (dev < 64) cached[dev] = n;
  return n;
}

bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

}  // namespace

extern "C" int hk_project_knot(const float* A, const float* B, const float* d, const float* qx,
                               const float* qu, const float* Qxx, const float* Quu,
                               const float* Qux, const float* g, const float* C, const float* D,
                               const float* mask, float* oA, float* oB, float* od, float* oqx,
                               float* oqw, float* oQxx, float* oQww, float* oQwx, float* oE,
                               float* oe, float* oP, int n_knots, float proj_reg,
                               float hess_reg, int pivot, void* stream) {
  const Inputs in{A, B, d, qx, qu, Qxx, Quu, Qux, g, C, D, mask};
  const Outputs out{oA, oB, od, oqx, oqw, oQxx, oQww, oQwx, oE, oe, oP};
  // the outputs take 8-byte stores (the wrapper's are fresh allocations)
  const float* outs[] = {oA, oB, od, oqx, oqw, oQxx, oQww, oQwx, oE, oe, oP};
  for (const float* p : outs)
    if (!aligned8(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_knots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* ins[] = {A, B, d, qx, qu, Qxx, Quu, Qux, g, C, D, mask};
  bool vec = true;
  for (const float* p : ins) vec = vec && aligned8(p);
  const int cap = resident_blocks();
  if (cap <= 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorUnknown);
  }
  const int grid = n_knots < cap ? n_knots : cap;
  auto kernel = vec ? project_knot_kernel<true> : project_knot_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n_knots, proj_reg,
                                                                  hess_reg, pivot);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PROJ_PHASE_CLOCKS
// The phase sums and block 0's knots since the last call, then zeroed.
extern "C" int hk_project_knot_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, proj_phase_cycles, sizeof(proj_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[PH_KNOTS + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(proj_phase_cycles, zero, sizeof(zero)));
}
#endif
