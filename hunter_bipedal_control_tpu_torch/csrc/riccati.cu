// B3: sequential Riccati backward sweep + forward rollout of the deltas.
//
// Replaces hunter_bipedal_control_tpu/solver/riccati.py::backward_scan (with
// its Newton-Schulz solve of Huu, ops/linalg.py::spd_solve / ns_inverse) and
// the forward rollout scan of solver/sqp.py::solve (sqp.py:338-361).
// Per scenario, backward over the N knots from S = 0, s = 0:
//   SM = S [A B d] (+ s on the last column),  H = [A B]' SM
//   Huu = Qww + H_uu + reg (1 + tr/nu) I,  Hux = Qwx + H_ux,  hu = qw + H_u
//   [K kff] = -Huu^-1 [Hux hu]          (Cholesky of 0.5 (Huu + Huu'))
//   S = sym(Qxx + H_xx + Hux' K),  s = qx + H_x + Hux' kff
// then forward from dx0: w = K dx + kff, du = e + E dx + P w,
// dx' = A dx + B w + d.
//
// NS was a TPU workaround for row-sequential LU; a Cholesky factor takes its
// place.  Huu reaches the kernel symmetric only up to the float32 rounding
// of the projection (P = I - D+ D, ~1e-2 relative on the main path), and its
// small eigenvalues (~1e-5 against ~1) make a factor of the lower triangle
// alone an order of magnitude farther from the float64 step than NS on the
// full matrix; factoring the symmetric part matches NS.  The factor solves
// exactly: where 20 NS iterations have not converged (warm steps of
// scenarios far from the nominal state) it follows the exact float64 solve,
// not NS.
//
// The elimination: with sym(Huu) = L L' and Y = L^-1 [Hux hu], Hux' K =
// -Yx' Yx and Hux' kff = -Yx' yh, so
//   S = sym(Qxx) + H_xx - Yx' Yx,  s = qx + H_x - Yx' yh
// (a Gram product, symmetric by construction): the recursion needs L and Y
// only, and the gains [K kff] = -L'^-1 Y come from a back sweep off the
// recursion's chain.  A pivot that is not > 0 (NaN included) makes that
// knot's L and Y NaN, and with them its gains and S, every earlier knot's,
// and the rollout.
//
// Bound on the card: the recursion is sequential in the knots, so its floor
// is the latency of N dependent knot steps per scenario, not bytes (~136 MB
// at the bench shape, ~41 us at 3.35 TB/s) or flops (~1.6 GFLOP, ~23 us at
// 67 TFLOP/s fp32); one SM issuing a knot's ~185k operations at one per
// fp32 lane (128) and clock needs ~0.7 us a knot, so the design keeps
// barriers, global loads and the gains' triangular solves off that chain:
// one block of nine warps per scenario (128 scenarios on 132 SMs), the
// knots looped inside it, four block barriers a knot:
//  - while a knot is factored, warps 2.. copy the inputs of the knot before
//    it into the other half of a double buffer in shared memory
//    (cp.async): no global load is on the chain;
//  - SM = S [A B d | s] in 2 x 2 register tiles (253 threads), then H =
//    [A B]' SM on its lower block triangle and last column (275 threads),
//    each symmetric block formed once, with Qxx and Qww entering as their
//    symmetric parts: sym(Qxx) + H_xx and qx + h_x for S and s, and the
//    factor's rows [Huu | Hux hu];
//  - one warp factors: lane i holds row i of the shifted Huu and lane c
//    column c of [Hux hu], in registers.  Step k takes lane k's pivot (which
//    it computes ahead of its row's update) by one shuffle and multiplies
//    in its reciprocal square root; L's column k then travels by shuffles
//    and each of its entries updates a trailing row and a right-hand side
//    column: the forward sweep rides on the factor's shuffles, and no
//    barrier is inside the factor.  Beside it warp 1 turns the knot after
//    this one into gains, from a two-slot ring of (L, Y) in shared memory,
//    and writes them to device memory once;
//  - S and s by the Gram form, a thread per entry of S's lower triangle and
//    of s.
// The rollout: warp 1 copies each knot's rows into a ring of four slots in
// shared memory (the five matrices by the copy engine, cp.async.bulk, after
// a proxy fence on the gains' stores; the vectors by cp.async; a slot's
// mbarrier completes when its copies have landed), and warp 0 runs the
// chain, lane i owning row i of [K; E; A] and [P; B], dx and w travelling
// by shuffles, and frees each slot by a second mbarrier: no block barrier a
// knot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NX = 22;
constexpr int NU = 22;
constexpr int NK = NX + 1;        // columns of [Hux hu] and of [K kff]
constexpr int WS = NU + NK;       // a row of the factor's [Huu | Hux hu]
constexpr int SMS = NX + NU + 2;  // row stride of SM = S [A B d | s], one pad column
constexpr int MAT = NX * NX;      // every per-knot matrix is 22 x 22
// one knot's data in shared memory: five matrices, three vectors, a pad to
// keep the next buffer 16-byte aligned
constexpr int KNOT = 5 * MAT + 3 * NX + 2;
constexpr int LTS = 24;           // column stride of the factor's columns (Lt)
constexpr int RING = 4;           // the rollout's knots in flight
constexpr int THREADS = 288;      // nine warps
constexpr int SM_TILES = (NX / 2) * (SMS / 2);          // 2 x 2 tiles of SM: 253
constexpr int H_TILES = (NX + NU) / 2 * ((NX + NU) / 2 + 1) / 2;  // H's lower block triangle: 253
constexpr int H_JOBS = H_TILES + (NX + NU) / 2;          // and its last column: 275
constexpr int S_JOBS = NX * (NX + 1) / 2 + NX;           // S's lower triangle and s: 275
constexpr unsigned FULL = 0xffffffffu;
static_assert(SM_TILES <= THREADS && H_JOBS <= THREADS && S_JOBS <= THREADS, "jobs per thread");
static_assert(KNOT % 4 == 0 && MAT % 4 == 0, "16-byte copies");
constexpr int V24 = 24;           // a 22-vector's slot, 16-byte aligned
// shared memory: the backward sweep's arrays (two knots' inputs, S, s, SM,
// Sp, sp, and two slots of the factor's rows, L and 1 / diag L), the
// rollout's ring in their place
constexpr int BWD = 2 * KNOT + 2 * MAT + 2 * V24 + NX * SMS + 2 * NU * WS + 2 * NU * LTS + 2 * V24;
constexpr int SMEM = BWD > RING * KNOT ? BWD : RING * KNOT;
static_assert((NX * SMS) % 4 == 0 && (2 * NU * WS) % 4 == 0, "aligned slots");

// Measurement build only (profile_step riccati_phases): -DRICCATI_PHASE_CLOCKS
// sums scenario 0's clock64 cycles per phase (thread 0, at the phase's end,
// behind a barrier after S's update that only this build has); the back
// sweep's own cycles (warp 1) apart, as they overlap the factor.
constexpr int RIC_PHASES = 8;  // loads, sm, h, factor, gains, s_update, rollout, gains_off_chain
#ifdef RICCATI_PHASE_CLOCKS
__device__ unsigned long long ric_phase_cycles[RIC_PHASES];
#define RIC_PHASE(p)                                 \
  if (blockIdx.x == 0 && threadIdx.x == 0) {         \
    const long long now = clock64();                 \
    ric_phase_cycles[p] += now - t_phase;            \
    t_phase = now;                                   \
  }
#else
#define RIC_PHASE(p)
#endif

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// waits for every cp.async this thread has issued
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrives on bar once every cp.async this thread has issued has landed
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// arrives on bar, expecting bytes more from bulk copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// bytes (a multiple of 16, both ends 16-byte aligned) from global to shared
// memory by the copy engine, counted on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ bool aligned16(const float* a, const float* b, const float* c,
                                          const float* d, const float* e) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
           reinterpret_cast<uintptr_t>(e)) & 15) == 0;
}

// One knot's five 22 x 22 matrices and three 22-vectors (pointers at the
// knot) -> buf, by threads t, t + nt, ...: 16-byte copies where every
// matrix is 16-byte aligned (each knot's matrix is 1,936 bytes), else
// 4-byte ones.
__device__ void fetch_knot(float* buf, const float* m0, const float* m1, const float* m2,
                           const float* m3, const float* m4, const float* v0, const float* v1,
                           const float* v2, int t, int nt, bool vec) {
  const float* const mats[5] = {m0, m1, m2, m3, m4};
  const float* const vecs[3] = {v0, v1, v2};
  if (vec) {
#pragma unroll
    for (int m = 0; m < 5; ++m)
      for (int c = 4 * t; c < MAT; c += 4 * nt) cp16(buf + m * MAT + c, mats[m] + c);
  } else {
#pragma unroll
    for (int m = 0; m < 5; ++m)
      for (int c = t; c < MAT; c += nt) cp4(buf + m * MAT + c, mats[m] + c);
  }
#pragma unroll
  for (int m = 0; m < 3; ++m)
    for (int c = t; c < NX; c += nt) cp4(buf + 5 * MAT + m * NX + c, vecs[m] + c);
}

// Entry t of a lower triangle in row order -> (i, j), j <= i.
__device__ __forceinline__ void tri_rc(int t, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  j = t - i * (i + 1) / 2;
}

// Entry (i, j) of H = [A B]' SM (j <= i, or j = NX + NU: the last column),
// plus its share of the cost, to where the sweep reads it: the lower
// triangle of sym(Qxx) + H_xx (Sp), qx + H_x (sp), and the rows of the
// factor's [Huu | Hux hu] (Wk: Huu's lower triangle, Hux, hu).
__device__ __forceinline__ void put_h(int i, int j, float h, const float* Qxx, const float* Qww,
                                      const float* Qwx, const float* qx, const float* qw,
                                      float* Sp, float* sp, float* Wk) {
  if (j == NX + NU) {
    if (i < NX) sp[i] = qx[i] + h;
    else Wk[(i - NX) * WS + WS - 1] = qw[i - NX] + h;
  } else if (i < NX) {
    Sp[i * NX + j] = h + 0.5f * (Qxx[i * NX + j] + Qxx[j * NX + i]);
  } else if (j < NX) {
    Wk[(i - NX) * WS + NU + j] = Qwx[(i - NX) * NX + j] + h;
  } else {
    const int iu = i - NX, ju = j - NX;
    Wk[iu * WS + ju] = h + 0.5f * (Qww[iu * NU + ju] + Qww[ju * NU + iu]);
  }
}

// A pivot's reciprocal square root: the approximate one (no denormal path;
// a pivot is never denormal where the factor is meaningful) refined by one
// Newton step, to about an ulp as 1 / sqrtf would give it.  NaN for a
// pivot that is not > 0.
__device__ __forceinline__ float pivot_rsqrt(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  const float e = fmaf(-x * r, r, 1.0f);  // 1 - x r^2
  return fmaf(0.5f * r, e, r);
}

// One warp: the lower triangle of Wk's Huu, shifted by reg (1 + tr(Huu) /
// nu) -> its Cholesky factor L by columns, Lt[k * LTS + i] = L_ik (i >= k),
// and inv_d[k] = 1 / L_kk; and Y = L^-1 [Hux hu] in place of Wk's right-
// hand side.  Lane i holds row i of Huu and lane c < NK column c of the
// right-hand side, in registers (lanes past them copies, never stored).
// Step k, right-looking: lane k's pivot, which it computes ahead of its
// row's update, comes by one shuffle; every lane scales its row's column-k
// entry by the pivot's reciprocal square root (L_ik) and its column's entry
// k (Y_kc), and takes L's column k, one shuffle an entry, off its trailing
// row and off its column: the forward sweep rides on the factor's shuffles.
// A pivot that is not > 0 (NaN included) makes all of L and Y NaN.
__device__ void factor(float* Wk, float* Lt, float* inv_d, float reg, int lane) {
  const int row = min(lane, NU - 1), col = min(lane, NK - 1);
  float w[NU], v[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) w[c] = Wk[row * WS + c];
#pragma unroll
  for (int i = 0; i < NU; ++i) v[i] = Wk[i * WS + NU + col];
  float dg[NU];  // Huu's diagonal, every lane (one address a load), summed as a tree
#pragma unroll
  for (int i = 0; i < NU; ++i) dg[i] = Wk[i * WS + i];
#pragma unroll
  for (int h = 1; h < NU; h *= 2)
#pragma unroll
    for (int i = 0; i + h < NU; i += 2 * h) dg[i] += dg[i + h];
  const float shift = reg * (1.0f + dg[0] / NU);
#pragma unroll
  for (int c = 0; c < NU; ++c)
    if (c == row) w[c] += shift;
  float inv = 0.0f;
  float dnext = w[0];  // lane k + 1's next pivot, ahead of its row's update
  bool ok = true;
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const float dk = __shfl_sync(FULL, dnext, k);
    ok = ok && dk > 0.0f;
    const float r = pivot_rsqrt(dk);
    const bool below = lane > k;
    const float l = w[k] * r;           // L_ik on the rows below k
    const float lb = below ? l : 0.0f;  // rows above k are done
    const float y = v[k] * r;           // Y_kc
    if (k + 1 < NU) dnext = fmaf(-l, l, w[k + 1]);
#pragma unroll
    for (int j = k + 1; j < NU; ++j) {
      const float ljk = __shfl_sync(FULL, l, j);
      w[j] = fmaf(-lb, ljk, w[j]);
      v[j] = fmaf(-ljk, y, v[j]);
    }
    v[k] = y;
    w[k] = lane == k ? dk * r : below ? l : w[k];
    inv = lane == k ? r : inv;
  }
  if (!ok) {  // uniform: every lane saw the same pivots
#pragma unroll
    for (int i = 0; i < NU; ++i) w[i] = v[i] = qnan();
    inv = qnan();
  }
  if (lane < NU) {
#pragma unroll
    for (int k = 0; k < NU; ++k)
      if (k <= lane) Lt[k * LTS + lane] = w[k];
    inv_d[lane] = inv;
  }
  if (lane < NK) {
#pragma unroll
    for (int i = 0; i < NU; ++i) Wk[i * WS + NU + lane] = v[i];
  }
}

// Lane c < NK: column c of [K kff] = -L'^-1 (column c of Y), from a slot the
// factor wrote, to device memory (K row-major nu x nx at K, kff at kff).
__device__ void back_sweep(const float* Wk, const float* Lt, const float* inv_d, float* K,
                           float* kff, int c) {
  float v[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) v[i] = Wk[i * WS + NU + c];
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    v[i] *= inv_d[i];
#pragma unroll
    for (int p = 0; p < i; ++p) v[p] = fmaf(-Lt[p * LTS + i], v[i], v[p]);
  }
  if (c < NX) {
#pragma unroll
    for (int i = 0; i < NU; ++i) K[i * NX + c] = -v[i];
  } else {
#pragma unroll
    for (int i = 0; i < NU; ++i) kff[i] = -v[i];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
riccati_kernel(const float* __restrict__ gA, const float* __restrict__ gB,
               const float* __restrict__ gd, const float* __restrict__ gQxx,
               const float* __restrict__ gQww, const float* __restrict__ gQwx,
               const float* __restrict__ gqx, const float* __restrict__ gqw,
               const float* __restrict__ gE, const float* __restrict__ gP,
               const float* __restrict__ ge, const float* __restrict__ gdx0,
               float* __restrict__ oK, float* __restrict__ okff,
               float* __restrict__ odxs, float* __restrict__ odus, int N, float reg) {
  // the backward sweep's arrays; the rollout's ring of RING knots in their place
  __shared__ __align__(16) float smem[SMEM];
  __shared__ unsigned long long mbar[2 * RING];  // the rollout's slots: full, then empty
  // smem, smem + KNOT: the knot's inputs, the next knot's arriving
  float* const S = smem + 2 * KNOT;           // the value function, both triangles
  float* const s = S + MAT;
  float* const SM = s + V24;                  // S [A B d | s], a pad column
  float* const Sp = SM + NX * SMS;            // sym(Qxx) + H_xx, lower triangle
  float* const sp = Sp + MAT;                 // qx + H_x
  float* const Wb = sp + V24;                 // [Huu | Hux hu] -> Y, two knots' slots
  float* const Ltb = Wb + 2 * NU * WS;        // L by columns, two knots' slots
  float* const invb = Ltb + 2 * NU * LTS;     // 1 / diag L, two knots' slots

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.x;

  // this thread's jobs, fixed over the sweep: an SM tile, an H tile, an
  // entry of S or s
  int si = -1, sj = 0, hi = -1, hj = 0, ui = -1, uj = 0;
  if (tid < SM_TILES) {
    si = 2 * (tid / (SMS / 2));
    sj = 2 * (tid % (SMS / 2));
  }
  if (tid < H_TILES) {
    tri_rc(tid, hi, hj);
    hi *= 2;
    hj *= 2;
  } else if (tid < H_JOBS) {
    hi = 2 * (tid - H_TILES);
    hj = NX + NU;
  }
  if (tid < S_JOBS - NX) {
    tri_rc(tid, ui, uj);
  } else if (tid < S_JOBS) {
    ui = tid - (S_JOBS - NX);
    uj = NX;
  }

  for (int i = tid; i < MAT; i += THREADS) S[i] = 0.0f;
  for (int i = tid; i < NX; i += THREADS) s[i] = 0.0f;
  // warps 2.. copy the inputs, a knot ahead
  const bool vec_in = aligned16(gA, gB, gQxx, gQww, gQwx);
  const int ct = tid - 64, cn = THREADS - 64;
  auto fetch_in = [&](float* dst, int k) {
    const long long kn = b * N + k;
    fetch_knot(dst, gA + kn * MAT, gB + kn * MAT, gQxx + kn * MAT, gQww + kn * MAT,
               gQwx + kn * MAT, gd + kn * NX, gqx + kn * NX, gqw + kn * NU, ct, cn, vec_in);
  };
  if (warp >= 2) fetch_in(smem, N - 1);
#ifdef RICCATI_PHASE_CLOCKS
  long long t_phase = clock64();
#endif

  for (int k = N - 1, it = 0; k >= 0; --k, ++it) {
    const float* cur = smem + (it & 1) * KNOT;
    if (warp >= 2) cp_wait_all();
    __syncthreads();  // this knot's inputs; S and s of the knot after it
    RIC_PHASE(0);
    const float* A = cur;
    const float* Bm = cur + MAT;
    const float* Qxx = cur + 2 * MAT;
    const float* Qww = cur + 3 * MAT;
    const float* Qwx = cur + 4 * MAT;
    const float* d = cur + 5 * MAT;
    const float* qx = d + NX;
    const float* qw = qx + NX;
    float* Wk = Wb + (k & 1) * NU * WS;

    // SM = S [A B d] (+ s on the last column): rows si, si + 1, columns
    // sj, sj + 1 (S symmetric: its column pair is a row pair)
    if (si >= 0) {
      const bool last = sj == NX + NU;
      const float* mc = sj < NX ? A + sj : last ? d : Bm + (sj - NX);
      float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        const float2 sv = *reinterpret_cast<const float2*>(S + r * NX + si);
        const float2 mv = last ? make_float2(mc[r], 0.0f)
                               : *reinterpret_cast<const float2*>(mc + r * NX);
        a00 = fmaf(sv.x, mv.x, a00);
        a01 = fmaf(sv.x, mv.y, a01);
        a10 = fmaf(sv.y, mv.x, a10);
        a11 = fmaf(sv.y, mv.y, a11);
      }
      if (last) {
        a00 += s[si];
        a10 += s[si + 1];
      }
      *reinterpret_cast<float2*>(SM + si * SMS + sj) = make_float2(a00, a01);
      *reinterpret_cast<float2*>(SM + (si + 1) * SMS + sj) = make_float2(a10, a11);
    }
    __syncthreads();
    RIC_PHASE(1);

    // H = [A B]' SM on the lower block triangle and the last column: rows
    // hi, hi + 1 (columns of [A B]), columns hj, hj + 1 of SM
    if (hi >= 0) {
      const float* uc = hi < NX ? A + hi : Bm + (hi - NX);
      float h00 = 0.0f, h01 = 0.0f, h10 = 0.0f, h11 = 0.0f;
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        const float2 u = *reinterpret_cast<const float2*>(uc + r * NX);
        const float2 v = *reinterpret_cast<const float2*>(SM + r * SMS + hj);
        h00 = fmaf(u.x, v.x, h00);
        h01 = fmaf(u.x, v.y, h01);
        h10 = fmaf(u.y, v.x, h10);
        h11 = fmaf(u.y, v.y, h11);
      }
      put_h(hi, hj, h00, Qxx, Qww, Qwx, qx, qw, Sp, sp, Wk);
      put_h(hi + 1, hj, h10, Qxx, Qww, Qwx, qx, qw, Sp, sp, Wk);
      if (hj < NX + NU) {
        put_h(hi + 1, hj + 1, h11, Qxx, Qww, Qwx, qx, qw, Sp, sp, Wk);
        if (hj < hi) put_h(hi, hj + 1, h01, Qxx, Qww, Qwx, qx, qw, Sp, sp, Wk);
      }
    }
    __syncthreads();
    RIC_PHASE(2);

    // one warp factors this knot; another turns the knot after it into
    // gains; the rest copy in the knot before it (over the inputs of the
    // knot after it, read last before the barrier above)
    if (warp == 0) {
      factor(Wk, Ltb + (k & 1) * NU * LTS, invb + (k & 1) * V24, reg, lane);
    } else if (warp == 1) {
      if (k + 1 < N && lane < NK) {
#ifdef RICCATI_PHASE_CLOCKS
        const long long t_bs = clock64();
#endif
        const int q = (k + 1) & 1;
        const long long kn = b * N + k + 1;
        back_sweep(Wb + q * NU * WS, Ltb + q * NU * LTS, invb + q * V24, oK + kn * NU * NX,
                   okff + kn * NU, lane);
#ifdef RICCATI_PHASE_CLOCKS
        if (blockIdx.x == 0 && lane == 0) ric_phase_cycles[7] += clock64() - t_bs;
#endif
      }
    } else if (k > 0) {
      fetch_in(smem + ((it + 1) & 1) * KNOT, k - 1);
    }
    __syncthreads();
    RIC_PHASE(3);

    // S = sym(Qxx) + H_xx - Yx' Yx, s = qx + H_x - Yx' yh
    if (ui >= 0) {
      const float* Y = Wk + NU;
      float g0 = 0.0f, g1 = 0.0f;
#pragma unroll
      for (int p = 0; p < NU; p += 2) {
        g0 = fmaf(Y[p * WS + ui], Y[p * WS + uj], g0);
        g1 = fmaf(Y[(p + 1) * WS + ui], Y[(p + 1) * WS + uj], g1);
      }
      if (uj < NX) {
        const float v = Sp[ui * NX + uj] - (g0 + g1);
        S[ui * NX + uj] = v;
        S[uj * NX + ui] = v;
      } else {
        s[ui] = sp[ui] - (g0 + g1);
      }
    }
#ifdef RICCATI_PHASE_CLOCKS
    __syncthreads();
#endif
    RIC_PHASE(5);
  }

  // the first knot's gains (its slot was written before the last barrier)
  if (warp == 1) {
    if (lane < NK) {
#ifdef RICCATI_PHASE_CLOCKS
      const long long t_bs = clock64();
#endif
      back_sweep(Wb, Ltb, invb, oK + b * N * NU * NX, okff + b * N * NU, lane);
#ifdef RICCATI_PHASE_CLOCKS
      if (blockIdx.x == 0 && lane == 0) ric_phase_cycles[7] += clock64() - t_bs;
#endif
    }
    // the gains went out by ordinary stores (the generic proxy); the
    // rollout's bulk copies read them back through the async proxy
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  if (tid == 0) {
#pragma unroll
    for (int q = 0; q < RING; ++q) {
      mbar_init(&mbar[q], 32 + 1);  // warp 1's lanes' copies, and lane 0's bulk copies
      mbar_init(&mbar[RING + q], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // every knot's gains in device memory; the barriers set
  RIC_PHASE(4);

  // forward rollout: warp 1 copies each knot's rows into a ring slot (the
  // five matrices by the copy engine where they are 16-byte aligned; full
  // once every copy has landed), warp 0 runs the chain and frees the slot
  if (warp == 1) {
    const bool bulk = aligned16(oK, gE, gA, gP, gB);
    for (int k = 0; k < N; ++k) {
      const int q = k % RING;
      if (k >= RING) mbar_wait(&mbar[RING + q], (k / RING - 1) & 1);
      const long long kn = b * N + k;
      float* slot = smem + q * KNOT;
      const float* const mats[5] = {oK + kn * MAT, gE + kn * MAT, gA + kn * MAT, gP + kn * MAT,
                                    gB + kn * MAT};
      if (bulk) {
        if (lane == 0) {
          mbar_expect(&mbar[q], 5 * MAT * sizeof(float));
#pragma unroll
          for (int m = 0; m < 5; ++m)
            bulk_copy(slot + m * MAT, mats[m], MAT * sizeof(float), &mbar[q]);
        }
      } else {
#pragma unroll
        for (int m = 0; m < 5; ++m)
          for (int c = lane; c < MAT; c += 32) cp4(slot + m * MAT + c, mats[m] + c);
        if (lane == 0) mbar_arrive(&mbar[q]);
      }
      const float* const vecs[3] = {okff + kn * NU, ge + kn * NU, gd + kn * NX};
#pragma unroll
      for (int m = 0; m < 3; ++m)
        if (lane < NX) cp4(slot + 5 * MAT + m * NX + lane, vecs[m] + lane);
      mbar_arrive_copies(&mbar[q]);
    }
    cp_wait_all();
    return;
  }
  if (warp != 0) return;
  // lane i owns row i of [K; E; A] and [P; B]
  const int row = min(lane, NX - 1);
  float dx = lane < NX ? gdx0[b * NX + lane] : 0.0f;
  for (int k = 0; k < N; ++k) {
    const int q = k % RING;
    const float* cur = smem + q * KNOT;
    mbar_wait(&mbar[q], (k / RING) & 1);
    const float* Kr = cur + row * NX;
    const float* Er = cur + MAT + row * NX;
    const float* Ar = cur + 2 * MAT + row * NX;
    const float* Pr = cur + 3 * MAT + row * NU;
    const float* Br = cur + 4 * MAT + row * NU;
    const float* kff = cur + 5 * MAT;
    const float* e = kff + NU;
    const float* d = e + NU;
    float rk[2] = {0.0f, 0.0f}, re[2] = {0.0f, 0.0f}, ra[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NX; j += 2) {
      const float2 x = make_float2(__shfl_sync(FULL, dx, j), __shfl_sync(FULL, dx, j + 1));
      const float2 kr = *reinterpret_cast<const float2*>(Kr + j);
      const float2 er = *reinterpret_cast<const float2*>(Er + j);
      const float2 ar = *reinterpret_cast<const float2*>(Ar + j);
      rk[0] = fmaf(kr.x, x.x, rk[0]);
      rk[1] = fmaf(kr.y, x.y, rk[1]);
      re[0] = fmaf(er.x, x.x, re[0]);
      re[1] = fmaf(er.y, x.y, re[1]);
      ra[0] = fmaf(ar.x, x.x, ra[0]);
      ra[1] = fmaf(ar.y, x.y, ra[1]);
    }
    const float w = (rk[0] + rk[1]) + kff[row];
    float rp[2] = {0.0f, 0.0f}, rb[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NU; j += 2) {
      const float2 y = make_float2(__shfl_sync(FULL, w, j), __shfl_sync(FULL, w, j + 1));
      const float2 pr = *reinterpret_cast<const float2*>(Pr + j);
      const float2 br = *reinterpret_cast<const float2*>(Br + j);
      rp[0] = fmaf(pr.x, y.x, rp[0]);
      rp[1] = fmaf(pr.y, y.y, rp[1]);
      rb[0] = fmaf(br.x, y.x, rb[0]);
      rb[1] = fmaf(br.y, y.y, rb[1]);
    }
    if (lane < NX) {
      odxs[(b * (N + 1) + k) * NX + lane] = dx;
      odus[(b * N + k) * NU + lane] = e[row] + (re[0] + re[1]) + (rp[0] + rp[1]);
    }
    dx = (ra[0] + ra[1]) + (rb[0] + rb[1]) + d[row];
    __syncwarp();  // every lane is done with the slot
    if (lane == 0) mbar_arrive(&mbar[RING + q]);
  }
  if (lane < NX) odxs[(b * (N + 1) + N) * NX + lane] = dx;
  RIC_PHASE(6);
}

}  // namespace

extern "C" int hk_riccati_solve(const float* A, const float* B, const float* d,
                                const float* Qxx, const float* Qww, const float* Qwx,
                                const float* qx, const float* qw, const float* E,
                                const float* P, const float* e, const float* dx0, float* K,
                                float* kff, float* dxs, float* dus, int batch, int N,
                                float reg, void* stream) {
  riccati_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, d, Qxx, Qww, Qwx, qx, qw, E, P, e, dx0, K, kff, dxs, dus, N, reg);
  return static_cast<int>(cudaGetLastError());
}

#ifdef RICCATI_PHASE_CLOCKS
// The phase sums since the last call (RIC_PHASES of them), then zeroed.
extern "C" int hk_riccati_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ric_phase_cycles, sizeof(ric_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[RIC_PHASES] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ric_phase_cycles, zero, sizeof(zero)));
}
#endif
