// K3: the whole InferADMM loop in one kernel, one thread-block cluster of
// kC = 16 CTAs per lane.
//
// Replaces the TPU kernel twoace_tpu/ops/pallas/solver_kernel.py::
// fused_infer_admm (body _solve_kernel, with _perturb_ladder, _pm3,
// _presplit3), with a lane axis: lane l uses codebook block a[l / per_group]
// and its U, its own b, prepared state (y0, z0, v0, mu0) and runtime
// ladder.  Each trip (ref: inferLowRankV4_multi.m:281-386):
//   A  rhs = (Y - M/mu) conj(A) + Z - N/mu             own n columns
//   B  X = rhs conj(U); Zin = X + N/mu; panel Gram     own n columns
//   C  AX = X A^T; magnitude prox and M-dual update    own m rows
//   D  A^H Y; Z-prox (zprox_core.cuh) and N-dual       own n columns
//   E  residual tests, mu update, best-so-far          every CTA alike
// with a cluster barrier after A, B, C and D.
//
// What bounds it on the H100: operations.  Per lane and trip the four
// complex products cost 6 r (3 m n + n^2) flops in Karatsuba form (102
// MFLOP at r 20, n 256, m 1024), 3x that as 3xTF32 tensor-core work,
// against ~3.5 MB of compulsory traffic per launch.  Design:
//  - One cluster of kC = 16 CTAs per lane (a non-portable size; the launch
//    raises if the card cannot place one).  CTA c owns the nr-wide slices
//    [c nt / kC, (c + 1) nt / kC) of n (one slice each at 16x16) for
//    phases A, B and D, and the rows [c m / kC, (c + 1) m / kC) of m for
//    phase C.  A CTA that owns nothing contributes zeros.
//  - The four products run 3xTF32 on the tensor cores (tf32x3.cuh, as K4:
//    mma.sync.m16n8k8, the integer split, each k8 step's products summed
//    from zero and flushed into float32, Karatsuba 3M) in the transposed
//    form out^T = B^T X^T: the CTA's columns (or rows) on the MMA's m16
//    side, r on its n8 side (three n8 tiles at r 20).
//  - The constant operands are split once per launch, per group (lanes of
//    a group share A and U), by a first kernel into the workspace: the
//    TF32 halves (big, small) of A's re, im, re + im and re - im planes,
//    and of U's re, im and re - im, the counterpart of JAX's split3
//    pre-split constants.  Each product streams its slab of them and of
//    the state through a three-stage cp.async ring in shared memory, so
//    the copies of stages k + 1 and k + 2 overlap the MMAs of stage k;
//    eight warps split each stage's depth and their partial sums meet in
//    shared memory in warp order.  The ring takes 192 KB; the CTA's
//    constant slab (at m 1024, 384 KB split, 128 KB float32) cannot stay
//    resident beside it.
//  - State that only its owner touches stays in shared memory across
//    trips: Z, the N-dual, A^H Y, X and Zin of the own columns.  What
//    other CTAs read goes through the L2 workspace: Y (phase D), Y - M/mu
//    (phase A: written in phase C for both mu the next trip can have,
//    kept or grown by rho, with the same rounding), the M-dual (C), X (C)
//    and the rhs (B), written with st.global.cg and
//    read with cp.async.cg / ld.global.cg; the cluster barrier
//    (barrier.cluster arrive.release / wait.acquire) orders them.
//  - Reductions across CTAs go through distributed shared memory: each
//    CTA leaves its panel-Gram partial and its scalar partials in its own
//    shared memory, and after the barrier every CTA reads all of them
//    (cluster.map_shared_rank) and sums them in CTA order, with no
//    atomics, so every CTA derives the same converged bit, mu and
//    best-so-far choice; the early exit once a lane converges is uniform
//    across the cluster and ends exactly where JAX's frozen trips begin.
//  - Every CTA runs the small nr x nr Z-prox chain redundantly on the same
//    summed Gram (zprox_core.cuh: its products 3xTF32 on the tensor cores,
//    its ladder on one warp) and keeps the basis V in its own shared
//    memory.
//  - The magnitude prox rounds every product and sum on its own, as K1 and
//    the plain version do; the ladder's padded f = 0 levels are guarded by
//    1/max(f, 1e-30) in zprox_core.cuh; ties take the first index.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream
// with cudaLaunchKernelEx, allocates nothing (the wrapper's workspace
// holds lanes x ws_lane floats of lane state, then the split constants of
// each group), returns -1 if the cluster cannot be placed on the device,
// else cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

#ifdef TWOACE_K3_PHASE_TIMER
// the Z-prox chain's parts (its products, its elementwise steps, its
// ladder), timed by thread 0 of the first CTA
__device__ unsigned long long g_k3_zprox[3];
__device__ __forceinline__ unsigned long long k3_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TWOACE_ZPROX_MARK_START                                      \
  const bool zp_on = blockIdx.x == 0 && threadIdx.x == 0;            \
  unsigned long long zp_acc[3] = {0, 0, 0}, zp_t = k3_now();
#define TWOACE_ZPROX_MARK(part)                                      \
  {                                                                  \
    const unsigned long long zp_n = k3_now();                        \
    zp_acc[part] += zp_n - zp_t;                                     \
    zp_t = zp_n;                                                     \
  }
#define TWOACE_ZPROX_MARK_END                                        \
  if (zp_on)                                                         \
    for (int zp = 0; zp < 3; ++zp) g_k3_zprox[zp] += zp_acc[zp];
#endif

#include "zprox_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 16;                  // CTAs per cluster, one cluster per lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 32;               // r on at most four n8 tiles
constexpr int kMaxOwnCols = 64;         // n columns a CTA owns, at most
constexpr int kRowsGroup = 128;         // phase C's rows a pass (8 m16 tiles)
constexpr int kStages = 3;              // the cp.async ring
static_assert(kStages >= 3, "phase C keeps the old Y in the third stage");
constexpr int kStageFloats = 16384;     // one stage of the ring: 64 KB
constexpr int kSlots = 48;              // scalar partials a CTA (>= S_OBJ + r)
constexpr int kMaxSmem = 232448;        // the H100's 227 KB a block

// scalar partial slots
enum Slot { S_NX, S_NAX, S_NY, S_JM, S_DY, S_NATY, S_DATY, S_NZ, S_DZ, S_JN,
            S_OBJ };

// the split constants of a group: planes of (big, small) TF32 halves
enum APlane { A_RE, A_IM, A_PLUS, A_MINUS, A_PLANES };
enum UPlane { U_RE, U_IM, U_MINUS, U_PLANES };

__host__ __device__ inline long long round4(long long x) {
  return (x + 3) / 4 * 4;
}

// floats of one lane's state: Y, the M-dual and Y - M/mu for both of the
// next trip's mu (r, m); X and the rhs (r, n)
__host__ __device__ inline long long lane_workspace(int r, int m, int n) {
  return round4(8LL * r * m + 4LL * r * n);
}

// floats of one group's split constants
__host__ __device__ inline long long split_workspace(int m, int n) {
  return round4(2LL * A_PLANES * m * n + 2LL * U_PLANES * n * n);
}

__host__ __device__ inline int own_cols_max(int nt, int nr) {
  return (nt + kC - 1) / kC * nr;
}

// the shared-memory layout (offsets in floats)
struct Layout {
  int own, gram, scal, gath, tot, colc, red, zs, total;
};

__host__ __device__ inline Layout layout(int r, int nt, int nr) {
  Layout L;
  L.own = kStages * kStageFloats;              // the ring
  L.gram = L.own + (int)round4(10LL * r * own_cols_max(nt, nr));
  L.scal = L.gram + (int)round4(2 * nr * nr);
  L.gath = L.scal + kSlots;
  L.tot = L.gath + kSlots * kC;
  L.colc = L.tot + kSlots;
  L.red = L.colc + 2 * kRowsGroup;
  L.zs = L.red + 8 * kWarps;
  L.total = L.zs + (int)round4(twoace::zprox_smem_floats(nr, kThreads));
  return L;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ void st(float* p, float v) { __stcg(p, v); }

// dst[i] = the block's sum of v[i], in a fixed order (warp shuffles, then
// the warps in index order); ends with a barrier
template <int NV>
__device__ __forceinline__ void block_sums(float (&v)[NV], float* red,
                                           float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red[warp * NV + i] = v[i];
  __syncthreads();
  if ((int)threadIdx.x < NV) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * NV + threadIdx.x];
    dst[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---- phase timer (built only with -DTWOACE_K3_PHASE_TIMER, by
// scripts/torch_k3_phases.py): thread 0 of lane 0's CTA 0 stamps
// %globaltimer at each phase's end and sums the nanoseconds per slot; the
// time it spends in cluster barriers goes to its own slot.
enum PhaseSlot { T_SETUP, T_A, T_B, T_B_GRAM, T_C, T_C_PROX, T_D_GEMM,
                 T_D_GRAM, T_D_ZPROX, T_D_APPLY, T_E, T_BARRIER, T_WAIT,
                 T_ISSUE, T_MMA, T_Z_PROD, T_Z_ELEM, T_Z_LADDER, T_TRIPS,
                 T_SLOTS };
#ifdef TWOACE_K3_PHASE_TIMER
__device__ unsigned long long g_k3_phase[T_SLOTS];
// the products' waits for a stage, issue of its copies, and its MMAs
__device__ unsigned long long g_k3_wait, g_k3_issue, g_k3_mma;
struct PhaseTimer {
  unsigned long long acc[T_SLOTS], last;
  bool on;
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void start() {
    on = blockIdx.x == 0 && threadIdx.x == 0;
    for (int s = 0; s < T_SLOTS; ++s) acc[s] = 0;
    if (on) {
      g_k3_wait = g_k3_issue = g_k3_mma = 0;
      g_k3_zprox[0] = g_k3_zprox[1] = g_k3_zprox[2] = 0;
    }
    last = now();
  }
  __device__ void stamp(int slot) {
    if (!on) return;
    const unsigned long long t = now();
    acc[slot] += t - last;
    last = t;
  }
  __device__ void finish(int trips) {
    if (!on) return;
    acc[T_TRIPS] = (unsigned long long)trips;
    acc[T_WAIT] = g_k3_wait;
    acc[T_ISSUE] = g_k3_issue;
    acc[T_MMA] = g_k3_mma;
    for (int z = 0; z < 3; ++z) acc[T_Z_PROD + z] = g_k3_zprox[z];
    for (int s = 0; s < T_SLOTS; ++s) g_k3_phase[s] = acc[s];
  }
};
#define PT_START() PhaseTimer pt; pt.start()
#define PT_STAMP(slot) pt.stamp(slot)
#define PT_FINISH(trips) pt.finish(trips)
#else
#define PT_START()
#define PT_STAMP(slot)
#define PT_FINISH(trips)
#endif

// ---------------------------------------------------------------- products

// out^T = B^T X^T for the output columns [j0, j0 + nj) of C = X B, X the
// dynamic (r, K) operand (planes dr = Xr, di = Xi, rows K apart), B
// the constant (K, *) one given by its split planes: c_sum =
// split(Br + Bi), c_i = split(Bi) up to its sign (conj: Bi = -c_i), c_r =
// split(Br).  KMAJ: B^T(j, k) at k * ld + j (the plane is B's own
// layout), else at j * ld + k.  Karatsuba 3M:
//   k1 = Xr (Br + Bi), k2 = (Xr + Xi) Bi, k3 = (Xi - Xr) Br,
//   re = k1 - k2, im = k1 + k3.
// Leaves out[jl * rp + k] = C(k, j0 + jl) as (re, im) in the ring's
// second stage, followed by a barrier.
struct Prod {
  const uint2 *c_sum, *c_i, *c_r;
  long long ld;
  int j0, nj, K;
  const float *dr, *di;
  bool conj;
  bool vec;     // K % 4 == 0: 16-byte copies of the state's rows
  bool cvec;    // the constants' pairs are 16-byte aligned
};

template <int TP, bool KMAJ>
__device__ __noinline__ void product(const Prod pr, int r, int rp,
                                     float* ring) {
  constexpr int SK = 64 / TP;           // depth of a stage: 8 warps x k8 / TP
  constexpr int NCOL = TP * 16;
  constexpr int PJ = NCOL + 4, PK = SK + 4, PD = SK + 4;
  constexpr int CP = KMAJ ? SK * PJ : NCOL * PK;       // uint2 a plane
  constexpr int CSL = SK * NCOL / 2 / kThreads;        // constant pairs a thread
  constexpr int DSL = 2;                               // state chunks a thread
  static_assert(SK * NCOL == 1024, "a stage holds 1024 constants a plane");
  static_assert(6 * CP + 2 * kMaxR * PD <= kStageFloats, "stage size");
  static_assert(kMaxR * (SK / 4) <= DSL * kThreads, "state chunks");
  // the operands, in registers (the copies' memory clobbers would reload
  // them from local memory)
  const uint2* const planes[3] = {pr.c_sum, pr.c_i, pr.c_r};
  const long long ldc = pr.ld;
  const int j0 = pr.j0, nj = pr.nj, K = pr.K;
  const float* const dsrc[2] = {pr.dr, pr.di};
  const bool conj = pr.conj, vec = pr.vec, cvec = pr.cvec;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int tile = warp % TP, kslot = warp / TP;
  const int nt8 = rp >> 3;
  const int nst = (K + SK - 1) / SK;
#ifdef TWOACE_K3_PHASE_TIMER
  const bool timed = blockIdx.x == 0 && tid == 0;
  unsigned long long waited = 0, issued = 0, computed = 0, tk = 0;
#endif

  // each thread's copies, the same in every stage but for k0: pairs of
  // constants along the contiguous axis, 16-byte chunks of the state
  int c_dst[CSL], c_kl[CSL], c_lim[CSL];
  long long c_src[CSL];
#pragma unroll
  for (int i = 0; i < CSL; ++i) {
    const int e = tid + i * kThreads;
    const int kl = KMAJ ? e / (NCOL / 2) : (e % (SK / 2)) * 2;
    const int jl = KMAJ ? (e % (NCOL / 2)) * 2 : e / (SK / 2);
    c_kl[i] = kl;
    c_dst[i] = KMAJ ? kl * PJ + jl : jl * PK + kl;
    c_src[i] = KMAJ ? (long long)kl * ldc + j0 + jl
                    : (long long)(j0 + jl) * ldc + kl;
    // KMAJ: the pair's columns inside [0, nj); else whether its row is
    c_lim[i] = KMAJ ? max(0, min(2, nj - jl)) : (jl < nj ? 2 : 0);
  }
  int d_dst[DSL], d_c4[DSL];
  long long d_src[DSL];
  bool d_ok[DSL];
#pragma unroll
  for (int i = 0; i < DSL; ++i) {
    const int e = tid + i * kThreads;
    const int rr = e / (SK / 4), c4 = (e % (SK / 4)) * 4;
    d_ok[i] = rr < r;
    d_c4[i] = c4;
    d_dst[i] = rr * PD + c4;
    d_src[i] = (long long)rr * K + c4;
  }

  auto load = [&](int s, int kt) {
    float* stg = ring + s * kStageFloats;
    uint2* cs = reinterpret_cast<uint2*>(stg);
    float* ds = stg + 6 * CP;
    const int k0 = kt * SK;
    if (cvec) {
#pragma unroll
      for (int i = 0; i < CSL; ++i) {
        const int k = k0 + c_kl[i];
        const int n2 = KMAJ ? (k < K ? c_lim[i] : 0)
                            : min(c_lim[i], max(0, K - k));
        const long long o = c_src[i] + (KMAJ ? (long long)k0 * ldc : k0);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          twoace::cp16n(cs + p * CP + c_dst[i],
                        n2 > 0 ? planes[p] + o : planes[p], 8 * n2);
      }
    } else {                           // odd n or nr: one constant a copy
#pragma unroll 1
      for (int p = 0; p < 3; ++p) {
#pragma unroll 1
        for (int e = tid; e < SK * NCOL; e += kThreads) {
          const int kl = KMAJ ? e / NCOL : e % SK;
          const int jl = KMAJ ? e % NCOL : e / SK;
          const int k = k0 + kl;
          const bool ok = k < K && jl < nj;
          const long long o = KMAJ ? (long long)k * ldc + j0 + jl
                                   : (long long)(j0 + jl) * ldc + k;
          twoace::cp8(cs + p * CP + (KMAJ ? kl * PJ + jl : jl * PK + kl),
                      ok ? planes[p] + o : planes[p], ok);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      float* dp = ds + d * rp * PD;
      const float* src = dsrc[d];
      if (vec) {                       // K % 4 == 0: whole 16-byte chunks
#pragma unroll
        for (int i = 0; i < DSL; ++i) {
          if (tid + i * kThreads >= rp * (SK / 4)) break;
          const bool ok = d_ok[i] && k0 + d_c4[i] < K;
          twoace::cp16(dp + d_dst[i], ok ? src + d_src[i] + k0 : src, ok);
        }
      } else {
#pragma unroll 1
        for (int e = tid; e < rp * SK; e += kThreads) {
          const int rr = e / SK, kl = e % SK;
          const bool ok = rr < r && k0 + kl < K;
          dp[rr * PD + kl] = ok ? ld(src + (long long)rr * K + k0 + kl)
                                : 0.0f;
        }
      }
    }
  };

  float acc[4][3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][p][q] = 0.0f;

  __syncthreads();                     // the ring is free
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load(s, s);
    twoace::cp_commit();
  }
  for (int kt = 0; kt < nst; ++kt) {
#ifdef TWOACE_K3_PHASE_TIMER
    unsigned long long t0 = 0;
    if (timed) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
#endif
    twoace::cp_wait<kStages - 2>();    // stage kt has landed (this thread's)
    __syncthreads();                   // ... everyone's; kt - 1 is consumed
#ifdef TWOACE_K3_PHASE_TIMER
    if (timed) {
      unsigned long long t1;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
      waited += t1 - t0;
      if (kt > 0) computed += t0 - tk;
      tk = t1;
    }
#endif
    if (kt + kStages - 1 < nst)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    twoace::cp_commit();
#ifdef TWOACE_K3_PHASE_TIMER
    if (timed) {
      unsigned long long t2;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t2));
      issued += t2 - tk;
      tk = t2;
    }
#endif

    const float* stg = ring + (kt % kStages) * kStageFloats;
    const uint2* cs = reinterpret_cast<const uint2*>(stg);
    const float* ds = stg + 6 * CP;
    const int kk = kslot * 8;
    // A fragments (the constant): a0 (row grp, k tig), a1 (grp + 8, tig),
    // a2 (grp, tig + 4), a3 (grp + 8, tig + 4); big and small halves
    uint32_t ab[3][4], as[3][4];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tile * 16 + grp + (q & 1) * 8;
        const int k = kk + tig + (q >> 1) * 4;
        const uint2 v = cs[p * CP + (KMAJ ? k * PJ + j : j * PK + k)];
        ab[p][q] = v.x;
        as[p][q] = v.y;
      }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      if (ni >= nt8) break;
      // B fragments (the state): b0 (k tig, r grp), b1 (k tig + 4, r grp)
      uint32_t bb[3][2], bs[3][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int o = (ni * 8 + grp) * PD + kk + tig + q * 4;
        const float xr = ds[o], xi = ds[rp * PD + o];
        twoace::split(xr, bb[0][q], bs[0][q]);        // k1 against c_sum
        twoace::split(xr + xi, bb[1][q], bs[1][q]);   // k2 against c_i
        twoace::split(xi - xr, bb[2][q], bs[2][q]);   // k3 against c_r
      }
      // mma3 for the three products, issued step by step across them
      // (small*big, big*small, big*big, each summed from zero) so their
      // dependent MMAs overlap; each sum then joins its accumulator in
      // float32
      float d[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[p][q] = 0.0f;
#pragma unroll
      for (int step = 0; step < 3; ++step)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          twoace::mma_tf32(d[p], step == 0 ? as[p] : ab[p],
                                   step == 1 ? bs[p] : bb[p]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[ni][p][q] += d[p][q];
    }
  }
#ifdef TWOACE_K3_PHASE_TIMER
  if (timed) {
    unsigned long long t3;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t3));
    computed += t3 - tk;
  }
#endif
  twoace::cp_wait<0>();
  __syncthreads();
#ifdef TWOACE_K3_PHASE_TIMER
  if (timed) {
    g_k3_wait += waited;
    g_k3_issue += issued;
    g_k3_mma += computed;
  }
#endif

  // each warp's partial (re, im), then the warps of a tile in order
  float2* red = reinterpret_cast<float2*>(ring);       // [warp][16][rp]
  float2* out = reinterpret_cast<float2*>(ring + kStageFloats);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    if (ni >= nt8) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float k1 = acc[ni][0][h * 2 + e], k2 = acc[ni][1][h * 2 + e];
        const float k3 = acc[ni][2][h * 2 + e];
        red[(warp * 16 + grp + h * 8) * rp + ni * 8 + tig * 2 + e] =
            make_float2(conj ? k1 + k2 : k1 - k2, k1 + k3);
      }
  }
  __syncthreads();
  for (int e = tid; e < NCOL * rp; e += kThreads) {
    const int jl = e / rp, c = e - jl * rp;
    const int t = jl >> 4, row = jl & 15;
    float2 s = red[(t * 16 + row) * rp + c];
    for (int ks = 1; ks < kWarps / TP; ++ks) {
      const float2 v = red[((ks * TP + t) * 16 + row) * rp + c];
      s.x += v.x;
      s.y += v.y;
    }
    out[jl * rp + c] = s;
  }
  __syncthreads();
}

// a product over nj <= kMaxOwnCols own columns (KMAJ) or nj <= kRowsGroup
// own rows, on the fewest m16 tiles that hold them
template <bool KMAJ>
__device__ __forceinline__ void product_any(const Prod& pr, int r, int rp,
                                            float* ring) {
  const int tiles = (pr.nj + 15) / 16;
  if (tiles <= 1) product<1, KMAJ>(pr, r, rp, ring);
  else if (tiles <= 2) product<2, KMAJ>(pr, r, rp, ring);
  else if (tiles <= 4) product<4, KMAJ>(pr, r, rp, ring);
  else if constexpr (!KMAJ) product<8, KMAJ>(pr, r, rp, ring);
}

// ------------------------------------------------------ the split constants

// out: the split constants of every group, split_floats floats apart:
// A's (re, im, re + im, re - im) planes, then U's (re, im, re - im)
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
             const float* __restrict__ u_re, const float* __restrict__ u_im,
             uint2* __restrict__ out, int groups, int m, int n,
             long long split_floats) {
  const long long mn = (long long)m * n, nn = (long long)n * n;
  const long long total = groups * (mn + nn);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long g = e / (mn + nn), o = e - g * (mn + nn);
    uint2* base = out + g * (split_floats / 2);
    float x[A_PLANES];
    long long at, stride;
    int planes;
    if (o < mn) {
      const float ar = a_re[g * mn + o], ai = a_im[g * mn + o];
      x[A_RE] = ar;
      x[A_IM] = ai;
      x[A_PLUS] = ar + ai;
      x[A_MINUS] = ar - ai;
      at = o;
      stride = mn;
      planes = A_PLANES;
    } else {
      const long long q = o - mn;
      const float ur = u_re[g * nn + q], ui = u_im[g * nn + q];
      x[U_RE] = ur;
      x[U_IM] = ui;
      x[U_MINUS] = ur - ui;
      at = A_PLANES * mn + q;
      stride = nn;
      planes = U_PLANES;
    }
    for (int p = 0; p < planes; ++p) {
      uint2 v;
      twoace::split(x[p], v.x, v.y);
      base[at + p * stride] = v;
    }
  }
}


// ------------------------------------------------------------- the loop

struct Params {
  const float *b, *y0_re, *y0_im, *z0_re, *z0_im, *v0_re, *v0_im, *mu0,
      *ranks, *fracs;
  float* ws;
  const uint2* split;
  float *ox_re, *ox_im, *oy_re, *oy_im;
  int *it_out, *conv_out;
  int per_group, r, m, n, nt, nr, levels, scale_by_row, maxiter;
  long long ws_lane, ws_split;
  float rho, tol_rel, tol_abs;
};

__global__ void __launch_bounds__(kThreads, 1)
infer_admm_kernel(const Params P) {
  PT_START();
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int lane = blockIdx.x / kC;
  const int tid = threadIdx.x;
  const int r = P.r, m = P.m, n = P.n, nr = P.nr, nt = P.nt;
  const int nn = nr * nr;
  const int rp = (r + 7) / 8 * 8;
  const bool sbr = P.scale_by_row != 0;
  const bool vec = m % 4 == 0 && n % 4 == 0;

  // this lane's split constants (its group's)
  const long long grp = lane / P.per_group;
  const uint2* sa = P.split + grp * (P.ws_split / 2);
  const long long mn = (long long)m * n;
  const uint2* su = sa + A_PLANES * mn;
  const float* bl = P.b + (long long)lane * m;

  // this lane's workspace (planar re / im)
  float* w = P.ws + lane * P.ws_lane;
  const long long rm = (long long)r * m, rn = (long long)r * n;
  float *Yr = w, *Yi = Yr + rm, *Mr = Yi + rm, *Mi = Mr + rm;
  // Y - M/mu for the next trip's mu: kept (K) or grown by rho (G)
  float *Kr = Mi + rm, *Ki = Kr + rm, *Gr = Ki + rm, *Gi = Gr + rm;
  float *Xr = Gi + rm, *Xi = Xr + rn, *Rr = Xi + rn, *Ri = Rr + rn;

  // ownership: n in whole nr-wide slices, m in even chunks
  const int t0 = (c * nt) / kC, t1 = ((c + 1) * nt) / kC;
  const int n0 = t0 * nr, ncol = (t1 - t0) * nr;
  const int m0 = (int)(((long long)c * m) / kC);
  const int m1 = (int)(((long long)(c + 1) * m) / kC);
  const int own = r * ncol;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(r, nt, nr);
  float* ring = smem;
  float2* Zs = reinterpret_cast<float2*>(smem + L.own);  // [k * ncol + jl]
  float2* Ns = Zs + own;
  float2* Ts = Ns + own;                                 // A^H Y
  float2* Xs = Ts + own;
  float2* Ws = Xs + own;                                 // Zin = X + N/mu
  float* gram = smem + L.gram;                           // 2 nr^2 partial
  float* scal = smem + L.scal;                           // scalar partials
  float* gath = smem + L.gath;
  float* tot = smem + L.tot;
  float* colc = smem + L.colc;
  float* red = smem + L.red;
  const twoace::ZproxSmem zs = twoace::zprox_smem(smem + L.zs, nr);
  const float2* out = reinterpret_cast<const float2*>(ring + kStageFloats);

  // ---- prepared state: own rows of Y, zero M-dual; own columns of Z,
  // zero N-dual; basis V0 in the W-convention (conj of the E-convention)
  for (long long e = tid; e < (long long)r * (m1 - m0); e += kThreads) {
    const int k = (int)(e / (m1 - m0)), j = m0 + (int)(e % (m1 - m0));
    const long long o = (long long)k * m + j;
    const float y0r = __ldg(P.y0_re + lane * rm + o);
    const float y0i = __ldg(P.y0_im + lane * rm + o);
    st(Yr + o, y0r);
    st(Yi + o, y0i);
    st(Kr + o, y0r);                   // Y - 0/mu for the first trip
    st(Ki + o, y0i);
    st(Mr + o, 0.0f);
    st(Mi + o, 0.0f);
  }
  for (int e = tid; e < own; e += kThreads) {
    const int k = e / ncol, j = n0 + e % ncol;
    const long long o = (long long)k * n + j;
    Zs[e] = make_float2(__ldg(P.z0_re + lane * rn + o),
                        __ldg(P.z0_im + lane * rn + o));
    Ns[e] = make_float2(0.0f, 0.0f);
  }
  for (int e = tid; e < nn; e += kThreads) {
    zs.Vr[e] = __ldg(P.v0_re + (long long)lane * nn + e);
    zs.Vi[e] = -__ldg(P.v0_im + (long long)lane * nn + e);
  }
  float mu = __ldg(P.mu0 + lane);
  float last_res = INFINITY, opt_obj = INFINITY;
  int it = 0;
  bool conv = false, grew = false;
  const float* ranks = P.ranks + (long long)lane * P.levels;
  const float* fracs = P.fracs + (long long)lane * P.levels;
  const float t_prim0 = (float)(P.tol_abs * sqrt((double)(m + n) * r));
  const float t_dual0 = (float)(P.tol_abs * sqrt((double)n * r * 2));
  const float t_comb0 = (float)(P.tol_abs * sqrt((double)(m + n) * r * 2));
  const float inv_sqrt_r = (float)(1.0 / sqrt((double)r));
  PT_STAMP(T_SETUP);
  cluster.sync();
  PT_STAMP(T_BARRIER);

  // products over the own columns against conj(A) (A^H Y, phases A, D)
  // and conj(U) (phase B), and over own rows against A^T (phase C)
  const bool cvec = n % 2 == 0 && nr % 2 == 0;
  const Prod ah{sa + A_MINUS * mn, sa + A_IM * mn, sa + A_RE * mn, n, n0,
                ncol, m, Yr, Yi, true, vec, cvec};
  const Prod uh{su + U_MINUS * (long long)n * n, su + U_IM * (long long)n * n,
                su + U_RE * (long long)n * n, n, n0, ncol, n, Rr, Ri, true,
                vec, cvec};

  // A^H Y of the initial Y, own n columns
  if (ncol > 0) {
    product_any<true>(ah, r, rp, ring);
    for (int e = tid; e < own; e += kThreads)
      Ts[e] = out[(e % ncol) * rp + e / ncol];
  }
  PT_STAMP(T_SETUP);

  while (it < P.maxiter && !conv) {
    const float inv_mu = 1.0f / mu;

    // ---- A: rhs = (Y - M/mu) conj(A) + Z - N/mu
    if (ncol > 0) {
      Prod pa = ah;
      pa.dr = grew ? Gr : Kr;
      pa.di = grew ? Gi : Ki;
      product_any<true>(pa, r, rp, ring);
      for (int e = tid; e < own; e += kThreads) {
        const int k = e / ncol, jl = e - k * ncol;
        const float2 v = out[jl * rp + k], z = Zs[e], nd = Ns[e];
        const long long o = (long long)k * n + n0 + jl;
        st(Rr + o, add(v.x, sub(z.x, mul(nd.x, inv_mu))));
        st(Ri + o, add(v.y, sub(z.y, mul(nd.y, inv_mu))));
      }
    }
    PT_STAMP(T_A);
    cluster.sync();
    PT_STAMP(T_BARRIER);

    // ---- B: X = rhs conj(U); Zin = X + N/mu; Gram partial of own slices
    {
      float v1[1] = {0.0f};
      if (ncol > 0) {
        product_any<true>(uh, r, rp, ring);
        for (int e = tid; e < own; e += kThreads) {
          const int k = e / ncol, jl = e - k * ncol;
          const float2 v = out[jl * rp + k], nd = Ns[e];
          const long long o = (long long)k * n + n0 + jl;
          st(Xr + o, v.x);
          st(Xi + o, v.y);
          Xs[e] = v;
          Ws[e] = make_float2(add(v.x, mul(nd.x, inv_mu)),
                              add(v.y, mul(nd.y, inv_mu)));
          v1[0] += v.x * v.x + v.y * v.y;
        }
      }
      PT_STAMP(T_B);
      block_sums(v1, red, scal + S_NX);                // Ws complete too
      for (int e = tid; e < nn; e += kThreads) {
        const int p = e / nr, q = e - p * nr;
        float sr = 0.0f, si = 0.0f;
        for (int t = 0; t < t1 - t0; ++t)
          for (int k = 0; k < r; ++k) {
            const float2 a = Ws[k * ncol + t * nr + p];
            const float2 b = Ws[k * ncol + t * nr + q];
            sr += a.x * b.x + a.y * b.y;
            si += a.x * b.y - a.y * b.x;
          }
        gram[e] = sr;
        gram[nn + e] = si;
      }
    }
    PT_STAMP(T_B_GRAM);
    cluster.sync();
    PT_STAMP(T_BARRIER);

    // ---- C: AX = X A^T on own m rows, then the prox entry by entry
    {
      float v5[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // nax ny jm dy obj
      if (!sbr)
        for (int k = tid; k < r; k += kThreads) scal[S_OBJ + k] = 0.0f;
      const float one_mu = 1.0f + mu;
      const float inv_grown = 1.0f / (mu * P.rho);
      for (int g0 = m0; g0 < m1; g0 += kRowsGroup) {
        const int nj = min(kRowsGroup, m1 - g0);
        const Prod pc{sa + A_PLUS * mn, sa + A_IM * mn, sa + A_RE * mn, n,
                      g0, nj, n, Xr, Xi, false, vec, cvec};
        product_any<false>(pc, r, rp, ring);
        PT_STAMP(T_C);
        // the ring's first stage: y before the prox, then the old M-dual;
        // its third: the old Y (the second holds AX)
        float2* yt = reinterpret_cast<float2*>(ring);
        float2* mo = yt + r * nj;
        float2* yo = reinterpret_cast<float2*>(ring + 2 * kStageFloats);
        for (int e = tid; e < r * nj; e += kThreads) {
          const int k = e / nj, jl = e - k * nj;
          const float2 ax = out[jl * rp + k];
          const long long o = (long long)k * m + g0 + jl;
          const float mdr = ld(Mr + o), mdi = ld(Mi + o);
          yo[e] = make_float2(ld(Yr + o), ld(Yi + o));
          yt[e] = make_float2(add(ax.x, mul(mdr, inv_mu)),
                              add(ax.y, mul(mdi, inv_mu)));
          mo[e] = make_float2(mdr, mdi);
        }
        __syncthreads();
        if (sbr) {
          // one thread a column: |y|^2 over r in order, and the column's
          // objective term
          for (int jl = tid; jl < nj; jl += kThreads) {
            float d2 = 0.0f, amp2 = 0.0f;
            for (int k = 0; k < r; ++k) {
              const float2 y = yt[k * nj + jl], ax = out[jl * rp + k];
              d2 = add(d2, add(mul(y.x, y.x), mul(y.y, y.y)));
              amp2 += ax.x * ax.x + ax.y * ax.y;
            }
            const float bj = __ldg(bl + g0 + jl);
            const float act = bj > 0.0f ? 1.0f : 0.0f;
            const bool zero = d2 <= 0.0f;
            colc[jl] = mul(add(bj / sqrtf(zero ? 1.0f : d2), mu) / one_mu,
                           act);
            colc[kRowsGroup + jl] = zero ? 1.0f : 0.0f;
            const float dev = sqrtf(fmaxf(amp2, 0.0f)) - bj;
            v5[4] += dev * dev;
          }
          __syncthreads();
        }
        for (int e = tid; e < r * nj; e += kThreads) {
          const int k = e / nj, jl = e - k * nj;
          const int j = g0 + jl;
          const float2 ax = out[jl * rp + k], md = mo[e];
          float yr = yt[e].x, yi = yt[e].y, coeff;
          const float bj = __ldg(bl + j);
          const float act = bj > 0.0f ? 1.0f : 0.0f;
          if (sbr) {
            coeff = colc[jl];
            if (colc[kRowsGroup + jl] != 0.0f) { yr = inv_sqrt_r; yi = 0.0f; }
          } else {
            const float e2 = add(mul(yr, yr), mul(yi, yi));
            const bool zero = e2 <= 0.0f;
            if (zero) yr = 1.0f;
            coeff = mul(add(bj / sqrtf(zero ? 1.0f : e2), mu) / one_mu, act);
            const float dev = sqrtf(fmaxf(ax.x * ax.x + ax.y * ax.y, 0.0f))
                              - bj;
            yt[e].x = dev * dev;        // this row's objective term
          }
          const long long o = (long long)k * m + j;
          const float outr = mul(yr, coeff), outi = mul(yi, coeff);
          const float dyr = outr - yo[e].x, dyi = outi - yo[e].y;
          const float jr = ax.x - outr, ji = ax.y - outi;
          v5[0] += ax.x * ax.x + ax.y * ax.y;
          v5[1] += outr * outr + outi * outi;
          v5[2] += jr * jr + ji * ji;
          v5[3] += dyr * dyr + dyi * dyi;
          const float mnr = add(md.x, mul(mu, sub(ax.x, outr)));
          const float mni = add(md.y, mul(mu, sub(ax.y, outi)));
          st(Yr + o, outr);
          st(Yi + o, outi);
          st(Mr + o, mnr);
          st(Mi + o, mni);
          st(Kr + o, sub(outr, mul(mnr, inv_mu)));
          st(Ki + o, sub(outi, mul(mni, inv_mu)));
          st(Gr + o, sub(outr, mul(mnr, inv_grown)));
          st(Gi + o, sub(outi, mul(mni, inv_grown)));
        }
        if (!sbr) {
          __syncthreads();
          for (int k = tid; k < r; k += kThreads) {
            float s = 0.0f;
            for (int jl = 0; jl < nj; ++jl) s += yt[k * nj + jl].x;
            scal[S_OBJ + k] += s;
          }
        }
      }
      block_sums(v5, red, gath);
      if (tid == 0) {
        scal[S_NAX] = gath[0];
        scal[S_NY] = gath[1];
        scal[S_JM] = gath[2];
        scal[S_DY] = gath[3];
        if (sbr) scal[S_OBJ] = gath[4];
      }
    }
    PT_STAMP(T_C_PROX);
    cluster.sync();
    PT_STAMP(T_BARRIER);

    // ---- D: A^H Y_new (own n columns), Z-prox, N-dual
    {
      float v2[2] = {0.0f, 0.0f};                      // naty daty
      if (ncol > 0) {
        product_any<true>(ah, r, rp, ring);
        for (int e = tid; e < own; e += kThreads) {
          const float2 v = out[(e % ncol) * rp + e / ncol], t = Ts[e];
          const float dr = v.x - t.x, di = v.y - t.y;
          v2[0] += v.x * v.x + v.y * v.y;
          v2[1] += dr * dr + di * di;
          Ts[e] = v;
        }
      }
      PT_STAMP(T_D_GEMM);
      // the panel Gram, summed over the cluster in CTA order
      for (int e = tid; e < 2 * nn; e += kThreads) {
        float s = 0.0f;
        for (int cc = 0; cc < kC; ++cc) s += cluster.map_shared_rank(gram, cc)[e];
        if (e < nn) zs.Gr[e] = s; else zs.Gi[e - nn] = s;
      }
      PT_STAMP(T_D_GRAM);
      twoace::zprox_basis_delta(zs, nr, ranks, fracs, P.levels);
      PT_STAMP(T_D_ZPROX);
      float v3[3] = {0.0f, 0.0f, 0.0f};                // nz dz jn
      for (int e = tid; e < own; e += kThreads) {
        const int k = e / ncol, jl = e - k * ncol;
        const int t = jl / nr, q = jl - t * nr;
        const float2* row = Ws + k * ncol + t * nr;
        float sr = 0.0f, si = 0.0f;
        for (int p = 0; p < nr; ++p) {
          const float2 a = row[p];
          const float br = zs.Pr[p * nr + q], bi = zs.Pi[p * nr + q];
          sr += a.x * br - a.y * bi;
          si += a.x * bi + a.y * br;
        }
        const float2 wv = Ws[e], z = Zs[e], x = Xs[e], nd = Ns[e];
        const float znr = wv.x + sr, zni = wv.y + si;
        const float dzr = znr - z.x, dzi = zni - z.y;
        const float jr = x.x - znr, ji = x.y - zni;
        v3[0] += znr * znr + zni * zni;
        v3[1] += dzr * dzr + dzi * dzi;
        v3[2] += jr * jr + ji * ji;
        Zs[e] = make_float2(znr, zni);
        Ns[e] = make_float2(nd.x + mu * jr, nd.y + mu * ji);
      }
      block_sums(v2, red, scal + S_NATY);
      block_sums(v3, red, scal + S_NZ);
    }
    PT_STAMP(T_D_APPLY);
    cluster.sync();
    PT_STAMP(T_BARRIER);

    // ---- E: every CTA sums the cluster's partials in CTA order
    const int nslot = S_OBJ + (sbr ? 1 : r);
    for (int e = tid; e < nslot * kC; e += kThreads) {
      const int q = e / kC, cc = e - q * kC;
      gath[e] = cluster.map_shared_rank(scal, cc)[q];
    }
    __syncthreads();
    if (tid < nslot) {
      float s = 0.0f;
      for (int cc = 0; cc < kC; ++cc) s += gath[tid * kC + cc];
      tot[tid] = s;
    }
    __syncthreads();
    float obj;
    int jj = 0;
    if (sbr) {
      obj = sqrtf(tot[S_OBJ]);
    } else {
      obj = INFINITY;
      for (int k = 0; k < r; ++k) {
        const float ok = sqrtf(tot[S_OBJ + k]);
        if (k == 0 || ok < obj) { obj = ok; jj = k; }      // first on ties
      }
    }
    if (obj < opt_obj) {                                   // best so far
      if (sbr) {
        for (int e = tid; e < own; e += kThreads) {
          const int k = e / ncol, j = n0 + e % ncol;
          P.ox_re[lane * rn + (long long)k * n + j] = Xs[e].x;
          P.ox_im[lane * rn + (long long)k * n + j] = Xs[e].y;
        }
        for (long long e = tid; e < (long long)r * (m1 - m0); e += kThreads) {
          const int k = (int)(e / (m1 - m0)), j = m0 + (int)(e % (m1 - m0));
          const long long o = (long long)k * m + j;
          P.oy_re[lane * rm + o] = ld(Yr + o);
          P.oy_im[lane * rm + o] = ld(Yi + o);
        }
      } else {
        for (int jl = tid; jl < ncol; jl += kThreads) {
          P.ox_re[(long long)lane * n + n0 + jl] = Xs[jj * ncol + jl].x;
          P.ox_im[(long long)lane * n + n0 + jl] = Xs[jj * ncol + jl].y;
        }
        for (int j = m0 + tid; j < m1; j += kThreads) {
          P.oy_re[(long long)lane * m + j] = ld(Yr + (long long)jj * m + j);
          P.oy_im[(long long)lane * m + j] = ld(Yi + (long long)jj * m + j);
        }
      }
    }
    opt_obj = (isnan(obj) || isnan(opt_obj)) ? NAN : fminf(obj, opt_obj);
    const float nax = sqrtf(tot[S_NAX]), ny = sqrtf(tot[S_NY]);
    const float naty = sqrtf(tot[S_NATY]), nx = sqrtf(tot[S_NX]);
    const float nz = sqrtf(tot[S_NZ]);
    const float res_prim = sqrtf(tot[S_JM] + tot[S_JN]);
    const float res_dual = mu * sqrtf(tot[S_DATY] + tot[S_DZ]);
    const float res_comb = sqrtf(res_prim * res_prim + tot[S_DY] + tot[S_DZ]);
    const float mx1 = fmaxf(nax, ny), mx2 = fmaxf(nx, nz);
    const float big = mx1 * mx1 + mx2 * mx2;
    const float t_prim = t_prim0 + P.tol_rel * sqrtf(big);
    const float t_dual = t_dual0 + P.tol_rel * sqrtf(naty * naty + nz * nz);
    const float t_comb = t_comb0 + P.tol_rel * sqrtf(big + ny * ny + nz * nz);
    conv = ((res_prim < t_prim) && (res_dual < t_dual)) || (res_comb < t_comb);
    grew = res_comb > last_res * 0.9f;
    if (grew) mu = mu * P.rho;
    last_res = res_comb;
    ++it;
    PT_STAMP(T_E);
  }
  PT_FINISH(it);
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
  if (c == 0 && tid == 0) {
    P.it_out[lane] = it;
    P.conv_out[lane] = conv ? 1 : 0;
  }
}

}  // namespace

extern "C" int twoace_infer_admm(
    const float* a_re, const float* a_im, const float* u_re,
    const float* u_im, const float* b, const float* y0_re,
    const float* y0_im, const float* z0_re, const float* z0_im,
    const float* v0_re, const float* v0_im, const float* mu0,
    const float* ranks, const float* fracs, float* ws, float* ox_re,
    float* ox_im, float* oy_re, float* oy_im, int* it_out, int* conv_out,
    int lanes, int per_group, int r, int m, int n, int nt, int nr,
    int levels, int scale_by_row, int maxiter, int ws_lane, float rho,
    float tol_rel, float tol_abs, void* stream) {
  if (lanes == 0) return 0;
  if (nr < 1 || nr > 32 || r < 1 || r > kMaxR || nt * nr != n || m < 1 ||
      per_group < 1 || lanes % per_group != 0 || ws_lane % 4 != 0 ||
      ws_lane < lane_workspace(r, m, n) ||
      own_cols_max(nt, nr) > kMaxOwnCols)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * layout(r, nt, nr).total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int groups = lanes / per_group;
  const long long ws_split = split_workspace(m, n);
  const uint2* split =
      reinterpret_cast<const uint2*>(ws + (long long)lanes * ws_lane);
  cudaStream_t s = (cudaStream_t)stream;

  // the constants of each group, split once per launch
  const long long work = (long long)groups * ((long long)m * n + (long long)n * n);
  const int blocks = (int)((work + 255) / 256 < 1024 ? (work + 255) / 256 : 1024);
  split_kernel<<<blocks, 256, 0, s>>>(a_re, a_im, u_re, u_im,
                                      const_cast<uint2*>(split), groups, m, n,
                                      ws_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Params p{b, y0_re, y0_im, z0_re, z0_im, v0_re, v0_im, mu0, ranks, fracs,
           ws, split, ox_re, ox_im, oy_re, oy_im, it_out, conv_out,
           per_group, r, m, n, nt, nr, levels, scale_by_row, maxiter,
           (long long)ws_lane, ws_split, rho, tol_rel, tol_abs};
  err = cudaFuncSetAttribute(infer_admm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(infer_admm_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)lanes * kC, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)infer_admm_kernel,
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return -1;
  err = cudaLaunchKernelEx(&cfg, infer_admm_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The shared memory one CTA needs at this shape, in bytes (layout()), or
// -1 if a CTA would own more than kMaxOwnCols columns of n; the launch
// refuses both that and more than twoace_infer_admm_smem_limit() bytes.
extern "C" int twoace_infer_admm_smem(int r, int nt, int nr) {
  if (own_cols_max(nt, nr) > kMaxOwnCols) return -1;
  return (int)(sizeof(float) * layout(r, nt, nr).total);
}

// The most shared memory a CTA of the kernel may take, in bytes.
extern "C" int twoace_infer_admm_smem_limit() { return kMaxSmem; }

// How many clusters of kC CTAs the card places at once for this shape's
// shared memory (cudaOccupancyMaxActiveClusters), or a negative error.
extern "C" int twoace_infer_admm_clusters(int r, int nt, int nr) {
  const size_t smem = sizeof(float) * layout(r, nt, nr).total;
  cudaError_t err = cudaFuncSetAttribute(
      infer_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        infer_admm_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)infer_admm_kernel,
                                       &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

#ifdef TWOACE_K3_PHASE_TIMER
// The phase timer's sums of the last launch (T_SLOTS values: nanoseconds
// per slot, then lane 0's trips), copied to out and cleared.
extern "C" int twoace_infer_admm_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_k3_phase,
                                         sizeof(unsigned long long) * T_SLOTS);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[T_SLOTS] = {};
  return (int)cudaMemcpyToSymbol(g_k3_phase, zero, sizeof(zero));
}
#endif
