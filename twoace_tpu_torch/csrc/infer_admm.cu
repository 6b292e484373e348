// K3: the whole InferADMM loop in one kernel, one thread-block cluster of
// kC CTAs per lane.
//
// Replaces the TPU kernel twoace_tpu/ops/pallas/solver_kernel.py::
// fused_infer_admm (body _solve_kernel, with _perturb_ladder, _pm, _pm_bt),
// with a lane axis: lane l uses codebook block a[l / per_group] and its U,
// its own b, prepared state (y0, z0, v0, mu0) and runtime ladder.  Each trip
// (ref: inferLowRankV4_multi.m:281-386):
//   A  rhs = (Y - M/mu) conj(A) + Z - N/mu             own n columns
//   B  X = rhs conj(U); Zin = X + N/mu; panel Gram     own n columns
//   C  AX = X A^T; magnitude prox and M-dual update    own m columns
//   D  A^H Y; Z-prox (zprox_core.cuh) and N-dual       own n columns
//   E  residual tests, mu update, best-so-far          every CTA alike
// with a cluster barrier after A, B, C and D.
//
// What bounds it on the H100: operations.  Per lane and trip the four
// complex products cost 6 r (3 m n + n^2) flops in Karatsuba form (102
// MFLOP at r 20, n 256, m 1024) against ~3.5 MB of compulsory traffic per
// launch, so the bound is (trips x flops) at the card's 67 TFLOP/s float32
// rate outside the tensor cores.  Design, simple before fast:
//  - One cluster per lane (kC = 8 CTAs, the portable size); a lane's state
//    lives in a global workspace the wrapper allocates (at 16x16, m 1024:
//    A 2 MB, U 0.5 MB, state ~1.3 MB, all L2-resident in the 50 MB L2).
//  - Each GEMM phase splits its output columns across the cluster's CTAs
//    (n columns in whole nr-wide slices, so each CTA's panel-Gram partial
//    covers its own slices) and runs 4-multiply complex FMA in float32 on
//    the CUDA cores from shared-memory tiles.  No tensor cores: the loop is
//    convergence-class whatever the config's kernel_precision says.
//  - Cross-CTA data (Y, the M-dual, X, rhs, partial sums) is written with
//    st.global.cg and read with ld.global.cg (L2, the coherence point), and
//    cluster.sync() (barrier.cluster arrive.release / wait.acquire) orders
//    it.  No pointer into the workspace is __restrict__/read-only.
//  - Reductions across CTAs (norms, the column objective, the panel Gram)
//    are per-CTA partials summed by every CTA in the same fixed order, with
//    no float atomics, so every CTA derives the same converged bit, mu and
//    best-so-far choice; the early exit once a lane converges is uniform
//    across the cluster and ends exactly where JAX's frozen trips begin.
//  - Every CTA runs the small nr x nr Z-prox chain redundantly on the same
//    summed Gram and keeps the basis V in its own shared memory.
//  - The magnitude prox rounds every product and sum on its own, as K1 and
//    the plain version do; the ladder's padded f = 0 levels are guarded by
//    1/max(f, 1e-30) in zprox_core.cuh.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream
// with cudaLaunchKernelEx, allocates nothing, returns -1 if the cluster
// cannot be placed on the device, else cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "zprox_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kC = 8;                  // CTAs per cluster, one cluster per lane
constexpr int kThreads = 256;
constexpr int kTK = 128;               // depth of a K tile
constexpr int kNB = 32;                // output columns per block pass
constexpr int kRsStride = kNB + 1;     // padded row of the R tile
constexpr int kRG = kThreads / kNB;    // row groups
constexpr int kMaxR = 32;
constexpr int kRows = kMaxR / kRG;     // accumulator rows per thread
static_assert(kNB == 32, "a warp's lanes are a block's columns");

// partial-sum slots after the panel Gram (2 nr^2 floats)
enum Slot { S_NX, S_NAX, S_NY, S_JM, S_DY, S_NATY, S_DATY, S_NZ, S_DZ, S_JN,
            S_OBJ };

__host__ __device__ inline int partial_floats(int r, int nr) {
  return 2 * nr * nr + S_OBJ + r;
}

__host__ __device__ inline long long lane_workspace(int r, int m, int n,
                                                    int nr) {
  return 4LL * r * m + 12LL * r * n + (long long)kC * partial_floats(r, nr);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ void st(float* p, float v) { __stcg(p, v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the total
}

// out(k, j) = sum_i L(k, i) R(i, j) over the columns [j0, j1), in blocks of
// kNB columns starting at jb; store(k, j, j - jb, acc) gets each finished
// entry and done(jb, nc) runs after each block.  Called by every thread of the CTA.  kIFast: R's
// source is contiguous along i (load the tile with i fastest).
template <bool kIFast, class LoadL, class LoadR, class Store, class Done>
__device__ __forceinline__ void gemm_cols(int r, int K, int j0, int j1,
                                          float2* Ls, float2* Rs,
                                          LoadL loadL, LoadR loadR,
                                          Store store, Done done) {
  const int tid = threadIdx.x, jl = tid % kNB, rg = tid / kNB;
  for (int jb = j0; jb < j1; jb += kNB) {
    const int nc = min(kNB, j1 - jb);
    float accr[kRows], acci[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s) accr[s] = acci[s] = 0.0f;
    for (int i0 = 0; i0 < K; i0 += kTK) {
      const int nk = min(kTK, K - i0);
      __syncthreads();                 // the previous tiles are consumed
#pragma unroll 4
      for (int e = tid; e < r * kTK; e += kThreads) {
        const int k = e / kTK, i = e - k * kTK;
        Ls[e] = i < nk ? loadL(k, i0 + i) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int e = tid; e < kTK * kNB; e += kThreads) {
        int i, j;
        if (kIFast) { j = e / kTK; i = e - j * kTK; }
        else        { i = e / kNB; j = e - i * kNB; }
        Rs[i * kRsStride + j] = (i < nk && j < nc)
            ? loadR(i0 + i, jb + j) : make_float2(0.0f, 0.0f);
      }
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < kTK; ++i) {
        const float2 bv = Rs[i * kRsStride + jl];
#pragma unroll
        for (int s = 0; s < kRows; ++s) {
          const int k = rg + s * kRG;
          if (k < r) {
            const float2 av = Ls[k * kTK + i];
            accr[s] = fmaf(av.x, bv.x, fmaf(-av.y, bv.y, accr[s]));
            acci[s] = fmaf(av.x, bv.y, fmaf(av.y, bv.x, acci[s]));
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int k = rg + s * kRG;
      if (k < r && jl < nc) store(k, jb + jl, jl, make_float2(accr[s], acci[s]));
    }
    done(jb, nc);
  }
}

struct Params {
  const float *a_re, *a_im, *u_re, *u_im, *b, *y0_re, *y0_im, *z0_re, *z0_im,
      *v0_re, *v0_im, *mu0, *ranks, *fracs;
  float* ws;
  float *ox_re, *ox_im, *oy_re, *oy_im;
  int *it_out, *conv_out;
  int per_group, r, m, n, nt, nr, levels, scale_by_row, maxiter;
  long long ws_lane;
  float rho, tol_rel, tol_abs;
};

__global__ void __launch_bounds__(kThreads)
infer_admm_kernel(const Params P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int lane = blockIdx.x / kC;
  const int tid = threadIdx.x;
  const int r = P.r, m = P.m, n = P.n, nr = P.nr, nt = P.nt;
  const int nn = nr * nr;
  const bool sbr = P.scale_by_row != 0;

  // this lane's inputs
  const long long grp = lane / P.per_group;
  const float* Ar = P.a_re + grp * m * n;
  const float* Ai = P.a_im + grp * m * n;
  const float* Ur = P.u_re + grp * n * n;
  const float* Ui = P.u_im + grp * n * n;
  const float* bl = P.b + (long long)lane * m;

  // this lane's workspace (planar re / im)
  float* w = P.ws + lane * P.ws_lane;
  const long long rm = (long long)r * m, rn = (long long)r * n;
  float *Yr = w, *Yi = Yr + rm, *Mr = Yi + rm, *Mi = Mr + rm;
  float *Zr = Mi + rm, *Zi = Zr + rn, *Nr = Zi + rn, *Ni = Nr + rn;
  float *Tr = Ni + rn, *Ti = Tr + rn;           // A^H Y
  float *Xr = Ti + rn, *Xi = Xr + rn;
  float *Rr = Xi + rn, *Ri = Rr + rn;           // rhs of the X-update
  float *Wr = Ri + rn, *Wi = Wr + rn;           // Zin = X + N/mu
  float* part = Wi + rn;
  const int np = partial_floats(r, nr);
  float* mypart = part + c * np;
  const int sb = 2 * nn;                        // first scalar slot

  // column ownership: n in whole nr-wide slices, m in even chunks
  const int t0 = (c * nt) / kC, t1 = ((c + 1) * nt) / kC;
  const int n0 = t0 * nr, n1 = t1 * nr;
  const int m0 = (int)(((long long)c * m) / kC);
  const int m1 = (int)(((long long)(c + 1) * m) / kC);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float2* Ls = reinterpret_cast<float2*>(smem);
  float2* Rs = Ls + kMaxR * kTK;
  float2* axs = Rs + kTK * kRsStride;
  float* objacc = reinterpret_cast<float*>(axs + kMaxR * kNB);
  float* colsum = objacc + kMaxR;               // 2 kRG x kNB
  const twoace::ZproxSmem zs =
      twoace::zprox_smem(colsum + 2 * kRG * kNB, nr);

  // ---- prepared state: own columns of Y, Z; zero duals; basis V0 in the
  // W-convention (conj of the E-convention input)
  for (long long e = tid; e < (long long)r * (m1 - m0); e += kThreads) {
    const int k = (int)(e / (m1 - m0)), j = m0 + (int)(e % (m1 - m0));
    const long long o = (long long)k * m + j;
    st(Yr + o, __ldg(P.y0_re + lane * rm + o));
    st(Yi + o, __ldg(P.y0_im + lane * rm + o));
    st(Mr + o, 0.0f);
    st(Mi + o, 0.0f);
  }
  for (long long e = tid; e < (long long)r * (n1 - n0); e += kThreads) {
    const int k = (int)(e / (n1 - n0)), j = n0 + (int)(e % (n1 - n0));
    const long long o = (long long)k * n + j;
    st(Zr + o, __ldg(P.z0_re + lane * rn + o));
    st(Zi + o, __ldg(P.z0_im + lane * rn + o));
    st(Nr + o, 0.0f);
    st(Ni + o, 0.0f);
  }
  for (int e = tid; e < nn; e += kThreads) {
    zs.Vr[e] = __ldg(P.v0_re + (long long)lane * nn + e);
    zs.Vi[e] = -__ldg(P.v0_im + (long long)lane * nn + e);
  }
  float mu = __ldg(P.mu0 + lane);
  float last_res = INFINITY, opt_obj = INFINITY;
  int it = 0;
  bool conv = false;
  const float* ranks = P.ranks + (long long)lane * P.levels;
  const float* fracs = P.fracs + (long long)lane * P.levels;
  const float t_prim0 = (float)(P.tol_abs * sqrt((double)(m + n) * r));
  const float t_dual0 = (float)(P.tol_abs * sqrt((double)n * r * 2));
  const float t_comb0 = (float)(P.tol_abs * sqrt((double)(m + n) * r * 2));
  const float inv_sqrt_r = (float)(1.0 / sqrt((double)r));
  auto nothing = [](int, int) {};
  cluster.sync();

  // A^H Y of the initial Y, own n columns
  gemm_cols<false>(
      r, m, n0, n1, Ls, Rs,
      [&](int k, int i) { const long long o = (long long)k * m + i;
                          return make_float2(ld(Yr + o), ld(Yi + o)); },
      [&](int i, int j) { const long long o = (long long)i * n + j;
                          return make_float2(__ldg(Ar + o), -__ldg(Ai + o)); },
      [&](int k, int j, int, float2 v) { const long long o = (long long)k * n + j;
                                    st(Tr + o, v.x); st(Ti + o, v.y); },
      nothing);

  while (it < P.maxiter && !conv) {
    const float inv_mu = 1.0f / mu;

    // ---- A: rhs = (Y - M/mu) conj(A) + Z - N/mu
    gemm_cols<false>(
        r, m, n0, n1, Ls, Rs,
        [&](int k, int i) {
          const long long o = (long long)k * m + i;
          return make_float2(ld(Yr + o) - ld(Mr + o) * inv_mu,
                             ld(Yi + o) - ld(Mi + o) * inv_mu); },
        [&](int i, int j) { const long long o = (long long)i * n + j;
                            return make_float2(__ldg(Ar + o), -__ldg(Ai + o)); },
        [&](int k, int j, int, float2 v) {
          const long long o = (long long)k * n + j;
          st(Rr + o, v.x + (ld(Zr + o) - ld(Nr + o) * inv_mu));
          st(Ri + o, v.y + (ld(Zi + o) - ld(Ni + o) * inv_mu)); },
        nothing);
    cluster.sync();

    // ---- B: X = rhs conj(U); Zin = X + N/mu; Gram partial of own slices
    float p_nx = 0.0f;
    gemm_cols<false>(
        r, n, n0, n1, Ls, Rs,
        [&](int k, int i) { const long long o = (long long)k * n + i;
                            return make_float2(ld(Rr + o), ld(Ri + o)); },
        [&](int i, int j) { const long long o = (long long)i * n + j;
                            return make_float2(__ldg(Ur + o), -__ldg(Ui + o)); },
        [&](int k, int j, int, float2 v) {
          const long long o = (long long)k * n + j;
          st(Xr + o, v.x); st(Xi + o, v.y);
          st(Wr + o, v.x + ld(Nr + o) * inv_mu);
          st(Wi + o, v.y + ld(Ni + o) * inv_mu);
          p_nx += v.x * v.x + v.y * v.y; },
        nothing);
    __syncthreads();
    for (int e = tid; e < nn; e += kThreads) {
      const int p = e / nr, q = e - p * nr;
      float sr = 0.0f, si = 0.0f;
      for (int t = t0; t < t1; ++t)
        for (int k = 0; k < r; ++k) {
          const long long o = (long long)k * n + t * nr;
          const float ar = ld(Wr + o + p), ai = ld(Wi + o + p);
          const float br = ld(Wr + o + q), bi = ld(Wi + o + q);
          sr += ar * br + ai * bi;
          si += ar * bi - ai * br;
        }
      st(mypart + e, sr);
      st(mypart + nn + e, si);
    }
    p_nx = twoace::block_sum(p_nx, zs.red);
    if (tid == 0) st(mypart + sb + S_NX, p_nx);
    cluster.sync();

    // ---- C: AX = X A^T on own m columns, then the prox column by column
    float p_nax = 0.0f, p_ny = 0.0f, p_jm = 0.0f, p_dy = 0.0f, p_obj = 0.0f;
    if (tid < kMaxR) objacc[tid] = 0.0f;
    gemm_cols<true>(
        r, n, m0, m1, Ls, Rs,
        [&](int k, int i) { const long long o = (long long)k * n + i;
                            return make_float2(ld(Xr + o), ld(Xi + o)); },
        [&](int i, int j) { const long long o = (long long)j * n + i;
                            return make_float2(__ldg(Ar + o), __ldg(Ai + o)); },
        [&](int k, int, int jl, float2 v) { axs[k * kNB + jl] = v; },
        [&](int jb, int nc) {
          // the prox of the block's columns: lane = column, warp w takes
          // rows w, w + 8, ...; column sums go through colsum in warp order
          __syncthreads();                            // axs is complete
          const int col = tid & 31, warp = tid >> 5;
          const bool valid = col < nc;
          const int j = jb + col;
          const float bj = valid ? __ldg(bl + j) : 0.0f;
          const float act = bj > 0.0f ? 1.0f : 0.0f;
          const float one_mu = 1.0f + mu;
          float coeff = 0.0f;
          bool zero = false;
          if (sbr) {
            float d2 = 0.0f, amp2 = 0.0f;
            for (int k = warp; k < r && valid; k += kRG) {
              const float2 ax = axs[k * kNB + col];
              const long long o = (long long)k * m + j;
              const float yr = add(ax.x, mul(ld(Mr + o), inv_mu));
              const float yi = add(ax.y, mul(ld(Mi + o), inv_mu));
              d2 = add(d2, add(mul(yr, yr), mul(yi, yi)));
              amp2 += ax.x * ax.x + ax.y * ax.y;
            }
            colsum[warp * kNB + col] = d2;
            colsum[(kRG + warp) * kNB + col] = amp2;
            __syncthreads();
            d2 = 0.0f;
            amp2 = 0.0f;
            for (int w = 0; w < kRG; ++w) {
              d2 = add(d2, colsum[w * kNB + col]);
              amp2 += colsum[(kRG + w) * kNB + col];
            }
            zero = d2 <= 0.0f;
            coeff = mul(add(bj / sqrtf(zero ? 1.0f : d2), mu) / one_mu, act);
            if (warp == 0 && valid) {
              const float dev = sqrtf(fmaxf(amp2, 0.0f)) - bj;
              p_obj += dev * dev;
            }
          }
          for (int k = warp; k < r; k += kRG) {
            float v = 0.0f;
            if (valid) {
              const float2 ax = axs[k * kNB + col];
              const long long o = (long long)k * m + j;
              const float mdr = ld(Mr + o), mdi = ld(Mi + o);
              float yr = add(ax.x, mul(mdr, inv_mu));
              float yi = add(ax.y, mul(mdi, inv_mu));
              if (sbr) {
                if (zero) { yr = inv_sqrt_r; yi = 0.0f; }
              } else {
                const float e2 = add(mul(yr, yr), mul(yi, yi));
                zero = e2 <= 0.0f;
                if (zero) yr = 1.0f;
                coeff = mul(add(bj / sqrtf(zero ? 1.0f : e2), mu) / one_mu,
                            act);
                const float dev = sqrtf(fmaxf(ax.x * ax.x + ax.y * ax.y,
                                              0.0f)) - bj;
                v = dev * dev;
              }
              const float outr = mul(yr, coeff), outi = mul(yi, coeff);
              const float dyr = outr - ld(Yr + o), dyi = outi - ld(Yi + o);
              const float jr = ax.x - outr, ji = ax.y - outi;
              p_nax += ax.x * ax.x + ax.y * ax.y;
              p_ny += outr * outr + outi * outi;
              p_jm += jr * jr + ji * ji;
              p_dy += dyr * dyr + dyi * dyi;
              st(Yr + o, outr);
              st(Yi + o, outi);
              st(Mr + o, add(mdr, mul(mu, sub(ax.x, outr))));
              st(Mi + o, add(mdi, mul(mu, sub(ax.y, outi))));
            }
            if (!sbr) {
              v = warp_sum(v);
              if (col == 0) objacc[k] += v;       // row k: one warp only
            }
          }
        });
    p_nax = twoace::block_sum(p_nax, zs.red);
    p_ny = twoace::block_sum(p_ny, zs.red);
    p_jm = twoace::block_sum(p_jm, zs.red);
    p_dy = twoace::block_sum(p_dy, zs.red);
    p_obj = twoace::block_sum(p_obj, zs.red);
    if (tid == 0) {
      st(mypart + sb + S_NAX, p_nax);
      st(mypart + sb + S_NY, p_ny);
      st(mypart + sb + S_JM, p_jm);
      st(mypart + sb + S_DY, p_dy);
      if (sbr) st(mypart + sb + S_OBJ, p_obj);
    }
    if (!sbr && tid < r) st(mypart + sb + S_OBJ + tid, objacc[tid]);
    cluster.sync();

    // ---- D: A^H Y_new (own n columns), Z-prox, N-dual
    float p_naty = 0.0f, p_daty = 0.0f;
    gemm_cols<false>(
        r, m, n0, n1, Ls, Rs,
        [&](int k, int i) { const long long o = (long long)k * m + i;
                            return make_float2(ld(Yr + o), ld(Yi + o)); },
        [&](int i, int j) { const long long o = (long long)i * n + j;
                            return make_float2(__ldg(Ar + o), -__ldg(Ai + o)); },
        [&](int k, int j, int, float2 v) {
          const long long o = (long long)k * n + j;
          const float dr = v.x - ld(Tr + o), di = v.y - ld(Ti + o);
          p_naty += v.x * v.x + v.y * v.y;
          p_daty += dr * dr + di * di;
          st(Tr + o, v.x); st(Ti + o, v.y); },
        nothing);
    // the panel Gram, summed over the cluster in CTA order
    for (int e = tid; e < nn; e += kThreads) {
      float sr = 0.0f, si = 0.0f;
      for (int cc = 0; cc < kC; ++cc) {
        sr += ld(part + cc * np + e);
        si += ld(part + cc * np + nn + e);
      }
      zs.Gr[e] = sr;
      zs.Gi[e] = si;
    }
    twoace::zprox_basis_delta(zs, nr, ranks, fracs, P.levels);
    float p_nz = 0.0f, p_dz = 0.0f, p_jn = 0.0f;
    for (long long e = tid; e < (long long)r * (n1 - n0); e += kThreads) {
      const int k = (int)(e / (n1 - n0)), j = n0 + (int)(e % (n1 - n0));
      const int t = j / nr, q = j - t * nr;
      const long long row = (long long)k * n + t * nr;
      const long long o = (long long)k * n + j;
      float sr = 0.0f, si = 0.0f;
      for (int p = 0; p < nr; ++p) {
        const float ar = ld(Wr + row + p), ai = ld(Wi + row + p);
        const float br = zs.Pr[p * nr + q], bi = zs.Pi[p * nr + q];
        sr += ar * br - ai * bi;
        si += ar * bi + ai * br;
      }
      const float znr = ld(Wr + o) + sr, zni = ld(Wi + o) + si;
      const float dzr = znr - ld(Zr + o), dzi = zni - ld(Zi + o);
      const float jr = ld(Xr + o) - znr, ji = ld(Xi + o) - zni;
      p_nz += znr * znr + zni * zni;
      p_dz += dzr * dzr + dzi * dzi;
      p_jn += jr * jr + ji * ji;
      st(Zr + o, znr);
      st(Zi + o, zni);
      st(Nr + o, ld(Nr + o) + mu * jr);
      st(Ni + o, ld(Ni + o) + mu * ji);
    }
    p_naty = twoace::block_sum(p_naty, zs.red);
    p_daty = twoace::block_sum(p_daty, zs.red);
    p_nz = twoace::block_sum(p_nz, zs.red);
    p_dz = twoace::block_sum(p_dz, zs.red);
    p_jn = twoace::block_sum(p_jn, zs.red);
    if (tid == 0) {
      st(mypart + sb + S_NATY, p_naty);
      st(mypart + sb + S_DATY, p_daty);
      st(mypart + sb + S_NZ, p_nz);
      st(mypart + sb + S_DZ, p_dz);
      st(mypart + sb + S_JN, p_jn);
    }
    cluster.sync();

    // ---- E: every thread of every CTA sums the partials in CTA order
    float s[S_OBJ];
    for (int q = 0; q < S_OBJ; ++q) {
      float acc = 0.0f;
      for (int cc = 0; cc < kC; ++cc) acc += ld(part + cc * np + sb + q);
      s[q] = acc;
    }
    float obj;
    int jj = 0;
    if (sbr) {
      float acc = 0.0f;
      for (int cc = 0; cc < kC; ++cc) acc += ld(part + cc * np + sb + S_OBJ);
      obj = sqrtf(acc);
    } else {
      obj = INFINITY;
      for (int k = 0; k < r; ++k) {
        float acc = 0.0f;
        for (int cc = 0; cc < kC; ++cc) acc += ld(part + cc * np + sb + S_OBJ + k);
        const float ok = sqrtf(acc);
        if (k == 0 || ok < obj) { obj = ok; jj = k; }      // first on ties
      }
    }
    if (obj < opt_obj) {                                   // best so far
      if (sbr) {
        for (long long e = tid; e < (long long)r * (n1 - n0); e += kThreads) {
          const int k = (int)(e / (n1 - n0)), j = n0 + (int)(e % (n1 - n0));
          const long long o = (long long)k * n + j;
          P.ox_re[lane * rn + o] = ld(Xr + o);
          P.ox_im[lane * rn + o] = ld(Xi + o);
        }
        for (long long e = tid; e < (long long)r * (m1 - m0); e += kThreads) {
          const int k = (int)(e / (m1 - m0)), j = m0 + (int)(e % (m1 - m0));
          const long long o = (long long)k * m + j;
          P.oy_re[lane * rm + o] = ld(Yr + o);
          P.oy_im[lane * rm + o] = ld(Yi + o);
        }
      } else {
        for (int j = n0 + tid; j < n1; j += kThreads) {
          P.ox_re[(long long)lane * n + j] = ld(Xr + (long long)jj * n + j);
          P.ox_im[(long long)lane * n + j] = ld(Xi + (long long)jj * n + j);
        }
        for (int j = m0 + tid; j < m1; j += kThreads) {
          P.oy_re[(long long)lane * m + j] = ld(Yr + (long long)jj * m + j);
          P.oy_im[(long long)lane * m + j] = ld(Yi + (long long)jj * m + j);
        }
      }
    }
    opt_obj = (isnan(obj) || isnan(opt_obj)) ? NAN : fminf(obj, opt_obj);
    const float nax = sqrtf(s[S_NAX]), ny = sqrtf(s[S_NY]);
    const float naty = sqrtf(s[S_NATY]), nx = sqrtf(s[S_NX]);
    const float nz = sqrtf(s[S_NZ]);
    const float res_prim = sqrtf(s[S_JM] + s[S_JN]);
    const float res_dual = mu * sqrtf(s[S_DATY] + s[S_DZ]);
    const float res_comb = sqrtf(res_prim * res_prim + s[S_DY] + s[S_DZ]);
    const float mx1 = fmaxf(nax, ny), mx2 = fmaxf(nx, nz);
    const float big = mx1 * mx1 + mx2 * mx2;
    const float t_prim = t_prim0 + P.tol_rel * sqrtf(big);
    const float t_dual = t_dual0 + P.tol_rel * sqrtf(naty * naty + nz * nz);
    const float t_comb = t_comb0 + P.tol_rel * sqrtf(big + ny * ny + nz * nz);
    conv = ((res_prim < t_prim) && (res_dual < t_dual)) || (res_comb < t_comb);
    if (res_comb > last_res * 0.9f) mu = mu * P.rho;
    last_res = res_comb;
    ++it;
  }
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
  if (nr < 1 || nr > 32 || r < 1 || r > kMaxR || nt * nr != n ||
      per_group < 1 || ws_lane < lane_workspace(r, m, n, nr))
    return (int)cudaErrorInvalidValue;
  Params p{a_re, a_im, u_re, u_im, b, y0_re, y0_im, z0_re, z0_im, v0_re,
           v0_im, mu0, ranks, fracs, ws, ox_re, ox_im, oy_re, oy_im, it_out,
           conv_out, per_group, r, m, n, nt, nr, levels, scale_by_row,
           maxiter, (long long)ws_lane, rho, tol_rel, tol_abs};
  const size_t smem =
      sizeof(float2) * (kMaxR * kTK + kTK * kRsStride + kMaxR * kNB) +
      sizeof(float) * (kMaxR + 2 * kRG * kNB +
                       twoace::zprox_smem_floats(nr, kThreads));
  cudaError_t err = cudaFuncSetAttribute(
      infer_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)lanes * kC, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
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
