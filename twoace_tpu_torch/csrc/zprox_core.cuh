// The per-lane chain of the warm spectral-profile Z-prox, shared by K2
// (zprox.cu) and K3 (infer_admm.cu).
//
// Port of the Pallas bodies twoace_tpu/ops/pallas/kernels.py::_zprox_kernel
// and twoace_tpu/ops/pallas/solver_kernel.py::_perturb_ladder.  On the panel
// Gram G = W^H W of W = z.reshape(r*nt, nr) (W-convention basis):
//   G' = V0^H G V0;  lam = diag(G')
//   C  = G'_ij / (lam_j - lam_i)   masked where |gap| <= 1e-3 (|l_i|+|l_j|),
//        projected anti-Hermitian, capped at ||C||_F <= 0.7
//   V  = V0 (I + C);  one Newton-Schulz step V <- V (1.5 I - 0.5 V^H V)
//   s  = ladder scales of max(lam, 0), ranked pairwise (no sort), with the
//        ladder as runtime data and 1/max(f, 1e-30) guarding padded levels
//   D  = V diag(sqrt(s) - 1) V^H
// The caller then applies W' = W + W D.  Every nr x nr matrix lives in
// shared memory; each product runs in 3xTF32 on the tensor cores
// (cmatmul: an m16 x n8 tile a warp), and the ladder on the lanes of the
// block's last warp, beside the products.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

// Optional timing hooks of the chain: empty unless the includer defines
// them (K3's and K2's phase-timer builds do)
#ifndef TWOACE_ZPROX_MARK
#define TWOACE_ZPROX_MARK_START
#define TWOACE_ZPROX_MARK(part)
#define TWOACE_ZPROX_MARK_END
#endif
// and of the ladder warp's own time (K2's phase-timer build)
#ifndef TWOACE_ZPROX_LADDER_BEGIN
#define TWOACE_ZPROX_LADDER_BEGIN
#define TWOACE_ZPROX_LADDER_END
#endif

namespace twoace {

constexpr float kRelGap = 1e-3f;
constexpr float kMaxNorm = 0.7f;

// the warp's total of v, summed in a fixed order (a shuffle tree into lane
// 0, then broadcast): every lane gets the same bits
__device__ __forceinline__ float warp_total(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Shared memory of the chain: eight nr x nr matrices, two nr-vectors and
// one partial sum per warp.
struct ZproxSmem {
  float *Vr, *Vi, *Gr, *Gi, *Pr, *Pi, *Cr, *Ci, *lam, *coeff, *red;
};

__host__ __device__ inline int zprox_smem_floats(int nr, int threads) {
  return 8 * nr * nr + 2 * nr + threads / 32;
}

__device__ inline ZproxSmem zprox_smem(float* base, int nr) {
  const int nn = nr * nr;
  ZproxSmem s;
  s.Vr = base;       s.Vi = s.Vr + nn;
  s.Gr = s.Vi + nn;  s.Gi = s.Gr + nn;
  s.Pr = s.Gi + nn;  s.Pi = s.Pr + nn;
  s.Cr = s.Pi + nn;  s.Ci = s.Cr + nn;
  s.lam = s.Ci + nn; s.coeff = s.lam + nr;
  s.red = s.coeff + nr;
  return s;
}

// The forms of a cmatmul operand, an nr x nr matrix X in row-major
// planes (re, im): entry (i, j) is X(i, j), conj X(j, i) (X^H),
// X(i, j) cs[j] (scaled columns) or X(i, j) c (a scalar factor).
enum OpForm { OP_N, OP_H, OP_COLS, OP_SCALED };

__device__ __forceinline__ float2 op_at(int form, const float* re,
                                        const float* im, int nr, int i,
                                        int j, const float* cs, float c) {
  if (form == OP_H) {
    const int o = j * nr + i;
    return make_float2(re[o], -im[o]);
  }
  const int o = i * nr + j;
  const float xr = re[o], xi = im[o];
  if (form == OP_COLS) return make_float2(xr * cs[j], xi * cs[j]);
  if (form == OP_SCALED && c != 1.0f) return make_float2(xr * c, xi * c);
  return make_float2(xr, xi);
}

// What cmatmul writes for (i, j) with sum = (A B)(i, j): the sum, the
// sum added to base(i, j), or 1.5 [i == j] - 0.5 sum.
enum CmmOut { CMM_STORE, CMM_PLUS, CMM_NEWTON };

// The chain's warps: every warp of the block but the last, which runs the
// ladder beside them, where the nr x nr output has fewer m16 x n8 tiles
// than the block has warps (nr <= 24); else all of them, and the ladder
// after the products as one step of the chain.
__host__ __device__ inline int chain_tiles(int nr) {
  return ((nr + 15) / 16) * ((nr + 7) / 8);
}
__host__ __device__ inline int chain_warps(int nr, int warps) {
  return chain_tiles(nr) < warps ? warps - 1 : warps;
}

// a barrier over the chain's warps only (named barrier 1)
__device__ __forceinline__ void chain_sync(int cw) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(cw * 32) : "memory");
}

// named barriers 2 (G' and lam written), 4 (every warp's part of the
// correction written) and 3 (the ladder's coefficients written) between
// the chain's warps and the ladder's, the whole block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// out = the nr x nr product A B as `mode` says, A and B in the forms fa
// and fb (cs: A's column scales, c: B's factor), in 3xTF32 on the tensor
// cores (tf32x3.cuh: the integer split, Karatsuba 3M with A's
// (re, re + im, im - re) against B's (re + im, im, re), each k8 step's
// three products summed from zero and flushed into float32).  Chain warp
// w of cw takes the m16 x n8 tiles w, w + cw, ... of the output; entries
// outside nr x nr read as zero.  No barrier.  Inlined at each of the
// chain's six products, its k loop not unrolled: a call, an unrolled k
// loop and one loop over the six products each made the chain slower on
// the H100 (PERF.md, section 6).
__device__ __forceinline__ void cmatmul(
    int mode, int fa, int fb, const float* ar, const float* ai,
    const float* br, const float* bi, const float* cs, float c, int nr,
    float* outr, float* outi, const float* baser, const float* basei,
    int cw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int nt = (nr + 7) / 8;
  for (int t = warp; t < chain_tiles(nr); t += cw) {
    const int i0 = (t / nt) * 16, j0 = (t % nt) * 8;
    float acc[3][4];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < nr; k0 += 8) {
      // A: a0 (row grp, k tig), a1 (grp + 8, tig), a2 (grp, tig + 4),
      // a3 (grp + 8, tig + 4); B: b0 (k tig, col grp), b1 (k tig + 4, grp)
      uint32_t ab[3][4], as[3][4], bb[3][2], bs[3][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + grp + (q & 1) * 8, p = k0 + tig + (q >> 1) * 4;
        const float2 a = i < nr && p < nr
                             ? op_at(fa, ar, ai, nr, i, p, cs, 1.0f)
                             : make_float2(0.0f, 0.0f);
        split(a.x, ab[0][q], as[0][q]);
        split(a.x + a.y, ab[1][q], as[1][q]);
        split(a.y - a.x, ab[2][q], as[2][q]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = k0 + tig + q * 4, j = j0 + grp;
        const float2 b = p < nr && j < nr
                             ? op_at(fb, br, bi, nr, p, j, nullptr, c)
                             : make_float2(0.0f, 0.0f);
        split(b.x + b.y, bb[0][q], bs[0][q]);
        split(b.y, bb[1][q], bs[1][q]);
        split(b.x, bb[2][q], bs[2][q]);
      }
      mma3_step(acc, ab, as, bb, bs);
    }
    // C: c0, c1 (row grp, cols 2 tig, 2 tig + 1), c2, c3 (row grp + 8)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + grp + (q >> 1) * 8, j = j0 + tig * 2 + (q & 1);
      if (i >= nr || j >= nr) continue;
      const int e = i * nr + j;
      const float sr = acc[0][q] - acc[1][q], si = acc[0][q] + acc[2][q];
      if (mode == CMM_STORE) {
        outr[e] = sr;
        outi[e] = si;
      } else if (mode == CMM_PLUS) {
        outr[e] = baser[e] + sr;
        outi[e] = basei[e] + si;
      } else {
        outr[e] = (i == j ? 1.5f : 0.0f) - 0.5f * sr;
        outi[e] = -0.5f * si;
      }
    }
  }
}

// The constraint ladder on w = max(lam, 0), run by one warp: nr <= 32
// values, one a lane; every sum is the same shuffle tree over the lanes.  lad_rk / lad_f: the first 32 levels, one a lane, loaded
// ahead.  Writes s.coeff = sqrt(scale) - 1.
__device__ inline void zprox_ladder(const ZproxSmem& s, int nr,
                                    const float* ranks, const float* fracs,
                                    int levels, float lad_rk, float lad_f) {
  const int i = threadIdx.x & 31;
  const bool act = i < nr;
  float w = act ? fmaxf(s.lam[i], 0.0f) : 0.0f, scl = 1.0f;
  int rk = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float wj = __shfl_sync(0xffffffffu, w, j);
    if (j < nr) rk += (wj > w) || (wj == w && j < i);
  }
  const float rank = (float)rk;
  float v_tot = warp_total(w);
  for (int l = 0; l < levels; ++l) {
    const float rkl = l < 32 ? __shfl_sync(0xffffffffu, lad_rk, l) : ranks[l];
    const float f = l < 32 ? __shfl_sync(0xffffffffu, lad_f, l) : fracs[l];
    // a level whose head holds every value (the padded ones) multiplies
    // nothing and leaves v_tot, the tree sum of w, as it was
    if (rkl >= (float)nr) continue;
    const float mine = act && rank < rkl ? w : 0.0f;
    const float vr = warp_total(mine);
    const bool need = vr < v_tot * f;
    float sc = fminf(1.0f, vr / fmaxf(v_tot - vr, 1e-30f) *
                               (1.0f / fmaxf(f, 1e-30f) - 1.0f));
    if (!need) sc = 1.0f;
    const float mult = rank < rkl ? 1.0f : sc;
    w *= mult;
    scl *= mult;
    v_tot = warp_total(w);
  }
  if (act) s.coeff[i] = sqrtf(scl) - 1.0f;
}

// The first-order correction C_ij = G'_ij / (lam_j - lam_i), masked, and
// C_ji as the plain version forms them, then the anti-Hermitian
// projection 0.5 (C - C^H) into s.P: entry e of nr x nr for thread e, e +
// blockDim, ... of the block; lam_i is read from G' itself.  The warp's
// part of ||C||_F^2 (a shuffle tree) goes to s.red[warp].
__device__ __forceinline__ void correction_part(const ZproxSmem& s, int nr) {
  const int nn = nr * nr;
  float part = 0.0f;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr, et = j * nr + i;
    const float li = s.Gr[i * nr + i], lj = s.Gr[j * nr + j];
    const float gap = lj - li, gapt = li - lj;
    const bool ok = fabsf(gap) > kRelGap * fmaxf(fabsf(lj) + fabsf(li),
                                                 1e-30f);
    const float cr = ok ? s.Gr[e] / gap : 0.0f;
    const float ci = ok ? s.Gi[e] / gap : 0.0f;
    const float tr = ok ? s.Gr[et] / gapt : 0.0f;
    const float ti = ok ? s.Gi[et] / gapt : 0.0f;
    const float pr = 0.5f * (cr - tr), pi = 0.5f * (ci + ti);
    s.Pr[e] = pr;
    s.Pi[e] = pi;
    part += pr * pr + pi * pi;
  }
  part = warp_total(part);
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = part;
}

// Called by every thread of the block with G in s.G and the warm basis V0
// (W-convention) in s.V, both complete.  Leaves the new basis in s.V and
// D in s.P, followed by a barrier.  ranks/fracs: this lane's ladder.
//
// The chain's warps (chain_warps) run the products, one m16 x n8 tile a
// warp, with barriers over those warps only.  The ladder needs only
// lam = diag(G'), so where a warp is left over it takes its part of the
// correction once G' = V0^H G V0 is formed and then runs the ladder beside
// the correction, Newton-Schulz and V = V1 Q products; the chain's warps
// wait for its coefficients just before D.
__device__ inline void zprox_basis_delta(const ZproxSmem& s, int nr,
                                         const float* ranks,
                                         const float* fracs, int levels) {
  const int nn = nr * nr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warps = (int)(blockDim.x >> 5);
  const int cw = chain_warps(nr, warps);
  const bool beside = cw < warps;            // the ladder on warp cw
  const int ct = cw * 32;                    // the chain's threads
  // the ladder's first 32 levels, one a lane of its warp, loaded now so
  // the loads overlap the products
  const bool lad_warp = warp == (beside ? cw : 0);
  const float lad_rk = lad_warp && lane < levels ? ranks[lane] : 0.0f;
  const float lad_f = lad_warp && lane < levels ? fracs[lane] : 0.0f;
  __syncthreads();
  TWOACE_ZPROX_MARK_START
  if (warp < cw) {
    // P = G V0
    cmatmul(CMM_STORE, OP_N, OP_N, s.Gr, s.Gi, s.Vr, s.Vi, nullptr, 1.0f, nr,
            s.Pr, s.Pi, nullptr, nullptr, cw);
    chain_sync(cw);
    // G' = V0^H P  (into G)
    cmatmul(CMM_STORE, OP_H, OP_N, s.Vr, s.Vi, s.Pr, s.Pi, nullptr, 1.0f, nr,
            s.Gr, s.Gi, nullptr, nullptr, cw);
    chain_sync(cw);
    TWOACE_ZPROX_MARK(0)
    for (int i = tid; i < nr; i += ct) s.lam[i] = s.Gr[i * nr + i];
    if (beside) named_arrive(2, blockDim.x);  // G', lam: the ladder's warp
    correction_part(s, nr);
    // every warp's part of ||C||_F^2, the ladder's warp's too
    if (beside)
      named_sync(4, blockDim.x);
    else
      chain_sync(cw);
    float sq = 0.0f;
    for (int w = 0; w < warps; ++w) sq += s.red[w];
    const float capped = fminf(1.0f, kMaxNorm / fmaxf(sqrtf(sq), 1e-30f));
    TWOACE_ZPROX_MARK(1)
    // V1 = V0 + V0 (capped C)  (into G)
    cmatmul(CMM_PLUS, OP_N, OP_SCALED, s.Vr, s.Vi, s.Pr, s.Pi, nullptr,
            capped, nr, s.Gr, s.Gi, s.Vr, s.Vi, cw);
    chain_sync(cw);
    // Newton-Schulz: Q = 1.5 I - 0.5 V1^H V1  (into C)
    cmatmul(CMM_NEWTON, OP_H, OP_N, s.Gr, s.Gi, s.Gr, s.Gi, nullptr, 1.0f,
            nr, s.Cr, s.Ci, nullptr, nullptr, cw);
    chain_sync(cw);
    // V = V1 Q  (into V; V0 is no longer needed)
    cmatmul(CMM_STORE, OP_N, OP_N, s.Gr, s.Gi, s.Cr, s.Ci, nullptr, 1.0f, nr,
            s.Vr, s.Vi, nullptr, nullptr, cw);
    TWOACE_ZPROX_MARK(0)
    if (beside) {
      // the ladder's coefficients; also a barrier over the chain's warps,
      // so V is complete
      named_sync(3, blockDim.x);
    } else {
      chain_sync(cw);
      if (warp == 0)
        zprox_ladder(s, nr, ranks, fracs, levels, lad_rk, lad_f);
      chain_sync(cw);
    }
    TWOACE_ZPROX_MARK(2)
    // D = V diag(coeff) V^H  (into P)
    cmatmul(CMM_STORE, OP_COLS, OP_H, s.Vr, s.Vi, s.Vr, s.Vi, s.coeff, 1.0f,
            nr, s.Pr, s.Pi, nullptr, nullptr, cw);
    TWOACE_ZPROX_MARK(0)
  } else {
    // the ladder's warp: waits for G' and lam, takes its part of the
    // correction, then runs the ladder beside the products and hands over
    // the coefficients
    named_sync(2, blockDim.x);
    correction_part(s, nr);
    named_arrive(4, blockDim.x);
    TWOACE_ZPROX_LADDER_BEGIN
    zprox_ladder(s, nr, ranks, fracs, levels, lad_rk, lad_f);
    TWOACE_ZPROX_LADDER_END
    named_arrive(3, blockDim.x);
  }
  __syncthreads();
  TWOACE_ZPROX_MARK_END
}

}  // namespace twoace
