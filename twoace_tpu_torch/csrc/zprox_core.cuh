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
// (cmatmul: an m16 x n8 tile a warp) and the ladder on the lanes of one
// warp.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

// Optional timing hooks of the chain: empty unless the includer defines
// them (K3's phase-timer build does)
#ifndef TWOACE_ZPROX_MARK
#define TWOACE_ZPROX_MARK_START
#define TWOACE_ZPROX_MARK(part)
#define TWOACE_ZPROX_MARK_END
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

// every thread passes its partial; all threads get the total, summed in a
// fixed order (warp shuffles, then warps in index order)
__device__ inline float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lanei = threadIdx.x & 31;
  __syncthreads();
  if (lanei == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
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

// One nr x nr complex operand of cmatmul: entry (i, j) is
// (re, +/-im)[i * rs + j * cs], times colscale[j] if given, times scale.
struct CMat {
  const float *re, *im;
  int rs, cs;
  bool conj;
  const float* colscale;
  float scale;
  __device__ float2 at(int i, int j) const {
    const int o = i * rs + j * cs;
    float f = scale;
    if (colscale) f *= colscale[j];
    const float xr = re[o], xi = conj ? -im[o] : im[o];
    return f == 1.0f ? make_float2(xr, xi) : make_float2(xr * f, xi * f);
  }
};

// What cmatmul writes for (i, j) with sum = (A B)(i, j): the sum, the
// sum added to base(i, j), or 1.5 [i == j] - 0.5 sum.
enum CmmOut { CMM_STORE, CMM_PLUS, CMM_NEWTON };

// out = the nr x nr product A B as MODE says, in 3xTF32 on the tensor
// cores (tf32x3.cuh: the integer split, each k8 step's three products
// summed from zero and flushed into float32, Karatsuba 3M with A's
// (re, re + im, im - re) against B's (re + im, im, re)).  A warp takes an
// m16 x n8 tile of the output at a time; entries outside nr x nr read as
// zero.  Called by every thread of the block; no barrier.
template <int MODE>
__device__ __forceinline__ void cmatmul(
    const CMat& A, const CMat& B, int nr, float* outr, float* outi,
    const float* baser, const float* basei) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int mt = (nr + 15) / 16, nt = (nr + 7) / 8, kt = (nr + 7) / 8;
  const int nwarps = (int)(blockDim.x >> 5);
  for (int t = warp; t < mt * nt; t += nwarps) {
    const int i0 = (t / nt) * 16, j0 = (t % nt) * 8;
    float acc[3][4];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
    for (int k0 = 0; k0 < kt * 8; k0 += 8) {
      // A: a0 (row grp, k tig), a1 (grp + 8, tig), a2 (grp, tig + 4),
      // a3 (grp + 8, tig + 4); B: b0 (k tig, col grp), b1 (k tig + 4, grp)
      uint32_t ab[3][4], as[3][4], bb[3][2], bs[3][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + grp + (q & 1) * 8, p = k0 + tig + (q >> 1) * 4;
        const float2 a = i < nr && p < nr ? A.at(i, p)
                                          : make_float2(0.0f, 0.0f);
        split(a.x, ab[0][q], as[0][q]);
        split(a.x + a.y, ab[1][q], as[1][q]);
        split(a.y - a.x, ab[2][q], as[2][q]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = k0 + tig + q * 4, j = j0 + grp;
        const float2 b = p < nr && j < nr ? B.at(p, j)
                                          : make_float2(0.0f, 0.0f);
        split(b.x + b.y, bb[0][q], bs[0][q]);
        split(b.y, bb[1][q], bs[1][q]);
        split(b.x, bb[2][q], bs[2][q]);
      }
      // mma3 of the three products, step by step across them
      float d[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[p][q] = 0.0f;
#pragma unroll
      for (int step = 0; step < 3; ++step)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          mma_tf32(d[p], step == 0 ? as[p] : ab[p],
                   step == 1 ? bs[p] : bb[p]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += d[p][q];
    }
    // C: c0, c1 (row grp, cols 2 tig, 2 tig + 1), c2, c3 (row grp + 8)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + grp + (q >> 1) * 8, j = j0 + tig * 2 + (q & 1);
      if (i >= nr || j >= nr) continue;
      const int e = i * nr + j;
      const float sr = acc[0][q] - acc[1][q], si = acc[0][q] + acc[2][q];
      if (MODE == CMM_STORE) {
        outr[e] = sr;
        outi[e] = si;
      } else if (MODE == CMM_PLUS) {
        outr[e] = baser[e] + sr;
        outi[e] = basei[e] + si;
      } else {
        outr[e] = (i == j ? 1.5f : 0.0f) - 0.5f * sr;
        outi[e] = -0.5f * si;
      }
    }
  }
}

// Called by every thread of the block with G in s.G and the warm basis V0
// (W-convention) in s.V, both complete.  Leaves the new basis in s.V and
// D in s.P, followed by a barrier.  ranks/fracs: this lane's ladder.
__device__ inline void zprox_basis_delta(const ZproxSmem& s, int nr,
                                         const float* ranks,
                                         const float* fracs, int levels) {
  const int nn = nr * nr;
  const int tid = threadIdx.x;
  const CMat V{s.Vr, s.Vi, nr, 1, false, nullptr, 1.0f};
  const CMat VH{s.Vr, s.Vi, 1, nr, true, nullptr, 1.0f};
  // the ladder's first 32 levels, one a lane of warp 0, loaded now so the
  // loads overlap the products
  const float lad_rk = tid < levels && tid < 32 ? ranks[tid] : 0.0f;
  const float lad_f = tid < levels && tid < 32 ? fracs[tid] : 0.0f;
  __syncthreads();
  TWOACE_ZPROX_MARK_START
  // P = G V0
  cmatmul<CMM_STORE>(CMat{s.Gr, s.Gi, nr, 1, false, nullptr, 1.0f}, V, nr,
                     s.Pr, s.Pi, nullptr, nullptr);
  __syncthreads();
  // G' = V0^H P  (into G)
  cmatmul<CMM_STORE>(VH, CMat{s.Pr, s.Pi, nr, 1, false, nullptr, 1.0f}, nr,
                     s.Gr, s.Gi, nullptr, nullptr);
  __syncthreads();
  TWOACE_ZPROX_MARK(0)
  for (int i = tid; i < nr; i += blockDim.x) s.lam[i] = s.Gr[i * nr + i];
  __syncthreads();
  // first-order correction C_ij = G'_ij / (lam_j - lam_i), masked
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    const float gap = s.lam[j] - s.lam[i];
    const float mag = fabsf(s.lam[j]) + fabsf(s.lam[i]);
    const bool ok = fabsf(gap) > kRelGap * fmaxf(mag, 1e-30f);
    s.Cr[e] = ok ? s.Gr[e] / gap : 0.0f;
    s.Ci[e] = ok ? s.Gi[e] / gap : 0.0f;
  }
  __syncthreads();
  // anti-Hermitian projection (into P) and its Frobenius norm
  float part = 0.0f;
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    const float cr = 0.5f * (s.Cr[e] - s.Cr[j * nr + i]);
    const float ci = 0.5f * (s.Ci[e] + s.Ci[j * nr + i]);
    s.Pr[e] = cr;
    s.Pi[e] = ci;
    part += cr * cr + ci * ci;
  }
  const float fro = sqrtf(block_sum(part, s.red));
  const float capped = fminf(1.0f, kMaxNorm / fmaxf(fro, 1e-30f));
  TWOACE_ZPROX_MARK(1)
  // V1 = V0 + V0 (capped C)  (into G)
  cmatmul<CMM_PLUS>(V, CMat{s.Pr, s.Pi, nr, 1, false, nullptr, capped}, nr,
                    s.Gr, s.Gi, s.Vr, s.Vi);
  __syncthreads();
  // Newton-Schulz: Q = 1.5 I - 0.5 V1^H V1  (into C)
  cmatmul<CMM_NEWTON>(CMat{s.Gr, s.Gi, 1, nr, true, nullptr, 1.0f},
                      CMat{s.Gr, s.Gi, nr, 1, false, nullptr, 1.0f}, nr, s.Cr,
                      s.Ci, nullptr, nullptr);
  __syncthreads();
  // V = V1 Q  (into V; V0 is no longer needed)
  cmatmul<CMM_STORE>(CMat{s.Gr, s.Gi, nr, 1, false, nullptr, 1.0f},
                     CMat{s.Cr, s.Ci, nr, 1, false, nullptr, 1.0f}, nr, s.Vr,
                     s.Vi, nullptr, nullptr);
  TWOACE_ZPROX_MARK(0)
  // constraint ladder on w = max(lam, 0): nr <= 32 values, one a lane of
  // warp 0; every sum runs over the values in index order, by shuffles
  if (tid < 32) {
    const int i = tid;
    const bool act = i < nr;
    float w = act ? fmaxf(s.lam[i], 0.0f) : 0.0f, scl = 1.0f;
    float v_tot = 0.0f;
    int rk = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      if (j < nr) {
        v_tot += wj;
        rk += (wj > w) || (wj == w && j < i);
      }
    }
    const float rank = (float)rk;
    for (int l = 0; l < levels; ++l) {
      const float rkl = l < 32 ? __shfl_sync(0xffffffffu, lad_rk, l) : ranks[l];
      const float f = l < 32 ? __shfl_sync(0xffffffffu, lad_f, l) : fracs[l];
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
  __syncthreads();
  TWOACE_ZPROX_MARK(2)
  // D = V diag(coeff) V^H  (into P)
  cmatmul<CMM_STORE>(CMat{s.Vr, s.Vi, nr, 1, false, s.coeff, 1.0f}, VH, nr,
                     s.Pr, s.Pi, nullptr, nullptr);
  __syncthreads();
  TWOACE_ZPROX_MARK(0)
  TWOACE_ZPROX_MARK_END
}

}  // namespace twoace
