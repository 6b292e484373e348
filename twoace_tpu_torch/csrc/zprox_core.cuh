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
// shared memory, one thread per entry.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace twoace {

constexpr float kRelGap = 1e-3f;
constexpr float kMaxNorm = 0.7f;

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

// Called by every thread of the block with G in s.G and the warm basis V0
// (W-convention) in s.V, both complete.  Leaves the new basis in s.V and
// D in s.P, followed by a barrier.  ranks/fracs: this lane's ladder.
__device__ inline void zprox_basis_delta(const ZproxSmem& s, int nr,
                                         const float* ranks,
                                         const float* fracs, int levels) {
  const int nn = nr * nr;
  const int tid = threadIdx.x;
  __syncthreads();
  // P = G V0
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = s.Gr[i * nr + p], ai = s.Gi[i * nr + p];
      const float br = s.Vr[p * nr + j], bi = s.Vi[p * nr + j];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    s.Pr[e] = sr;
    s.Pi[e] = si;
  }
  __syncthreads();
  // G' = V0^H P  (into G)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = s.Vr[p * nr + i], ai = -s.Vi[p * nr + i];
      const float br = s.Pr[p * nr + j], bi = s.Pi[p * nr + j];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    s.Gr[e] = sr;
    s.Gi[e] = si;
  }
  __syncthreads();
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
  // V1 = V0 + V0 (capped C)  (into G)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = s.Vr[i * nr + p], ai = s.Vi[i * nr + p];
      const float br = s.Pr[p * nr + j] * capped, bi = s.Pi[p * nr + j] * capped;
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    s.Gr[e] = s.Vr[e] + sr;
    s.Gi[e] = s.Vi[e] + si;
  }
  __syncthreads();
  // Newton-Schulz: Q = 1.5 I - 0.5 V1^H V1  (into C)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = s.Gr[p * nr + i], ai = -s.Gi[p * nr + i];
      const float br = s.Gr[p * nr + j], bi = s.Gi[p * nr + j];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    s.Cr[e] = (i == j ? 1.5f : 0.0f) - 0.5f * sr;
    s.Ci[e] = -0.5f * si;
  }
  __syncthreads();
  // V = V1 Q  (into V; V0 is no longer needed)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = s.Gr[i * nr + p], ai = s.Gi[i * nr + p];
      const float br = s.Cr[p * nr + j], bi = s.Ci[p * nr + j];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    s.Vr[e] = sr;
    s.Vi[e] = si;
  }
  // constraint ladder on w = max(lam, 0): nr <= 32 values, one thread
  if (tid == 0) {
    float w[32], scl[32], rank[32];
    float v_tot = 0.0f;
    for (int i = 0; i < nr; ++i) {
      w[i] = fmaxf(s.lam[i], 0.0f);
      scl[i] = 1.0f;
      v_tot += w[i];
    }
    for (int i = 0; i < nr; ++i) {
      int rk = 0;
      for (int j = 0; j < nr; ++j)
        rk += (w[j] > w[i]) || (w[j] == w[i] && j < i);
      rank[i] = (float)rk;
    }
    for (int l = 0; l < levels; ++l) {
      const float rk = ranks[l];
      const float f = fracs[l];
      float vr = 0.0f;
      for (int i = 0; i < nr; ++i) vr += rank[i] < rk ? w[i] : 0.0f;
      const bool need = vr < v_tot * f;
      float sc = fminf(1.0f, vr / fmaxf(v_tot - vr, 1e-30f) *
                                 (1.0f / fmaxf(f, 1e-30f) - 1.0f));
      if (!need) sc = 1.0f;
      v_tot = 0.0f;
      for (int i = 0; i < nr; ++i) {
        const float mult = rank[i] < rk ? 1.0f : sc;
        w[i] *= mult;
        scl[i] *= mult;
        v_tot += w[i];
      }
    }
    for (int i = 0; i < nr; ++i) s.coeff[i] = sqrtf(scl[i]) - 1.0f;
  }
  __syncthreads();
  // D = V diag(coeff) V^H  (into P)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int p = e / nr, q = e - p * nr;
    float sr = 0.0f, si = 0.0f;
    for (int i = 0; i < nr; ++i) {
      const float ar = s.Vr[p * nr + i] * s.coeff[i], ai = s.Vi[p * nr + i] * s.coeff[i];
      const float br = s.Vr[q * nr + i], bi = -s.Vi[q * nr + i];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    s.Pr[e] = sr;
    s.Pi[e] = si;
  }
  __syncthreads();
}

}  // namespace twoace
