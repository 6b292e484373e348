// K2: warm spectral-profile Z-prox, one block per lane.
//
// Replaces the TPU kernels twoace_tpu/ops/pallas/kernels.py::fused_zprox_t
// (body _zprox_kernel) and ::fused_zprox_batch (body _zprox_batch_kernel).
// The batched Pallas kernel packed 128/nr instances block-diagonally into
// one 128x128 MXU tile; here the batch is simply the grid: block b owns
// lane b, and every per-lane nr x nr matrix lives in its shared memory.
//
// Per lane, on W = z.reshape(r*nt, nr) (a free view of the transposed
// state, whose Gram W^H W is the conjugate of the panel Gram E E^H):
//   G  = W^H W;  G' = V0^H G V0;  lam = diag(G')
//   C  = G'_ij / (lam_j - lam_i)   masked where |gap| <= 1e-3 (|l_i|+|l_j|),
//        projected anti-Hermitian, capped at ||C||_F <= 0.7
//   V  = V0 (I + C);  one Newton-Schulz step V <- V (1.5 I - 0.5 V^H V)
//   s  = ladder scales of max(lam, 0), ranked pairwise (no sort), with the
//        ladder as runtime data and 1/max(f, 1e-30) guarding padded levels
//   W' = W + W V diag(sqrt(s) - 1) V^H
// The basis arrives and leaves in the E-convention and is conjugated to the
// W-convention here, as the Pallas wrapper does at its boundary.
//
// What bounds it on the H100: neither flops nor bytes but latency.  Per lane
// it streams W (r*nt*nr complex, 51 KB at r = 20, 16x16) twice from global
// memory -- once for the Gram, once for the delta apply -- and runs a chain
// of seven dependent nr x nr complex products and two block reductions, each
// separated by a barrier.  Design: only nr x nr matrices are kept in shared
// memory (8 of them plus two nr-vectors: 8 KB at nr = 16, 33 KB at nr = 32,
// under the 48 KB default, no opt-in), one thread per matrix entry, and one
// block per lane so the 192 lanes of the main path fill the 132 SMs.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kRelGap = 1e-3f;
constexpr float kMaxNorm = 0.7f;

__device__ float block_sum(float v, float* red) {
  // every thread passes its partial; all threads get the total
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lanei = threadIdx.x & 31;
  __syncthreads();
  if (lanei == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

__global__ void zprox_kernel(
    const float* __restrict__ z_re, const float* __restrict__ z_im,
    const float* __restrict__ v0_re, const float* __restrict__ v0_im,
    const float* __restrict__ ranks, const float* __restrict__ fracs,
    float* __restrict__ zn_re, float* __restrict__ zn_im,
    float* __restrict__ vn_re, float* __restrict__ vn_im,
    int rows, int nr, int levels) {
  extern __shared__ float smem[];
  const int nn = nr * nr;
  float* Vr = smem;          float* Vi = Vr + nn;
  float* Gr = Vi + nn;       float* Gi = Gr + nn;
  float* Pr = Gi + nn;       float* Pi = Pr + nn;
  float* Cr = Pi + nn;       float* Ci = Cr + nn;
  float* lam = Ci + nn;      float* coeff = lam + nr;
  float* red = coeff + nr;   // kThreads / 32 partial sums

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const long long zoff = (long long)lane * rows * nr;
  const float* wr = z_re + zoff;
  const float* wi = z_im + zoff;

  // V0 in the W-convention: conj of the E-convention basis
  for (int e = tid; e < nn; e += blockDim.x) {
    Vr[e] = v0_re[(long long)lane * nn + e];
    Vi[e] = -v0_im[(long long)lane * nn + e];
  }
  // G = W^H W, one entry (p, q) per thread, rows streamed from global
  for (int e = tid; e < nn; e += blockDim.x) {
    const int p = e / nr, q = e - p * nr;
    float sr = 0.0f, si = 0.0f;
    for (int k = 0; k < rows; ++k) {
      const float ar = wr[k * nr + p], ai = wi[k * nr + p];
      const float br = wr[k * nr + q], bi = wi[k * nr + q];
      sr += ar * br + ai * bi;
      si += ar * bi - ai * br;
    }
    Gr[e] = sr;
    Gi[e] = si;
  }
  __syncthreads();
  // P = G V0
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = Gr[i * nr + p], ai = Gi[i * nr + p];
      const float br = Vr[p * nr + j], bi = Vi[p * nr + j];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    Pr[e] = sr;
    Pi[e] = si;
  }
  __syncthreads();
  // G' = V0^H P  (into G)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = Vr[p * nr + i], ai = -Vi[p * nr + i];
      const float br = Pr[p * nr + j], bi = Pi[p * nr + j];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    Gr[e] = sr;
    Gi[e] = si;
  }
  __syncthreads();
  for (int i = tid; i < nr; i += blockDim.x) lam[i] = Gr[i * nr + i];
  __syncthreads();
  // first-order correction C_ij = G'_ij / (lam_j - lam_i), masked
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    const float gap = lam[j] - lam[i];
    const float mag = fabsf(lam[j]) + fabsf(lam[i]);
    const bool ok = fabsf(gap) > kRelGap * fmaxf(mag, 1e-30f);
    Cr[e] = ok ? Gr[e] / gap : 0.0f;
    Ci[e] = ok ? Gi[e] / gap : 0.0f;
  }
  __syncthreads();
  // anti-Hermitian projection (into P) and its Frobenius norm
  float part = 0.0f;
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    const float cr = 0.5f * (Cr[e] - Cr[j * nr + i]);
    const float ci = 0.5f * (Ci[e] + Ci[j * nr + i]);
    Pr[e] = cr;
    Pi[e] = ci;
    part += cr * cr + ci * ci;
  }
  const float fro = sqrtf(block_sum(part, red));
  const float capped = fminf(1.0f, kMaxNorm / fmaxf(fro, 1e-30f));
  // V1 = V0 + V0 (capped C)  (into G)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = Vr[i * nr + p], ai = Vi[i * nr + p];
      const float br = Pr[p * nr + j] * capped, bi = Pi[p * nr + j] * capped;
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    Gr[e] = Vr[e] + sr;
    Gi[e] = Vi[e] + si;
  }
  __syncthreads();
  // Newton-Schulz: Q = 1.5 I - 0.5 V1^H V1  (into C)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = Gr[p * nr + i], ai = -Gi[p * nr + i];
      const float br = Gr[p * nr + j], bi = Gi[p * nr + j];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    Cr[e] = (i == j ? 1.5f : 0.0f) - 0.5f * sr;
    Ci[e] = -0.5f * si;
  }
  __syncthreads();
  // V = V1 Q  (into V; V0 is no longer needed)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int i = e / nr, j = e - i * nr;
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = Gr[i * nr + p], ai = Gi[i * nr + p];
      const float br = Cr[p * nr + j], bi = Ci[p * nr + j];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    Vr[e] = sr;
    Vi[e] = si;
  }
  // constraint ladder on w = max(lam, 0): nr <= 32 values, one thread
  if (tid == 0) {
    float w[32], scl[32], rank[32];
    float v_tot = 0.0f;
    for (int i = 0; i < nr; ++i) {
      w[i] = fmaxf(lam[i], 0.0f);
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
      const float rk = ranks[lane * levels + l];
      const float f = fracs[lane * levels + l];
      float vr = 0.0f;
      for (int i = 0; i < nr; ++i) vr += rank[i] < rk ? w[i] : 0.0f;
      const bool need = vr < v_tot * f;
      float s = fminf(1.0f, vr / fmaxf(v_tot - vr, 1e-30f) *
                                (1.0f / fmaxf(f, 1e-30f) - 1.0f));
      if (!need) s = 1.0f;
      v_tot = 0.0f;
      for (int i = 0; i < nr; ++i) {
        const float mult = rank[i] < rk ? 1.0f : s;
        w[i] *= mult;
        scl[i] *= mult;
        v_tot += w[i];
      }
    }
    for (int i = 0; i < nr; ++i) coeff[i] = sqrtf(scl[i]) - 1.0f;
  }
  __syncthreads();
  // D = V diag(coeff) V^H  (into P)
  for (int e = tid; e < nn; e += blockDim.x) {
    const int p = e / nr, q = e - p * nr;
    float sr = 0.0f, si = 0.0f;
    for (int i = 0; i < nr; ++i) {
      const float ar = Vr[p * nr + i] * coeff[i], ai = Vi[p * nr + i] * coeff[i];
      const float br = Vr[q * nr + i], bi = -Vi[q * nr + i];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    Pr[e] = sr;
    Pi[e] = si;
  }
  __syncthreads();
  // W' = W + W D, rows streamed from global again; neighbouring threads
  // write neighbouring addresses
  float* onr = zn_re + zoff;
  float* oni = zn_im + zoff;
  for (long long e = tid; e < (long long)rows * nr; e += blockDim.x) {
    const int k = (int)(e / nr), q = (int)(e - (long long)k * nr);
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = wr[k * nr + p], ai = wi[k * nr + p];
      const float br = Pr[p * nr + q], bi = Pi[p * nr + q];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    onr[e] = wr[e] + sr;
    oni[e] = wi[e] + si;
  }
  // new basis back in the E-convention
  for (int e = tid; e < nn; e += blockDim.x) {
    vn_re[(long long)lane * nn + e] = Vr[e];
    vn_im[(long long)lane * nn + e] = -Vi[e];
  }
}

}  // namespace

extern "C" int twoace_zprox_t(
    const float* z_re, const float* z_im, const float* v0_re,
    const float* v0_im, const float* ranks, const float* fracs,
    float* zn_re, float* zn_im, float* vn_re, float* vn_im, int lanes,
    int rows, int nr, int levels, void* stream) {
  if (lanes == 0) return 0;
  if (nr < 1 || nr > 32) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (8 * nr * nr + 2 * nr + kThreads / 32);
  zprox_kernel<<<lanes, kThreads, smem, (cudaStream_t)stream>>>(
      z_re, z_im, v0_re, v0_im, ranks, fracs, zn_re, zn_im, vn_re, vn_im,
      rows, nr, levels);
  return (int)cudaGetLastError();
}
