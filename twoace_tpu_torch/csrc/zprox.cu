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
// G = W^H W, then the chain of zprox_core.cuh (perturbative basis update,
// constraint ladder, D = V diag(sqrt(s) - 1) V^H), then W' = W + W D.
// The basis arrives and leaves in the E-convention and is conjugated to the
// W-convention here, as the Pallas wrapper does at its boundary.
//
// What bounds it on the H100: neither flops nor bytes but latency.  Per lane
// it streams W (r*nt*nr complex, 51 KB at r = 20, 16x16) twice from global
// memory -- once for the Gram, once for the delta apply -- and runs a chain
// of seven dependent nr x nr complex products and two block reductions, each
// separated by a barrier.  Design: only nr x nr matrices are kept in shared
// memory (8 of them plus two nr-vectors: 8 KB at nr = 16, 33 KB at nr = 32,
// under the 48 KB default, no opt-in), the chain's products 3xTF32 on the
// tensor cores and its ladder on one warp (zprox_core.cuh, shared with K3),
// and one block per lane so the 192 lanes of the main path fill the 132
// SMs.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "zprox_core.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void zprox_kernel(
    const float* __restrict__ z_re, const float* __restrict__ z_im,
    const float* __restrict__ v0_re, const float* __restrict__ v0_im,
    const float* __restrict__ ranks, const float* __restrict__ fracs,
    float* __restrict__ zn_re, float* __restrict__ zn_im,
    float* __restrict__ vn_re, float* __restrict__ vn_im,
    int rows, int nr, int levels) {
  extern __shared__ float smem[];
  const twoace::ZproxSmem s = twoace::zprox_smem(smem, nr);
  const int nn = nr * nr;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const long long zoff = (long long)lane * rows * nr;
  const float* wr = z_re + zoff;
  const float* wi = z_im + zoff;

  // V0 in the W-convention: conj of the E-convention basis
  for (int e = tid; e < nn; e += blockDim.x) {
    s.Vr[e] = v0_re[(long long)lane * nn + e];
    s.Vi[e] = -v0_im[(long long)lane * nn + e];
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
    s.Gr[e] = sr;
    s.Gi[e] = si;
  }
  twoace::zprox_basis_delta(s, nr, ranks + lane * levels,
                            fracs + lane * levels, levels);
  // W' = W + W D, rows streamed from global again; neighbouring threads
  // write neighbouring addresses
  float* onr = zn_re + zoff;
  float* oni = zn_im + zoff;
  for (long long e = tid; e < (long long)rows * nr; e += blockDim.x) {
    const int k = (int)(e / nr), q = (int)(e - (long long)k * nr);
    float sr = 0.0f, si = 0.0f;
    for (int p = 0; p < nr; ++p) {
      const float ar = wr[k * nr + p], ai = wi[k * nr + p];
      const float br = s.Pr[p * nr + q], bi = s.Pi[p * nr + q];
      sr += ar * br - ai * bi;
      si += ar * bi + ai * br;
    }
    onr[e] = wr[e] + sr;
    oni[e] = wi[e] + si;
  }
  // new basis back in the E-convention
  for (int e = tid; e < nn; e += blockDim.x) {
    vn_re[(long long)lane * nn + e] = s.Vr[e];
    vn_im[(long long)lane * nn + e] = -s.Vi[e];
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
  const size_t smem = sizeof(float) * twoace::zprox_smem_floats(nr, kThreads);
  zprox_kernel<<<lanes, kThreads, smem, (cudaStream_t)stream>>>(
      z_re, z_im, v0_re, v0_im, ranks, fracs, zn_re, zn_im, vn_re, vn_im,
      rows, nr, levels);
  return (int)cudaGetLastError();
}
