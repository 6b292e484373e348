// K1: fused magnitude prox + M-dual update on transposed (lanes, r, m) pairs.
//
// Replaces the TPU kernel twoace_tpu/ops/pallas/kernels.py::fused_prox_dual_t
// (body _prox_dual_t_kernel).  It also carries the elementwise pass-2 form
// (twoace_tpu/ops/pair_solver.py::magnitude_prox_cols_elem), which the JAX
// package computes only inside its megakernel.
//
//   y  = prox(ax + M/mu)        norm over r per column (per_entry = 0)
//                               or per entry (per_entry = 1)
//   M' = M + mu (ax - y)
//
// What bounds it on the H100: bytes.  Each call reads 4 planes and writes 4
// planes of lanes*r*m floats (plus b and mu) and does ~20 flops per entry,
// far under the card's flop:byte ratio.  Design: one thread per
// (lane, column j), looping over r with stride m, so the 32 threads of a
// warp touch 32 neighbouring addresses of each row (coalesced 128-byte
// transactions).  The row pass reads ax/M twice (once for the norm, once
// for the outputs); the second read hits L1/L2, so DRAM traffic stays at
// one read and one write of each plane.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn), as
// the plain PyTorch version rounds it: an FMA contraction of ax + M/mu
// changes the direction of a near-cancelling entry by more than the
// kernel's tolerance.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void prox_dual_t_kernel(
    const float* __restrict__ ax_re, const float* __restrict__ ax_im,
    const float* __restrict__ md_re, const float* __restrict__ md_im,
    const float* __restrict__ b, const float* __restrict__ mu_lane,
    float* __restrict__ y_re, float* __restrict__ y_im,
    float* __restrict__ mo_re, float* __restrict__ mo_im,
    int lanes, int r, int m, int per_entry, float inv_sqrt_r) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)lanes * m) return;
  const int lane = (int)(idx / m);
  const int j = (int)(idx - (long long)lane * m);
  const float mu = mu_lane[lane];
  const float inv_mu = 1.0f / mu;
  const float bj = b[(long long)lane * m + j];
  // (b / d + mu) / (1 + mu) * (b > 0)
  const float active = bj > 0.0f ? 1.0f : 0.0f;
  const float one_mu = 1.0f + mu;
  const long long base = (long long)lane * r * m + j;

  if (!per_entry) {
    float d2 = 0.0f;
    for (int k = 0; k < r; ++k) {
      const long long o = base + (long long)k * m;
      const float yr = add(ax_re[o], mul(md_re[o], inv_mu));
      const float yi = add(ax_im[o], mul(md_im[o], inv_mu));
      d2 = add(d2, add(mul(yr, yr), mul(yi, yi)));
    }
    const bool zero = d2 <= 0.0f;
    const float d = sqrtf(zero ? 1.0f : d2);
    const float coeff = mul(add(bj / d, mu) / one_mu, active);
    for (int k = 0; k < r; ++k) {
      const long long o = base + (long long)k * m;
      const float axr = ax_re[o], axi = ax_im[o];
      const float mdr = md_re[o], mdi = md_im[o];
      const float yr = zero ? inv_sqrt_r : add(axr, mul(mdr, inv_mu));
      const float yi = zero ? 0.0f : add(axi, mul(mdi, inv_mu));
      const float outr = mul(yr, coeff), outi = mul(yi, coeff);
      y_re[o] = outr;
      y_im[o] = outi;
      mo_re[o] = add(mdr, mul(mu, sub(axr, outr)));
      mo_im[o] = add(mdi, mul(mu, sub(axi, outi)));
    }
  } else {
    for (int k = 0; k < r; ++k) {
      const long long o = base + (long long)k * m;
      const float axr = ax_re[o], axi = ax_im[o];
      const float mdr = md_re[o], mdi = md_im[o];
      float yr = add(axr, mul(mdr, inv_mu));
      const float yi = add(axi, mul(mdi, inv_mu));
      const float d2 = add(mul(yr, yr), mul(yi, yi));
      const bool zero = d2 <= 0.0f;
      if (zero) yr = 1.0f;
      const float d = sqrtf(zero ? 1.0f : d2);
      const float coeff = mul(add(bj / d, mu) / one_mu, active);
      const float outr = mul(yr, coeff), outi = mul(yi, coeff);
      y_re[o] = outr;
      y_im[o] = outi;
      mo_re[o] = add(mdr, mul(mu, sub(axr, outr)));
      mo_im[o] = add(mdi, mul(mu, sub(axi, outi)));
    }
  }
}

}  // namespace

extern "C" int twoace_prox_dual_t(
    const float* ax_re, const float* ax_im, const float* md_re,
    const float* md_im, const float* b, const float* mu, float* y_re,
    float* y_im, float* mo_re, float* mo_im, int lanes, int r, int m,
    int per_entry, void* stream) {
  const long long total = (long long)lanes * m;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const float inv_sqrt_r = (float)(1.0 / sqrt((double)r));
  prox_dual_t_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      ax_re, ax_im, md_re, md_im, b, mu, y_re, y_im, mo_re, mo_im, lanes, r,
      m, per_entry, inv_sqrt_r);
  return (int)cudaGetLastError();
}
