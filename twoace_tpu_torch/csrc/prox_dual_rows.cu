// K5: fused magnitude prox + M-dual update on row-layout (..., m, r)
// complex state, read in place as interleaved (re, im).
//
// Replaces the TPU kernel twoace_tpu/ops/pallas/kernels.py::fused_prox_dual
// (body _prox_dual_kernel), which the complex-dtype solver family
// (twoace_tpu/ops/admm.py::infer_admm, Y-update and M-dual) computes in
// XLA.  Per row i of the flattened (rows, r) state:
//
//   y   = ax + M / mu,   d2 = sum_r |y|^2      (per_entry = 0)
//   rows with d2 = 0 get y = 1/sqrt(r), d = 1
//   c   = (b / d + mu) / (1 + mu) * [b > 0]
//   out = (y c,  M + mu (ax - y c))
//
// per_entry = 1 is the elementwise form (the norm of each entry, zero
// entries get y = 1), which the per-column pass of inferLowRankImpl runs.
//
// What bounds it on the H100: bytes.  A call reads ax, M (2 complex planes)
// and b and writes 2 complex planes; about 20 flops per complex entry is far
// under the card's flop:byte ratio.  Design: a warp covers a contiguous run
// of rows.  Each row gets a segment of `seg` lanes (the power of two >= r,
// at most 32), so the lanes of a warp read neighbouring complex entries
// (coalesced float2 / double2 loads) and the row norm is a segmented
// shuffle-xor reduction in a fixed order.  For r > 32 each lane strides
// over its row.  The second read of a row hits L1, so DRAM traffic stays
// at one read and one write of each plane.
//
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn and the double forms), as the plain PyTorch version
// rounds it: FMA contraction of ax + M/mu changes near-cancelling entries
// by more than the kernel's tolerance.  M / mu is a division, as in the
// plain version, not a multiplication by 1/mu.
//
// Templated on float (complex64) and double (complex128).  Plain C
// interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T> struct R;

template <> struct R<float> {
  using T2 = float2;
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
};

template <> struct R<double> {
  using T2 = double2;
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }
};

template <typename T>
__global__ void prox_dual_rows_kernel(
    const typename R<T>::T2* __restrict__ ax,
    const typename R<T>::T2* __restrict__ md, const T* __restrict__ b,
    const T* __restrict__ mu_ptr, typename R<T>::T2* __restrict__ y,
    typename R<T>::T2* __restrict__ mo, long long rows, int r, int seg,
    int per_entry, T inv_sqrt_r) {
  using O = R<T>;
  using T2 = typename R<T>::T2;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long row = warp * (32 / seg) + lane / seg;
  const int k0 = lane & (seg - 1);
  const bool live = row < rows;
  const T zero_t = T(0), one_t = T(1);
  const T mu = *mu_ptr;
  const T one_mu = O::add(one_t, mu);
  const T bi = live ? b[row] : zero_t;
  const T active = bi > zero_t ? one_t : zero_t;
  const long long base = row * (long long)r;

  if (!per_entry) {
    T d2 = zero_t;
    if (live) {
      for (int k = k0; k < r; k += seg) {
        const T2 a = ax[base + k], m = md[base + k];
        const T yr = O::add(a.x, O::div(m.x, mu));
        const T yi = O::add(a.y, O::div(m.y, mu));
        d2 = O::add(d2, O::add(O::mul(yr, yr), O::mul(yi, yi)));
      }
    }
    // every lane of the warp takes part in the segmented reduction
    for (int off = seg >> 1; off > 0; off >>= 1)
      d2 = O::add(d2, __shfl_xor_sync(0xffffffffu, d2, off));
    if (!live) return;
    const bool zero = d2 <= zero_t;
    const T d = O::sqrt_(zero ? one_t : d2);
    const T coeff = O::mul(O::div(O::add(O::div(bi, d), mu), one_mu), active);
    for (int k = k0; k < r; k += seg) {
      const T2 a = ax[base + k], m = md[base + k];
      const T yr = zero ? inv_sqrt_r : O::add(a.x, O::div(m.x, mu));
      const T yi = zero ? zero_t : O::add(a.y, O::div(m.y, mu));
      T2 out, dual;
      out.x = O::mul(yr, coeff);
      out.y = O::mul(yi, coeff);
      dual.x = O::add(m.x, O::mul(mu, O::sub(a.x, out.x)));
      dual.y = O::add(m.y, O::mul(mu, O::sub(a.y, out.y)));
      y[base + k] = out;
      mo[base + k] = dual;
    }
  } else {
    if (!live) return;
    for (int k = k0; k < r; k += seg) {
      const T2 a = ax[base + k], m = md[base + k];
      T yr = O::add(a.x, O::div(m.x, mu));
      T yi = O::add(a.y, O::div(m.y, mu));
      const T d2 = O::add(O::mul(yr, yr), O::mul(yi, yi));
      const bool zero = d2 <= zero_t;
      if (zero) {
        yr = one_t;
        yi = zero_t;
      }
      const T d = O::sqrt_(zero ? one_t : d2);
      const T coeff =
          O::mul(O::div(O::add(O::div(bi, d), mu), one_mu), active);
      T2 out, dual;
      out.x = O::mul(yr, coeff);
      out.y = O::mul(yi, coeff);
      dual.x = O::add(m.x, O::mul(mu, O::sub(a.x, out.x)));
      dual.y = O::add(m.y, O::mul(mu, O::sub(a.y, out.y)));
      y[base + k] = out;
      mo[base + k] = dual;
    }
  }
}

template <typename T>
int launch(const void* ax, const void* md, const void* b, const void* mu,
           void* y, void* mo, long long rows, int r, int per_entry,
           cudaStream_t stream) {
  using T2 = typename R<T>::T2;
  int seg = 1;
  while (seg < r && seg < 32) seg <<= 1;
  const int threads = 256;
  const long long rows_per_block = (long long)(threads / 32) * (32 / seg);
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  const T inv_sqrt_r = (T)(1.0 / sqrt((double)r));
  prox_dual_rows_kernel<T><<<blocks, threads, 0, stream>>>(
      (const T2*)ax, (const T2*)md, (const T*)b, (const T*)mu, (T2*)y,
      (T2*)mo, rows, r, seg, per_entry, inv_sqrt_r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int twoace_prox_dual_rows(const void* ax, const void* md,
                                     const void* b, const void* mu, void* y,
                                     void* mo, long long rows, int r,
                                     int per_entry, int is_double,
                                     void* stream) {
  if (rows <= 0 || r <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch<double>(ax, md, b, mu, y, mo, rows, r, per_entry, s)
                   : launch<float>(ax, md, b, mu, y, mo, rows, r, per_entry, s);
}
