// K6: a chain of batched complex n x n products on planar float32 pairs,
// renormalised after every step.
//
// Replaces the TPU kernel scripts/bench_pallas_mm.py::run_pallas (body
// chain_kernel), the microbenchmark behind the Z-prox's batched nr x nr
// product chain.  For each instance b, `steps` times:
//
//   k1 = Vr (Gr + Gi),  k2 = (Vr + Vi) Gi,  k3 = (Vi - Vr) Gr   (Karatsuba 3M)
//   Vr, Vi = k1 - k2, k1 + k3
//   s = rsqrt(sum |V|^2 + 1e-30);  V = V s
//
// Layout: batch-major (B, n, n) planes, row-major within an instance.  The
// TPU kernel kept the instance axis on the lanes, (n, n, B); a caller with
// that layout transposes once (ops/kernels/chain_mm.py says where).
//
// What bounds it on the H100: neither bytes nor operations.  At the
// benchmark's B = 256, n = 16 and 8 steps a launch moves 1.57 MB (0.47 us at
// 3.35 TB/s) and does 50.3 MFLOP (0.75 us at 67 TFLOP/s); the launch and
// the steps' dependent chain of block-wide barriers take longer.  Design,
// simple first: one block per instance (so any B works, and no sum crosses
// blocks), one thread per output entry, V and G in shared memory for all
// steps.  G's Karatsuba sum Gr + Gi is formed once; V's two sums Vr + Vi
// and Vi - Vr are formed by each thread for its own entry at the end of a
// step, so the inner product loop reads three shared rows and three shared
// columns.  The norm is a block reduction in a fixed order: a shuffle tree
// in each warp, then warp 0 adds the warps' sums in order.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), summing k in order, as the plain version's float32 products
// do; 1/sqrt is the correctly rounded __frsqrt_rn.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;  // n * n threads, at most 1024

__device__ __forceinline__ float block_sum(float v, float* red, int nwarps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    if (lane == 0)
      for (int w = 0; w < nwarps; ++w) s = __fadd_rn(s, red[w]);
    if (lane == 0) red[kMaxN] = s;
  }
  __syncthreads();
  return red[kMaxN];
}

__global__ void chain_mm_kernel(const float* __restrict__ vr,
                                const float* __restrict__ vi,
                                const float* __restrict__ gr,
                                const float* __restrict__ gi,
                                float* __restrict__ out_r,
                                float* __restrict__ out_i, int n, int steps) {
  extern __shared__ float sm[];
  const int nn = n * n;
  float* s_vr = sm;            // Vr
  float* s_vp = sm + nn;       // Vr + Vi
  float* s_vm = sm + 2 * nn;   // Vi - Vr
  float* s_gs = sm + 3 * nn;   // Gr + Gi
  float* s_gi = sm + 4 * nn;   // Gi
  float* s_gr = sm + 5 * nn;   // Gr
  float* red = sm + 6 * nn;    // warp sums, then the total at red[kMaxN]

  const int t = threadIdx.x;
  const bool live = t < nn;
  const long long base = (long long)blockIdx.x * nn;
  const int i = live ? t / n : 0, j = live ? t % n : 0;
  const int nwarps = (blockDim.x + 31) >> 5;

  float re = 0.f, im = 0.f;
  if (live) {
    re = vr[base + t];
    im = vi[base + t];
    const float a = gr[base + t], b = gi[base + t];
    s_gr[t] = a;
    s_gi[t] = b;
    s_gs[t] = __fadd_rn(a, b);
    s_vr[t] = re;
    s_vp[t] = __fadd_rn(re, im);
    s_vm[t] = __fsub_rn(im, re);
  }
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    float p = 0.f;
    if (live) {
      const float* rr = s_vr + i * n;
      const float* rp = s_vp + i * n;
      const float* rm = s_vm + i * n;
      float k1 = __fmul_rn(rr[0], s_gs[j]);
      float k2 = __fmul_rn(rp[0], s_gi[j]);
      float k3 = __fmul_rn(rm[0], s_gr[j]);
      for (int k = 1; k < n; ++k) {
        k1 = __fadd_rn(k1, __fmul_rn(rr[k], s_gs[k * n + j]));
        k2 = __fadd_rn(k2, __fmul_rn(rp[k], s_gi[k * n + j]));
        k3 = __fadd_rn(k3, __fmul_rn(rm[k], s_gr[k * n + j]));
      }
      re = __fsub_rn(k1, k2);
      im = __fadd_rn(k1, k3);
      p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
    }
    // block_sum's first barrier also ends every thread's reads of V
    const float scale = __frsqrt_rn(__fadd_rn(block_sum(p, red, nwarps), 1e-30f));
    if (live) {
      re = __fmul_rn(re, scale);
      im = __fmul_rn(im, scale);
      s_vr[t] = re;
      s_vp[t] = __fadd_rn(re, im);
      s_vm[t] = __fsub_rn(im, re);
    }
    __syncthreads();
  }
  if (live) {
    out_r[base + t] = re;
    out_i[base + t] = im;
  }
}

}  // namespace

extern "C" int twoace_chain_mm(const void* vr, const void* vi, const void* gr,
                               const void* gi, void* out_r, void* out_i,
                               int batch, int n, int steps, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  const int threads = ((n * n + 31) / 32) * 32;
  const size_t smem = (6 * n * n + kMaxN + 1) * sizeof(float);
  chain_mm_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      (const float*)vr, (const float*)vi, (const float*)gr, (const float*)gi,
      (float*)out_r, (float*)out_i, n, steps);
  return (int)cudaGetLastError();
}
