// 3xTF32 tensor-core products and cp.async copies, shared by K4
// (pair_matmul.cu), K3 (infer_admm.cu) and K2 (zprox.cu, zprox_core.cuh).
//
// Precision: every float32 operand x is split into TF32 halves
// big = rna(x) and small = rna(x - big), and each real product is
// small*big + big*small + big*big on the tensor cores (mma.sync.m16n8k8),
// about 2^-22 per product against plain TF32's 2^-11; small*small is below
// float32's rounding.  The split adds half a TF32 ulp to the bit pattern
// and lets the MMA ignore the low 13 bits, as CUTLASS's fast 3xTF32 does.
// The three products of a k8 step start from zero in a fresh register and
// are added to the running sum in float32 (round to nearest): the tensor
// cores' own accumulation truncates, and into a long-running sum that bias
// grows with K (PERF.md, the K4 tile table).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace twoace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte copy, L2 only; src_size 0 zero-fills the destination
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 16-byte copy, L2 only, of the first `bytes` (0 ... 16) of src; the rest
// of the destination is zero-filled
__device__ __forceinline__ void cp16n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small to about 2^-22 relative, both TF32, rounded to nearest
// (ties away from zero) by integer adds, as CUTLASS's fast 3xTF32 does:
// half a TF32 ulp added to the bit pattern, and the MMA reads only a .tf32
// operand's top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma_tf32 without `volatile`: a pure function of its operands, which the
// compiler may schedule among independent work (K2 and the Z-prox chain,
// where a warp's tiles are latency-bound)
__device__ __forceinline__ void mma_tf32_nv(float* c, const uint32_t* a,
                                            const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k8 step of a complex m16 x n8 tile in 3xTF32, Karatsuba 3M: for
// each of the three real products p (A's (re, re + im, im - re) halves
// against B's (re + im, im, re) halves), small*big, big*small and big*big
// summed from zero on the tensor cores and flushed into acc[p] in
// float32, the three products' chains interleaved step by step.  For the
// short products of K2 and the Z-prox chain.
__device__ __forceinline__ void mma3_step(float (&acc)[3][4],
                                          const uint32_t (&ab)[3][4],
                                          const uint32_t (&as)[3][4],
                                          const uint32_t (&bb)[3][2],
                                          const uint32_t (&bs)[3][2]) {
  float d[3][4];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) d[p][q] = 0.0f;
#pragma unroll
  for (int step = 0; step < 3; ++step)
#pragma unroll
    for (int p = 0; p < 3; ++p)
      mma_tf32_nv(d[p], step == 0 ? as[p] : ab[p], step == 1 ? bs[p] : bb[p]);
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] += d[p][q];
}

// c += a b in 3xTF32, the small terms first: the three products are
// summed into a fresh register from zero and added to c with a float32 add
// that rounds to nearest.
__device__ __forceinline__ void mma3(float* c, const uint32_t* a_big,
                                     const uint32_t* a_small,
                                     const uint32_t* b_big,
                                     const uint32_t* b_small) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] += d[q];
}

__host__ __device__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

}  // namespace twoace
