// K4: batched pair-complex GEMM C[g] = A[g] @ B[g] on planar float32
// (re, im) pairs, A (G, M, K), B (G, K, N), C (G, M, N), all row-major and
// contiguous, with float32 accumulation.
//
// Replaces the TPU kernel twoace_tpu/ops/pallas/kernels.py::pair_matmul
// (body _pair_matmul_kernel), with G as an outer grid axis.  It carries the
// three products of every trip of the solver's per-op loop
// (twoace_tpu_torch/ops/admm_loop.py): A^H Y, the X-update against conj(U),
// and A X.
//
// Karatsuba 3M form, as the TPU kernel and the plain version
// (ops/cplx.py::matmul) compute it:
//   k1 = Ar (Br + Bi),  k2 = (Ar + Ai) Bi,  k3 = (Ai - Ar) Br
//   re = k1 - k2,       im = k1 + k3
// The operand sums Br + Bi, Ar + Ai and Ai - Ar are formed once, while a
// tile is staged into shared memory, so the inner loop is 3 FMAs per complex
// multiply-add (the direct 4M form needs 4).
//
// What bounds it on the H100: operations at the batch solver's shapes
// (6 M N K G flops, e.g. 5.7 GFLOP for (3, 1280, 972) @ (3, 972, 256),
// against about 30 MB of operands), and latency at the anchored refine's
// (1, 1, 80) @ (1, 80, 256) (its seed is one row: 4 output tiles, one live
// row of 64 each, and a serial walk down K).  Design, simple
// on purpose: one 256-thread block per 64x64 output tile of one g
// (blockIdx.z), K in 16-deep shared-memory stages, each thread holding a 4x4
// register tile of the three Karatsuba sums, FP32 FMA on the CUDA cores (no
// tensor cores: TF32 would not be JAX's "float32").  Ragged M, N and K
// edges are zero-filled on load and guarded on store.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 16;          // K depth of one shared-memory stage
constexpr int TM = 4;           // rows per thread
constexpr int TN = 4;           // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int A_PAD = BM + 4;   // row pitch of the K-major A tile: fewer bank
                                // conflicts on the transposing store, and
                                // still 16-byte aligned for float4 reads

__global__ void __launch_bounds__(THREADS)
pair_matmul_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ br, const float* __restrict__ bi,
                   float* __restrict__ cr, float* __restrict__ ci,
                   int m, int k, int n) {
  // A planes: Ar, Ar + Ai, Ai - Ar, stored K-major ([kk][row]);
  // B planes: Br, Bi, Br + Bi ([kk][col])
  __shared__ __align__(16) float sa[3][BK][A_PAD];
  __shared__ __align__(16) float sb[3][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);        // column group
  const int ty = tid / (BN / TN);        // row group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long g = blockIdx.z;
  const float* a_re = ar + g * m * k;
  const float* a_im = ai + g * m * k;
  const float* b_re = br + g * k * n;
  const float* b_im = bi + g * k * n;

  float k1[TM][TN], k2[TM][TN], k3[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) k1[i][j] = k2[i][j] = k3[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // stage A: 64 rows x 16 k, four entries a thread, each row's 16 k
    // read by 16 neighbouring threads
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int row = idx / BK, kk = idx % BK;
      const int gm = m0 + row, gk = k0 + kk;
      float vr = 0.0f, vi = 0.0f;
      if (gm < m && gk < k) {
        const long long o = (long long)gm * k + gk;
        vr = a_re[o];
        vi = a_im[o];
      }
      sa[0][kk][row] = vr;
      sa[1][kk][row] = vr + vi;
      sa[2][kk][row] = vi - vr;
    }
    // stage B: 16 k x 64 columns, coalesced along the columns
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int kk = idx / BN, col = idx % BN;
      const int gk = k0 + kk, gn = n0 + col;
      float vr = 0.0f, vi = 0.0f;
      if (gk < k && gn < n) {
        const long long o = (long long)gk * n + gn;
        vr = b_re[o];
        vi = b_im[o];
      }
      sb[0][kk][col] = vr;
      sb[1][kk][col] = vi;
      sb[2][kk][col] = vr + vi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_r = *reinterpret_cast<const float4*>(&sa[0][kk][ty * TM]);
      const float4 a_s = *reinterpret_cast<const float4*>(&sa[1][kk][ty * TM]);
      const float4 a_d = *reinterpret_cast<const float4*>(&sa[2][kk][ty * TM]);
      const float4 b_r = *reinterpret_cast<const float4*>(&sb[0][kk][tx * TN]);
      const float4 b_i = *reinterpret_cast<const float4*>(&sb[1][kk][tx * TN]);
      const float4 b_s = *reinterpret_cast<const float4*>(&sb[2][kk][tx * TN]);
      const float ra[TM] = {a_r.x, a_r.y, a_r.z, a_r.w};
      const float sa_[TM] = {a_s.x, a_s.y, a_s.z, a_s.w};
      const float da[TM] = {a_d.x, a_d.y, a_d.z, a_d.w};
      const float rb[TN] = {b_r.x, b_r.y, b_r.z, b_r.w};
      const float ib[TN] = {b_i.x, b_i.y, b_i.z, b_i.w};
      const float sb_[TN] = {b_s.x, b_s.y, b_s.z, b_s.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          k1[i][j] = fmaf(ra[i], sb_[j], k1[i][j]);
          k2[i][j] = fmaf(sa_[i], ib[j], k2[i][j]);
          k3[i][j] = fmaf(da[i], rb[j], k3[i][j]);
        }
    }
    __syncthreads();
  }

  float* c_re = cr + g * m * n;
  float* c_im = ci + g * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= n) continue;
      const long long o = (long long)gm * n + gn;
      c_re[o] = k1[i][j] - k2[i][j];
      c_im[o] = k1[i][j] + k3[i][j];
    }
  }
}

}  // namespace

extern "C" int twoace_pair_matmul(const float* ar, const float* ai,
                                  const float* br, const float* bi,
                                  float* cr, float* ci, int g, int m, int k,
                                  int n, void* stream) {
  if (g == 0 || m == 0 || n == 0) return 0;
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((m + BM - 1) / BM),
                  (unsigned)g);
  pair_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      ar, ai, br, bi, cr, ci, m, k, n);
  return (int)cudaGetLastError();
}
