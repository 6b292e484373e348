// K4: batched pair-complex GEMM C[g] = A[g] @ B[g] on planar float32
// (re, im) pairs, A (G, M, K), B (G, K, N), C (G, M, N), all row-major and
// contiguous, at float32 accuracy.
//
// Replaces the TPU kernel twoace_tpu/ops/pallas/kernels.py::pair_matmul
// (body _pair_matmul_kernel), with G as an outer grid axis.  It carries the
// three products of every trip of the solver's per-op loop
// (twoace_tpu_torch/ops/admm_loop.py): A^H Y, the X-update against conj(U),
// and A X.  Two routes, picked by the wrapper from the shape alone
// (ops/kernels/pair_matmul.py::route, M <= 32 takes the second):
//
// The tensor-core route ("tc"), for the batch solver's products
// ((3, 1280, 972) @ (3, 972, 256) and its kin: 5.7 GFLOP of Karatsuba
// products against about 30 MB of operands, so bound by operations).
//  - Precision, 3xTF32 (the helpers in tf32x3.cuh, shared with K3): every
//    float32 operand x is split into TF32 halves
//    big = rna(x) and small = rna(x - big), and each real product is
//    small*big + big*small + big*big on the tensor cores (about 2^-22 per
//    product against plain TF32's 2^-11, three digits; small*small is
//    below float32's rounding).  The split adds half a TF32 ulp to the bit
//    pattern and lets the MMA ignore the low 13 bits, as CUTLASS's fast
//    3xTF32 does: cvt.rna.tf32.f32 compiles to compares and selects, and
//    measured about 18% slower (PERF.md, the K4 tile table).
//  - Accumulation: the three products of a k8 step start from zero in a
//    fresh register and are added to the running sum in float32 (round to
//    nearest).  The tensor cores' own accumulation truncates: accumulated
//    there across K = 972 the error against complex128 grows past 3 times
//    the plain version's; flushed it stays below it (PERF.md).
//  - The complex product in the Karatsuba 3M form, as the TPU kernel and
//    the plain version compute it,
//      k1 = Ar (Br + Bi),  k2 = (Ar + Ai) Bi,  k3 = (Ai - Ar) Br,
//      re = k1 - k2,       im = k1 + k3,
//    9 MMAs a k8 step, the operand sums formed in registers after the
//    fragment loads.  The direct 4M form (12 MMAs) measured 3-6% slower
//    at the batch shapes, at an error against complex128 of the same
//    order (PERF.md).
//  - The instruction: mma.sync.m16n8k8 with TF32 operands from registers.
//    wgmma would read B from shared memory K-major (B arrives N-major), and
//    its operands cannot be split after they are loaded: the big and small
//    planes would have to be written to shared memory, tripling its
//    traffic.  mma.sync takes register fragments, so the split costs only
//    ALU work on values already loaded; its TF32 rate is what bounds this
//    design (PERF.md).
//  - Copies: a ring of TC_STAGES shared-memory stages, each BK = 16 deep,
//    filled with cp.async, so the loads of stage k + 3 overlap the MMAs of
//    stage k.  16-byte copies when K and N are multiples of 4 and every
//    pointer is 16-byte aligned; otherwise (phase 2's ragged (2, 70, 97,
//    51)) 4-byte copies, both zero-filling outside the matrix.  Rows are
//    padded (A by 4 floats, B by 8) so the fragment loads are free of bank
//    conflicts.
//  - Tiles: warps of 32 x 32 outputs; a block of 2 x 2 warps (64 x 64:
//    240, 240 and 960 blocks at the batch shapes on 132 SMs), measured
//    the fastest of 128 x 64, 64 x 64 and 64 x 128 at all three
//    (PERF.md).
//
// The split-K route ("rows"), for the one-row products of the anchored
// refine and the warm trackers ((1, 1, K) @ (1, K, N), K, N in 80 ... 1024):
// a matrix-vector product, bound by reading B once (under a microsecond),
// where tensor cores buy nothing, so the design is about latency.  A block
// takes a 32-column strip of B and a slice of K: 8 threads a k-row read
// B's row coalesced (16-byte loads when N % 4 == 0), each thread loads its
// next 2-4 k-rows before it uses any (up to 128 k-rows in flight a block),
// the 3-FMA Karatsuba form on the CUDA cores for up to RS_MR rows of A.
// Partial sums are reduced in a fixed order: warp shuffles, then shared
// memory across the warps, then across the K slices of a thread-block
// cluster (one cluster of ksplit <= 8 blocks along gridDim.y): each slice
// pushes its sums into the cluster's first block with st.async, counted by
// an mbarrier there, and leaves; the first block adds them in rank order.
// No atomics: two runs give the same bits.  (A second cluster barrier in
// place of the mbarrier was slower: PERF.md.)
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using twoace::aligned16;
using twoace::cp16;
using twoace::cp4;
using twoace::cp_commit;
using twoace::cp_wait;
using twoace::mma3;
using twoace::smem_u32;
using twoace::split;

// ------------------------------------------------------ tensor-core route

constexpr int TC_BK = 16;        // K depth of one stage (two k8 steps)
constexpr int TC_STAGES = 4;     // cp.async ring
constexpr int WARP_M = 32;       // outputs a warp: 2 m16 x 4 n8 tiles
constexpr int WARP_N = 32;
constexpr int A_PITCH = TC_BK + 4;   // 20: rows g and g + 1 of a fragment
                                     // land 20 banks apart, 16-byte aligned

// the block: 2 x 2 warps, 64 x 64 outputs
struct TcTile {
  static constexpr int WM = 2, WN = 2;
  static constexpr int BM = WM * WARP_M;
  static constexpr int BN = WN * WARP_N;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int B_PITCH = BN + 8;   // k rows 8 banks apart
  static constexpr int A_PLANE = BM * A_PITCH;
  static constexpr int B_PLANE = TC_BK * B_PITCH;
  static constexpr int STAGE = 2 * A_PLANE + 2 * B_PLANE;   // floats
  static constexpr size_t SMEM = sizeof(float) * STAGE * TC_STAGES;
};

template <bool VEC>
__global__ void __launch_bounds__(TcTile::THREADS)
pair_mm_tc(const float* __restrict__ ar, const float* __restrict__ ai,
           const float* __restrict__ br, const float* __restrict__ bi,
           float* __restrict__ cr, float* __restrict__ ci, int m, int k,
           int n) {
  using T = TcTile;
  constexpr int WM = T::WM;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp % WM) * WARP_M;     // the warp's first row in the tile
  const int wc = (warp / WM) * WARP_N;     // and first column
  const int grp = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const long long g = blockIdx.z;
  const float* a_re = ar + g * m * k;
  const float* a_im = ai + g * m * k;
  const float* b_re = br + g * k * n;
  const float* b_im = bi + g * k * n;

  // stage s <- k-tile kt: A planes [2][BM][A_PITCH], B planes
  // [2][BK][B_PITCH]
  auto stage_in = [&](int s, int kt) {
    float* sa = smem + s * T::STAGE;
    float* sb = sa + 2 * T::A_PLANE;
    const int k0 = kt * TC_BK;
    if constexpr (VEC) {
      constexpr int AC = T::BM * (TC_BK / 4) / T::THREADS;
      constexpr int BC = TC_BK * (T::BN / 4) / T::THREADS;
      static_assert(AC * T::THREADS == T::BM * (TC_BK / 4), "A chunks");
      static_assert(BC * T::THREADS == TC_BK * (T::BN / 4), "B chunks");
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* src = p ? a_im : a_re;
#pragma unroll
        for (int l = 0; l < AC; ++l) {
          const int c = tid + l * T::THREADS;
          const int row = c / (TC_BK / 4), kc = (c % (TC_BK / 4)) * 4;
          const int gm = m0 + row, gk = k0 + kc;
          const bool ok = gm < m && gk < k;
          cp16(sa + p * T::A_PLANE + row * A_PITCH + kc,
               ok ? src + (long long)gm * k + gk : src, ok);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* src = p ? b_im : b_re;
#pragma unroll
        for (int l = 0; l < BC; ++l) {
          const int c = tid + l * T::THREADS;
          const int row = c / (T::BN / 4), nc = (c % (T::BN / 4)) * 4;
          const int gk = k0 + row, gn = n0 + nc;
          const bool ok = gk < k && gn < n;
          cp16(sb + p * T::B_PLANE + row * T::B_PITCH + nc,
               ok ? src + (long long)gk * n + gn : src, ok);
        }
      }
    } else {
      constexpr int AE = T::BM * TC_BK / T::THREADS;
      constexpr int BE = TC_BK * T::BN / T::THREADS;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* src = p ? a_im : a_re;
#pragma unroll
        for (int l = 0; l < AE; ++l) {
          const int c = tid + l * T::THREADS;
          const int row = c / TC_BK, kk = c % TC_BK;
          const int gm = m0 + row, gk = k0 + kk;
          const bool ok = gm < m && gk < k;
          cp4(sa + p * T::A_PLANE + row * A_PITCH + kk,
              ok ? src + (long long)gm * k + gk : src, ok);
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* src = p ? b_im : b_re;
#pragma unroll
        for (int l = 0; l < BE; ++l) {
          const int c = tid + l * T::THREADS;
          const int row = c / T::BN, col = c % T::BN;
          const int gk = k0 + row, gn = n0 + col;
          const bool ok = gk < k && gn < n;
          cp4(sb + p * T::B_PLANE + row * T::B_PITCH + col,
              ok ? src + (long long)gk * n + gn : src, ok);
        }
      }
    }
  };

  // acc[i][j]: m16 tile i, n8 tile j; k1, k2, k3
  float acc[2][4][3][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][p][q] = 0.0f;

  const int kt_n = (k + TC_BK - 1) / TC_BK;
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < kt_n) stage_in(s, s);
    cp_commit();
  }

  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<TC_STAGES - 2>();   // stage kt has landed (this thread's part)
    __syncthreads();            // ... everyone's; stage kt - 1 is consumed
    if (kt + TC_STAGES - 1 < kt_n)
      stage_in((kt + TC_STAGES - 1) % TC_STAGES, kt + TC_STAGES - 1);
    cp_commit();

    const float* sa = smem + (kt % TC_STAGES) * T::STAGE;
    const float* sb = sa + 2 * T::A_PLANE;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      // A fragments: a0 (grp, tig), a1 (grp + 8, tig), a2 (grp, tig + 4),
      // a3 (grp + 8, tig + 4) of each m16 x k8 tile
      uint32_t a_big[3][2][4], a_small[3][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = (wr + i * 16 + grp + (q & 1) * 8) * A_PITCH + kk +
                        tig + (q >> 1) * 4;
          const float xr = sa[o], xi = sa[T::A_PLANE + o];
          split(xr, a_big[0][i][q], a_small[0][i][q]);
          split(xr + xi, a_big[1][i][q], a_small[1][i][q]);
          split(xi - xr, a_big[2][i][q], a_small[2][i][q]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B fragments: b0 (k tig, n grp), b1 (k tig + 4, n grp)
        uint32_t b_big[3][2], b_small[3][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int o = (kk + tig + q * 4) * T::B_PITCH + wc + j * 8 + grp;
          const float yr = sb[o], yi = sb[T::B_PLANE + o];
          split(yr + yi, b_big[0][q], b_small[0][q]);   // k1 = Ar (Br + Bi)
          split(yi, b_big[1][q], b_small[1][q]);        // k2 = (Ar + Ai) Bi
          split(yr, b_big[2][q], b_small[2][q]);        // k3 = (Ai - Ar) Br
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int p = 0; p < 3; ++p)
            mma3(acc[i][j][p], a_big[p][i], a_small[p][i], b_big[p],
                 b_small[p]);
      }
    }
  }
  cp_wait<0>();

  // C fragments: c0, c1 (grp, 2 tig + 0/1), c2, c3 (grp + 8, ...)
  float* c_re = cr + g * m * n;
  float* c_im = ci + g * m * n;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wc + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wr + i * 16 + grp + h * 8;
        if (row >= m || col >= n) continue;
        float re[2], im[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x0 = acc[i][j][0][h * 2 + e];
          const float x1 = acc[i][j][1][h * 2 + e];
          const float x2 = acc[i][j][2][h * 2 + e];
          re[e] = x0 - x1;
          im[e] = x0 + x2;
        }
        const long long o = (long long)row * n + col;
        if constexpr (VEC) {       // n % 4 == 0: col + 1 < n, 8-byte aligned
          *reinterpret_cast<float2*>(c_re + o) = make_float2(re[0], re[1]);
          *reinterpret_cast<float2*>(c_im + o) = make_float2(im[0], im[1]);
        } else {
          c_re[o] = re[0];
          c_im[o] = im[0];
          if (col + 1 < n) {
            c_re[o + 1] = re[1];
            c_im[o + 1] = im[1];
          }
        }
      }
    }
}

template <bool VEC>
int launch_tc(const float* ar, const float* ai, const float* br,
              const float* bi, float* cr, float* ci, int g, int m, int k,
              int n, cudaStream_t stream) {
  using T = TcTile;
  auto kern = pair_mm_tc<VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + T::BN - 1) / T::BN),
                  (unsigned)((m + T::BM - 1) / T::BM), (unsigned)g);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(ar, ai, br, bi, cr, ci, m, k,
                                               n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- split-K route

constexpr int RS_THREADS = 256;
constexpr int RS_COLS = 32;                     // columns a block
constexpr int RS_MR = 8;                        // rows of A a block, at most
constexpr int RS_MAX_SPLIT = 8;                 // the portable cluster size

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// p's address in the shared memory of the cluster's block `rank`
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
// v into another block's shared memory; the store's 4 bytes count toward
// that block's mbarrier transaction
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "f"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

template <int MR, bool VEC>
__global__ void __launch_bounds__(RS_THREADS)
pair_mm_rows(const float* __restrict__ ar, const float* __restrict__ ai,
             const float* __restrict__ br, const float* __restrict__ bi,
             float* __restrict__ cr, float* __restrict__ ci, int m, int k,
             int n, int mblocks) {
  constexpr int TPR = RS_COLS / 4;                 // threads on one k-row: 8
  constexpr int KROWS = RS_THREADS / TPR;       // k-rows a block step
  constexpr int WARPS = RS_THREADS / 32;
  constexpr int OUT = 2 * MR * RS_COLS;            // (re, im) x rows x columns
  __shared__ __align__(16) float part[WARPS][OUT];
  // each K slice's sums, gathered in the cluster's first block
  __shared__ __align__(16) float slots[RS_MAX_SPLIT][OUT];
  // the first block's: the other slices' sums have landed in its slots
  __shared__ __align__(8) unsigned long long landed;

  const int nsplit = gridDim.y;
  const unsigned rank = blockIdx.y;        // the cluster is (1, nsplit, 1)
  if (nsplit > 1) {
    if (rank == 0 && threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&landed)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // this block has started (and the first block's mbarrier is set up):
    // waited for before any block writes into another's shared memory
    cluster_arrive_relaxed();
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c4 = (tid % TPR) * 4;               // the thread's first column
  const int col = blockIdx.x * RS_COLS + c4;
  const long long g = blockIdx.z / mblocks;
  const int m0 = (blockIdx.z % mblocks) * MR;
  const int rows = min(MR, m - m0);
  const int chunk = (k + nsplit - 1) / nsplit;
  const int kb = blockIdx.y * chunk, ke = min(k, kb + chunk);
  const float* a_re = ar + (g * m + m0) * k;
  const float* a_im = ai + (g * m + m0) * k;
  const float* b_re = br + g * k * n;
  const float* b_im = bi + g * k * n;

  float k1[MR][4], k2[MR][4], k3[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) k1[r][c] = k2[r][c] = k3[r][c] = 0.0f;

  // U k-rows a thread, all loaded before any is used, so their loads are in
  // flight together; rows past the slice or past M read as zeros
  constexpr int U = MR <= 2 ? 4 : 2;
  for (int k0 = kb + tid / TPR; k0 < ke; k0 += U * KROWS) {
    float yr[U][4], yi[U][4], xr[U][MR], xi[U][MR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k0 + u * KROWS;
      const bool live = kk < ke;
      const long long o = (long long)kk * n + col;
#pragma unroll
      for (int c = 0; c < 4; ++c) yr[u][c] = yi[u][c] = 0.0f;
      if constexpr (VEC) {
        if (live && col < n) {
          const float4 vr = __ldg(reinterpret_cast<const float4*>(b_re + o));
          const float4 vi = __ldg(reinterpret_cast<const float4*>(b_im + o));
          yr[u][0] = vr.x; yr[u][1] = vr.y; yr[u][2] = vr.z; yr[u][3] = vr.w;
          yi[u][0] = vi.x; yi[u][1] = vi.y; yi[u][2] = vi.z; yi[u][3] = vi.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (live && col + c < n) {
            yr[u][c] = __ldg(b_re + o + c);
            yi[u][c] = __ldg(b_im + o + c);
          }
      }
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const bool ok = live && r < rows;
        xr[u][r] = ok ? __ldg(a_re + (long long)r * k + kk) : 0.0f;
        xi[u][r] = ok ? __ldg(a_im + (long long)r * k + kk) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float ys[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) ys[c] = yr[u][c] + yi[u][c];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float xs = xr[u][r] + xi[u][r], xd = xi[u][r] - xr[u][r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          k1[r][c] = fmaf(xr[u][r], ys[c], k1[r][c]);
          k2[r][c] = fmaf(xs, yi[u][c], k2[r][c]);
          k3[r][c] = fmaf(xd, yr[u][c], k3[r][c]);
        }
      }
    }
  }

  // fold the warp's k-row groups (xor TPR, 2 TPR, ... 16: every lane of a
  // column ends with the same bits), then the warps in order
  float re[MR][4], im[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      re[r][c] = k1[r][c] - k2[r][c];
      im[r][c] = k1[r][c] + k3[r][c];
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1) {
        re[r][c] += __shfl_xor_sync(0xffffffffu, re[r][c], off);
        im[r][c] += __shfl_xor_sync(0xffffffffu, im[r][c], off);
      }
    }
  if (lane < TPR) {
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        part[warp][r * RS_COLS + c4 + c] = re[r][c];
        part[warp][MR * RS_COLS + r * RS_COLS + c4 + c] = im[r][c];
      }
  }
  __syncthreads();

  // this slice's sums: the other slices push theirs into their slot of the
  // cluster's first block and leave; the first block keeps its own
  if (nsplit > 1 && rank != 0) {
    cluster_wait();
    const unsigned dst = cluster_addr(slots[rank], 0);
    const unsigned bar = cluster_addr(&landed, 0);
    for (int t = tid; t < OUT; t += RS_THREADS) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += part[w][t];
      st_async(dst + 4u * t, s, bar);
    }
    return;
  }
  for (int t = tid; t < OUT; t += RS_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w][t];
    slots[0][t] = s;
  }
  if (nsplit > 1) {
    const unsigned bar = smem_u32(&landed);
    if (tid == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar), "r"((unsigned)((nsplit - 1) * OUT * 4)) : "memory");
    for (int spin = 0; !mbar_try_wait(bar, 0); ++spin)
      if (spin > (1 << 22)) __trap();
  }
  __syncthreads();

  float* c_re = cr + (g * m + m0) * n;
  float* c_im = ci + (g * m + m0) * n;
  for (int t = tid; t < OUT; t += RS_THREADS) {
    float s = 0.0f;
    for (int q = 0; q < nsplit; ++q) s += slots[q][t];     // in rank order
    const int p = t / (MR * RS_COLS), rc = t % (MR * RS_COLS);
    const int r = rc / RS_COLS, cc = blockIdx.x * RS_COLS + rc % RS_COLS;
    if (r < rows && cc < n) (p ? c_im : c_re)[(long long)r * n + cc] = s;
  }
}

template <int MR, bool VEC>
int launch_rows(const float* ar, const float* ai, const float* br,
                const float* bi, float* cr, float* ci, int g, int m, int k,
                int n, int ksplit, cudaStream_t stream) {
  const int mblocks = (m + MR - 1) / MR;
  const dim3 grid((unsigned)((n + RS_COLS - 1) / RS_COLS), (unsigned)ksplit,
                  (unsigned)(g * mblocks));
  auto kern = pair_mm_rows<MR, VEC>;
  if (ksplit == 1) {
    kern<<<grid, RS_THREADS, 0, stream>>>(ar, ai, br, bi, cr, ci, m, k, n,
                                          mblocks);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(RS_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)ksplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, ar, ai, br, bi, cr, ci, m,
                                       k, n, mblocks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_rows_mr(const float* ar, const float* ai, const float* br,
                   const float* bi, float* cr, float* ci, int g, int m, int k,
                   int n, int ksplit, cudaStream_t stream) {
  if (m <= 1)
    return launch_rows<1, VEC>(ar, ai, br, bi, cr, ci, g, m, k, n,
                                     ksplit, stream);
  if (m <= 2)
    return launch_rows<2, VEC>(ar, ai, br, bi, cr, ci, g, m, k, n,
                                     ksplit, stream);
  if (m <= 4)
    return launch_rows<4, VEC>(ar, ai, br, bi, cr, ci, g, m, k, n,
                                     ksplit, stream);
  return launch_rows<RS_MR, VEC>(ar, ai, br, bi, cr, ci, g, m, k, n,
                                       ksplit, stream);
}

}  // namespace

// The tensor-core route: 16-byte copies when K and N are multiples of 4 and
// every pointer is 16-byte aligned, else 4-byte copies.
extern "C" int twoace_pair_matmul_tc(const float* ar, const float* ai,
                                     const float* br, const float* bi,
                                     float* cr, float* ci, int g, int m,
                                     int k, int n, void* stream) {
  if (g == 0 || m == 0 || n == 0) return 0;
  const bool vec = k % 4 == 0 && n % 4 == 0 && aligned16(ar) &&
                   aligned16(ai) && aligned16(br) && aligned16(bi) &&
                   aligned16(cr) && aligned16(ci);
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_tc<true>(ar, ai, br, bi, cr, ci, g, m, k, n, s)
             : launch_tc<false>(ar, ai, br, bi, cr, ci, g, m, k, n, s);
}

// The split-K route: K cut into ksplit (1 ... 8) slices, one cluster of
// ksplit blocks a 32-column strip and block of up to 8 rows of A.
extern "C" int twoace_pair_matmul_rows(const float* ar, const float* ai,
                                       const float* br, const float* bi,
                                       float* cr, float* ci, int g, int m,
                                       int k, int n, int ksplit,
                                       void* stream) {
  if (g == 0 || m == 0 || n == 0) return 0;
  if (ksplit < 1 || ksplit > RS_MAX_SPLIT) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(br) && aligned16(bi);
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_rows_mr<true>(ar, ai, br, bi, cr, ci, g, m, k, n,
                                    ksplit, s)
             : launch_rows_mr<false>(ar, ai, br, bi, cr, ci, g, m, k, n,
                                     ksplit, s);
}
