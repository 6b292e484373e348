// K2: warm spectral-profile Z-prox, one block per lane.
//
// Replaces the TPU kernels twoace_tpu/ops/pallas/kernels.py::fused_zprox_t
// (body _zprox_kernel) and ::fused_zprox_batch (body _zprox_batch_kernel).
// The batched Pallas kernel packed 128/nr instances block-diagonally into
// one 128x128 MXU tile; here the batch is simply the grid: block b owns
// lane b.
//
// Per lane, on W = z.reshape(r*nt, nr) (a free view of the transposed
// state, whose Gram W^H W is the conjugate of the panel Gram E E^H):
// G = W^H W, then the chain of zprox_core.cuh (perturbative basis update,
// constraint ladder, D = V diag(sqrt(s) - 1) V^H), then W' = W + W D.
// The basis arrives and leaves in the E-convention and is conjugated to the
// W-convention here, as the Pallas wrapper does at its boundary.
//
// What bounds it on the H100: the bytes of W, read once and written once
// (80 KB a lane at r 20, 16x16; 4.7 us for the batch solve's 192 lanes at
// 3.35 TB/s), and the latency of the chain between them.  Design:
//  - W is staged into shared memory once, by 16-byte cp.async copies from
//    every thread in up to four commit groups (chunks of rows), so the
//    Gram starts on the first chunk while the rest arrive; the Gram and
//    the apply both run from that copy.  A staged row is padded to a
//    stride of 4 mod 8 floats, which keeps both products' fragment loads
//    free of bank conflicts.  Where W does not fit the block's 227 KB
//    (nr 32 at large r), 64-row chunks stream through a two-stage ring,
//    and the apply reads them again (from L2) while the chain runs.
//  - The Gram runs on the tensor cores in 3xTF32 (tf32x3.cuh: each k8
//    step's three products summed from zero and flushed into float32) as
//    the real products Xr^T Xr, Xi^T Xi and Xr^T Xi, so each W element is
//    split once a plane, an m16 x n16 block of G a warp and K = rows
//    split over the block's other warps; the warps' partials are summed
//    in a fixed order, with no atomics, and made Hermitian,
//    0.5 (G + G^H), as the plain version's hermitian_part.
//  - The apply W' = W + W D runs on the tensor cores too, an m16 row tile
//    a warp over all nr columns, written back in place and stored with
//    16-byte stores to neighbouring addresses.
//  - The chain (zprox_core.cuh, shared with K3) runs on seven warps with
//    the ladder on the eighth beside them.  It runs once a launch, so its
//    instruction fetch counts: one copy of its product serves all six.
// Shared memory: the staged W, the Gram's partials (24 nr (nr + 1) floats
// at nr <= 16) and the chain's nr x nr matrices: 85,664 B at r 20, 16x16,
// so two blocks share an SM.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// ---- phase timer (built only with -DTWOACE_K2_PHASE_TIMER, by
// scripts/torch_k2_phases.py): thread 0 of lane 0's block stamps
// %globaltimer after each part and sums the nanoseconds per slot over the
// launches until the host reads and clears them.  K2_LOAD is the time it
// waits for W's chunks (and the other warps) in the Gram's loop, K2_GRAM
// its own Gram steps, K2_REDUCE the sum of the warps' partials; K2_LADDER
// the time the product warp waits for the ladder's coefficients;
// K2_APPLY the apply up to its last barrier, K2_STORE the stores of V and
// W'; K2_LADDER_WARP the ladder's own time on its warp (lane 0 of that
// warp), beside the products.
enum K2Slot { K2_LOAD, K2_GRAM, K2_REDUCE, K2_PROD, K2_ELEM, K2_LADDER,
              K2_APPLY, K2_STORE, K2_LADDER_WARP, K2_LAUNCHES, K2_SLOTS };
#ifdef TWOACE_K2_PHASE_TIMER
__device__ unsigned long long g_k2_phase[K2_SLOTS];
__device__ __forceinline__ unsigned long long k2_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// the chain's parts: its products, its elementwise steps, its ladder
#define TWOACE_ZPROX_MARK_START                                      \
  const bool zp_on = blockIdx.x == 0 && threadIdx.x == 0;            \
  unsigned long long zp_acc[3] = {0, 0, 0}, zp_t = k2_now();
#define TWOACE_ZPROX_MARK(part)                                      \
  {                                                                  \
    const unsigned long long zp_n = k2_now();                        \
    zp_acc[part] += zp_n - zp_t;                                     \
    zp_t = zp_n;                                                     \
  }
#define TWOACE_ZPROX_MARK_END                                        \
  if (zp_on)                                                         \
    for (int zp = 0; zp < 3; ++zp) g_k2_phase[K2_PROD + zp] += zp_acc[zp];
#define TWOACE_ZPROX_LADDER_BEGIN const unsigned long long zl_t = k2_now();
#define TWOACE_ZPROX_LADDER_END                                      \
  if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)                    \
    g_k2_phase[K2_LADDER_WARP] += k2_now() - zl_t;
#define K2_START()                                                   \
  const bool k2_on = blockIdx.x == 0 && threadIdx.x == 0;            \
  unsigned long long k2_t = k2_now()
// the time since the last stamp into SLOT
#define K2_MARK(slot)                                                \
  if (k2_on) {                                                       \
    const unsigned long long k2_n = k2_now();                        \
    g_k2_phase[slot] += k2_n - k2_t;                                 \
    k2_t = k2_n;                                                     \
  }
// a barrier, then the same
#define K2_STAMP(slot)                                               \
  __syncthreads();                                                   \
  K2_MARK(slot)
// restart the clock after a part timed by its own hooks
#define K2_SKIP() k2_t = k2_now()
#define K2_FINISH()                                                  \
  if (k2_on) g_k2_phase[K2_LAUNCHES] += 1
#else
#define K2_START()
#define K2_MARK(slot)
#define K2_STAMP(slot)
#define K2_SKIP()
#define K2_FINISH()
#endif

#include "zprox_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;        // the H100's 227 KB a block
constexpr int kMaxChunks = 4;           // commit groups of a resident W
constexpr int kStreamRows = 64;         // rows of a streamed chunk

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The Gram's units: its m16 x n16 blocks (1 at nr <= 16, else 4), a warp
// each, the block's other warps splitting K with them: at most
// kWarps / units K slices, and no more than W has k8 steps
__host__ __device__ inline int gram_units(int nr) {
  const int b = (nr + 15) / 16;
  return b * b;
}
__host__ __device__ inline int gram_slices(int nr, int rows) {
  const int most = kWarps / gram_units(nr), steps = (rows + 7) / 8;
  return steps < 1 ? 1 : steps < most ? steps : most;
}

// How a launch stages W; host and device compute it alike, and
// ops/kernels/zprox.py::plan mirrors it.
struct Plan {
  int stride;     // floats a staged row: >= nr, 4 mod 8 (no bank conflicts)
  int chunk;      // rows a chunk, a multiple of 16
  int chunks;     // chunks of W
  int stages;     // chunks held at once: all (resident) or 2 (streamed)
  int resident;   // 1: W is read once and kept for the apply
  int scratch;    // floats of the Gram's partial sums RR, II, RI, one set
                  // a K slice this launch uses (rows padded to nr + 1: the
                  // sum reads them transposed)
  int smem;       // bytes of shared memory a block
};

__host__ __device__ inline Plan make_plan(int rows, int nr) {
  Plan p;
  p.stride = (nr + 3) / 8 * 8 + 4;
  p.scratch = gram_slices(nr, rows) * 3 * nr * (nr + 1);
  const int fixed =
      p.scratch + round_up(twoace::zprox_smem_floats(nr, kThreads), 4);
  p.chunk = round_up((rows + kMaxChunks - 1) / kMaxChunks, 16);
  if (p.chunk < 16) p.chunk = 16;
  p.chunks = (rows + p.chunk - 1) / p.chunk;
  p.stages = p.chunks > 1 ? p.chunks : 1;
  p.resident = 1;
  if (4LL * (2LL * p.stages * p.chunk * p.stride + fixed) > kMaxSmem) {
    p.chunk = kStreamRows;
    p.chunks = (rows + kStreamRows - 1) / kStreamRows;
    p.stages = 2;
    p.resident = 0;
  }
  p.smem = 4 * (2 * p.stages * p.chunk * p.stride + fixed);
  return p;
}

// wait until at most n (0 ... 3) of this thread's commit groups are pending
__device__ __forceinline__ void cp_wait_upto(int n) {
  if (n <= 0)
    twoace::cp_wait<0>();
  else if (n == 1)
    twoace::cp_wait<1>();
  else if (n == 2)
    twoace::cp_wait<2>();
  else
    twoace::cp_wait<3>();
}

// copies of W's rows [row0, row0 + chunk) into a staged chunk (rows past
// `rows` zero-filled): 16 bytes a copy where a row is whole 16-byte words
// (vec), else 4 bytes
__device__ __forceinline__ void copy_chunk(float* sr, float* si,
                                           const float* wr, const float* wi,
                                           int row0, int chunk, int rows,
                                           int nr, int stride, bool vec) {
  if (vec) {
    const int q4 = nr >> 2;
    for (int e = threadIdx.x; e < chunk * q4; e += kThreads) {
      const int k = e / q4, q = e - k * q4;
      const bool ok = row0 + k < rows;
      const long long g = ok ? (long long)(row0 + k) * nr + 4 * q : 0;
      twoace::cp16(sr + k * stride + 4 * q, wr + g, ok);
      twoace::cp16(si + k * stride + 4 * q, wi + g, ok);
    }
  } else {
    for (int e = threadIdx.x; e < chunk * nr; e += kThreads) {
      const int k = e / nr, q = e - k * nr;
      const bool ok = row0 + k < rows;
      const long long g = ok ? (long long)(row0 + k) * nr + q : 0;
      twoace::cp4(sr + k * stride + q, wr + g, ok);
      twoace::cp4(si + k * stride + q, wi + g, ok);
    }
  }
}

// rows [0, n) of a staged chunk to W' rows [row0, row0 + n)
__device__ __forceinline__ void store_rows(const float* sr, const float* si,
                                           float* outr, float* outi,
                                           int row0, int n, int nr,
                                           int stride, bool vec) {
  if (vec) {
    const int q4 = nr >> 2;
    for (int e = threadIdx.x; e < n * q4; e += kThreads) {
      const int k = e / q4, q = e - k * q4;
      const long long g = (long long)(row0 + k) * nr + 4 * q;
      *reinterpret_cast<float4*>(outr + g) =
          *reinterpret_cast<const float4*>(sr + k * stride + 4 * q);
      *reinterpret_cast<float4*>(outi + g) =
          *reinterpret_cast<const float4*>(si + k * stride + 4 * q);
    }
  } else {
    for (int e = threadIdx.x; e < n * nr; e += kThreads) {
      const int k = e / nr, q = e - k * nr;
      const long long g = (long long)(row0 + k) * nr + q;
      outr[g] = sr[k * stride + q];
      outi[g] = si[k * stride + q];
    }
  }
}

// This warp's part of G = W^H W over the staged rows [0, n) of a chunk,
// as the three real products RR = Xr^T Xr, II = Xi^T Xi and RI = Xr^T Xi
// of W = Xr + i Xi (Re G = RR + II, Im G = RI - RI^T): its m16 x n16
// block (i0, j0) of each as two n8 tiles that share A's fragments, over
// the chunk's k8 steps st0, st0 + ksplit, ...  Each W element is split
// once for each of its planes.  Within a step, thread tig reads rows
// 2 tig and 2 tig + 1 as k = tig and tig + 4 (any order of k sums the same
// terms), so A's and B's fragments both come from W's rows without bank
// conflicts; on the diagonal (i0 == j0) B's elements are A's own.
__device__ __forceinline__ void gram_chunk(const float* sr, const float* si,
                                           int n, int nr, int stride,
                                           int i0, int j0, int st0,
                                           int ksplit,
                                           float (&acc)[2][3][4]) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
  const bool same = i0 == j0, two = j0 + 8 < nr;
  for (int st = st0; st * 8 < n; st += ksplit) {
    const int r0 = st * 8 + 2 * tig;
    // A = Xr^T, Xi^T: a0 (i grp, k tig), a1 (grp + 8, tig), a2 (grp,
    // tig + 4), a3 (grp + 8, tig + 4) are W[r0 + (q >> 1)][i0 + grp + 8 (q & 1)]
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = i0 + grp + (q & 1) * 8, o = (r0 + (q >> 1)) * stride;
      twoace::split(col < nr ? sr[o + col] : 0.0f, ab[0][q], as[0][q]);
      twoace::split(col < nr ? si[o + col] : 0.0f, ab[1][q], as[1][q]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t == 1 && !two) break;
      // B = Xr, Xi: b0 (k tig, n grp), b1 (k tig + 4, grp)
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (same) {
          const int qa = 2 * q + t;             // A's element (r0 + q, col)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bb[h][q] = ab[h][qa];
            bs[h][q] = as[h][qa];
          }
        } else {
          const int col = j0 + t * 8 + grp, o = (r0 + q) * stride;
          twoace::split(col < nr ? sr[o + col] : 0.0f, bb[0][q], bs[0][q]);
          twoace::split(col < nr ? si[o + col] : 0.0f, bb[1][q], bs[1][q]);
        }
      }
      // RR, II, RI: small*big, big*small, big*big from zero, the three
      // chains interleaved, flushed into acc
      const int pa[3] = {0, 1, 0}, pb[3] = {0, 1, 1};
      float d[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[p][q] = 0.0f;
#pragma unroll
      for (int step = 0; step < 3; ++step)
#pragma unroll
        for (int p = 0; p < 3; ++p)
          twoace::mma_tf32_nv(d[p], step == 0 ? as[pa[p]] : ab[pa[p]],
                              step == 1 ? bs[pb[p]] : bb[pb[p]]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][p][q] += d[p][q];
    }
  }
}

// A's fragments of the apply at k step k0: W's staged rows as
// a0 (row grp, k tig), a1 (grp + 8, tig), a2 (grp, tig + 4),
// a3 (grp + 8, tig + 4), split as (re, re + im, im - re)
__device__ __forceinline__ void apply_a(const float* sr, const float* si,
                                        int i0, int k0, int nr, int stride,
                                        uint32_t (&ab)[3][4],
                                        uint32_t (&as)[3][4]) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + tig + (q >> 1) * 4;
    const int o = (i0 + grp + (q & 1) * 8) * stride + k;
    const float x = k < nr ? sr[o] : 0.0f, y = k < nr ? si[o] : 0.0f;
    twoace::split(x, ab[0][q], as[0][q]);
    twoace::split(x + y, ab[1][q], as[1][q]);
    twoace::split(y - x, ab[2][q], as[2][q]);
  }
}

// B's fragments of the apply at k step k0, n8 tile j0: D's b0 (k tig,
// n grp), b1 (k tig + 4, grp), from D split once (split_d)
__device__ __forceinline__ void apply_b(const uint32_t* dsp, int k0, int j0,
                                        int nr, uint32_t (&bb)[3][2],
                                        uint32_t (&bs)[3][2]) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
  const int nn = nr * nr;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = k0 + tig + q * 4, j = j0 + grp;
    const bool ok = p < nr && j < nr;
    const int e = p * nr + j;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bb[c][q] = ok ? dsp[2 * c * nn + e] : 0u;
      bs[c][q] = ok ? dsp[(2 * c + 1) * nn + e] : 0u;
    }
  }
}

// D (in s.P) split once for the apply, as B's (re + im, im, re) halves:
// six planes of nn words from s.Vr on (V, G and P itself; V has been
// written out).  Each thread reads and writes only its own entries.
__device__ __forceinline__ void split_d(const twoace::ZproxSmem& s, int nr) {
  const int nn = nr * nr;
  uint32_t* dsp = reinterpret_cast<uint32_t*>(s.Vr);
  for (int e = threadIdx.x; e < nn; e += kThreads) {
    const float x = s.Pr[e], y = s.Pi[e];
    uint32_t big, small;
    twoace::split(x + y, big, small);
    dsp[e] = big;
    dsp[nn + e] = small;
    twoace::split(y, big, small);
    dsp[2 * nn + e] = big;
    dsp[3 * nn + e] = small;
    twoace::split(x, big, small);
    dsp[4 * nn + e] = big;
    dsp[5 * nn + e] = small;
  }
}

// W' = W + W D into the staged rows, for the m16 x n8 tile (i0, j0) whose
// sums are acc: c0, c1 (row grp, cols 2 tig, 2 tig + 1), c2, c3 (row
// grp + 8)
__device__ __forceinline__ void apply_out(float* sr, float* si, int i0,
                                          int j0, int nr, int stride,
                                          const float (&acc)[3][4]) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + tig * 2 + (q & 1);
    if (j >= nr) continue;
    const int o = (i0 + grp + (q >> 1) * 8) * stride + j;
    sr[o] = sr[o] + (acc[0][q] - acc[1][q]);
    si[o] = si[o] + (acc[0][q] + acc[2][q]);
  }
}

// W' = W + W D on the staged rows [0, n), written back in place.  Called
// by every thread.  Few rows (at most 8 m16 x n8 tiles of W'): one tile a
// warp, all of them read before any is written.  Else an m16 row tile a
// warp, with all of its TN >= ceil(nr / 8) n8 tiles at once: the warp
// reads only its own rows, all of them before it writes.
template <int TN>
__device__ __forceinline__ void apply_rows(float* sr, float* si, int n,
                                           int nr, int stride,
                                           const uint32_t* dsp) {
  const int warp = threadIdx.x >> 5;
  const int nt8 = (nr + 7) >> 3, rtiles = (n + 15) >> 4;
  if (rtiles * nt8 <= kWarps) {
    const bool mine = warp < rtiles * nt8;
    const int i0 = (warp / nt8) * 16, j0 = (warp % nt8) * 8;
    float acc[3][4];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
    if (mine) {
#pragma unroll
      for (int kk = 0; kk < TN; ++kk) {
        if (kk * 8 >= nr) break;
        uint32_t ab[3][4], as[3][4], bb[3][2], bs[3][2];
        apply_a(sr, si, i0, kk * 8, nr, stride, ab, as);
        apply_b(dsp, kk * 8, j0, nr, bb, bs);
        twoace::mma3_step(acc, ab, as, bb, bs);
      }
    }
    __syncthreads();
    if (mine) apply_out(sr, si, i0, j0, nr, stride, acc);
    return;
  }
  for (int tile = warp; tile < rtiles; tile += kWarps) {
    const int i0 = tile * 16;
    float acc[TN][3][4];
#pragma unroll
    for (int t = 0; t < TN; ++t)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][p][q] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < TN; ++kk) {
      if (kk * 8 >= nr) break;
      uint32_t ab[3][4], as[3][4];
      apply_a(sr, si, i0, kk * 8, nr, stride, ab, as);
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        if (t * 8 >= nr) break;
        uint32_t bb[3][2], bs[3][2];
        apply_b(dsp, kk * 8, t * 8, nr, bb, bs);
        twoace::mma3_step(acc[t], ab, as, bb, bs);
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < TN; ++t)
      if (t * 8 < nr) apply_out(sr, si, i0, t * 8, nr, stride, acc[t]);
  }
}

// TN: n8 tiles of the apply, 2 (nr <= 16) or 4 (nr <= 32)
template <int TN>
__global__ void __launch_bounds__(kThreads, 2) zprox_kernel(
    const float* __restrict__ z_re, const float* __restrict__ z_im,
    const float* __restrict__ v0_re, const float* __restrict__ v0_im,
    const float* __restrict__ ranks, const float* __restrict__ fracs,
    float* __restrict__ zn_re, float* __restrict__ zn_im,
    float* __restrict__ vn_re, float* __restrict__ vn_im,
    int rows, int nr, int levels, int vec) {
  extern __shared__ __align__(16) float smem[];
  const Plan pl = make_plan(rows, nr);
  const int S = pl.stride, CH = pl.chunk, P = pl.stages;
  float* Wr = smem;
  float* Wi = Wr + P * CH * S;
  float* gpart = Wi + P * CH * S;        // the Gram's partials
  const twoace::ZproxSmem s = twoace::zprox_smem(gpart + pl.scratch, nr);
  const int nn = nr * nr;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long zoff = (long long)lane * rows * nr;
  const float* wr = z_re + zoff;
  const float* wi = z_im + zoff;
  K2_START();

  // W's first P chunks (all of a resident W), a commit group each
  for (int c = 0; c < P; ++c) {
    if (c < pl.chunks)
      copy_chunk(Wr + c * CH * S, Wi + c * CH * S, wr, wi, c * CH, CH,
                 rows, nr, S, vec);
    twoace::cp_commit();
  }
  // V0 in the W-convention: conj of the E-convention basis
  for (int e = tid; e < nn; e += kThreads) {
    s.Vr[e] = v0_re[(long long)lane * nn + e];
    s.Vi[e] = -v0_im[(long long)lane * nn + e];
  }

  // G = W^H W: warp (u, ks) takes m16 x n16 block u of G over K slice ks
  // (the k8 steps ks, ks + ksplit, ... of W, across the chunks)
  const int units = gram_units(nr), ksplit = gram_slices(nr, rows);
  const bool gram_warp = warp < units * ksplit;
  const int u = warp % units, ks = warp / units;
  const int nb = (nr + 15) >> 4;
  const int i0 = (u / nb) * 16, j0 = (u % nb) * 16;
  float acc[2][3][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][p][q] = 0.0f;
  for (int c = 0; c < pl.chunks; ++c) {
    cp_wait_upto(P - 1);                 // chunk c has landed
    __syncthreads();
    K2_MARK(K2_LOAD);
    const int b = c % P;
    if (gram_warp)
      gram_chunk(Wr + b * CH * S, Wi + b * CH * S, min(CH, rows - c * CH),
                 nr, S, i0, j0, (ks + ksplit - (c * CH / 8) % ksplit) % ksplit,
                 ksplit, acc);
    K2_MARK(K2_GRAM);
    if (!pl.resident) {
      __syncthreads();                   // stage b is free again
      if (c + P < pl.chunks)
        copy_chunk(Wr + b * CH * S, Wi + b * CH * S, wr, wi, (c + P) * CH,
                   CH, rows, nr, S, vec);
    }
    twoace::cp_commit();
  }
  // streamed: the apply's first chunks come back (from L2) during the chain
  if (!pl.resident) {
    for (int c = 0; c < P; ++c) {
      if (c < pl.chunks)
        copy_chunk(Wr + c * CH * S, Wi + c * CH * S, wr, wi, c * CH, CH,
                   rows, nr, S, vec);
      twoace::cp_commit();
    }
  }
  // the partials, then their sums over the K slices in order, and G made
  // Hermitian as the plain version's hermitian_part: with Re = RR + II and
  // Im = RI - RI^T, G = 0.5 (Re + Re^T) + i 0.5 (Im - Im^T)
  const int pn = nr * (nr + 1);
  if (gram_warp) {
    const int grp = (tid & 31) >> 2, tig = tid & 3;
    float* mine = gpart + ks * 3 * pn;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + grp + (q >> 1) * 8;
        const int j = j0 + t * 8 + tig * 2 + (q & 1);
        if (i < nr && j < nr) {
#pragma unroll
          for (int p = 0; p < 3; ++p)
            mine[p * pn + i * (nr + 1) + j] = acc[t][p][q];
        }
      }
  }
  __syncthreads();
  for (int e = tid; e < nn; e += kThreads) {
    const int i = e / nr, j = e - i * nr;
    const int ep = i * (nr + 1) + j, et = j * (nr + 1) + i;
    float rr = 0.0f, rrt = 0.0f, ii = 0.0f, iit = 0.0f, ri = 0.0f, rit = 0.0f;
    for (int k = 0; k < ksplit; ++k) {
      const float* part = gpart + k * 3 * pn;
      rr += part[ep];
      rrt += part[et];
      ii += part[pn + ep];
      iit += part[pn + et];
      ri += part[2 * pn + ep];
      rit += part[2 * pn + et];
    }
    s.Gr[e] = 0.5f * ((rr + ii) + (rrt + iit));
    s.Gi[e] = ri - rit;
  }
  K2_STAMP(K2_REDUCE);
  twoace::zprox_basis_delta(s, nr, ranks + (long long)lane * levels,
                            fracs + (long long)lane * levels, levels);
  K2_SKIP();
  // new basis back in the E-convention
  for (int e = tid; e < nn; e += kThreads) {
    vn_re[(long long)lane * nn + e] = s.Vr[e];
    vn_im[(long long)lane * nn + e] = -s.Vi[e];
  }
  __syncthreads();
  // W' = W + W D, D in s.P split once
  split_d(s, nr);
  __syncthreads();
  const uint32_t* dsp = reinterpret_cast<const uint32_t*>(s.Vr);
  float* onr = zn_re + zoff;
  float* oni = zn_im + zoff;
  if (pl.resident) {
    apply_rows<TN>(Wr, Wi, rows, nr, S, dsp);
    __syncthreads();
    K2_MARK(K2_APPLY);
    store_rows(Wr, Wi, onr, oni, 0, rows, nr, S, vec);
  } else {
    for (int c = 0; c < pl.chunks; ++c) {
      cp_wait_upto(P - 1);
      __syncthreads();
      const int b = c % P, n = min(CH, rows - c * CH);
      apply_rows<TN>(Wr + b * CH * S, Wi + b * CH * S, n, nr, S, dsp);
      __syncthreads();
      store_rows(Wr + b * CH * S, Wi + b * CH * S, onr, oni, c * CH, n, nr, S,
                 vec);
      __syncthreads();                   // stage b is free again
      if (c + P < pl.chunks)
        copy_chunk(Wr + b * CH * S, Wi + b * CH * S, wr, wi, (c + P) * CH,
                   CH, rows, nr, S, vec);
      twoace::cp_commit();
    }
  }
  K2_STAMP(K2_STORE);
  K2_FINISH();
}

template <int TN>
int launch(const float* z_re, const float* z_im, const float* v0_re,
           const float* v0_im, const float* ranks, const float* fracs,
           float* zn_re, float* zn_im, float* vn_re, float* vn_im, int lanes,
           int rows, int nr, int levels, int vec, int smem,
           cudaStream_t stream) {
  // the opt-in above 48 KB, once a device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && !(dev < 64 && opted[dev])) {
    err = cudaFuncSetAttribute(zprox_kernel<TN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  zprox_kernel<TN><<<lanes, kThreads, smem, stream>>>(
      z_re, z_im, v0_re, v0_im, ranks, fracs, zn_re, zn_im, vn_re, vn_im,
      rows, nr, levels, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int twoace_zprox_t(
    const float* z_re, const float* z_im, const float* v0_re,
    const float* v0_im, const float* ranks, const float* fracs,
    float* zn_re, float* zn_im, float* vn_re, float* vn_im, int lanes,
    int rows, int nr, int levels, void* stream) {
  if (lanes == 0) return 0;
  if (nr < 1 || nr > 32 || rows < 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(rows, nr);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int vec = nr % 4 == 0 && twoace::aligned16(z_re) &&
                  twoace::aligned16(z_im) && twoace::aligned16(zn_re) &&
                  twoace::aligned16(zn_im);
  if (nr <= 16)
    return launch<2>(z_re, z_im, v0_re, v0_im, ranks, fracs, zn_re, zn_im,
                     vn_re, vn_im, lanes, rows, nr, levels, vec, p.smem,
                     (cudaStream_t)stream);
  return launch<4>(z_re, z_im, v0_re, v0_im, ranks, fracs, zn_re, zn_im,
                   vn_re, vn_im, lanes, rows, nr, levels, vec, p.smem,
                   (cudaStream_t)stream);
}

// The staging plan at (rows, nr), for the tests: stride, chunk, chunks,
// stages, resident, scratch, smem into out[0 ... 6].
extern "C" int twoace_zprox_plan(int rows, int nr, int* out) {
  const Plan p = make_plan(rows, nr);
  const int v[7] = {p.stride, p.chunk, p.chunks, p.stages, p.resident,
                    p.scratch, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

#ifdef TWOACE_K2_PHASE_TIMER
// The phase timer's sums since the last read (K2_SLOTS values:
// nanoseconds per slot, then lane 0's launches), copied to out and
// cleared.
extern "C" int twoace_zprox_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_k2_phase,
                                         sizeof(unsigned long long) * K2_SLOTS);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[K2_SLOTS] = {};
  return (int)cudaMemcpyToSymbol(g_k2_phase, zero, sizeof(zero));
}
#endif
