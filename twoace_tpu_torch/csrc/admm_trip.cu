// K7: the per-op loop's trip glue (ops/admm_loop.py), in five kernels.
//
// Replaces no TPU kernel: inside the JAX package's jitted loop body XLA
// fused this glue into the products around it.  Eager PyTorch ran it as
// about 155 elementwise and reduction kernels a trip; these passes run it
// in at most six launches, around the unchanged K4 (pair GEMM), K1
// (magnitude prox + M-dual) and K2 (Z-prox) of ops/kernels/admm_trip.py.
// One trip, planar float32, lanes L = G * P, each lane's state contiguous:
//
//   shift (A)   t = Y - M/mu                       (before K4's A^H T)
//   rhs (B)     rhs = A^H T + Z - N/mu [+ anchor]   (before K4's X-update)
//   row sums (C) one read of AX, Y_new, Y_old, b: ||AX||^2, ||Y_new||^2,
//               ||AX - Y_new||^2, ||Y_new - Y_old||^2 and the objective's
//               squared residuals (one a lane with the norm over r of each
//               row, or one a column r in the per-column pass)
//   shift (D)   Z_in = X + N/mu                     (before K2)
//   n_dual (E)  N_new = N + mu (X - Z_new) on active lanes, N on the
//               others, with ||X||^2, ||Z_new||^2, ||X - Z_new||^2,
//               ||Z_new - Z_old||^2, ||A^H Y_new - A^H Y_old||^2 and
//               ||A^H Y_new||^2
//   commit (F)  per lane: the residual tests, mu, the best-so-far (the
//               argmin over r in the per-column pass, the first on ties),
//               the small fields into a second set of buffers; then the
//               new best-so-far (X and Y_new, or their column, on lanes
//               that improved, the old one on the others) and the restore
//               of every new field on lanes that were not active
//
// No pass writes into its inputs: every field of the trip's state is new.
//
// The Z-free loop runs A, C, E (its sums of A^H Y only) and F.
//
// What bounds it on the H100: bytes.  Every pass is a stream over lane
// state with a few flops an entry, far under the card's flop:byte ratio.
// Design:
//  - each pass reads each input once and writes each output once; F's
//    restores touch only lanes that were not active;
//  - 16-byte loads and stores.  A pass over a lane's flat state walks it in
//    float4s from the first 16-byte boundary, with scalar head and tail.
//    The row sums need one thread on the same 4 columns in every row (the
//    row-scaled objective sums |AX|^2 over r of each column), so where a
//    row starts off a 16-byte boundary (m not a multiple of 4, as the
//    32x32 train split's 3891) a thread loads the two aligned float4s that
//    hold its 4 entries and shifts them together;
//  - a lane's state is cut over several blocks (grid (parts, lanes)) so
//    that 96 lanes still fill 132 SMs; each block writes its partial sums
//    into a per-lane row of a scratch buffer, and F adds them in a fixed
//    order.  Sums in a block run in a fixed order too (shuffles, then
//    warps in turn): no float atomics, the same bits every run;
//  - masked rows (b = 0, A_i = 0) hold zeros in AX, Y and b and add
//    nothing to a sum.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn), as
// the plain PyTorch version rounds it, so the elementwise outputs match it
// bit for bit; the sums differ from it only in their order.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
//: slots of a block's partial sums in E's scratch row
constexpr int COL_SLOTS = 6;
//: the most state fields F restores on a lane that was not active (five
//: pairs: Y, the M-dual, Z, A^H Y, the basis)
constexpr int MAX_RESTORE = 10;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sq2(float re, float im) {
  return add(mul(re, re), mul(im, im));
}
// torch.maximum and torch.minimum: a NaN operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? nanf("") : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? nanf("") : fminf(a, b);
}

template <int V> struct Width { static constexpr int v = V; };

template <int V> __device__ __forceinline__ void ld(const float* p, float (&v)[V]);
template <> __device__ __forceinline__ void ld<4>(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
template <> __device__ __forceinline__ void ld<1>(const float* p, float (&v)[1]) {
  v[0] = *p;
}
template <int V> __device__ __forceinline__ void st(float* p, const float (&v)[V]);
template <> __device__ __forceinline__ void st<4>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void st<1>(float* p, const float (&v)[1]) {
  *p = v[0];
}

// p[0..3] from anywhere: the one aligned float4 that holds them, or the two
// that do, shifted together.  An aligned 16-byte chunk that holds an entry
// of a tensor lies inside its allocation, so the second load stays in it.
__device__ __forceinline__ void ldu4(const float* p, float (&v)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int sh = (int)((a >> 2) & 3);
  const float4* q = reinterpret_cast<const float4*>(a & ~(uintptr_t)15);
  const float4 lo = q[0];
  if (sh == 0) {
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    return;
  }
  const float4 hi = q[1];
  if (sh == 1) {
    v[0] = lo.y; v[1] = lo.z; v[2] = lo.w; v[3] = hi.x;
  } else if (sh == 2) {
    v[0] = lo.z; v[1] = lo.w; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = lo.w; v[1] = hi.x; v[2] = hi.y; v[3] = hi.z;
  }
}

// f(Width<V>, o) over the entries [lo, hi) of arrays whose bases share
// ref's alignment: float4s (V = 4) from the first 16-byte boundary, single
// entries (V = 1) before it and after the last whole float4.
template <class F>
__device__ __forceinline__ void each(const float* ref, long long lo,
                                     long long hi, F&& f) {
  if (lo >= hi) return;
  const int mis = (int)((reinterpret_cast<uintptr_t>(ref + lo) >> 2) & 3);
  long long a = lo + ((4 - mis) & 3);
  if (a > hi) a = hi;
  const long long b = a + ((hi - a) & ~3LL);
  const long long t = threadIdx.x;
  if (lo + t < a) f(Width<1>(), lo + t);
  for (long long o = a + 4 * t; o < b; o += 4LL * THREADS) f(Width<4>(), o);
  if (b + t < hi) f(Width<1>(), b + t);
}

// [lo, hi) of part ``part`` of ``parts`` of a lane's ``per`` entries: equal
// parts, each a multiple of 4 entries long
__device__ __forceinline__ void part_range(long long per, int part, int parts,
                                           long long* lo, long long* hi) {
  const long long step = ((per + parts - 1) / parts + 3) & ~3LL;
  *lo = (long long)part * step;
  *hi = min(per, *lo + step);
}

// the block's sums of v[0..NV), lane 0's shuffle tree and then the warps in
// turn: the same order, and the same bits, every run.  Thread k < NV
// returns sum k; ``sm`` holds WARPS * NV floats.
template <int NV>
__device__ __forceinline__ float block_sum(float (&v)[NV], float* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = add(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
    if (lane == 0) sm[warp * NV + k] = v[k];
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < NV)
    for (int w = 0; w < WARPS; ++w) s = add(s, sm[w * NV + threadIdx.x]);
  return s;
}

// A and D: out = a + sign (b / mu), per lane; sign -1 gives the plain
// version's a - b * (1 / mu) exactly
__global__ void __launch_bounds__(THREADS) admm_trip_shift(
    const float* __restrict__ a_re, const float* __restrict__ a_im,
    const float* __restrict__ b_re, const float* __restrict__ b_im,
    const float* __restrict__ mu, float* __restrict__ o_re,
    float* __restrict__ o_im, long long per, float sign) {
  const int lane = blockIdx.y;
  long long lo, hi;
  part_range(per, blockIdx.x, gridDim.x, &lo, &hi);
  const long long base = (long long)lane * per;
  const float inv = __fdiv_rn(1.0f, mu[lane]);
  each(o_re, base + lo, base + hi, [&](auto w, long long o) {
    constexpr int V = decltype(w)::v;
    float ar[V], ai[V], br[V], bi[V];
    ld<V>(a_re + o, ar); ld<V>(a_im + o, ai);
    ld<V>(b_re + o, br); ld<V>(b_im + o, bi);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      ar[q] = add(ar[q], sign * mul(br[q], inv));
      ai[q] = add(ai[q], sign * mul(bi[q], inv));
    }
    st<V>(o_re + o, ar); st<V>(o_im + o, ai);
  });
}

// B: out = (A^H T + (Z - N / mu)) + anchor, the anchor where there is one
__global__ void __launch_bounds__(THREADS) admm_trip_rhs(
    const float* __restrict__ h_re, const float* __restrict__ h_im,
    const float* __restrict__ z_re, const float* __restrict__ z_im,
    const float* __restrict__ n_re, const float* __restrict__ n_im,
    const float* __restrict__ c_re, const float* __restrict__ c_im,
    const float* __restrict__ mu, float* __restrict__ o_re,
    float* __restrict__ o_im, long long per) {
  const int lane = blockIdx.y;
  long long lo, hi;
  part_range(per, blockIdx.x, gridDim.x, &lo, &hi);
  const long long base = (long long)lane * per;
  const float inv = __fdiv_rn(1.0f, mu[lane]);
  const bool anchored = c_re != nullptr;
  each(o_re, base + lo, base + hi, [&](auto w, long long o) {
    constexpr int V = decltype(w)::v;
    float hr[V], hi_[V], zr[V], zi[V], nr[V], ni[V];
    ld<V>(h_re + o, hr); ld<V>(h_im + o, hi_);
    ld<V>(z_re + o, zr); ld<V>(z_im + o, zi);
    ld<V>(n_re + o, nr); ld<V>(n_im + o, ni);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      hr[q] = add(hr[q], sub(zr[q], mul(nr[q], inv)));
      hi_[q] = add(hi_[q], sub(zi[q], mul(ni[q], inv)));
    }
    if (anchored) {
      ld<V>(c_re + o, zr); ld<V>(c_im + o, zi);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        hr[q] = add(hr[q], zr[q]);
        hi_[q] = add(hi_[q], zi[q]);
      }
    }
    st<V>(o_re + o, hr); st<V>(o_im + o, hi_);
  });
}

// C: the sums over a lane's rows.  Block (part, lane) takes columns
// [part * 4 THREADS, ...) of every row of its lane, 4 a thread, and writes
// its partials to out[(lane * parts + part) * slots + ...]: ||AX||^2,
// ||Y_new||^2, ||AX - Y_new||^2, ||Y_new - Y_old||^2, then the objective's
// squared residuals, one (per_column 0) or one a row k (per_column 1).
// Dynamic shared memory: r * WARPS floats in the per-column pass.
__global__ void __launch_bounds__(THREADS) admm_trip_rows(
    const float* __restrict__ ax_re, const float* __restrict__ ax_im,
    const float* __restrict__ y_re, const float* __restrict__ y_im,
    const float* __restrict__ yo_re, const float* __restrict__ yo_im,
    const float* __restrict__ b, float* __restrict__ out, int r, int m,
    int per_column) {
  extern __shared__ float per_row[];
  __shared__ float sm[WARPS * 5];
  const int lane = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const int slots = 4 + (per_column ? r : 1);
  const int j0 = part * 4 * THREADS + 4 * threadIdx.x;
  // the thread's entries of each row: all 4, or the m % 4 of the row's end
  // (or none).  ``full`` is tested on its own: from ``valid == 4`` ptxas
  // (CUDA 12.9, -O3, sm_90a) fused the clamp and the test into one
  // VIMNMX.RELU whose predicate also held for 0 <= m - j0 < 4, so the row's
  // last thread took the 16-byte loads and its padding entries held the
  // next entries of memory (the next row's first ones)
  const bool full = m - j0 >= 4;
  const int valid = max(0, min(4, m - j0));
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  float bj[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (full) {
    ldu4(b + (long long)lane * m + j0, bj);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= valid) break;
      bj[q] = b[(long long)lane * m + j0 + q];
    }
  }
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < r; ++k) {
    const long long o = ((long long)lane * r + k) * m + j0;
    float xr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, xi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float nr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ni[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float pr[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (full) {
      ldu4(ax_re + o, xr); ldu4(ax_im + o, xi);
      ldu4(y_re + o, nr); ldu4(y_im + o, ni);
      ldu4(yo_re + o, pr); ldu4(yo_im + o, pi);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= valid) break;
        xr[q] = ax_re[o + q]; xi[q] = ax_im[o + q];
        nr[q] = y_re[o + q]; ni[q] = y_im[o + q];
        pr[q] = yo_re[o + q]; pi[q] = yo_im[o + q];
      }
    }
    float rk = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= valid) break;
      const float a2 = sq2(xr[q], xi[q]);
      acc[0] = add(acc[0], a2);
      acc[1] = add(acc[1], sq2(nr[q], ni[q]));
      acc[2] = add(acc[2], sq2(sub(xr[q], nr[q]), sub(xi[q], ni[q])));
      acc[3] = add(acc[3], sq2(sub(nr[q], pr[q]), sub(ni[q], pi[q])));
      if (per_column) {
        const float e = sub(sqrtf(a2), bj[q]);
        rk = add(rk, mul(e, e));
      } else {
        col[q] = add(col[q], a2);
      }
    }
    if (per_column) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rk = add(rk, __shfl_xor_sync(0xffffffffu, rk, off));
      if (wl == 0) per_row[k * WARPS + warp] = rk;
    }
  }
  if (!per_column) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= valid) break;
      const float e = sub(sqrtf(col[q]), bj[q]);
      acc[4] = add(acc[4], mul(e, e));
    }
  }
  float* row = out + ((long long)lane * parts + part) * slots;
  const float s = block_sum<5>(acc, sm);      // syncs: per_row is complete
  if (threadIdx.x < (per_column ? 4 : 5)) row[threadIdx.x] = s;
  if (per_column) {
    for (int k = threadIdx.x; k < r; k += THREADS) {
      float t = 0.0f;
      for (int w = 0; w < WARPS; ++w) t = add(t, per_row[k * WARPS + w]);
      row[4 + k] = t;
    }
  }
}

// E: the N-dual update into no (the old N on lanes that were not active)
// and the column sums, block (part, lane) over its part of the lane's r x n
// entries.  Partials to out[(lane * parts + part) *
// COL_SLOTS + ...]: ||X||^2, ||Z_new||^2, ||X - Z_new||^2,
// ||Z_new - Z_old||^2, ||A^H Y_new - A^H Y_old||^2, ||A^H Y_new||^2; the
// Z-free loop (x null) only the last two.
__global__ void __launch_bounds__(THREADS) admm_trip_n_dual(
    const float* __restrict__ x_re, const float* __restrict__ x_im,
    const float* __restrict__ zn_re, const float* __restrict__ zn_im,
    const float* __restrict__ zo_re, const float* __restrict__ zo_im,
    const float* __restrict__ n_re, const float* __restrict__ n_im,
    float* __restrict__ no_re, float* __restrict__ no_im,
    const float* __restrict__ h_re,
    const float* __restrict__ h_im, const float* __restrict__ ho_re,
    const float* __restrict__ ho_im, const float* __restrict__ mu,
    const int* __restrict__ it, const unsigned char* __restrict__ conv,
    float* __restrict__ out, long long per, int bound) {
  __shared__ float sm[WARPS * COL_SLOTS];
  const int lane = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  long long lo, hi;
  part_range(per, part, parts, &lo, &hi);
  const long long base = (long long)lane * per;
  const float mu_l = mu[lane];
  const bool active = it[lane] < bound && !conv[lane];
  const bool has_z = x_re != nullptr;
  float acc[COL_SLOTS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  each(h_re, base + lo, base + hi, [&](auto w, long long o) {
    constexpr int V = decltype(w)::v;
    float hr[V], hi_[V], gr[V], gi[V];
    ld<V>(h_re + o, hr); ld<V>(h_im + o, hi_);
    ld<V>(ho_re + o, gr); ld<V>(ho_im + o, gi);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      acc[4] = add(acc[4], sq2(sub(hr[q], gr[q]), sub(hi_[q], gi[q])));
      acc[5] = add(acc[5], sq2(hr[q], hi_[q]));
    }
    if (!has_z) return;
    float xr[V], xi[V], zr[V], zi[V], pr[V], pi[V], nr[V], ni[V];
    ld<V>(x_re + o, xr); ld<V>(x_im + o, xi);
    ld<V>(zn_re + o, zr); ld<V>(zn_im + o, zi);
    ld<V>(zo_re + o, pr); ld<V>(zo_im + o, pi);
    ld<V>(n_re + o, nr); ld<V>(n_im + o, ni);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float jr = sub(xr[q], zr[q]), ji = sub(xi[q], zi[q]);
      acc[0] = add(acc[0], sq2(xr[q], xi[q]));
      acc[1] = add(acc[1], sq2(zr[q], zi[q]));
      acc[2] = add(acc[2], sq2(jr, ji));
      acc[3] = add(acc[3], sq2(sub(zr[q], pr[q]), sub(zi[q], pi[q])));
      if (active) {
        nr[q] = add(nr[q], mul(mu_l, jr));
        ni[q] = add(ni[q], mul(mu_l, ji));
      }
    }
    st<V>(no_re + o, nr); st<V>(no_im + o, ni);
  });
  const float s = block_sum<COL_SLOTS>(acc, sm);
  if (threadIdx.x < COL_SLOTS)
    out[((long long)lane * parts + part) * COL_SLOTS + threadIdx.x] = s;
}

struct Restore {
  const float* src[MAX_RESTORE];
  float* dst[MAX_RESTORE];
  long long per[MAX_RESTORE];
  int count;
};

struct Small {
  const float* mu;
  const float* last_res;
  const float* opt_obj;
  const int* it;
  const unsigned char* conv;
};

struct SmallOut {
  float* mu;
  float* last_res;
  float* opt_obj;
  int* it;
  unsigned char* conv;
};

// constants of the residual tests: tol_abs times each threshold's square
// root, computed on the host in double as the plain version does
struct Tests {
  float tol_rel, rho, c_prim, c_dual, c_comb;
};

// part ``part`` of ``parts`` of a copy of ``count`` entries: 16-byte moves
// where source and destination share their alignment, else single entries
__device__ __forceinline__ void copy_part(float* dst, const float* src,
                                          long long count, int part,
                                          int parts) {
  long long lo, hi;
  part_range(count, part, parts, &lo, &hi);
  if ((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src))
      & 15) {
    for (long long o = lo + threadIdx.x; o < hi; o += THREADS) dst[o] = src[o];
    return;
  }
  each(dst, lo, hi, [&](auto w, long long o) {
    constexpr int V = decltype(w)::v;
    float v[V];
    ld<V>(src + o, v);
    st<V>(dst + o, v);
  });
}

// F: every block of a lane adds the lane's partial sums in the same fixed
// order and takes the same decisions; block 0 writes the small fields.
// Then the lane's blocks share its copies: the new best-so-far, from X and
// Y_new on an active lane that improved (row-scaled: all of each;
// per-column: row j), else from the old one; on a lane that was not active
// every restore job (new <- old) too.
__global__ void __launch_bounds__(THREADS) admm_trip_commit(
    const float* __restrict__ rows, const float* __restrict__ cols,
    Small in, SmallOut out, Tests tests, Restore restore,
    const float* __restrict__ x_re, const float* __restrict__ x_im,
    const float* __restrict__ y_re, const float* __restrict__ y_im,
    const float* __restrict__ px_re, const float* __restrict__ px_im,
    const float* __restrict__ py_re, const float* __restrict__ py_im,
    float* __restrict__ ox_re, float* __restrict__ ox_im,
    float* __restrict__ oy_re, float* __restrict__ oy_im, int r, int m,
    int n, int row_parts, int col_parts, int per_column, int has_z,
    int bound) {
  extern __shared__ float sums[];    // row slots, then COL_SLOTS
  __shared__ int decision[3];        // active, better, j
  const int lane = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const int slots = 4 + (per_column ? r : 1);
  for (int w = threadIdx.x; w < slots; w += THREADS) {
    float s = 0.0f;
    for (int c = 0; c < row_parts; ++c)
      s = add(s, rows[((long long)lane * row_parts + c) * slots + w]);
    sums[w] = s;
  }
  if (threadIdx.x < COL_SLOTS) {
    float s = 0.0f;
    for (int c = 0; c < col_parts; ++c)
      s = add(s, cols[((long long)lane * col_parts + c) * COL_SLOTS
                      + threadIdx.x]);
    sums[slots + threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float* cs = sums + slots;
    const float nax2 = sums[0], ny2 = sums[1], njm2 = sums[2],
                ndy2 = sums[3];
    const float nx2 = cs[0], nz2 = cs[1], njn2 = cs[2], dz2 = cs[3],
                ndh2 = cs[4], nh2 = cs[5];
    // the objective: one a lane, or the first least of the r columns'
    // (torch.argmin: a NaN is the least)
    int j = 0;
    float obj = sqrtf(sums[4]);
    if (per_column) {
      for (int k = 1; k < r; ++k) {
        const float v = sqrtf(sums[4 + k]);
        if (obj == obj && (v != v || v < obj)) {
          obj = v;
          j = k;
        }
      }
    }
    const float mu = in.mu[lane], last = in.last_res[lane];
    const float best = in.opt_obj[lane];
    const float nax = sqrtf(nax2), ny = sqrtf(ny2), nh = sqrtf(nh2);
    float res_prim, res_dual, res_comb, t_prim, t_dual, t_comb;
    if (has_z) {
      const float nx = sqrtf(nx2), nz = sqrtf(nz2);
      res_prim = sqrtf(add(njm2, njn2));
      res_dual = mul(mu, sqrtf(add(ndh2, dz2)));
      res_comb = sqrtf(add(add(mul(res_prim, res_prim), ndy2), dz2));
      const float m1 = tmax(nax, ny), m2 = tmax(nx, nz);
      const float big = add(mul(m1, m1), mul(m2, m2));
      t_prim = add(tests.c_prim, mul(tests.tol_rel, sqrtf(big)));
      t_dual = add(tests.c_dual,
                   mul(tests.tol_rel, sqrtf(add(mul(nh, nh), mul(nz, nz)))));
      t_comb = add(tests.c_comb,
                   mul(tests.tol_rel,
                       sqrtf(add(add(big, mul(ny, ny)), mul(nz, nz)))));
    } else {
      res_prim = sqrtf(njm2);
      res_dual = mul(mu, sqrtf(ndh2));
      res_comb = sqrtf(add(mul(res_prim, res_prim), ndy2));
      const float big = tmax(nax, ny);
      t_prim = add(tests.c_prim, mul(tests.tol_rel, big));
      t_dual = add(tests.c_dual, mul(tests.tol_rel, nh));
      t_comb = add(tests.c_comb,
                   mul(tests.tol_rel, sqrtf(add(mul(big, big), mul(ny, ny)))));
    }
    const bool conv = ((res_prim < t_prim) && (res_dual < t_dual))
                      || (res_comb < t_comb);
    const bool active = in.it[lane] < bound && !in.conv[lane];
    const bool better = obj < best;
    if (part == 0) {
      out.mu[lane] = active ? (res_comb > mul(last, 0.9f) ? mul(mu, tests.rho)
                                                          : mu)
                            : mu;
      out.last_res[lane] = active ? res_comb : last;
      out.opt_obj[lane] = active ? tmin(obj, best) : best;
      out.it[lane] = active ? in.it[lane] + 1 : in.it[lane];
      out.conv[lane] = active ? (unsigned char)conv : in.conv[lane];
    }
    decision[0] = active;
    decision[1] = better;
    decision[2] = j;
  }
  __syncthreads();
  if (!decision[0]) {
    for (int q = 0; q < restore.count; ++q) {
      const long long per = restore.per[q];
      copy_part(restore.dst[q] + lane * per, restore.src[q] + lane * per, per,
                part, parts);
    }
  }
  const long long kx = per_column ? n : (long long)r * n;
  const long long ky = per_column ? m : (long long)r * m;
  if (decision[0] && decision[1]) {
    const int j = decision[2];
    const long long sx = ((long long)lane * r + j) * n;
    const long long sy = ((long long)lane * r + j) * m;
    copy_part(ox_re + lane * kx, x_re + sx, kx, part, parts);
    copy_part(ox_im + lane * kx, x_im + sx, kx, part, parts);
    copy_part(oy_re + lane * ky, y_re + sy, ky, part, parts);
    copy_part(oy_im + lane * ky, y_im + sy, ky, part, parts);
  } else {
    copy_part(ox_re + lane * kx, px_re + lane * kx, kx, part, parts);
    copy_part(ox_im + lane * kx, px_im + lane * kx, kx, part, parts);
    copy_part(oy_re + lane * ky, py_re + lane * ky, ky, part, parts);
    copy_part(oy_im + lane * ky, py_im + lane * ky, ky, part, parts);
  }
}

inline int finish() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" int twoace_trip_shift(const float* a_re, const float* a_im,
                                 const float* b_re, const float* b_im,
                                 const float* mu, float* o_re, float* o_im,
                                 int lanes, long long per, int parts,
                                 float sign, void* stream) {
  if (lanes == 0 || per == 0) return 0;
  admm_trip_shift<<<dim3(parts, lanes), THREADS, 0, (cudaStream_t)stream>>>(
      a_re, a_im, b_re, b_im, mu, o_re, o_im, per, sign);
  return finish();
}

extern "C" int twoace_trip_rhs(const float* h_re, const float* h_im,
                               const float* z_re, const float* z_im,
                               const float* n_re, const float* n_im,
                               const float* c_re, const float* c_im,
                               const float* mu, float* o_re, float* o_im,
                               int lanes, long long per, int parts,
                               void* stream) {
  if (lanes == 0 || per == 0) return 0;
  admm_trip_rhs<<<dim3(parts, lanes), THREADS, 0, (cudaStream_t)stream>>>(
      h_re, h_im, z_re, z_im, n_re, n_im, c_re, c_im, mu, o_re, o_im, per);
  return finish();
}

extern "C" int twoace_trip_rows(const float* ax_re, const float* ax_im,
                                const float* y_re, const float* y_im,
                                const float* yo_re, const float* yo_im,
                                const float* b, float* out, int lanes, int r,
                                int m, int parts, int per_column,
                                void* stream) {
  if (lanes == 0) return 0;
  const size_t smem = per_column ? (size_t)r * WARPS * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_trip_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_trip_rows<<<dim3(parts, lanes), THREADS, smem,
                   (cudaStream_t)stream>>>(ax_re, ax_im, y_re, y_im, yo_re,
                                           yo_im, b, out, r, m, per_column);
  return finish();
}

extern "C" int twoace_trip_n_dual(
    const float* x_re, const float* x_im, const float* zn_re,
    const float* zn_im, const float* zo_re, const float* zo_im,
    const float* n_re, const float* n_im, float* no_re, float* no_im,
    const float* h_re, const float* h_im, const float* ho_re,
    const float* ho_im, const float* mu, const int* it,
    const unsigned char* conv, float* out, int lanes, long long per,
    int parts, int bound, void* stream) {
  if (lanes == 0) return 0;
  admm_trip_n_dual<<<dim3(parts, lanes), THREADS, 0, (cudaStream_t)stream>>>(
      x_re, x_im, zn_re, zn_im, zo_re, zo_im, n_re, n_im, no_re, no_im, h_re,
      h_im, ho_re, ho_im, mu, it, conv, out, per, bound);
  return finish();
}

// small_in / small_out: mu, last_res, opt_obj (float), it (int32),
// converged (bool, one byte); restore: ``count`` (source, destination,
// entries a lane) triples; tests: tol_rel, rho and the three thresholds'
// constant terms; px / py the old best-so-far, ox / oy the new
extern "C" int twoace_trip_commit(
    const float* rows, const float* cols, void* const* small_in,
    void* const* small_out, const float* tests, const float* const* rsrc,
    float* const* rdst, const long long* rper, int count, const float* x_re,
    const float* x_im, const float* y_re, const float* y_im,
    const float* px_re, const float* px_im, const float* py_re,
    const float* py_im, float* ox_re, float* ox_im, float* oy_re,
    float* oy_im, int lanes, int r, int m, int n,
    int row_parts, int col_parts, int parts, int per_column, int has_z,
    int bound, void* stream) {
  if (lanes == 0) return 0;
  if (count > MAX_RESTORE) return (int)cudaErrorInvalidValue;
  Small in{(const float*)small_in[0], (const float*)small_in[1],
           (const float*)small_in[2], (const int*)small_in[3],
           (const unsigned char*)small_in[4]};
  SmallOut out{(float*)small_out[0], (float*)small_out[1],
               (float*)small_out[2], (int*)small_out[3],
               (unsigned char*)small_out[4]};
  Tests t{tests[0], tests[1], tests[2], tests[3], tests[4]};
  Restore rs{};
  for (int q = 0; q < count; ++q) {
    rs.src[q] = rsrc[q];
    rs.dst[q] = rdst[q];
    rs.per[q] = rper[q];
  }
  rs.count = count;
  const int slots = 4 + (per_column ? r : 1);
  const size_t smem = (size_t)(slots + COL_SLOTS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        admm_trip_commit, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_trip_commit<<<dim3(parts, lanes), THREADS, smem,
                     (cudaStream_t)stream>>>(
      rows, cols, in, out, t, rs, x_re, x_im, y_re, y_im, px_re, px_im, py_re,
      py_im, ox_re, ox_im, oy_re, oy_im, r, m, n, row_parts, col_parts,
      per_column, has_z, bound);
  return finish();
}
