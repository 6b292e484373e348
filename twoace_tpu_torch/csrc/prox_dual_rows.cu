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
// At r = 1 the row form is the same function, and runs as it.
//
// What bounds it on the H100: neither bytes nor operations, but latency.
// At the main path's (972, 20) complex64 a call moves 0.62 MB (0.19 us at
// 3.35 TB/s) with about 20 flops an entry, far below one launch: the time
// is the launch plus one chain of dependent memory round trips.  Design:
//
// - every entry is loaded once, into registers, and held there across the
//   row's reduction; M / mu is one division an entry;
// - one entry a lane, rows packed per warp: a row takes `lanes` = r lanes
//   and a warp floor(32 / r) rows (r <= 16: 10 rows of 3 at r 3; one row
//   of 20 at r 20); rows longer than 32 hold `chunks` entries a lane; the
//   row sum is each lane's entries in order, then a shuffle tree over the
//   row's lanes in a fixed order;
// - the elementwise form (and r = 1) runs one entry a lane, no reduction;
// - the blocks hold 1-8 warps, as few as leave at least one block for each
//   of the 132 SMs (139 blocks at (972, 20), 152 in the elementwise form);
// - mu and b are loaded before the entries and in flight beside them.
// Two entries a lane (one 16-byte load, 10 lanes a row at r 20, 3 rows a
// warp) was measured slower at every row-form shape (PERF.md): a
// lane's divisions run one after another, and the time is that chain.
// Rows longer than 4 chunks (r > 128) are summed in a first pass and read
// again in a second (`held` = 0), so no size is refused.
// twoace_prox_dual_rows_plan returns the geometry, which
// ops/kernels/prox_dual_rows.py::plan mirrors.
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

constexpr int kSms = 132;        // the H100 SXM's SMs
constexpr int kMaxWarps = 8;     // warps a block
constexpr int kMaxHeld = 4;      // entries a lane held in registers

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

// y = ax + M / mu of one entry
template <typename T>
__device__ __forceinline__ typename R<T>::T2 shifted(typename R<T>::T2 a,
                                                     typename R<T>::T2 m,
                                                     T mu) {
  using O = R<T>;
  typename R<T>::T2 y;
  y.x = O::add(a.x, O::div(m.x, mu));
  y.y = O::add(a.y, O::div(m.y, mu));
  return y;
}

// the row's (or entry's) coefficient (b / d + mu) / (1 + mu) [b > 0]
template <typename T>
__device__ __forceinline__ T coefficient(T bi, T d, T mu, T one_mu) {
  using O = R<T>;
  return O::mul(O::div(O::add(O::div(bi, d), mu), one_mu),
                bi > T(0) ? T(1) : T(0));
}

// out = y c and M' = M + mu (ax - out) of one entry
template <typename T>
__device__ __forceinline__ void finish(typename R<T>::T2 a,
                                       typename R<T>::T2& m,
                                       typename R<T>::T2& y, T coeff, T mu) {
  using O = R<T>;
  y.x = O::mul(y.x, coeff);
  y.y = O::mul(y.y, coeff);
  m.x = O::add(m.x, O::mul(mu, O::sub(a.x, y.x)));
  m.y = O::add(m.y, O::mul(mu, O::sub(a.y, y.y)));
}

// The row form.  A warp holds rows_per_warp rows of `lanes` lanes each;
// lane k of a row holds entries k, k + lanes, ... (HELD of them in
// registers; HELD = 0 reads each entry again in a second pass).
template <typename T, int HELD>
__global__ void prox_dual_rows_kernel(
    const typename R<T>::T2* __restrict__ ax,
    const typename R<T>::T2* __restrict__ md, const T* __restrict__ b,
    const T* __restrict__ mu_ptr, typename R<T>::T2* __restrict__ y,
    typename R<T>::T2* __restrict__ mo, long long rows, int r, int lanes,
    int rows_per_warp, int chunks, int tree, T inv_sqrt_r) {
  using O = R<T>;
  using T2 = typename R<T>::T2;
  constexpr int kRegs = HELD > 0 ? HELD : 1;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int slot = lane / lanes;
  const int k = lane - slot * lanes;
  const long long row = warp * rows_per_warp + slot;
  const bool live = slot < rows_per_warp && row < rows;
  const long long base = row * (long long)r;

  const T mu = __ldg(mu_ptr);
  const T bi = live ? __ldg(b + row) : T(0);
  T2 a[kRegs], m[kRegs], ys[kRegs];
#pragma unroll
  for (int c = 0; c < kRegs; ++c) {
    const int e = k + c * lanes;
    if (HELD > 0 && live && e < r) {
      a[c] = __ldg(ax + base + e);
      m[c] = __ldg(md + base + e);
    }
  }

  // y = ax + M / mu, held in ys; the lane's part of sum |y|^2, in order
  T d2 = T(0);
  if (live) {
#pragma unroll
    for (int c = 0; c < (HELD > 0 ? HELD : chunks); ++c) {
      const int e = k + c * lanes;
      if (e >= r) break;
      const int h = HELD > 0 ? c : 0;
      if (HELD == 0) {
        a[0] = __ldg(ax + base + e);
        m[0] = __ldg(md + base + e);
      }
      ys[h] = shifted<T>(a[h], m[h], mu);
      d2 = O::add(d2, O::add(O::mul(ys[h].x, ys[h].x),
                             O::mul(ys[h].y, ys[h].y)));
    }
  }
  // the row's total in lane k = 0: a tree over its lanes in a fixed order
  // (every lane of the warp takes part in the shuffles), then broadcast
  for (int off = tree; off > 0; off >>= 1) {
    const T o = __shfl_down_sync(0xffffffffu, d2, off);
    if (k + off < lanes) d2 = O::add(d2, o);
  }
  d2 = __shfl_sync(0xffffffffu, d2, min(slot * lanes, 31));
  if (!live) return;

  const bool zero = d2 <= T(0);
  const T d = O::sqrt_(zero ? T(1) : d2);
  const T coeff = coefficient<T>(bi, d, mu, O::add(T(1), mu));
#pragma unroll
  for (int c = 0; c < (HELD > 0 ? HELD : chunks); ++c) {
    const int e = k + c * lanes;
    if (e >= r) break;
    const int h = HELD > 0 ? c : 0;
    if (HELD == 0) {
      a[0] = __ldg(ax + base + e);
      m[0] = __ldg(md + base + e);
    }
    T2 out = zero ? T2{inv_sqrt_r, T(0)}
                  : HELD > 0 ? ys[h] : shifted<T>(a[h], m[h], mu);
    T2 dual = m[h];
    finish<T>(a[h], dual, out, coeff, mu);
    y[base + e] = out;
    mo[base + e] = dual;
  }
}

// The elementwise form (per_entry = 1, and the row form at r = 1): a lane
// takes one entry, with its own norm.
template <typename T>
__global__ void prox_dual_entries_kernel(
    const typename R<T>::T2* __restrict__ ax,
    const typename R<T>::T2* __restrict__ md, const T* __restrict__ b,
    const T* __restrict__ mu_ptr, typename R<T>::T2* __restrict__ y,
    typename R<T>::T2* __restrict__ mo, long long entries, int r) {
  using O = R<T>;
  using T2 = typename R<T>::T2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= entries) return;
  // the entry's row, in 32 bits where it fits (a 64-bit division is a
  // long call)
  const long long row = entries <= 0xffffffffLL
                            ? (long long)((unsigned)i / (unsigned)r)
                            : i / r;
  const T mu = __ldg(mu_ptr);
  const T bi = __ldg(b + row);
  const T2 a = __ldg(ax + i);
  T2 m = __ldg(md + i);
  T2 out = shifted<T>(a, m, mu);
  const T d2 = O::add(O::mul(out.x, out.x), O::mul(out.y, out.y));
  const bool zero = d2 <= T(0);
  if (zero) out = T2{T(1), T(0)};
  const T d = O::sqrt_(zero ? T(1) : d2);
  finish<T>(a, m, out, coefficient<T>(bi, d, mu, O::add(T(1), mu)), mu);
  y[i] = out;
  mo[i] = m;
}

// The launch geometry (ops/kernels/prox_dual_rows.py::plan mirrors it).
struct Plan {
  int elementwise;    // the elementwise kernel (per_entry, or r = 1)
  int lanes;          // lanes a row (0: elementwise)
  int rows_per_warp;  // (0: elementwise)
  int chunks;         // entries a lane
  int held;           // entries a lane held in registers (0: two passes)
  int threads;        // a block
  int blocks;
};

Plan make_plan(long long rows, int r, int per_entry) {
  Plan p{};
  p.elementwise = per_entry || r == 1;
  long long warps;
  if (p.elementwise) {
    p.chunks = 1;
    p.held = 1;
    warps = (rows * r + 31) / 32;
  } else {
    p.lanes = r < 32 ? r : 32;
    p.rows_per_warp = 32 / p.lanes;
    p.chunks = (r + p.lanes - 1) / p.lanes;
    p.held = 1;
    while (p.held < p.chunks) p.held <<= 1;
    if (p.held > kMaxHeld) p.held = 0;
    warps = (rows + p.rows_per_warp - 1) / p.rows_per_warp;
  }
  long long per_block = warps / kSms;
  if (per_block < 1) per_block = 1;
  if (per_block > kMaxWarps) per_block = kMaxWarps;
  p.threads = 32 * (int)per_block;
  p.blocks = (int)((warps + per_block - 1) / per_block);
  return p;
}

template <typename T, int HELD>
void launch_rows(const Plan& p, const void* ax, const void* md,
                 const void* b, const void* mu, void* y, void* mo,
                 long long rows, int r, cudaStream_t s) {
  using T2 = typename R<T>::T2;
  int tree = 0;                 // the largest power of two below lanes
  while (2 * tree < p.lanes) tree = tree ? 2 * tree : 1;
  if (p.lanes <= 1) tree = 0;
  const T inv_sqrt_r = (T)(1.0 / sqrt((double)r));
  prox_dual_rows_kernel<T, HELD><<<p.blocks, p.threads, 0, s>>>(
      (const T2*)ax, (const T2*)md, (const T*)b, (const T*)mu, (T2*)y,
      (T2*)mo, rows, r, p.lanes, p.rows_per_warp, p.chunks, tree,
      inv_sqrt_r);
}

template <typename T>
void launch(const Plan& p, const void* ax, const void* md, const void* b,
            const void* mu, void* y, void* mo, long long rows, int r,
            cudaStream_t s) {
  using T2 = typename R<T>::T2;
  if (p.elementwise) {
    prox_dual_entries_kernel<T><<<p.blocks, p.threads, 0, s>>>(
        (const T2*)ax, (const T2*)md, (const T*)b, (const T*)mu, (T2*)y,
        (T2*)mo, rows * r, r);
    return;
  }
  switch (p.held) {
    case 1: launch_rows<T, 1>(p, ax, md, b, mu, y, mo, rows, r, s); break;
    case 2: launch_rows<T, 2>(p, ax, md, b, mu, y, mo, rows, r, s); break;
    case 4: launch_rows<T, 4>(p, ax, md, b, mu, y, mo, rows, r, s); break;
    default: launch_rows<T, 0>(p, ax, md, b, mu, y, mo, rows, r, s);
  }
}

}  // namespace

// The launch geometry for (rows, r), the row or the elementwise form:
// elementwise, lanes, rows_per_warp, chunks, held, threads, blocks into
// out[0 ... 6].
extern "C" int twoace_prox_dual_rows_plan(long long rows, int r,
                                          int per_entry, int* out) {
  const Plan p = make_plan(rows, r, per_entry);
  const int v[7] = {p.elementwise, p.lanes, p.rows_per_warp, p.chunks,
                    p.held, p.threads, p.blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

extern "C" int twoace_prox_dual_rows(const void* ax, const void* md,
                                     const void* b, const void* mu, void* y,
                                     void* mo, long long rows, int r,
                                     int per_entry, int is_double,
                                     void* stream) {
  if (rows <= 0 || r <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Plan p = make_plan(rows, r, per_entry);
  if (is_double)
    launch<double>(p, ax, md, b, mu, y, mo, rows, r, s);
  else
    launch<float>(p, ax, md, b, mu, y, mo, rows, r, s);
  return (int)cudaGetLastError();
}
