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
// 3.35 TB/s) and does 50.3 MFLOP (0.75 us at 67 TFLOP/s); what takes the
// time is each instance's chain of dependent steps.  Design: one warp an
// instance, with no block barrier anywhere:
//
// - V G runs on the tensor cores in 3xTF32 (csrc/tf32x3.cuh::mma3_step:
//   m16 x n8 tiles over k8 steps, each operand split into TF32 halves, the
//   three Karatsuba products, each k8 step flushed into float32); n is
//   zero-padded up to NB, a multiple of 8 (the k8 steps' MMAs run side by
//   side, each from zero, and added in k order after, measured 1.5%
//   slower: the step is bound by the MMAs' issue, not their chain);
// - G is the same at every step: it is staged once, split once into TF32
//   B fragments, and held in registers for all steps (NB <= 16; at 24 and
//   32, in the warp's shared memory, in fragment order);
// - V lives in a warp-private shared tile (rows at a stride of NB + 4
//   floats, so that the A fragments' reads meet no bank twice): each step
//   rebuilds V's A fragments from it, and writes the scaled product back,
//   with __syncwarp only;
// - the norm is each lane's entries summed pairwise, then a butterfly of
//   xor shuffles: both in a fixed order, and every lane gets the same bits;
// - V and G come in, and V' goes out, with every load of a lane in flight
//   at once: 16-byte copies where n = NB and the planes are aligned;
// - a block takes 1-4 instances, as few as put every instance of B <= 528
//   on an SM of its own (128 blocks of 2 at B 256).
//
// Every sum and product outside the tensor cores is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn); 1/sqrt is the correctly rounded
// __frsqrt_rn.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

// ---- phase timer (built only with -DTWOACE_K6_PHASE_TIMER, by
// scripts/torch_k6_phases.py): the first thread of block 0 stamps
// %globaltimer after each part and sums the nanoseconds per slot over the
// launches until the host reads and clears them: loading V and G (with
// G's split), the steps' products (with V's A fragments), their norms with
// the warp barriers (and the writes of V for the next step), the stores.
enum K6Slot { K6_LOAD, K6_PROD, K6_NORM, K6_STORE, K6_LAUNCHES, K6_SLOTS };
#ifdef TWOACE_K6_PHASE_TIMER
__device__ unsigned long long g_k6_phase[K6_SLOTS];
__device__ __forceinline__ unsigned long long k6_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K6_MARK_START                                                \
  const bool k6_on = blockIdx.x == 0 && threadIdx.x == 0;            \
  unsigned long long k6_acc[K6_LAUNCHES] = {}, k6_t = k6_now();
#define K6_MARK(slot)                                                \
  if (k6_on) {                                                       \
    const unsigned long long k6_n = k6_now();                        \
    k6_acc[slot] += k6_n - k6_t;                                     \
    k6_t = k6_n;                                                     \
  }
#define K6_MARK_END                                                  \
  if (k6_on) {                                                       \
    for (int k6_s = 0; k6_s < K6_LAUNCHES; ++k6_s)                   \
      atomicAdd(&g_k6_phase[k6_s], k6_acc[k6_s]);                    \
    atomicAdd(&g_k6_phase[K6_LAUNCHES], 1ull);                       \
  }
#else
#define K6_MARK_START
#define K6_MARK(slot)
#define K6_MARK_END
#endif

namespace {

using twoace::aligned16;
using twoace::mma3_step;
using twoace::split;

constexpr int kMaxN = 32;
constexpr int kSms = 132;            // the H100 SXM's SMs
constexpr int kMaxInstances = 4;     // warps (instances) a block
constexpr int kStaticSmem = 48 * 1024;

// The shapes of one instance, n padded up to NB (8, 16, 24 or 32).
template <int NB>
struct Geo {
  static constexpr int KT = NB / 8;           // k8 steps = n8 tiles
  static constexpr int MT = (NB + 15) / 16;   // m16 tiles
  static constexpr int ROWS = MT * 16;        // the tile's rows
  static constexpr int S = NB + 4;            // a row's stride, in floats
  static constexpr bool kGRegs = NB <= 16;    // G's fragments in registers
  // entries (16-byte groups of four) of an n x n plane a lane moves
  static constexpr int kLoads = (NB * NB + 31) / 32;
  static constexpr int kLoads4 = (NB * NB / 4 + 31) / 32;
  // a warp's shared memory: V's tile and G's (both planes each), and G's
  // fragments where they are not in registers (a uint4 a lane per k8
  // step, n8 tile and Karatsuba form: big b0, b1, small b0, b1)
  static constexpr int kTileFloats = 2 * ROWS * S;
  static constexpr int kFragBytes = kGRegs ? 0 : KT * KT * 3 * 32 * 16;
  static constexpr int kBytes = 2 * kTileFloats * 4 + kFragBytes;
};

// P planes of one instance (n x n, row-major, from base on) into their
// tiles (or, with OUT, the tiles back into the planes): every load issued
// before the first store, so that a lane waits for one round trip, not
// one an entry.  FAST (n = NB, every plane 16-byte aligned) moves four
// entries a lane at a time and divides by a constant.
template <int NB, bool FAST, bool OUT, int P>
__device__ __forceinline__ void move(float* const (&global)[P],
                                     float* const (&tile)[P],
                                     long long base, int n, int lane) {
  using G = Geo<NB>;
  if constexpr (FAST) {
    constexpr int quads = NB * NB / 4;
    float4 v[P][G::kLoads4];
#pragma unroll
    for (int j = 0; j < G::kLoads4; ++j) {
      const int e = lane + 32 * j;
      const int o = (4 * e / NB) * G::S + 4 * e % NB;
      if (quads % 32 == 0 || e < quads) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          v[p][j] = OUT ? *reinterpret_cast<const float4*>(tile[p] + o)
                        : __ldg(reinterpret_cast<const float4*>(
                              global[p] + base) + e);
      }
    }
#pragma unroll
    for (int j = 0; j < G::kLoads4; ++j) {
      const int e = lane + 32 * j;
      const int o = (4 * e / NB) * G::S + 4 * e % NB;
      if (quads % 32 == 0 || e < quads) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (OUT)
            reinterpret_cast<float4*>(global[p] + base)[e] = v[p][j];
          else
            *reinterpret_cast<float4*>(tile[p] + o) = v[p][j];
        }
      }
    }
  } else {
    const int nn = n * n;
    float v[P][G::kLoads];
#pragma unroll
    for (int j = 0; j < G::kLoads; ++j) {
      const int e = lane + 32 * j;
      const int o = (e / n) * G::S + e % n;
#pragma unroll
      for (int p = 0; p < P; ++p)
        v[p][j] = e >= nn ? 0.0f : OUT ? tile[p][o] : __ldg(global[p] + base + e);
    }
#pragma unroll
    for (int j = 0; j < G::kLoads; ++j) {
      const int e = lane + 32 * j;
      const int o = (e / n) * G::S + e % n;
      if (e < nn) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (OUT)
            global[p][base + e] = v[p][j];
          else
            tile[p][o] = v[p][j];
        }
      }
    }
  }
}

// G's B fragment at k8 step kt, n8 tile nt, from the staged planes: the
// three Karatsuba forms (re + im, im, re), each split into TF32 halves
__device__ __forceinline__ void g_fragment(const float* tr, const float* ti,
                                           int s, int kt, int nt, int lane,
                                           uint32_t (&bb)[3][2],
                                           uint32_t (&bs)[3][2]) {
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int o = (kt * 8 + tig + q * 4) * s + nt * 8 + grp;
    const float x = tr[o], y = ti[o];
    split(__fadd_rn(x, y), bb[0][q], bs[0][q]);
    split(y, bb[1][q], bs[1][q]);
    split(x, bb[2][q], bs[2][q]);
  }
}

// V's A fragment at m16 tile mt, k8 step kt, from its tile: a0 (row grp,
// k tig), a1 (grp + 8, tig), a2 (grp, tig + 4), a3 (grp + 8, tig + 4), in
// the Karatsuba forms (re, re + im, im - re), each split into TF32 halves
__device__ __forceinline__ void v_fragment(const float* tr, const float* ti,
                                           int s, int mt, int kt, int lane,
                                           uint32_t (&ab)[3][4],
                                           uint32_t (&as)[3][4]) {
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = (mt * 16 + grp + (q & 1) * 8) * s + kt * 8 + tig +
                  (q >> 1) * 4;
    const float x = tr[o], y = ti[o];
    split(x, ab[0][q], as[0][q]);
    split(__fadd_rn(x, y), ab[1][q], as[1][q]);
    split(__fsub_rn(y, x), ab[2][q], as[2][q]);
  }
}

template <int NB, bool FAST>
__global__ void __launch_bounds__(32 * kMaxInstances)
chain_mm_kernel(const float* __restrict__ vr, const float* __restrict__ vi,
                const float* __restrict__ gr, const float* __restrict__ gi,
                float* __restrict__ out_r, float* __restrict__ out_i,
                int batch, int n, int steps) {
  using G = Geo<NB>;
  constexpr int KT = G::KT, MT = G::MT, S = G::S;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inst = blockIdx.x * (blockDim.x >> 5) + warp;
  if (inst >= batch) return;              // a whole warp: no block barriers
  K6_MARK_START
  const int grp = lane >> 2, tig = lane & 3;
  float* tr = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + warp * G::kBytes);
  float* ti = tr + G::ROWS * S;
  float* gtr = tr + G::kTileFloats;
  float* gti = gtr + G::ROWS * S;
  uint4* gfrag = reinterpret_cast<uint4*>(tr + 2 * G::kTileFloats);
  const long long base = (long long)inst * (FAST ? NB * NB : n * n);

  // V and G into tiles whose padding (rows and columns from n on) is zero
  if (!FAST || G::ROWS != NB) {
    float4* z = reinterpret_cast<float4*>(tr);
    for (int e = lane; e < G::kTileFloats / 2; e += 32)
      z[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();
  }
  float* const vg[4] = {const_cast<float*>(vr), const_cast<float*>(vi),
                        const_cast<float*>(gr), const_cast<float*>(gi)};
  if constexpr (NB <= 16) {
    move<NB, FAST, false, 4>(vg, {tr, ti, gtr, gti}, base, n, lane);
  } else {
    move<NB, FAST, false, 2>({vg[2], vg[3]}, {gtr, gti}, base, n, lane);
    move<NB, FAST, false, 2>({vg[0], vg[1]}, {tr, ti}, base, n, lane);
  }
  __syncwarp();
  // G split once into B fragments
  uint32_t gbb[G::kGRegs ? KT : 1][G::kGRegs ? KT : 1][3][2];
  uint32_t gbs[G::kGRegs ? KT : 1][G::kGRegs ? KT : 1][3][2];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      if constexpr (G::kGRegs) {
        g_fragment(gtr, gti, S, kt, nt, lane, gbb[kt][nt], gbs[kt][nt]);
      } else {
        uint32_t bb[3][2], bs[3][2];
        g_fragment(gtr, gti, S, kt, nt, lane, bb, bs);
#pragma unroll
        for (int f = 0; f < 3; ++f)
          gfrag[((kt * KT + nt) * 3 + f) * 32 + lane] =
              make_uint4(bb[f][0], bb[f][1], bs[f][0], bs[f][1]);
      }
    }
  K6_MARK(K6_LOAD)

  for (int step = 0; step < steps; ++step) {
    float acc[MT][KT][3][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][p][q] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ab[3][4], as[3][4];
        v_fragment(tr, ti, S, mt, kt, lane, ab, as);
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) {
          if constexpr (G::kGRegs) {
            mma3_step(acc[mt][nt], ab, as, gbb[kt][nt], gbs[kt][nt]);
          } else {
            uint32_t bb[3][2], bs[3][2];
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              const uint4 u = gfrag[((kt * KT + nt) * 3 + f) * 32 + lane];
              bb[f][0] = u.x;
              bb[f][1] = u.y;
              bs[f][0] = u.z;
              bs[f][1] = u.w;
            }
            mma3_step(acc[mt][nt], ab, as, bb, bs);
          }
        }
      }
    K6_MARK(K6_PROD)

    // V' = (k1 - k2, k1 + k3); its squared norm: the lane's entries summed
    // pairwise, then a butterfly over the lanes (a + b = b + a, so every
    // lane ends with the same bits); the scale
    constexpr int E = MT * KT * 4;
    float sq[E];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float re = __fsub_rn(acc[mt][nt][0][q], acc[mt][nt][1][q]);
          const float im = __fadd_rn(acc[mt][nt][0][q], acc[mt][nt][2][q]);
          acc[mt][nt][0][q] = re;
          acc[mt][nt][1][q] = im;
          sq[(mt * KT + nt) * 4 + q] =
              __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
#pragma unroll
    for (int w = 1; w < E; w *= 2)
#pragma unroll
      for (int k = 0; k + w < E; k += 2 * w) sq[k] = __fadd_rn(sq[k], sq[k + w]);
    float total = sq[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total = __fadd_rn(total, __shfl_xor_sync(0xffffffffu, total, off));
    const float scale = __frsqrt_rn(__fadd_rn(total, 1e-30f));
    // every lane has read this step's A fragments before any writes V'
    __syncwarp();
    // C: c0, c1 (row grp, cols 2 tig, 2 tig + 1), c2, c3 (row grp + 8)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < KT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = (mt * 16 + grp + h * 8) * S + nt * 8 + tig * 2;
          *reinterpret_cast<float2*>(tr + o) =
              make_float2(__fmul_rn(acc[mt][nt][0][2 * h], scale),
                          __fmul_rn(acc[mt][nt][0][2 * h + 1], scale));
          *reinterpret_cast<float2*>(ti + o) =
              make_float2(__fmul_rn(acc[mt][nt][1][2 * h], scale),
                          __fmul_rn(acc[mt][nt][1][2 * h + 1], scale));
        }
    __syncwarp();
    K6_MARK(K6_NORM)
  }
  move<NB, FAST, true, 2>({out_r, out_i}, {tr, ti}, base, n, lane);
  K6_MARK(K6_STORE)
  K6_MARK_END
}

template <int NB, bool FAST>
int launch(const void* vr, const void* vi, const void* gr, const void* gi,
           void* out_r, void* out_i, int batch, int n, int steps,
           cudaStream_t stream) {
  int per_block = (batch + kSms - 1) / kSms;
  if (per_block > kMaxInstances) per_block = kMaxInstances;
  while (per_block > 1 && per_block * Geo<NB>::kBytes > kStaticSmem)
    --per_block;
  const int blocks = (batch + per_block - 1) / per_block;
  chain_mm_kernel<NB, FAST>
      <<<blocks, 32 * per_block, per_block * Geo<NB>::kBytes, stream>>>(
          (const float*)vr, (const float*)vi, (const float*)gr,
          (const float*)gi, (float*)out_r, (float*)out_i, batch, n, steps);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_nb(const void* vr, const void* vi, const void* gr, const void* gi,
              void* out_r, void* out_i, int batch, int n, int steps,
              cudaStream_t stream) {
  const bool fast = n == NB && aligned16(vr) && aligned16(vi) &&
                    aligned16(gr) && aligned16(gi) && aligned16(out_r) &&
                    aligned16(out_i);
  return fast ? launch<NB, true>(vr, vi, gr, gi, out_r, out_i, batch, n,
                                 steps, stream)
              : launch<NB, false>(vr, vi, gr, gi, out_r, out_i, batch, n,
                                  steps, stream);
}

}  // namespace

extern "C" int twoace_chain_mm(const void* vr, const void* vi, const void* gr,
                               const void* gi, void* out_r, void* out_i,
                               int batch, int n, int steps, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 8) return launch_nb<8>(vr, vi, gr, gi, out_r, out_i, batch, n, steps, s);
  if (n <= 16) return launch_nb<16>(vr, vi, gr, gi, out_r, out_i, batch, n, steps, s);
  if (n <= 24) return launch_nb<24>(vr, vi, gr, gi, out_r, out_i, batch, n, steps, s);
  return launch_nb<32>(vr, vi, gr, gi, out_r, out_i, batch, n, steps, s);
}

#ifdef TWOACE_K6_PHASE_TIMER
// The phase timer's sums since the last read (K6_SLOTS values:
// nanoseconds per slot, then block 0's launches), copied to out and
// cleared.
extern "C" int twoace_chain_mm_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_k6_phase,
                                         sizeof(unsigned long long) * K6_SLOTS);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[K6_SLOTS] = {};
  return (int)cudaMemcpyToSymbol(g_k6_phase, zero, sizeof(zero));
}
#endif
