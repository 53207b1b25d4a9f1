// Stochastic-rounding quantize of a gradient to int8 codes, for Hopper:
// the unfused backward quantizers of the FQT step.
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize_sr.py
// quantize_sr_rows (body _kernel, PSQ: one affine pair per row) and
// quantize_sr_tensor (body _tensor_kernel, PTQ: one pair for the tensor).
// Per element, with B = 2^bits - 1 and [lo, hi] the range of the row or of
// the tensor:
//
//   scale  = B / max(hi - lo, 1e-12),  zero = lo
//   t      = scale * (x - lo)
//   c      = clip(floor(t + float(rbits) * 2^-32), 0, B) - 2^(bits-1)
//
// evaluated with explicitly rounded float operations (__fmul_rn & co.), so
// nvcc contracts nothing into an FMA, and the scale divided with __fdiv_rn:
// the codes, scales and zeros are bit-identical to the plain PyTorch
// versions in kernels/quantize_sr.py (min and max are exact, whatever the
// order of the reduction).  The SR bits arrive as prng.bits draws them,
// uint32 values held in int64; the kernels read each entry's low 32 bits as
// unsigned (modulo 2^32: values >= 2^31 never saturate) and convert with
// round-to-nearest (__uint2float_rn), as the plain cast does.
//
// What bounds them on an H100: device memory.  Each element reads 4 bytes
// of x and 8 of SR bits and writes 1 code byte; the statquant-tx lm_head
// gradient (512, 10240) moves 68 MB, 20.35 us at 3.35 TB/s.  Each needs
// the range before its first code, so a plain design reads x twice and
// waits out the reduction with nothing in flight.  Both designs here:
//
//   * A block owns one contiguous part of the flat tensor.  One thread
//     copies up to `stage` elements of x from the part's start into shared
//     memory with cp.async.bulk on an mbarrier (its 16-byte-aligned body;
//     a ragged word or three at either end go word by word).  Before the
//     block waits for the copy every thread issues the loads of its first
//     DEPTH quads of SR bits (two 16-byte loads a quad), so the bits stream
//     while x lands and the range is reduced from shared memory.  Then the
//     block quantizes, DEPTH quads of bits in flight a thread, and stores
//     4 codes with one 32-bit store (element by element at a ragged or
//     unaligned edge).  Where the part is longer than the stage (REST),
//     the rest is read for the range with an L2 evict_last hint and again,
//     backwards and evict_first, to quantize: the most recently read x is
//     still in L2.
//   * rows (PSQ): a row is split over a thread-block cluster of C = 1, 2, 4
//     or 8 blocks (kernels/quantize_sr.py rows_plan picks C from N).  The
//     blocks combine their partial (lo, hi) through distributed shared
//     memory, every block computes the same scale, and rank 0 writes the
//     row's scale and zero.  A narrow row (rows_plan: up to 1,024 columns)
//     is held in one block's registers instead: x and the bits loaded
//     together, one round trip, no stage.
//   * tensor (PTQ): one cooperative launch of at most the blocks the card
//     holds at once (tensor_plan), a chunk each, staged as far as the
//     resident blocks' shared memory reaches.  Each block writes its
//     partial (lo, hi) to a workspace, the grid meets at a grid-wide
//     barrier (cooperative_groups grid sync: the launch is refused, not
//     hung, if the grid cannot be co-resident), and every block reduces
//     all partials itself; block 0 writes the 0-d scale and zero.  Given a
//     range (lo, hi) in device memory, as a data-parallel step gives the
//     range of the whole batch (repro_torch/sharding/data.py), the blocks
//     skip the partials and the grid-wide barrier and use it: the Pallas
//     original takes its range from outside too.  Given the tensor's own
//     range, the codes, scale and zero are those of the in-kernel range.

#include <cooperative_groups.h>

#include <type_traits>

#include "int8_mma.cuh"
#include "kv_read.cuh"

namespace {

namespace cg = cooperative_groups;
using kv_read::aligned16;
using kv_read::bulk_load;
using kv_read::mbar_expect;
using kv_read::mbar_init;
using kv_read::mbar_wait;

// 256 threads, at most 64 registers a thread (4 blocks an SM), 2 quads of
// SR bits loaded ahead a thread: on an H100 depths of 1 to 4 quads timed
// alike, and capping the registers at 40 or 32 (6 or 8 blocks an SM) was
// slower at every shape timed.
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;
constexpr int WARPS = THREADS / 32;
constexpr int DEPTH = 2;
constexpr float EPS = 1e-12f;
constexpr float U32_TO_UNIT = 2.3283064365386963e-10f;   // 2^-32, exact

__device__ __forceinline__ int sr_code(float x, float s, float z,
                                       unsigned rb, float nbins, float off) {
  const float t = __fmul_rn(s, __fsub_rn(x, z));
  float q = floorf(__fadd_rn(t, __fmul_rn(__uint2float_rn(rb), U32_TO_UNIT)));
  q = fminf(fmaxf(q, 0.0f), nbins);
  return static_cast<int>(__fsub_rn(q, off));
}

// Elements [b, e) of the flat tensor through pointers offset by b, so a
// block's arithmetic is 32-bit: x[b + k] is P[xpre + k], with P the stage
// or, in device memory, x + b - xpre (both 16-byte aligned).  Quads lie on
// the codes' 4-byte grid, quad q at local element 4 q - cpre.
struct Range {
  const float* x;
  const long long* rb;
  int8_t* codes;
  const float* P;
  int len, nq, xpre, cpre;
};

__device__ __forceinline__ Range make_range(const float* x,
                                            const long long* rb,
                                            int8_t* codes, long long b,
                                            long long e) {
  Range r;
  r.x = x + b;
  r.rb = rb + b;
  r.codes = codes + b;
  r.len = static_cast<int>(max(0LL, e - b));
  r.xpre = static_cast<int>((reinterpret_cast<uintptr_t>(r.x) >> 2) & 3);
  r.cpre = static_cast<int>(reinterpret_cast<uintptr_t>(r.codes) & 3);
  r.nq = r.len > 0 ? (r.len + r.cpre + 3) / 4 : 0;
  r.P = r.x - r.xpre;
  return r;
}

// A block's part, rank `rank` of `parts` of [e0, e1) (part 0 from e0, the
// others from multiples of `span`, a multiple of 4, past the codes' first
// quad boundary; the last to e1): its staged head s (at most `stage`
// elements counted from the part's first quad) and, with REST, the rest r.
struct Part {
  Range s, r;
};

template <bool REST>
__device__ __forceinline__ Part part_of(const float* x, const long long* rb,
                                        int8_t* codes, long long e0,
                                        long long e1, long long span,
                                        int rank, int parts, long long stage,
                                        float* smem) {
  const long long a =
      e0 + static_cast<long long>(
               (4 - (reinterpret_cast<uintptr_t>(codes + e0) & 3)) & 3);
  const long long b = rank == 0 ? e0 : min(e1, a + rank * span);
  const long long e = rank == parts - 1 ? e1 : min(e1, a + (rank + 1) * span);
  const int cpre =
      static_cast<int>(reinterpret_cast<uintptr_t>(codes + b) & 3);
  const long long m = REST ? max(b, min(e, b - cpre + stage)) : e;
  Part p;
  p.s = make_range(x, rb, codes, b, m);
  p.s.P = smem;
  p.r = make_range(x, rb, codes, m, REST ? e : m);
  return p;
}

// Start the stage of r: the 16-byte-aligned body by one bulk copy (thread
// 0), the words outside it one a thread.  The caller syncs the block, then
// waits on `bar` if this returns true.
__device__ __forceinline__ bool stage_issue(const Range& r, float* stage,
                                            uint64_t* bar) {
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(r.x);
  const uintptr_t g1 = reinterpret_cast<uintptr_t>(r.x + r.len);
  const uintptr_t a0 = (g0 + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t a1 = g1 & ~static_cast<uintptr_t>(15);
  const bool bulk = a1 > a0;
  if (bulk && threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(a1 - a0);
    mbar_init(bar);
    mbar_expect(bar, bytes);
    bulk_load(stage + r.xpre + (a0 - g0) / 4,
              reinterpret_cast<const void*>(a0), bytes, bar);
  }
  const int head = bulk ? static_cast<int>(a0 - g0) / 4 : r.len;
  const int tail = bulk ? static_cast<int>(g1 - a1) / 4 : 0;
  for (int j = threadIdx.x; j < head + tail; j += THREADS) {
    const int k = j < head ? j : r.len - tail + (j - head);
    stage[r.xpre + k] = r.x[k];
  }
  return bulk;
}

__device__ __forceinline__ void minmax4(float2& m, float4 v) {
  m.x = fminf(m.x, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
  m.y = fmaxf(m.y, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
}

// Where a quad of x comes from: the stage, or device memory read for the
// range (and kept in L2 for the quantize pass) or read the last time.
enum Src { STAGE, FIRST_READ, LAST_READ };

// The first read of a re-read quad asks L2 to keep its line (evict_last),
// the last read lets it go (evict_first); the stage is shared memory.
template <Src SRC>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (SRC == STAGE) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    uint64_t pol;
    if constexpr (SRC == FIRST_READ)
      asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
    else
      asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
    float4 v;
    asm("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p), "l"(pol));
    return v;
  }
}

// Fold this thread's part of r, read through P, into m: the whole quads by
// 16-byte loads, four in flight, then the up to 3 + 3 words outside them.
template <Src SRC>
__device__ __forceinline__ void thread_minmax(float2& m, const Range& r,
                                              const float* P) {
  const int lim = r.xpre + r.len;
  const int k0 = (r.xpre + 3) & ~3, k1 = lim & ~3;
#pragma unroll 4
  for (int k = k0 + 4 * threadIdx.x; k < k1; k += 4 * THREADS)
    minmax4(m, load4<SRC>(P + k));
  const int head = min(k0, lim) - r.xpre, tail = max(k0, k1);
  const int edge = head + max(0, lim - tail);
  for (int j = threadIdx.x; j < edge; j += THREADS) {
    const float v = P[j < head ? r.xpre + j : tail + (j - head)];
    m.x = fminf(m.x, v);
    m.y = fmaxf(m.y, v);
  }
}

// The block's min and max, in every thread.  s_warp is free again once
// the block has passed another __syncthreads.
__device__ __forceinline__ float2 block_minmax(float2 m, float2* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m.x = fminf(m.x, __shfl_xor_sync(0xffffffffu, m.x, o));
    m.y = fmaxf(m.y, __shfl_xor_sync(0xffffffffu, m.y, o));
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x / 32] = m;
  __syncthreads();
  m = s_warp[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    m.x = fminf(m.x, s_warp[w].x);
    m.y = fmaxf(m.y, s_warp[w].y);
  }
  return m;
}

// What the quantize pass loads ahead for one quad: the low 32 bits of its
// SR bits (zeros outside the range) and, for a whole re-read quad on the
// 16-byte grid, its x (else x is read when the quad is coded).
struct Quad {
  unsigned b[4];
  float4 x;
};

template <bool REREAD>
__device__ __forceinline__ Quad load_quad(const Range& r, int q) {
  const int g = 4 * q - r.cpre;
  const bool whole = g >= 0 && g + 4 <= r.len;
  Quad o;
  if (whole && aligned16(r.rb + g)) {
    const longlong2* p = reinterpret_cast<const longlong2*>(r.rb + g);
    const longlong2 b0 = __ldcs(p), b1 = __ldcs(p + 1);
    o.b[0] = static_cast<unsigned>(b0.x);
    o.b[1] = static_cast<unsigned>(b0.y);
    o.b[2] = static_cast<unsigned>(b1.x);
    o.b[3] = static_cast<unsigned>(b1.y);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o.b[j] = g + j >= 0 && g + j < r.len
                   ? static_cast<unsigned>(__ldcs(r.rb + g + j)) : 0u;
  }
  if (REREAD && whole && ((r.xpre + g) & 3) == 0)
    o.x = load4<LAST_READ>(r.P + r.xpre + g);
  return o;
}

// Codes of quad q of r, x from the Quad (a whole re-read quad on the
// grid) or read through P: one 32-bit store where the quad is whole, else
// element by element.
template <Src SRC>
__device__ __forceinline__ void put_quad(const Range& r, const float* P,
                                         int q, const Quad& qd, float s,
                                         float z, float nbins, float off) {
  const int g = 4 * q - r.cpre;
  const int k = r.xpre + g;                     // P index of element g
  if (g >= 0 && g + 4 <= r.len) {
    float4 v;
    if ((k & 3) != 0)
      v = make_float4(P[k], P[k + 1], P[k + 2], P[k + 3]);
    else if constexpr (SRC == STAGE)
      v = *reinterpret_cast<const float4*>(P + k);
    else
      v = qd.x;
    const int c0 = sr_code(v.x, s, z, qd.b[0], nbins, off);
    const int c1 = sr_code(v.y, s, z, qd.b[1], nbins, off);
    const int c2 = sr_code(v.z, s, z, qd.b[2], nbins, off);
    const int c3 = sr_code(v.w, s, z, qd.b[3], nbins, off);
    *reinterpret_cast<unsigned*>(r.codes + g) = static_cast<unsigned>(
        (c0 & 0xff) | ((c1 & 0xff) << 8) | ((c2 & 0xff) << 16) |
        ((c3 & 0xff) << 24));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (g + j >= 0 && g + j < r.len)
        r.codes[g + j] = static_cast<int8_t>(
            sr_code(P[k + j], s, z, qd.b[j], nbins, off));
  }
}

// The quantize pass's t-th quad: with REST the re-read rest first,
// backwards (the most recently read x, still in L2), then the staged head.
template <bool REST>
__device__ __forceinline__ Quad load_at(const Part& pt, int t) {
  if (REST && t < pt.r.nq) return load_quad<true>(pt.r, pt.r.nq - 1 - t);
  return load_quad<false>(pt.s, t - (REST ? pt.r.nq : 0));
}

// The quantize pass over this thread's quads, the next DEPTH in flight
// while a quad is coded; pf holds the first ones (loaded before the range
// was known, so they stream while it is reduced).
template <bool REST>
__device__ __forceinline__ void sweep(const Part& pt, const float* stage,
                                      Quad (&pf)[DEPTH], float s, float z,
                                      float nbins, float off) {
  const int n = pt.s.nq + (REST ? pt.r.nq : 0);
  for (int t0 = 0; t0 < n; t0 += DEPTH * THREADS) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int t = t0 + threadIdx.x + d * THREADS;
      if (t < n) {
        if (REST && t < pt.r.nq)
          put_quad<LAST_READ>(pt.r, pt.r.P, pt.r.nq - 1 - t, pf[d], s, z,
                              nbins, off);
        else
          put_quad<STAGE>(pt.s, stage, t - (REST ? pt.r.nq : 0), pf[d], s,
                          z, nbins, off);
        if (t + DEPTH * THREADS < n)
          pf[d] = load_at<REST>(pt, t + DEPTH * THREADS);
      }
    }
  }
}

// Pass 1 of a block: start the stage and the first DEPTH quads' loads,
// read the rest for the range, then reduce.  Returns the block's (lo, hi)
// in every thread.
template <bool REST>
__device__ __forceinline__ float2 first_pass(const Part& pt, float* stage,
                                             uint64_t* bar,
                                             Quad (&pf)[DEPTH],
                                             float2* s_warp) {
  const bool bulk = pt.s.len > 0 && stage_issue(pt.s, stage, bar);
  const int n = pt.s.nq + (REST ? pt.r.nq : 0);
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int t = threadIdx.x + d * THREADS;
    if (t < n) pf[d] = load_at<REST>(pt, t);
  }
  float2 m = make_float2(INFINITY, -INFINITY);
  if (REST) thread_minmax<FIRST_READ>(m, pt.r, pt.r.P);
  __syncthreads();               // the stage's edge words and the mbarrier
  if (bulk) mbar_wait(bar, 0);
  thread_minmax<STAGE>(m, pt.s, stage);
  return block_minmax(m, s_warp);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// rows: C blocks (one cluster) a row; REST: a block's share of the row
// does not fit its stage
template <int C, bool REST>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
quantize_sr_rows_kernel(const float* __restrict__ x,
                        const long long* __restrict__ rbits,
                        int8_t* __restrict__ codes, float* __restrict__ scale,
                        float* __restrict__ zero, int N, long long span,
                        long long stage_elems, float nbins, float off) {
  extern __shared__ __align__(128) float stage[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float2 s_warp[WARPS];
  __shared__ float2 s_part;
  const long long row = blockIdx.x / C;
  const int rank = static_cast<int>(blockIdx.x % C);  // == cluster rank
  const Part pt = part_of<REST>(x, rbits, codes, row * N, row * N + N, span,
                                rank, C, stage_elems, stage);
  Quad pf[DEPTH];
  float2 m = first_pass<REST>(pt, stage, &bar, pf, s_warp);
  if constexpr (C > 1) {
    // the cluster's partials through distributed shared memory
    if (threadIdx.x == 0) s_part = m;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    float2 p[C];
#pragma unroll
    for (int i = 0; i < C; ++i) p[i] = *cl.map_shared_rank(&s_part, i);
    cluster_arrive();           // peers may leave once all have read
    m = p[0];
#pragma unroll
    for (int i = 1; i < C; ++i) {
      m.x = fminf(m.x, p[i].x);
      m.y = fmaxf(m.y, p[i].y);
    }
  }
  const float s = __fdiv_rn(nbins, fmaxf(__fsub_rn(m.y, m.x), EPS));
  if (rank == 0 && threadIdx.x == 0) {
    scale[row] = s;
    zero[row] = m.x;
  }
  sweep<REST>(pt, stage, pf, s, m.x, nbins, off);
  if constexpr (C > 1) cluster_wait();
}

// rows of at most REG_ROW columns, a block a row held in registers: each
// thread loads its (at most DEPTH) quads of x with their SR bits at once,
// before the range is known, folds them into the range and codes them from
// registers; no stage, no second read of x
constexpr int REG_ROW = 4 * (DEPTH * THREADS - 1);

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
quantize_sr_rows_reg_kernel(const float* __restrict__ x,
                            const long long* __restrict__ rbits,
                            int8_t* __restrict__ codes,
                            float* __restrict__ scale,
                            float* __restrict__ zero, int N, float nbins,
                            float off) {
  __shared__ float2 s_warp[WARPS];
  const long long row = blockIdx.x;
  const Range r = make_range(x, rbits, codes, row * N, row * N + N);
  Quad pf[DEPTH];
  float2 m = make_float2(INFINITY, -INFINITY);
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int q = threadIdx.x + d * THREADS;
    if (q < r.nq) {
      pf[d] = load_quad<false>(r, q);
      const int g = 4 * q - r.cpre, k = r.xpre + g;
      if (g >= 0 && g + 4 <= r.len && (k & 3) == 0) {
        pf[d].x = *reinterpret_cast<const float4*>(r.P + k);
        minmax4(m, pf[d].x);
      } else {
        for (int j = 0; j < 4; ++j) {
          if (g + j >= 0 && g + j < r.len) {
            m.x = fminf(m.x, r.P[k + j]);
            m.y = fmaxf(m.y, r.P[k + j]);
          }
        }
      }
    }
  }
  m = block_minmax(m, s_warp);
  const float s = __fdiv_rn(nbins, fmaxf(__fsub_rn(m.y, m.x), EPS));
  if (threadIdx.x == 0) {
    scale[row] = s;
    zero[row] = m.x;
  }
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int q = threadIdx.x + d * THREADS;
    if (q < r.nq)
      put_quad<LAST_READ>(r, r.P, q, pf[d], s, m.x, nbins, off);
  }
}

// tensor: one cooperative grid, a chunk a block; REST: a chunk does not fit
// its stage.  `given` (lo, hi), when not null, is the range to use: the
// partials and the grid-wide barrier are skipped (every block takes the
// branch alike).
template <bool REST>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
quantize_sr_tensor_kernel(const float* __restrict__ x,
                          const long long* __restrict__ rbits,
                          int8_t* __restrict__ codes,
                          float* __restrict__ scale, float* __restrict__ zero,
                          float2* __restrict__ part,
                          const float2* __restrict__ given, long long n,
                          long long chunk, long long stage_elems, float nbins,
                          float off) {
  extern __shared__ __align__(128) float stage[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float2 s_warp[WARPS];
  const Part pt = part_of<REST>(x, rbits, codes, 0, n, chunk, blockIdx.x,
                                gridDim.x, stage_elems, stage);
  Quad pf[DEPTH];
  float2 m = first_pass<REST>(pt, stage, &bar, pf, s_warp);
  if (given != nullptr) {
    m = __ldg(given);
  } else {
    if (threadIdx.x == 0) part[blockIdx.x] = m;
    cg::this_grid().sync();
    float2 t = make_float2(INFINITY, -INFINITY);
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
         i += THREADS) {
      const float2 p = __ldcg(part + i);
      t.x = fminf(t.x, p.x);
      t.y = fmaxf(t.y, p.y);
    }
    m = block_minmax(t, s_warp);  // s_warp's first use ended at the sync
  }
  const float s = __fdiv_rn(nbins, fmaxf(__fsub_rn(m.y, m.x), EPS));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *scale = s;
    *zero = m.x;
  }
  sweep<REST>(pt, stage, pf, s, m.x, nbins, off);
}

// The kernels by mode: rows 2 log2(C) + REST (0..7), tensor 8 + REST, rows
// in registers 10.
constexpr int MODES = 11;

template <int MODE>
constexpr auto kernel_of() {
  if constexpr (MODE < 8)
    return quantize_sr_rows_kernel<1 << (MODE / 2), (MODE & 1) != 0>;
  else if constexpr (MODE < 10)
    return quantize_sr_tensor_kernel<(MODE & 1) != 0>;
  else
    return quantize_sr_rows_reg_kernel;
}

// f(std::integral_constant<int, MODE>) for every mode, up to the first
// CUDA error
template <typename F, int MODE = 0>
cudaError_t for_modes(F f) {
  const cudaError_t e = f(std::integral_constant<int, MODE>());
  if constexpr (MODE + 1 < MODES) {
    if (e == cudaSuccess) return for_modes<F, MODE + 1>(f);
  }
  return e;
}

// Once a process: every kernel may take all of the opt-in shared memory and
// prefers the largest carveout, so a cooperative grid's co-residency is the
// one tensor_plan models.
template <int MODE>
cudaError_t prepare_one(int smem_optin) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel_of<MODE>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel_of<MODE>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_optin - static_cast<int>(a.sharedSizeBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel_of<MODE>(),
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// 0 or the first CUDA error of the process's preparation
int prepare() {
  static int err = -1;
  if (err >= 0) return err;
  int dev = 0, smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = for_modes([smem](auto mode) {
    return prepare_one<decltype(mode)::value>(smem);
  });
  return err = static_cast<int>(e);
}

// mode MODE's blocks an SM at no dynamic shared memory and its static
// shared memory, into out[MODE] and out[MODES + MODE]
template <int MODE>
cudaError_t report(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel_of<MODE>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + MODE, kernel_of<MODE>(), THREADS, 0);
  out[MODES + MODE] = static_cast<int>(a.sharedSizeBytes);
  return e;
}

template <int C, bool REST>
int launch_rows(const float* x, const long long* rbits, int8_t* codes,
                float* scale, float* zero, int M, int N, long long span,
                long long stage, int smem, float nbins, float off,
                cudaStream_t stream) {
  if constexpr (C == 1) {       // no cluster: a plain launch costs less
    quantize_sr_rows_kernel<1, REST><<<M, THREADS, smem, stream>>>(
        x, rbits, codes, scale, zero, N, span, stage, nbins, off);
    return static_cast<int>(cudaGetLastError());
  } else {
    return int8_mma::launch_clustered<quantize_sr_rows_kernel<C, REST>>(
        M * C, THREADS, smem, C, stream, x, rbits, codes, scale, zero, N,
        span, stage, nbins, off);
  }
}

template <int C>
int launch_rows(bool rest, const float* x, const long long* rbits,
                int8_t* codes, float* scale, float* zero, int M, int N,
                long long span, long long stage, int smem, float nbins,
                float off, cudaStream_t stream) {
  return rest ? launch_rows<C, true>(x, rbits, codes, scale, zero, M, N,
                                     span, stage, smem, nbins, off, stream)
              : launch_rows<C, false>(x, rbits, codes, scale, zero, M, N,
                                      span, stage, smem, nbins, off, stream);
}

// a stage the kernel cannot hold: not a multiple of 4, or more than smem
bool bad_stage(long long stage, int smem) {
  return stage < 0 || stage % 4 != 0 || smem < 0 ||
         (stage > 0 && smem < (stage + 8) * 4);
}

}  // namespace

// C interfaces, loaded with ctypes.  The launches return the launch's CUDA
// error (0 = launched); cudaErrorInvalidValue, unlaunched, for a plan the
// kernel cannot run.  A plan's `stage` (a multiple of 4) is how many of a
// block's elements go through shared memory (the rest are read twice), and
// `smem` its dynamic shared memory, at least (stage + 8) * 4 bytes.

// The card's numbers the plans need: out[0] SMs, out[1] shared memory an
// SM, out[2] opt-in shared memory a block, out[3] shared memory the system
// reserves a block; then for each kernel mode (rows 2 log2(C) + rest,
// tensor 8 + rest: rest 1 where a block's part does not fit its stage;
// rows in registers 10) its blocks an SM at no dynamic shared memory
// (out[4 + mode]) and its static shared memory (out[15 + mode]).  Returns
// 0 or the CUDA error.
extern "C" int quantize_sr_card(int* out) {
  const int err = prepare();
  if (err) return err;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 4 && e == cudaSuccess; ++i)
    e = cudaDeviceGetAttribute(out + i, attrs[i], dev);
  if (e == cudaSuccess) e = for_modes([out](auto mode) {
    return report<decltype(mode)::value>(out + 4);
  });
  return static_cast<int>(e);
}

// Blocks an SM of kernel `mode` at `smem` bytes of dynamic shared memory,
// as the occupancy calculator reports it (what a cooperative launch is held
// to), or minus the CUDA error.
extern "C" int quantize_sr_occupancy(int mode, int smem) {
  const int err = prepare();
  if (err) return -err;
  if (mode < 0 || mode >= MODES)
    return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t e = for_modes([&](auto m) {
    return decltype(m)::value == mode
               ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, kernel_of<decltype(m)::value>(), THREADS, smem)
               : cudaSuccess;
  });
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// x: (M, N) f32; rbits: (M, N) int64 SR bits; codes: (M, N) int8; scale,
// zero: (M,) f32 outputs.  The plan (rows_plan): `regs` 1, a block a row
// held in registers (N <= 4 * (2 * 256 - 1), cluster 1, stage 0); or
// `cluster` C in {1, 2, 4, 8} blocks a row, each on span = 4 * ceil(ceil(N
// / C) / 4) columns (the first up to 3 more), `stage` of them staged.
extern "C" int quantize_sr_rows(const float* x, const long long* rbits,
                                int8_t* codes, float* scale, float* zero,
                                int M, int N, int bits, int regs,
                                int cluster, long long stage, int smem,
                                void* stream) {
  if (M == 0 || N == 0) return 0;
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      bad_stage(stage, smem) ||
      (regs && (cluster != 1 || stage != 0 || N > REG_ROW)) ||
      static_cast<long long>(M) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare();
  if (err) return err;
  const float nbins = static_cast<float>((1 << bits) - 1);
  const float off = static_cast<float>(1 << (bits - 1));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (regs) {
    quantize_sr_rows_reg_kernel<<<M, THREADS, 0, st>>>(
        x, rbits, codes, scale, zero, N, nbins, off);
    return static_cast<int>(cudaGetLastError());
  }
  const long long span = ((N + cluster - 1) / cluster + 3) / 4 * 4;
  const bool rest = stage < span + 4;   // a part is at most span + 3 long
  switch (cluster) {
    case 1: return launch_rows<1>(rest, x, rbits, codes, scale, zero, M, N,
                                  span, stage, smem, nbins, off, st);
    case 2: return launch_rows<2>(rest, x, rbits, codes, scale, zero, M, N,
                                  span, stage, smem, nbins, off, st);
    case 4: return launch_rows<4>(rest, x, rbits, codes, scale, zero, M, N,
                                  span, stage, smem, nbins, off, st);
    default: return launch_rows<8>(rest, x, rbits, codes, scale, zero, M, N,
                                   span, stage, smem, nbins, off, st);
  }
}

// x: n f32; rbits: n int64; codes: n int8; scale, zero: one f32 each;
// part: 2 * grid f32 of workspace; range: null (the kernel reduces the
// tensor's range) or (lo, hi), 2 f32 8-byte aligned, the range to use.
// The plan (tensor_plan): `grid` blocks, all co-resident (or the launch is
// refused), on chunks of `chunk` elements (a multiple of 4, grid * chunk >=
// n), `stage` of each staged.
extern "C" int quantize_sr_tensor(const float* x, const long long* rbits,
                                  int8_t* codes, float* scale, float* zero,
                                  float* part, const float* range,
                                  long long n, int bits, int grid,
                                  long long chunk, long long stage, int smem,
                                  void* stream) {
  if (n == 0) return 0;
  if (grid < 1 || chunk < 4 || chunk % 4 != 0 || grid * chunk < n ||
      bad_stage(stage, smem) || (reinterpret_cast<uintptr_t>(range) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare();
  if (err) return err;
  const float nbins = static_cast<float>((1 << bits) - 1);
  const float off = static_cast<float>(1 << (bits - 1));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  float2* p = reinterpret_cast<float2*>(part);
  const float2* g = reinterpret_cast<const float2*>(range);
  const cudaError_t e =
      stage < chunk + 4
          ? cudaLaunchKernelEx(&cfg, quantize_sr_tensor_kernel<true>, x,
                               rbits, codes, scale, zero, p, g, n, chunk,
                               stage, nbins, off)
          : cudaLaunchKernelEx(&cfg, quantize_sr_tensor_kernel<false>, x,
                               rbits, codes, scale, zero, p, g, n, chunk,
                               stage, nbins, off);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
