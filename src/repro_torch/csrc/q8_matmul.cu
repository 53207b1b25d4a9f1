// int8 x int8 -> int32 GEMM with the affine epilogue, for Hopper's int8
// tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/q8_matmul.py q8_matmul
// (body _kernel): the unfused quantized GEMM of core/backend.py q8_gemm.
// On the training path it is the activation-grad GEMM under BHQ,
// Q_b2(dY) @ Q_theta(W).T, computed on the raw Householder-domain codes
// before the S^-1 epilogue (core/backend.py qt_gemm_nt), and, unfused, the
// forward (qt_gemm) and the weight grad (qt_gemm_tn) too.
//
// What it computes, per output (i, j):
//   acc_ij = sum_k x8_ik * y8_kj                                (int32, exact)
//   out_ij = acc_ij*(rs_i*cs_j) + r2_i*u_j + a_i + b_j
// with every float operation rounded explicitly (__fmul_rn, __fadd_rn) in
// the reference's order, applied once to the full sum, so the result is
// bit-identical to the plain PyTorch version in kernels/q8_matmul.py.
//
// Layouts: x8 is (M, K) row-major.  y8 is (K, N) either row-major
// (N-major: the unfused forward's weight codes and dW's dY codes) or
// K-major, i.e. stored (N, K) row-major: the BHQ dX GEMM reads the
// (d_in, d_out) weight codes as their transpose, whose K axis is already
// contiguous, so the wrapper passes the view and no copy is made.
//
// What bounds it on an H100: at the training shapes (M = 512 tokens,
// K, N <= 10240) it moves M*K + K*N int8 bytes and 4*M*N float bytes and
// does 2*M*N*K int8 operations: a few us either way (bytes over 3.35 TB/s,
// operations over 1,979 TOP/s).  What cost the old __dp4a tile 443 us at
// lm_head (512, 10240, 512) was latency: 128 blocks each swept 160 K steps
// in series with nothing in flight.  This design (int8_mma.cuh):
//   * a 64 x 128 output tile a block, 4 warps of 32 x 64, mma.sync
//     m16n8k32 from ldmatrix fragments;
//   * a ring of STAGES = 4 cp.async stages of BK = 64 K codes (A 4 KB,
//     B 8 KB a stage: 48 KB, plus 8 KB for the transposed B of the N-major
//     layout; 3 blocks fit an SM's 227 KB), three stages in flight while
//     one is in the tensor cores; each thread's source rows are resolved
//     once, so a stage's load is an add, a compare and the cp.async;
//   * split-K in clusters (kernels/splitk.py): lm_head runs 32 tiles x 8
//     slices of 20 K steps, 256 blocks, instead of 32 blocks of 160;
//   * the epilogue's vectors are read into shared memory while the first
//     stages are in flight, and the outputs leave as 16-byte stores from
//     the shared accumulator tile (storing each fragment's scattered
//     floats took longer than the K sweep).
// A K-major B tile goes straight from cp.async into its swizzled tile.  An
// N-major B tile lands as it is stored (k rows of 128 n codes), and each
// stage is transposed in registers, 4 x 4 bytes a thread with __byte_perm
// (int8_mma.cuh transpose_b), into the K-major tile (int8 ldmatrix has no
// transpose).  Ragged M, N
// and K edges and unaligned rows are masked in the loaders (codes outside
// the matrix are 0), so the wrapper never pads or slices.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

using namespace int8_mma;

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int CH = BK / 16;           // 16-byte chunks a tile row
constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int STAGES = 4;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp tile
constexpr int MI = WM / 16, NJ = WN / 8;
constexpr int NACC = MI * NJ * 4;     // int32 accumulators a thread
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int LDT = BN + 8;           // int32 row of the accumulator tile
static_assert(BM * LDT * 4 <= STAGES * STAGE_BYTES,
              "the accumulator tile reuses the ring");

// Shared memory of one block: the ring, and the transposed B tile of the
// N-major layout.
constexpr int smem_bytes(bool b_kmajor) {
  return STAGES * STAGE_BYTES + (b_kmajor ? 0 : B_BYTES);
}

// Chunks of 16 codes a thread loads each stage: A, and a K-major B.
constexpr int AC = BM * CH / THREADS;
constexpr int BC = BN * CH / THREADS;
static_assert(AC * THREADS == BM * CH && BC * THREADS == BN * CH,
              "whole chunks a thread");

// The rows behind a thread's K-major chunks, fixed for the K sweep: chunk
// i of a kind is id = t + THREADS * i, row id / CH, at byte 16 (id % CH)
// of the stage's K range.
struct Sources {
  RowSrc a[AC], b[BC];
};

template <bool B_KMAJOR>
__device__ __forceinline__ Sources sources(const uint8_t* x,
                                           const uint8_t* y, int M, int N,
                                           int K, int m0, int n0, int t) {
  Sources s;
#pragma unroll
  for (int i = 0; i < AC; ++i) {
    const int m = m0 + (t + THREADS * i) / CH;
    s.a[i] = row_src(x, m, K, m < M);
  }
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    const int n = n0 + (t + THREADS * i) / CH;
    s.b[i] = row_src(y, n, K, B_KMAJOR && n < N);
  }
  return s;
}

template <bool B_KMAJOR>
__device__ __forceinline__ void load_stage(uint8_t* st, const Sources& s,
                                           const uint8_t* y, int N, int K,
                                           int n0, int k0, int t) {
  // A: BM rows x CH chunks
#pragma unroll
  for (int i = 0; i < AC; ++i) {
    const int id = t + THREADS * i, r = id / CH, c = id % CH;
    load_row_chunk(st + swz<CH>(r, c), s.a[i], k0 + 16 * c);
  }
  uint8_t* bs = st + A_BYTES;
  if (B_KMAJOR) {
    // B stored (N, K): BN rows x CH chunks
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      const int id = t + THREADS * i, r = id / CH, c = id % CH;
      load_row_chunk(bs + swz<CH>(r, c), s.b[i], k0 + 16 * c);
    }
  } else {
    // B stored (K, N): BK rows x BN / 16 chunks, as stored
    load_b_raw<BK, BN, THREADS>(bs, y, N, K, n0, k0, t);
  }
}

template <bool B_KMAJOR, int SPLITS>
__global__ void __launch_bounds__(THREADS, 3)
q8_matmul_kernel(const int8_t* __restrict__ x8,
                 const int8_t* __restrict__ y8,
                 const float* __restrict__ rs, const float* __restrict__ cs,
                 const float* __restrict__ r2, const float* __restrict__ u,
                 const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int M, int N, int K, int k_span) {
  extern __shared__ __align__(128) uint8_t smem[];
  // the epilogue's vectors, loaded while the first stages are in flight
  __shared__ float cs_s[BN], u_s[BN], b_s[BN], rs_s[BM], r2_s[BM], a_s[BM];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_tiles = (N + BN - 1) / BN;
  const BlockCoords bc = block_coords(n_tiles, SPLITS);
  const int m0 = bc.m_tile * BM, n0 = bc.n_tile * BN;
  const int k_beg = bc.split * k_span;
  const int steps = (min(K, k_beg + k_span) - k_beg + BK - 1) / BK;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x8);
  const uint8_t* yb = reinterpret_cast<const uint8_t*>(y8);
  uint8_t* bt = smem + STAGES * STAGE_BYTES;   // N-major: transposed B
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;

  const Sources src = sources<B_KMAJOR>(xb, yb, M, N, K, m0, n0, t);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_stage<B_KMAJOR>(smem + s * STAGE_BYTES, src, yb, N, K, n0,
                           k_beg + s * BK, t);
    cp_async_commit();
  }
  for (int i = t; i < BN; i += THREADS) {
    const int n = n0 + i;
    cs_s[i] = n < N ? cs[n] : 0.0f;
    u_s[i] = n < N ? u[n] : 0.0f;
    b_s[i] = n < N ? b[n] : 0.0f;
  }
  for (int i = t; i < BM; i += THREADS) {
    const int m = m0 + i;
    rs_s[i] = m < M ? rs[m] : 0.0f;
    r2_s[i] = m < M ? r2[m] : 0.0f;
    a_s[i] = m < M ? a[m] : 0.0f;
  }

  for (int kk = 0; kk < steps; ++kk) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage read in the previous step is free again
    const int next = kk + STAGES - 1;
    if (next < steps)
      load_stage<B_KMAJOR>(smem + (next % STAGES) * STAGE_BYTES, src, yb, N,
                           K, n0, k_beg + next * BK, t);
    cp_async_commit();
    const uint8_t* st = smem + (kk % STAGES) * STAGE_BYTES;
    const uint8_t* bs = st + A_BYTES;
    if (!B_KMAJOR) {
      // bt's readers of the previous step all passed the barrier above
      transpose_b<BK, BN, THREADS>(bt, bs, t);
      __syncthreads();
      bs = bt;
    }
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc)
      warp_mma_k32<MI, NJ, CH>(acc, st, wm * WM, bs, wn * WN, kc, lane);
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free and the vectors are in

  int* tile = reinterpret_cast<int*>(smem);
  acc_to_tile<MI, NJ, LDT>(tile, acc, wm * WM, wn * WN, lane);
  reduce_tile<BM, BN, THREADS, SPLITS>(
      tile, nullptr, [&](int row, int col, int4 v, int) {
        const int m = m0 + row, n = n0 + col;
        if (m >= M) return;
        const int s4[4] = {v.x, v.y, v.z, v.w};
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = __fadd_rn(
              __fadd_rn(
                  __fadd_rn(__fmul_rn(static_cast<float>(s4[j]),
                                      __fmul_rn(rs_s[row], cs_s[col + j])),
                            __fmul_rn(r2_s[row], u_s[col + j])),
                  a_s[row]),
              b_s[col + j]);
        store4(out, m, n, N, o);
      });
}

template <bool B_KMAJOR, int SPLITS>
int launch(const int8_t* x8, const int8_t* y8, const float* rs,
           const float* cs, const float* r2, const float* u, const float* a,
           const float* b, float* out, int M, int N, int K, int k_span,
           cudaStream_t s) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  return launch_clustered<q8_matmul_kernel<B_KMAJOR, SPLITS>>(tiles * SPLITS,
                          THREADS, smem_bytes(B_KMAJOR), SPLITS, s, x8, y8,
                          rs, cs, r2, u, a, b, out, M, N, K, k_span);
}

template <bool B_KMAJOR>
int launch(const int8_t* x8, const int8_t* y8, const float* rs,
           const float* cs, const float* r2, const float* u, const float* a,
           const float* b, float* out, int M, int N, int K, int splits,
           int k_span, cudaStream_t s) {
  switch (splits) {
    case 1:
      return launch<B_KMAJOR, 1>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 k_span, s);
    case 2:
      return launch<B_KMAJOR, 2>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 k_span, s);
    case 3:
      return launch<B_KMAJOR, 3>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 k_span, s);
    case 4:
      return launch<B_KMAJOR, 4>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 k_span, s);
    case 5:
      return launch<B_KMAJOR, 5>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 k_span, s);
    case 6:
      return launch<B_KMAJOR, 6>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 k_span, s);
    case 7:
      return launch<B_KMAJOR, 7>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 k_span, s);
    case 8:
      return launch<B_KMAJOR, 8>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 k_span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The tile this library was built with, for the wrapper's split plan
// (kernels/splitk.py): {BM, BN, BK, THREADS, NACC, STAGES,
// smem bytes K-major, smem bytes N-major}.
extern "C" void q8_matmul_tile(int* cfg) {
  const int v[8] = {BM, BN, BK, THREADS, NACC, STAGES, smem_bytes(true),
                    smem_bytes(false)};
  for (int i = 0; i < 8; ++i) cfg[i] = v[i];
}

// Blocks the card runs at once in clusters of `cluster` (1..8), K-major
// or N-major B (minus the CUDA error on failure): what kernels/splitk.py
// plans with.
extern "C" int q8_matmul_capacity(int b_kmajor, int cluster) {
  return b_kmajor ? cluster_capacity<q8_matmul_kernel<true, 8>>(
                        THREADS, smem_bytes(true), cluster)
                  : cluster_capacity<q8_matmul_kernel<false, 8>>(
                        THREADS, smem_bytes(false), cluster);
}

// C interface, loaded with ctypes.  y8 is (K, N) row-major when
// b_kmajor == 0 and stored (N, K) row-major when b_kmajor != 0.  The
// wrapper's split plan gives `splits` K slices (1, 2, 4 or 8, one cluster
// a tile) of k_span codes (a multiple of BK; the last may be shorter).
// One launch; returns its CUDA error (0 = launched).
extern "C" int q8_matmul(const int8_t* x8, const int8_t* y8, const float* rs,
                         const float* cs, const float* r2, const float* u,
                         const float* a, const float* b, float* out, int M,
                         int N, int K, int b_kmajor, int splits, int k_span,
                         void* stream) {
  if (splits < 1 || splits > 8 || k_span < 1 || k_span % BK != 0 ||
      static_cast<long long>(splits) * k_span < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b_kmajor ? launch<true>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                 splits, k_span, s)
                  : launch<false>(x8, y8, rs, cs, r2, u, a, b, out, M, N, K,
                                  splits, k_span, s);
}
