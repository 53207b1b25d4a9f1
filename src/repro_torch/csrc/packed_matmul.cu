// int8 x bit-packed -> int32 GEMM with the affine epilogue, for Hopper's
// int8 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/q4_matmul.py
// packed_matmul (body _kernel): q8_matmul with the weight operand kept
// bit-packed in device memory (kernels/pack.py layout: ppb = 8 / wbits
// unsigned codes a byte along K).  It is the unfused forward GEMM against
// packed weights: a weight_bits serving engine under fused=False, and the
// training forward under the int4w/binary/ternary weight quantizers with
// fused=False (core/backend.py _packed_gemm).
//
// What it computes, per output (i, j), with w8_kj = code_kj - 2^(wbits-1)
// for k < kdim (the pack's padding rows unpack to code 0, not to the
// shifted zero, and are masked):
//   acc_ij = sum_k x8_ik * w8_kj                                (int32, exact)
//   out_ij = acc_ij*(rs_i*cs_j) + r2_i*u_j + a_i + b_j
// the q8_matmul epilogue term for term, every float operation rounded
// explicitly (__fmul_rn, __fadd_rn) in the reference's order and applied
// once to the full sums, so the result is bit-identical to the plain
// PyTorch version in kernels/q4_matmul.py.
//
// What bounds it on an H100: at decode (M = slot count) the K*N/ppb packed
// weight bytes, read once, 8.4 MB for the 2048 x 8192 MLP projection at 4
// bits, 2.5 us at 3.35 TB/s.  The first port's __dp4a tile took 53.5 us
// there (no load in flight, one byte a thread a load).  This kernel runs
// the packed forward's tiles (fused_qlhs_gemm.cuh Tile with B packed, the
// same packed-B stage: load_b, then int8_mma.cuh unpack_b into the
// swizzled K-major tile) on int8_mma.cuh: the int8 LHS codes go by
// cp.async straight into their swizzled tile, as q8_matmul.cu's A does (no
// quantize, no row sums); a ring of cp.async stages keeps the next stages'
// bytes in flight while the warps run mma.sync m16n8k32 on this one;
// split-K in clusters (kernels/splitk.py) sums the slices' int32 tiles
// exactly in distributed shared memory; the epilogue's vectors are read
// into shared memory while the first stages are in flight and the outputs
// leave as 16-byte stores.  A decode tile of 16 x 256 outputs for M <= 16
// and a 64 x 256 one above, as for the packed forward.  Ragged M, N and K
// edges and unaligned rows are masked in the loaders and the unpack.

#include <cstdint>
#include <cuda_runtime.h>

#include "fused_qlhs_gemm.cuh"

namespace {

using namespace fused_qlhs_gemm;

// A stage: the LHS codes' swizzled tile, then B's packed bytes.  The ring
// (reused by the accumulator tile after the K sweep), then the K-major B
// tile.
template <class T>
__host__ __device__ constexpr int stage_bytes() {
  return T::A_BYTES + T::B_BYTES;
}
template <class T>
__host__ __device__ constexpr int ring_bytes() {
  return T::STAGES * stage_bytes<T>() > T::PART_BYTES
             ? T::STAGES * stage_bytes<T>()
             : T::PART_BYTES;
}
template <class T>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<T>() + T::BT_BYTES;
}

// chunks of 16 LHS codes a stage, and a thread's share (the decode tile
// has fewer chunks than threads)
template <class T>
__host__ __device__ constexpr int a_chunks() {
  return T::BM * T::CH;
}
template <class T>
__host__ __device__ constexpr int a_per_thread() {
  return (a_chunks<T>() + T::THREADS - 1) / T::THREADS;
}

template <class T>
__device__ __forceinline__ void load_stage(uint8_t* st, const RowSrc* sa,
                                           const uint8_t* packed, int N,
                                           int K, int n0, int k0, int t) {
  constexpr int CH = T::CH;
#pragma unroll
  for (int i = 0; i < a_per_thread<T>(); ++i) {
    const int id = t + T::THREADS * i;
    if (id >= a_chunks<T>()) break;
    load_row_chunk(st + swz<CH>(id / CH, id % CH), sa[i], k0 + 16 * (id % CH));
  }
  load_b<T>(st + T::A_BYTES, nullptr, packed, N, K, n0, k0, t);
}

template <class T, int SPLITS>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
packed_matmul_kernel(const uint8_t* __restrict__ x8,
                     const uint8_t* __restrict__ packed,
                     const float* __restrict__ rs,
                     const float* __restrict__ cs,
                     const float* __restrict__ r2,
                     const float* __restrict__ u,
                     const float* __restrict__ a,
                     const float* __restrict__ b, float* __restrict__ out,
                     int M, int N, int K, int k_span) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, THREADS = T::THREADS;
  constexpr int SB = stage_bytes<T>();
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
  uint8_t* bt = smem + ring_bytes<T>();        // the K-major B tile
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;

  int acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0;

  // the LHS rows behind the thread's chunks, fixed for the K sweep
  RowSrc sa[a_per_thread<T>()];
#pragma unroll
  for (int i = 0; i < a_per_thread<T>(); ++i) {
    const int m = m0 + (t + THREADS * i) / T::CH;
    sa[i] = row_src(x8, m, K, m < M);
  }
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < steps)
      load_stage<T>(smem + s * SB, sa, packed, N, K, n0, k_beg + s * BK, t);
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
    cp_async_wait<T::STAGES - 2>();
    // also: the B tile's readers of the previous step are done
    __syncthreads();
    const int next = kk + T::STAGES - 1;
    if (next < steps)
      load_stage<T>(smem + (next % T::STAGES) * SB, sa, packed, N, K, n0,
                    k_beg + next * BK, t);
    cp_async_commit();
    const uint8_t* st = smem + (kk % T::STAGES) * SB;
    const uint8_t* bs = b_tile<T>(bt, st + T::A_BYTES, k_beg + kk * BK, K, t);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc)
      warp_mma_k32<T::MI, T::NJ, T::CH>(acc, st, wm * T::WM, bs, wn * T::WN,
                                        kc, lane);
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free and the vectors are in

  int* tile = reinterpret_cast<int*>(smem);
  acc_to_tile<T::MI, T::NJ, T::LDT>(tile, acc, wm * T::WM, wn * T::WN,
                                    lane);
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

template <class T>
int launch(const int8_t* x8, const uint8_t* packed, const float* rs,
           const float* cs, const float* r2, const float* u, const float* a,
           const float* b, float* out, int M, int N, int K, int splits,
           int k_span, cudaStream_t s) {
  const int tiles = ((M + T::BM - 1) / T::BM) * ((N + T::BN - 1) / T::BN);
  const uint8_t* x = reinterpret_cast<const uint8_t*>(x8);
#define PACKED_SPLIT(S)                                                   \
  case S:                                                                 \
    return launch_clustered<packed_matmul_kernel<T, S>>(                  \
        tiles * S, T::THREADS, smem_bytes<T>(), S, s, x, packed, rs, cs,  \
        r2, u, a, b, out, M, N, K, k_span);
  switch (splits) {
    PACKED_SPLIT(1) PACKED_SPLIT(2) PACKED_SPLIT(3) PACKED_SPLIT(4)
    PACKED_SPLIT(5) PACKED_SPLIT(6) PACKED_SPLIT(7) PACKED_SPLIT(8)
  }
#undef PACKED_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The tile of `mode` as built, for the wrapper's split plan
// (kernels/splitk.py): {BM, BN, BK, THREADS, NACC, STAGES, smem bytes,
// smem bytes}; all -1 for an unknown mode.
extern "C" void packed_matmul_tile(int mode, int* cfg) {
#define TILE_CONFIG(T)                                                    \
  {                                                                       \
    const int v[8] = {T::BM, T::BN, T::BK, T::THREADS, T::NACC,           \
                      T::STAGES, smem_bytes<T>(), smem_bytes<T>()};       \
    for (int i = 0; i < 8; ++i) cfg[i] = v[i];                            \
    return;                                                               \
  }
  PACKED_TILE_CASES(TILE_CONFIG)
#undef TILE_CONFIG
  for (int i = 0; i < 8; ++i) cfg[i] = -1;
}

// Blocks of the tile of `mode` the card runs at once in clusters of
// `cluster` (1..8) (minus the CUDA error on failure): what
// kernels/splitk.py plans with.
extern "C" int packed_matmul_capacity(int mode, int cluster) {
#define TILE_CAPACITY(T)                                                  \
  return cluster_capacity<packed_matmul_kernel<T, 8>>(                    \
      T::THREADS, smem_bytes<T>(), cluster);
  PACKED_TILE_CASES(TILE_CAPACITY)
#undef TILE_CAPACITY
  return -static_cast<int>(cudaErrorInvalidValue);
}

// C interface, loaded with ctypes.  x8: (M, K) int8; packed: (ceil(K/ppb),
// N) uint8 at the width of `mode` (above); K is the logical contraction
// length.  The wrapper's split plan gives `splits` K slices (1..8, one
// cluster a tile) of k_span codes (a multiple of the tile's BK; the last
// may be shorter).  One launch; returns its CUDA error (0 = launched),
// cudaErrorInvalidValue for an unknown mode or a bad split.
extern "C" int packed_matmul(const int8_t* x8, const uint8_t* packed,
                             const float* rs, const float* cs,
                             const float* r2, const float* u, const float* a,
                             const float* b, float* out, int M, int N, int K,
                             int mode, int splits, int k_span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TILE_LAUNCH(T)                                                    \
  if (!valid_split<T>(K, splits, k_span)) break;                          \
  return launch<T>(x8, packed, rs, cs, r2, u, a, b, out, M, N, K, splits, \
                   k_span, s);
  PACKED_TILE_CASES(TILE_LAUNCH)
#undef TILE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
