// The fused-quantize LHS GEMM on the int8 tensor-core tile (int8_mma.cuh):
// out = Q(xf) @ B-hat, with the per-row quantize of the f32 LHS done in
// the K sweep, so no int8 codes of it reach device memory.  Three entries
// instantiate it, one B layout each:
//   fused_qlhs_dx.cu      dX = Q_b2(dY) @ Q_theta(W).T: B the (N, K) =
//                         (d_in, d_out) weight codes read as their
//                         transpose, K-major, straight from cp.async into
//                         the tile;
//   fused_qlhs_fwd.cu     the int8 forward Q_f(X) @ Q_theta(W): B the
//                         (K, N) weight codes, N-major, landing as stored
//                         in a raw stage and transposed in shared memory
//                         (int8_mma.cuh transpose_b);
//   fused_qlhs_packed.cu  the packed forward Q_f(X) @ W-hat: B the weight
//                         codes bit-packed at 1, 2, 4 or 8 bits along K,
//                         landing as stored and unpacked in shared memory
//                         (int8_mma.cuh unpack_b).
// packed_matmul.cu runs the same tiles and B stages with an int8 LHS
// (load_b, b_tile).
//
// What it computes, per output (i, j):
//   t_ik   = scale_i * (x_ik - zero_i)
//   c_ik   = clip(rint(t_ik), 0, 2^b-1) - 2^(b-1)                 (det)
//          = clip(floor(t_ik + float(rbits_ik) * 2^-32), 0, 2^b-1)
//            - 2^(b-1)                                            (SR)
//   acc_ij = sum_k c_ik * b_kj                                 (int32, exact)
//   rsum_i = sum_k c_ik
//   out_ij = acc_ij*(alpha_a*alpha_b) + beta_a*u_j + (alpha_a*beta_b)*rsum_i
//   alpha_a = 1/scale_i,  beta_a = 2^(b-1)*alpha_a + zero_i
// with every float operation rounded explicitly (int8_mma.cuh
// quantize_code), the epilogue applied once to the full sums, so the
// result is bit-identical to the plain PyTorch version in
// kernels/fused_fqt.py.  The SR bits arrive as prng.bits draws them,
// uint32 values held in int64; each entry's low 32 bits are read as
// unsigned.
//
// A block owns one (M tile, N tile, K slice).  Each step of BK codes:
//   * a ring of STAGES cp.async stages brings the f32 LHS rows, their SR
//     bits and the B codes (packed B: its bytes); each thread's source
//     rows are resolved once;
//   * the block quantizes its BM x BK LHS tile from shared memory, one
//     quad a thread, always the same rows, so each thread keeps its rows'
//     code sums in registers, into a K-major code tile;
//   * an N-major or packed B stage becomes the K-major B tile;
//   * the warps run mma.sync on them;
// then split-K in clusters (kernels/splitk.py) sums the slices' int32
// tiles and row code sums exactly, and the epilogue's vectors, read into
// shared memory while the first stages are in flight, turn them into
// 16-byte stores.  Ragged M, N and K edges and unaligned rows are masked in
// the loaders and the quantize (codes outside the matrix are 0, as the
// Pallas kernel's col < kdim mask makes them), so no wrapper pads or
// slices.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace fused_qlhs_gemm {

using namespace int8_mma;

// How B lies in device memory:
//   BKMajor     int8 codes stored (N, K) row-major: a stage's chunks go
//               straight into the swizzled tile;
//   BNMajor     int8 codes stored (K, N) row-major: a raw stage as stored,
//               transposed into the tile (transpose_b);
//   BPacked<W>  unsigned codes bit-packed at W in {1, 2, 4, 8} bits along
//               K (kernels/pack.py: (ceil(K / ppb), N) bytes, ppb = 8 / W):
//               a raw stage of BK / ppb byte rows as stored, unpacked into
//               the tile (unpack_b).
// Elem is the type of B's elements as the C entry receives them.
struct BKMajor {
  using Elem = int8_t;
  static constexpr bool KMAJOR = true;
  static constexpr int WBITS = 0, PPB = 1;
};
struct BNMajor {
  using Elem = int8_t;
  static constexpr bool KMAJOR = false;
  static constexpr int WBITS = 0, PPB = 1;
};
template <int W>
struct BPacked {
  using Elem = uint8_t;
  static constexpr bool KMAJOR = false;
  static constexpr int WBITS = W, PPB = 8 / W;
};

// A block tile: BM x BN outputs, K steps of BK codes, WARPS_M x WARPS_N
// warps, STAGES cp.async stages; B laid out as B_ says; MIN_BLOCKS blocks
// an SM for __launch_bounds__.  A library declares each of its tiles as
// its own struct deriving from Tile in an anonymous namespace, so that the
// kernels and launch_clustered's statics it instantiates stay its own (the
// dynamic linker unifies those of a shared Tile<...> across libraries).
template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_,
          int STAGES_, class B_, int MIN_BLOCKS_>
struct Tile {
  using B = B_;
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int CH = BK / 16;       // 16-byte chunks a code-tile row
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp tile
  static constexpr int MI = WM / 16, NJ = WN / 8;
  static constexpr int NACC = MI * NJ * 4;   // int32 accumulators a thread
  static constexpr int KQ = BK / 4;        // quads of K a row
  static constexpr int QPT = BM * KQ / THREADS;   // quads a thread a step
  static constexpr int X_BYTES = BM * BK * 4;     // f32 LHS, [BM][BK]
  static constexpr int R_BYTES = BM * BK * 8;     // int64 SR bits, [BM][BK]
  static constexpr int A_BYTES = BM * BK;         // the LHS codes
  // B a stage (swizzled K-major codes, or raw rows as stored) and the
  // K-major B tile an N-major or packed stage becomes
  static constexpr int B_BYTES = BN * BK / B::PPB;
  static constexpr int BT_BYTES = B::KMAJOR ? 0 : BN * BK;
  static constexpr int LDT = BN + 8;              // accumulator tile row
  static constexpr int PART_BYTES = BM * LDT * 4;
  // chunks a thread loads each stage: LHS (4 floats), SR bits (2 int64)
  // and K-major B codes (16) a chunk
  static constexpr int XC = BM * BK / 4 / THREADS;
  static constexpr int RC = BM * BK / 2 / THREADS;
  static constexpr int BC = B::KMAJOR ? BN * CH / THREADS : 1;
  // a row's quads lie in one warp, whose lanes reduce its code sums
  static_assert(QPT >= 1 && BM * KQ % THREADS == 0 && THREADS % KQ == 0 &&
                    KQ <= 32,
                "quantize mapping");
  static_assert(XC >= 1 && XC * THREADS == BM * BK / 4 &&
                RC * THREADS == BM * BK / 2 &&
                (!B::KMAJOR || BC * THREADS == BN * CH),
                "whole chunks a thread");
  // a packed stage holds whole bytes of every column
  static_assert(BK % 32 == 0 && BK % (4 * B::PPB) == 0, "BK");

  __host__ __device__ static constexpr int stage_bytes(bool sr) {
    return X_BYTES + (sr ? R_BYTES : 0) + B_BYTES;
  }
  // the ring, which the accumulator tile reuses once the K sweep is done
  __host__ __device__ static constexpr int ring_bytes(bool sr) {
    return STAGES * stage_bytes(sr) > PART_BYTES ? STAGES * stage_bytes(sr)
                                                 : PART_BYTES;
  }
  // the ring, the quantized code tile and the K-major B tile
  __host__ __device__ static constexpr int smem_bytes(bool sr) {
    return ring_bytes(sr) + A_BYTES + BT_BYTES;
  }
};

// The rows behind a thread's chunks, fixed for the K sweep: chunk i of a
// kind is id = t + THREADS * i, row id / (chunks a row), and its byte
// offset in the row is fixed too.
template <class T>
struct Sources {
  RowSrc x[T::XC], r[T::RC], b[T::BC];
};

template <class T, bool SR>
__device__ __forceinline__ Sources<T> sources(const float* xf,
                                              const long long* rbits,
                                              const uint8_t* y8, int M,
                                              int N, int K, int m0, int n0,
                                              int t) {
  Sources<T> s;
#pragma unroll
  for (int i = 0; i < T::XC; ++i) {
    const int m = m0 + (t + T::THREADS * i) / (T::BK / 4);
    s.x[i] = row_src(xf, m, 4 * K, m < M);
  }
#pragma unroll
  for (int i = 0; i < T::RC; ++i) {
    const int m = m0 + (t + T::THREADS * i) / (T::BK / 2);
    s.r[i] = row_src(rbits, m, SR ? 8 * K : 0, SR && m < M);
  }
  if constexpr (T::B::KMAJOR) {
#pragma unroll
    for (int i = 0; i < T::BC; ++i) {
      const int n = n0 + (t + T::THREADS * i) / T::CH;
      s.b[i] = row_src(y8, n, K, n < N);
    }
  }
  return s;
}

// B's part of the stage of K codes k0 .. k0 + BK - 1 into bs.
template <class T>
__device__ __forceinline__ void load_b(uint8_t* bs, const RowSrc* sb,
                                       const uint8_t* y8, int N, int K,
                                       int n0, int k0, int t) {
  if constexpr (T::B::KMAJOR) {
    // B stored (N, K): BN rows x CH chunks, into the swizzled tile
#pragma unroll
    for (int i = 0; i < T::BC; ++i) {
      const int id = t + T::THREADS * i, r = id / T::CH, c = id % T::CH;
      load_row_chunk(bs + swz<T::CH>(r, c), sb[i], k0 + 16 * c);
    }
  } else {
    // B stored (K, N), or its (ceil(K / ppb), N) packed bytes: BK / ppb
    // rows of BN bytes, as stored
    constexpr int PPB = T::B::PPB;
    load_b_raw<T::BK / PPB, T::BN, T::THREADS>(bs, y8, N, (K + PPB - 1) / PPB,
                                              n0, k0 / PPB, t);
  }
}

// The K-major B tile of the stage of K codes from k0 whose B part is bs:
// bs itself (K-major), or bt after transposing (N-major) or unpacking
// (packed) bs into it.  The caller's barrier comes after.
template <class T>
__device__ __forceinline__ const uint8_t* b_tile(uint8_t* bt,
                                                 const uint8_t* bs, int k0,
                                                 int K, int t) {
  if constexpr (T::B::KMAJOR) {
    return bs;
  } else if constexpr (T::B::WBITS == 0) {
    transpose_b<T::BK, T::BN, T::THREADS>(bt, bs, t);
    return bt;
  } else {
    unpack_b<T::B::WBITS, T::BK, T::BN, T::THREADS>(bt, bs, k0, K, t);
    return bt;
  }
}

template <class T, bool SR>
__device__ __forceinline__ void load_stage(uint8_t* st, const Sources<T>& s,
                                           const uint8_t* y8, int N, int K,
                                           int n0, int k0, int t) {
  constexpr int BK = T::BK;
  // LHS: BM rows x BK / 4 chunks of 4 floats
#pragma unroll
  for (int i = 0; i < T::XC; ++i) {
    const int id = t + T::THREADS * i, r = id / (BK / 4), c = id % (BK / 4);
    load_row_chunk(st + r * (BK * 4) + 16 * c, s.x[i], 4 * (k0 + 4 * c));
  }
  if (SR) {
    // bits: BM rows x BK / 2 chunks of 2 int64
#pragma unroll
    for (int i = 0; i < T::RC; ++i) {
      const int id = t + T::THREADS * i, r = id / (BK / 2),
                c = id % (BK / 2);
      load_row_chunk(st + T::X_BYTES + r * (BK * 8) + 16 * c, s.r[i],
                     8 * (k0 + 2 * c));
    }
  }
  load_b<T>(st + T::stage_bytes(SR) - T::B_BYTES, s.b, y8, N, K, n0, k0, t);
}

template <class T, bool SR, int SPLITS>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
qlhs_kernel(const float* __restrict__ xf, const float* __restrict__ sa,
            const float* __restrict__ za,
            const long long* __restrict__ rbits,
            const uint8_t* __restrict__ y8, const float* __restrict__ ab_ptr,
            const float* __restrict__ bb_ptr, const float* __restrict__ u,
            float* __restrict__ out, int M, int N, int K, int bits,
            int k_span) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, THREADS = T::THREADS;
  constexpr int KQ = T::KQ, QPT = T::QPT, CH = T::CH;
  constexpr int SB = T::stage_bytes(SR);
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int rowsum_s[BM];
  // the epilogue's vectors, loaded while the first stages are in flight
  __shared__ float u_s[BN], s_ab_s[BM], beta_s[BM], c1_s[BM];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_tiles = (N + BN - 1) / BN;
  const BlockCoords bc = block_coords(n_tiles, SPLITS);
  const int m0 = bc.m_tile * BM, n0 = bc.n_tile * BN;
  const int k_beg = bc.split * k_span;
  const int steps = (min(K, k_beg + k_span) - k_beg + BK - 1) / BK;
  const float top = static_cast<float>((1 << bits) - 1);
  const float off = static_cast<float>(1 << (bits - 1));
  const int sub = quant_sub(bits);
  uint8_t* ac = smem + T::ring_bytes(SR);      // the quantized code tile
  uint8_t* bt = ac + T::A_BYTES;               // the K-major B tile
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;

  int acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0;

  const Sources<T> src = sources<T, SR>(xf, rbits, y8, M, N, K, m0, n0, t);
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < steps)
      load_stage<T, SR>(smem + s * SB, src, y8, N, K, n0, k_beg + s * BK, t);
    cp_async_commit();
  }

  {
    const float ab = *ab_ptr, bb = *bb_ptr;
    for (int i = t; i < BN; i += THREADS)
      u_s[i] = n0 + i < N ? u[n0 + i] : 0.0f;
    for (int i = t; i < BM; i += THREADS) {
      const int m = m0 + i;
      if (m >= M) continue;
      const float alpha_a = __fdiv_rn(1.0f, sa[m]);
      beta_s[i] = __fadd_rn(__fmul_rn(off, alpha_a), za[m]);
      c1_s[i] = __fmul_rn(alpha_a, bb);
      s_ab_s[i] = __fmul_rn(alpha_a, ab);
    }
  }

  // quantize mapping: quad kq of rows qr[i], the same every step
  const int kq = t % KQ;
  int qr[QPT], rsum[QPT];
  float q_s[QPT], q_z[QPT];
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    qr[i] = t / KQ + i * (THREADS / KQ);
    rsum[i] = 0;
    const int m = m0 + qr[i];
    q_s[i] = m < M ? sa[m] : 0.0f;
    q_z[i] = m < M ? za[m] : 0.0f;
  }

  for (int kk = 0; kk < steps; ++kk) {
    cp_async_wait<T::STAGES - 2>();
    // also: the code tiles' readers of the previous step are done
    __syncthreads();
    const int next = kk + T::STAGES - 1;
    if (next < steps)
      load_stage<T, SR>(smem + (next % T::STAGES) * SB, src, y8, N, K, n0,
                        k_beg + next * BK, t);
    cp_async_commit();
    const uint8_t* st = smem + (kk % T::STAGES) * SB;
    const int k = k_beg + kk * BK + 4 * kq;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int r = qr[i];
      const float4 v = *reinterpret_cast<const float4*>(
          st + r * (BK * 4) + 16 * kq);
      unsigned rb[4] = {0u, 0u, 0u, 0u};
      if (SR) {
        const longlong2* p = reinterpret_cast<const longlong2*>(
            st + T::X_BYTES + r * (BK * 8) + 32 * kq);
        const longlong2 p0 = p[0], p1 = p[1];
        rb[0] = static_cast<unsigned>(p0.x);
        rb[1] = static_cast<unsigned>(p0.y);
        rb[2] = static_cast<unsigned>(p1.x);
        rb[3] = static_cast<unsigned>(p1.y);
      }
      const float x[4] = {v.x, v.y, v.z, v.w};
      const bool row_ok = m0 + r < M;
      int c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = (row_ok && k + j < K)
                   ? quantize_code<SR>(x[j], q_s[i], q_z[i], rb[j], top,
                                       sub)
                   : 0;
      rsum[i] += c[0] + c[1] + c[2] + c[3];
      *reinterpret_cast<unsigned*>(ac + swz<CH>(r, kq >> 2) + 4 * (kq & 3)) =
          pack4(c[0], c[1], c[2], c[3]);
    }
    const uint8_t* bs =
        b_tile<T>(bt, st + SB - T::B_BYTES, k_beg + kk * BK, K, t);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc)
      warp_mma_k32<T::MI, T::NJ, CH>(acc, ac, wm * T::WM, bs, wn * T::WN, kc,
                                     lane);
  }
  cp_async_wait<0>();

  // row code sums: the KQ lanes sharing a row reduce, the first stores
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    int v = rsum[i];
#pragma unroll
    for (int o = KQ / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    if (kq == 0) rowsum_s[qr[i]] = v;
  }
  __syncthreads();     // the ring is free and rowsum_s complete

  int* tile = reinterpret_cast<int*>(smem);
  acc_to_tile<T::MI, T::NJ, T::LDT>(tile, acc, wm * T::WM, wn * T::WN,
                                    lane);
  reduce_tile<BM, BN, THREADS, SPLITS>(
      tile, rowsum_s, [&](int row, int col, int4 v, int rsum) {
        const int m = m0 + row, n = n0 + col;
        if (m >= M) return;
        const int s4[4] = {v.x, v.y, v.z, v.w};
        const float a_i = __fmul_rn(c1_s[row], static_cast<float>(rsum));
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = __fadd_rn(
              __fadd_rn(__fmul_rn(static_cast<float>(s4[j]), s_ab_s[row]),
                        __fmul_rn(beta_s[row], u_s[col + j])),
              a_i);
        store4(out, m, n, N, o);
      });
}

template <class T, bool SR, int SPLITS>
int launch_split(const float* xf, const float* sa, const float* za,
                 const long long* rbits, const typename T::B::Elem* y8,
                 const float* ab, const float* bb, const float* u, float* out,
                 int M, int N, int K, int bits, int k_span, cudaStream_t s) {
  const int tiles = ((M + T::BM - 1) / T::BM) * ((N + T::BN - 1) / T::BN);
  return launch_clustered<qlhs_kernel<T, SR, SPLITS>>(
      tiles * SPLITS, T::THREADS, T::smem_bytes(SR), SPLITS, s, xf, sa, za,
      rbits, reinterpret_cast<const uint8_t*>(y8), ab, bb, u, out, M, N, K,
      bits, k_span);
}

// One launch of tile T with `splits` K slices of k_span codes (the C
// entries check both), with SR bits (rbits) or deterministic (rbits
// ignored); returns the CUDA error.
template <class T, bool SR>
int launch(const float* xf, const float* sa, const float* za,
           const long long* rbits, const typename T::B::Elem* y8,
           const float* ab, const float* bb, const float* u, float* out,
           int M, int N, int K, int bits, int splits, int k_span,
           cudaStream_t s) {
#define QLHS_SPLIT(S)                                                       \
  case S:                                                                   \
    return launch_split<T, SR, S>(xf, sa, za, rbits, y8, ab, bb, u, out,   \
                                  M, N, K, bits, k_span, s);
  switch (splits) {
    QLHS_SPLIT(1) QLHS_SPLIT(2) QLHS_SPLIT(3) QLHS_SPLIT(4)
    QLHS_SPLIT(5) QLHS_SPLIT(6) QLHS_SPLIT(7) QLHS_SPLIT(8)
  }
#undef QLHS_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

// {BM, BN, BK, THREADS, NACC, STAGES, smem bytes with SR bits, smem bytes
// deterministic}: what the library's *_tile entry reports.
template <class T>
void tile_config(int* cfg) {
  const int v[8] = {T::BM, T::BN, T::BK, T::THREADS, T::NACC, T::STAGES,
                    T::smem_bytes(true), T::smem_bytes(false)};
  for (int i = 0; i < 8; ++i) cfg[i] = v[i];
}

// Blocks of tile T the card runs at once in clusters of `cluster` (1..8),
// with SR bits or deterministic (minus the CUDA error on failure).
template <class T, bool SR>
int capacity(int cluster) {
  return cluster_capacity<qlhs_kernel<T, SR, 8>>(
      T::THREADS, T::smem_bytes(SR), cluster);
}

// The checks of a C entry's split: 1..8 slices of k_span codes, a
// multiple of BK, covering K.
template <class T>
bool valid_split(int K, int splits, int k_span) {
  return splits >= 1 && splits <= 8 && k_span >= 1 && k_span % T::BK == 0 &&
         static_cast<long long>(splits) * k_span >= K;
}

}  // namespace fused_qlhs_gemm

// The packed GEMMs' tiles (fused_qlhs_packed.cu, packed_matmul.cu): the
// int8 forward's two with B bit-packed at W bits.  Decode (M <= 16):
// 16 x 256 outputs, 8 warps, a 4-stage ring of 64 codes; wide: 64 x 256,
// 16 warps, 3 stages of 64 codes.  A decode K step that grows with ppb, so
// that a stage moves as many packed bytes as at 8 bits, was no faster on
// the card (PERF.md).  In an anonymous namespace, so each library gets its
// own (see Tile).
namespace {

template <int W>
struct PackedDecodeTile
    : fused_qlhs_gemm::Tile<16, 256, 64, 1, 8, 4,
                            fused_qlhs_gemm::BPacked<W>, 2> {};
template <int W>
struct PackedWideTile
    : fused_qlhs_gemm::Tile<64, 256, 64, 2, 8, 3,
                            fused_qlhs_gemm::BPacked<W>, 1> {};

}  // namespace

// A packed GEMM's mode names its tile and width, as kernels/splitk.py
// does: 4 * tile + log2(wbits) (tile 0 decode, 1 wide; wbits 1, 2, 4, 8
// -> 0..3).  PACKED_TILE_CASES(F) runs F(T) for the tile of `mode`; F
// returns or breaks.
#define PACKED_TILE_CASES(F)                                              \
  switch (mode) {                                                         \
    case 0: F(PackedDecodeTile<1>)                                        \
    case 1: F(PackedDecodeTile<2>)                                        \
    case 2: F(PackedDecodeTile<4>)                                        \
    case 3: F(PackedDecodeTile<8>)                                        \
    case 4: F(PackedWideTile<1>)                                          \
    case 5: F(PackedWideTile<2>)                                          \
    case 6: F(PackedWideTile<4>)                                          \
    case 7: F(PackedWideTile<8>)                                          \
  }
