// The FQT activation grad with the quantize fused in, for Hopper's int8
// tensor cores: dX = Q_b2(dY) @ Q_theta(W).T.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_fqt.py
// fused_qlhs_matmul (body _qlhs_kernel) in its trans_b mode, deterministic
// or stochastic: the PTQ/PSQ activation-grad GEMM of core/backend.py
// fused_fqt_dx.  The forward and packed modes of the same Pallas kernel
// stay in fused_qlhs.cu.
//
// What it computes, per output (i, j), with B the (N, K) = (d_in, d_out)
// weight codes read as their transpose (K is the contiguous axis):
//   t_ik   = scale_i * (g_ik - zero_i)
//   c_ik   = clip(rint(t_ik), 0, 2^b-1) - 2^(b-1)                 (det)
//          = clip(floor(t_ik + float(rbits_ik) * 2^-32), 0, 2^b-1)
//            - 2^(b-1)                                            (SR)
//   acc_ij = sum_k c_ik * y8_jk                                (int32, exact)
//   rsum_i = sum_k c_ik
//   out_ij = acc_ij*(alpha_a*alpha_b) + beta_a*u_j + (alpha_a*beta_b)*rsum_i
//   alpha_a = 1/scale_i,  beta_a = 2^(b-1)*alpha_a + zero_i
// with every float operation rounded explicitly (quantize_code is
// fused_qlhs.cu's, verbatim), the epilogue applied once to the full sums,
// so the result is bit-identical to the plain PyTorch version in
// kernels/fused_fqt.py.  The SR bits arrive as prng.bits draws them,
// uint32 values held in int64; each entry's low 32 bits are read as
// unsigned.
//
// What bounds it on an H100: the f32 dY and the int64 bits, 12 bytes a
// code, against 1 byte a weight code: at lm_head (512, 10240, 512) 63 MB,
// 20.7 us at 3.35 TB/s; the 5.4 GOP of int8 products take 2.7 us at the
// tensor-core peak.  The old __dp4a tile took 532 us there: 128 blocks
// each swept 160 K steps in series.  This design (int8_mma.cuh):
//   * a 32 x 512 output tile a block, 16 warps of 32 x 32, mma.sync
//     m16n8k32 from ldmatrix fragments: 512 columns cover N = 512, so dY
//     and its bits stream once (the weight codes, 1 byte each and L2
//     resident, are what the M tiles read again);
//   * a ring of STAGES = 3 cp.async stages of BK = 64 codes: dY 8 KB, bits
//     16 KB, weight codes 32 KB a stage, 168 KB a block, one block an SM;
//   * each step the block quantizes its 32 x 64 dY tile from shared
//     memory, one quad a thread, always the same row, so each thread keeps
//     its row's code sum in a register, into a K-major code tile; then the
//     warps run the tensor cores on it;
//   * split-K in clusters (kernels/splitk.py): a cluster's blocks share a
//     GPC, and the H100 then holds only 102 to 120 of them at one an SM,
//     so lm_head runs 16 tiles x 6 slices of 27 steps (96 blocks, one
//     wave) instead of 16 x 1 of 160; the row code sums join the exact
//     reduction beside the accumulators;
//   * the epilogue's vectors and per-row factors go to shared memory while
//     the first stages are in flight, and the outputs leave as 16-byte
//     stores from the shared accumulator tile.
// What holds it back (PERF.md): each SM's streaming of dY, the bits and
// the weight codes in the K loop, and the cluster capacity, which leaves
// 36 SMs idle at lm_head.
// Ragged M, N and K edges and unaligned rows are masked in the loaders and
// the quantize (codes outside the matrix are 0, as the Pallas kernel's
// col < kdim mask makes them), so the wrapper never pads or slices.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

using namespace int8_mma;

constexpr int BM = 32;
constexpr int BN = 512;
constexpr int BK = 64;
constexpr int CH = BK / 16;           // 16-byte chunks a code-tile row
constexpr int WARPS_M = 1, WARPS_N = 16;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int STAGES = 3;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp tile
constexpr int MI = WM / 16, NJ = WN / 8;
constexpr int NACC = MI * NJ * 4;     // int32 accumulators a thread
constexpr int KQ = BK / 4;            // quads of K a row
constexpr int QPT = BM * KQ / THREADS;   // quads a thread quantizes a step
constexpr int X_BYTES = BM * BK * 4;  // f32 dY, [BM][BK]
constexpr int R_BYTES = BM * BK * 8;  // int64 SR bits, [BM][BK]
constexpr int B_BYTES = BN * BK;      // weight codes, swizzled
constexpr int A_BYTES = BM * BK;      // the quantized codes, swizzled
static_assert(QPT >= 1 && BM * KQ % THREADS == 0 && THREADS % KQ == 0,
              "quantize mapping");
constexpr int LDT = BN + 8;           // int32 row of the accumulator tile
constexpr int PART_BYTES = BM * LDT * 4;     // the accumulator tile

__host__ __device__ constexpr int stage_bytes(bool sr) {
  return X_BYTES + (sr ? R_BYTES : 0) + B_BYTES;
}
// the ring, which the accumulator tile reuses once the K sweep is done
__host__ __device__ constexpr int ring_bytes(bool sr) {
  return STAGES * stage_bytes(sr) > PART_BYTES ? STAGES * stage_bytes(sr)
                                               : PART_BYTES;
}
constexpr int smem_bytes(bool sr) { return ring_bytes(sr) + A_BYTES; }

constexpr float U32_TO_UNIT = 2.3283064365386963e-10f;   // 2^-32, exact

template <bool SR>
__device__ __forceinline__ int quantize_code(float x, float s, float z,
                                             unsigned rb, float nbins,
                                             float off) {
  const float t = __fmul_rn(s, __fsub_rn(x, z));
  float q;
  if (SR)
    q = floorf(__fadd_rn(t, __fmul_rn(__uint2float_rn(rb), U32_TO_UNIT)));
  else
    q = rintf(t);
  q = fminf(fmaxf(q, 0.0f), nbins);
  return static_cast<int>(__fsub_rn(q, off));
}

// Chunks a thread loads each stage: dY (4 floats), SR bits (2 int64) and
// weight codes (16) a chunk.
constexpr int XC = BM * BK / 4 / THREADS;
constexpr int RC = BM * BK / 2 / THREADS;
constexpr int BC = BN * CH / THREADS;
static_assert(XC * THREADS == BM * BK / 4 && RC * THREADS == BM * BK / 2 &&
              BC * THREADS == BN * CH && XC >= 1,
              "whole chunks a thread");

// The rows behind a thread's chunks, fixed for the K sweep: chunk i of a
// kind is id = t + THREADS * i, row id / (chunks a row), and its byte
// offset in the row is fixed too (kb_*).
struct Sources {
  RowSrc x[XC], r[RC], b[BC];
};

template <bool SR>
__device__ __forceinline__ Sources sources(const float* xf,
                                           const long long* rbits,
                                           const uint8_t* y8, int M, int N,
                                           int K, int m0, int n0, int t) {
  Sources s;
#pragma unroll
  for (int i = 0; i < XC; ++i) {
    const int m = m0 + (t + THREADS * i) / (BK / 4);
    s.x[i] = row_src(xf, m, 4 * K, m < M);
  }
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int m = m0 + (t + THREADS * i) / (BK / 2);
    s.r[i] = row_src(rbits, m, SR ? 8 * K : 0, SR && m < M);
  }
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    const int n = n0 + (t + THREADS * i) / CH;
    s.b[i] = row_src(y8, n, K, n < N);
  }
  return s;
}

template <bool SR>
__device__ __forceinline__ void load_stage(uint8_t* st, const Sources& s,
                                           int k0, int t) {
  // dY: BM rows x BK / 4 chunks of 4 floats
#pragma unroll
  for (int i = 0; i < XC; ++i) {
    const int id = t + THREADS * i, r = id / (BK / 4), c = id % (BK / 4);
    load_row_chunk(st + r * (BK * 4) + 16 * c, s.x[i], 4 * (k0 + 4 * c));
  }
  if (SR) {
    // bits: BM rows x BK / 2 chunks of 2 int64
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int id = t + THREADS * i, r = id / (BK / 2), c = id % (BK / 2);
      load_row_chunk(st + X_BYTES + r * (BK * 8) + 16 * c, s.r[i],
                     8 * (k0 + 2 * c));
    }
  }
  // weight codes, stored (N, K): BN rows x CH chunks
  uint8_t* bs = st + stage_bytes(SR) - B_BYTES;
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    const int id = t + THREADS * i, r = id / CH, c = id % CH;
    load_row_chunk(bs + swz<CH>(r, c), s.b[i], k0 + 16 * c);
  }
}

template <bool SR, int SPLITS>
__global__ void __launch_bounds__(THREADS, 1)
fused_qlhs_dx_kernel(const float* __restrict__ xf,
                     const float* __restrict__ sa,
                     const float* __restrict__ za,
                     const long long* __restrict__ rbits,
                     const uint8_t* __restrict__ y8,
                     const float* __restrict__ ab_ptr,
                     const float* __restrict__ bb_ptr,
                     const float* __restrict__ u, float* __restrict__ out,
                     int M, int N, int K, float nbins, float off,
                     int k_span) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int rowsum_s[BM];
  // the epilogue's vectors, loaded while the first stages are in flight
  __shared__ float u_s[BN], s_ab_s[BM], beta_s[BM], c1_s[BM];
  constexpr int SB = stage_bytes(SR);
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_tiles = (N + BN - 1) / BN;
  const BlockCoords bc = block_coords(n_tiles, SPLITS);
  const int m0 = bc.m_tile * BM, n0 = bc.n_tile * BN;
  const int k_beg = bc.split * k_span;
  const int steps = (min(K, k_beg + k_span) - k_beg + BK - 1) / BK;
  uint8_t* ac = smem + ring_bytes(SR);         // the quantized code tile
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;

  const Sources src = sources<SR>(xf, rbits, y8, M, N, K, m0, n0, t);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage<SR>(smem + s * SB, src, k_beg + s * BK, t);
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
    cp_async_wait<STAGES - 2>();
    // also: the code tile's readers of the previous step are done
    __syncthreads();
    const int next = kk + STAGES - 1;
    if (next < steps)
      load_stage<SR>(smem + (next % STAGES) * SB, src, k_beg + next * BK, t);
    cp_async_commit();
    const uint8_t* st = smem + (kk % STAGES) * SB;
    const int k = k_beg + kk * BK + 4 * kq;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int r = qr[i];
      const float4 v = *reinterpret_cast<const float4*>(
          st + r * (BK * 4) + 16 * kq);
      unsigned rb[4] = {0u, 0u, 0u, 0u};
      if (SR) {
        const longlong2* p = reinterpret_cast<const longlong2*>(
            st + X_BYTES + r * (BK * 8) + 32 * kq);
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
                   ? quantize_code<SR>(x[j], q_s[i], q_z[i], rb[j], nbins,
                                       off)
                   : 0;
      rsum[i] += c[0] + c[1] + c[2] + c[3];
      *reinterpret_cast<unsigned*>(ac + swz<CH>(r, kq >> 2) + 4 * (kq & 3)) =
          pack4(c[0], c[1], c[2], c[3]);
    }
    __syncthreads();
    const uint8_t* bs = st + SB - B_BYTES;
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc)
      warp_mma_k32<MI, NJ, CH>(acc, ac, wm * WM, bs, wn * WN, kc, lane);
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
  acc_to_tile<MI, NJ, LDT>(tile, acc, wm * WM, wn * WN, lane);
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

template <bool SR, int SPLITS>
int launch(const float* xf, const float* sa, const float* za,
           const long long* rbits, const int8_t* y8, const float* ab,
           const float* bb, const float* u, float* out, int M, int N, int K,
           float nbins, float off, int k_span, cudaStream_t s) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  return launch_clustered<fused_qlhs_dx_kernel<SR, SPLITS>>(tiles * SPLITS,
                          THREADS, smem_bytes(SR), SPLITS, s, xf, sa, za,
                          rbits, reinterpret_cast<const uint8_t*>(y8), ab, bb,
                          u, out, M, N, K, nbins, off, k_span);
}

template <bool SR>
int launch(const float* xf, const float* sa, const float* za,
           const long long* rbits, const int8_t* y8, const float* ab,
           const float* bb, const float* u, float* out, int M, int N, int K,
           int bits, int splits, int k_span, cudaStream_t s) {
  const float nbins = static_cast<float>((1 << bits) - 1);
  const float off = static_cast<float>(1 << (bits - 1));
  switch (splits) {
    case 1:
      return launch<SR, 1>(xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K,
                           nbins, off, k_span, s);
    case 2:
      return launch<SR, 2>(xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K,
                           nbins, off, k_span, s);
    case 3:
      return launch<SR, 3>(xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K,
                           nbins, off, k_span, s);
    case 4:
      return launch<SR, 4>(xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K,
                           nbins, off, k_span, s);
    case 5:
      return launch<SR, 5>(xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K,
                           nbins, off, k_span, s);
    case 6:
      return launch<SR, 6>(xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K,
                           nbins, off, k_span, s);
    case 7:
      return launch<SR, 7>(xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K,
                           nbins, off, k_span, s);
    case 8:
      return launch<SR, 8>(xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K,
                           nbins, off, k_span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The tile this library was built with, for the wrapper's split plan
// (kernels/splitk.py): {BM, BN, BK, THREADS, NACC, STAGES,
// smem bytes with SR bits, smem bytes deterministic}.
extern "C" void fused_qlhs_dx_tile(int* cfg) {
  const int v[8] = {BM, BN, BK, THREADS, NACC, STAGES, smem_bytes(true),
                    smem_bytes(false)};
  for (int i = 0; i < 8; ++i) cfg[i] = v[i];
}

// Blocks the card runs at once in clusters of `cluster` (1..8), with SR
// bits or deterministic (minus the CUDA error on failure): what
// kernels/splitk.py plans with.
extern "C" int fused_qlhs_dx_capacity(int sr, int cluster) {
  return sr ? cluster_capacity<fused_qlhs_dx_kernel<true, 8>>(
                  THREADS, smem_bytes(true), cluster)
            : cluster_capacity<fused_qlhs_dx_kernel<false, 8>>(
                  THREADS, smem_bytes(false), cluster);
}

// C interface, loaded with ctypes.  rbits: (M, K) int64 SR bits, or
// nullptr for deterministic rounding; y8: the (N, K) row-major weight
// codes.  The wrapper's split plan gives `splits` K slices (1, 2, 4 or 8,
// one cluster a tile) of k_span codes (a multiple of BK; the last may be
// shorter).  One launch; returns its CUDA error (0 = launched).
extern "C" int fused_qlhs_dx(const float* xf, const float* scale_a,
                             const float* zero_a, const long long* rbits,
                             const int8_t* y8, const float* alpha_b,
                             const float* beta_b, const float* u, float* out,
                             int M, int N, int K, int bits, int splits,
                             int k_span, void* stream) {
  if (splits < 1 || splits > 8 || k_span < 1 || k_span % BK != 0 ||
      static_cast<long long>(splits) * k_span < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rbits ? launch<true>(xf, scale_a, zero_a, rbits, y8, alpha_b,
                              beta_b, u, out, M, N, K, bits, splits, k_span,
                              s)
               : launch<false>(xf, scale_a, zero_a, rbits, y8, alpha_b,
                               beta_b, u, out, M, N, K, bits, splits, k_span,
                               s);
}
