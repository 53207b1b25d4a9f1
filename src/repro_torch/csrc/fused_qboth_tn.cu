// Weight-gradient GEMM with both operands quantized in the K sweep, for
// Hopper's int8 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_fqt.py
// fused_qboth_tn_matmul (body _qboth_tn_kernel): dW = Q_f(X).T @ Q_b1(dY)
// of the FQT step (paper Eq. 6), with X's deterministic per-tensor
// quantize and dY's stochastic per-tensor quantize both done on the fly,
// so no int8 codes of either operand reach device memory.  It runs once
// per linear layer per step under every FQT policy.
//
// What it computes, with af = X (K tokens x M = d_in) and bf = dY
// (K x N = d_out), both f32 row-major, contracting over the K rows:
//   ca_km  = clip(rint(sa * (af_km - za)), 0, 2^ba-1) - 2^(ba-1)
//   cb_kn  = clip(floor(sb * (bf_kn - zb) + float(rbits_kn) * 2^-32),
//                 0, 2^bb-1) - 2^(bb-1)
//   acc_mn = sum_k ca_km * cb_kn                              (int32, exact)
//   csum_n = sum_k cb_kn
//   u_n    = alpha_b*csum_n + K*beta_b
//   out_mn = acc_mn*(alpha_a*alpha_b) + beta_a*u_n + a_m
//   alpha = 1/s,  beta = 2^(b-1)*alpha + z  (per operand)
// with a_m = alpha_a*beta_b*sum_k ca_km computed outside (core/backend.py
// dw_operands: a block never holds a whole column of A), and every float
// operation rounded explicitly in the reference's order, so the result is
// bit-identical to the plain PyTorch version in kernels/fused_fqt.py.  The
// four scalars arrive as device pointers, so no launch waits on the host.
// The SR bits are uint32 values held in int64, as prng.bits draws them;
// the kernel reads each entry's low 32 bits as unsigned.
//
// What bounds it on an H100: it reads 4*K*(M + N) bytes of f32 operands
// and 8*K*N bytes of SR bits and writes 4*M*N bytes of dW: at lm_head
// (K 512, M 512, N 10240) 85 MB, 25.4 us at 3.35 TB/s; the 5.4 GOP of int8
// products take 2.7 us at the tensor-core peak.  Two costs come on top,
// both set by the tile: every block reads (from L2) and quantizes the
// K x BM slab of X and the K x BN slab of dY and bits it needs, so a BM x
// BN tile moves K*M*N*(4/BN + 12/BM) bytes into the SMs and quantizes
// K*M*N*(1/BN + 1/BM) codes.  Measured on the card (PERF.md), the quantize
// instructions and those bytes cost about equally; the old tile (32 x 64,
// __dp4a, nothing in flight) took 263 us at lm_head.  This design
// (int8_mma.cuh):
//   * a 256 x 128 output tile a block (BM/BN near 12/4, the two operands'
//     bytes a code), 16 warps of 32 x 64, mma.sync m16n8k32 from ldmatrix
//     fragments: lm_head's dY and bits are read twice, X 80 times;
//   * a ring of 2 cp.async stages of BK = 32 rows: X 32 KB, dY 16 KB, bits
//     32 KB a stage, 160 KB, plus 12 KB of code tiles, one block an SM;
//     both raw tiles arrive M- or N-major, their 16-byte chunks swizzled
//     by row (int8_mma.cuh raw_off) so the quantize's reads of four rows
//     spread over the banks;
//   * each step every thread quantizes 4 (k) x 2 (m or n) blocks of the
//     stage in registers and packs each column's four codes into one word
//     (packing the codes by column is the 4 x 4 transpose, done for free),
//     stored K-major into the swizzled code tiles ldmatrix reads, the two
//     columns' store order alternating so one warp's stores fill distinct
//     banks; the thread's dY columns are the same every step, so their
//     code sums stay in registers;
//   * the quantize is int8_mma.cuh quantize_code, off the conversion pipe;
//     steps inside the matrix skip the edge masks;
//   * split-K in clusters (kernels/splitk.py), the column code sums summed
//     beside the accumulators (int8_mma.cuh reduce_cols); blocks of one N
//     tile run side by side (M tile fastest in the grid), so dY and its
//     bits come from device memory once.
// Ragged M, N and K edges and unaligned rows are masked in the loaders and
// the quantize (codes of padded K rows are 0, as the Pallas kernel's
// row < kdim mask makes them), so the wrapper never pads or slices.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

using namespace int8_mma;

constexpr int BM = 256;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int CH = BK / 16;           // 16-byte chunks a code-tile row
constexpr int WARPS_M = 8, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int STAGES = 2;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp tile
constexpr int MI = WM / 16, NJ = WN / 8;
constexpr int NACC = MI * NJ * 4;     // int32 accumulators a thread
constexpr int XA_BYTES = BK * BM * 4;   // raw f32 X, [BK][BM]
constexpr int XB_BYTES = BK * BN * 4;   // raw f32 dY, [BK][BN]
constexpr int R_BYTES = BK * BN * 8;    // raw int64 SR bits, [BK][BN]
constexpr int STAGE_BYTES = XA_BYTES + XB_BYTES + R_BYTES;
constexpr int CA_BYTES = BM * BK;       // X codes, K-major, swizzled
constexpr int CB_BYTES = BN * BK;       // dY codes, K-major, swizzled
constexpr int LDT = BN + 8;             // int32 row of the accumulator tile
constexpr int PART_BYTES = BM * LDT * 4;
constexpr int RING_BYTES = STAGES * STAGE_BYTES > PART_BYTES
                               ? STAGES * STAGE_BYTES : PART_BYTES;
constexpr int SMEM_BYTES = RING_BYTES + CA_BYTES + CB_BYTES;

// Chunks a thread loads each stage: X, dY (4 floats) and bits (2 int64)
// a chunk.  Chunk i of a kind is id = t + THREADS * i: column chunk
// id % (chunks a row), the same every i, and row id / (chunks a row).
constexpr int XA_CPR = BM / 4, XB_CPR = BN / 4, R_CPR = BN / 2;
constexpr int XA_C = BK * XA_CPR / THREADS;
constexpr int XB_C = BK * XB_CPR / THREADS;
constexpr int R_C = BK * R_CPR / THREADS;
static_assert(XA_C * THREADS == BK * XA_CPR && XB_C * THREADS == BK * XB_CPR &&
              R_C * THREADS == BK * R_CPR && THREADS % XA_CPR == 0 &&
              THREADS % XB_CPR == 0 && THREADS % R_CPR == 0,
              "whole chunks a thread, one column chunk each");

// Quantize units: 4 rows (k) x 2 columns (m or n).  Unit i of a kind is
// id = t + THREADS * i: k quad id % (BK / 4), the same for every unit of
// the thread, and column pair id / (BK / 4).
constexpr int KQ = BK / 4;
constexpr int UA = KQ * (BM / 2) / THREADS;
constexpr int UB = KQ * (BN / 2) / THREADS;
static_assert(UA * THREADS == KQ * (BM / 2) && UB * THREADS == KQ * (BN / 2) &&
              THREADS % KQ == 0, "whole units a thread");

// The source of one column chunk over the K rows: its first row's byte,
// the row stride, the bytes of the chunk inside the matrix (0..16), and
// whether every row's chunk is 16 whole aligned bytes (cp.async).
struct ColSrc {
  const uint8_t* p;
  size_t stride;
  int bytes;
  bool aligned;
};

__device__ __forceinline__ ColSrc col_src(const void* base, int col0,
                                          int cols, int elem_bytes) {
  const uint8_t* p = static_cast<const uint8_t*>(base) +
                     static_cast<size_t>(col0) * elem_bytes;
  const size_t stride = static_cast<size_t>(cols) * elem_bytes;
  const int bytes = min(max(cols - col0, 0) * elem_bytes, 16);
  return {p, stride, bytes,
          bytes == 16 && ((reinterpret_cast<uintptr_t>(p) | stride) & 15) == 0};
}

// The chunk of row k into smem; rows at or past K are skipped (their codes
// are masked to 0 by the quantize), bytes past the matrix's edge are 0.
__device__ __forceinline__ void load_col_chunk(void* smem, const ColSrc& s,
                                               int k, int K) {
  if (k >= K) return;
  const uint8_t* src = s.p + static_cast<size_t>(k) * s.stride;
  if (s.aligned)
    cp_async16(smem, src, 16);
  else
    load_chunk(smem, src, s.bytes);
}

struct Sources {
  ColSrc xa, xb, r;
};

__device__ __forceinline__ void load_stage(uint8_t* st, const Sources& s,
                                           int K, int k0, int t) {
#pragma unroll
  for (int i = 0; i < XA_C; ++i) {
    const int r = t / XA_CPR + i * (THREADS / XA_CPR);
    load_col_chunk(st + raw_off<BM * 4>(r, t % XA_CPR), s.xa, k0 + r, K);
  }
  uint8_t* xb = st + XA_BYTES;
#pragma unroll
  for (int i = 0; i < XB_C; ++i) {
    const int r = t / XB_CPR + i * (THREADS / XB_CPR);
    load_col_chunk(xb + raw_off<BN * 4>(r, t % XB_CPR), s.xb, k0 + r, K);
  }
  // the SR bits: the one loader of the rbits operand
  uint8_t* rs = xb + XB_BYTES;
#pragma unroll
  for (int i = 0; i < R_C; ++i) {
    const int r = t / R_CPR + i * (THREADS / R_CPR);
    load_col_chunk(rs + raw_off<BN * 8>(r, t % R_CPR), s.r, k0 + r, K);
  }
}

// The two words of one unit (columns 2 cp and 2 cp + 1, the four codes of
// rows 4 kq .. 4 kq + 3 each) into a K-major code tile; the column pairs
// 2 and 3 (mod 4) of a warp store their second column first, so the four
// pairs' stores of one instruction fill four distinct 32-byte windows.
__device__ __forceinline__ void store_unit(uint8_t* tile, int cp, int kq,
                                           const unsigned w[2]) {
  const int flip = (cp >> 1) & 1;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int col = 2 * cp + (q ^ flip);
    *reinterpret_cast<unsigned*>(tile + swz<CH>(col, kq >> 2) +
                                 4 * (kq & 3)) = w[q ^ flip];
  }
}

// The quantize parameters: per-tensor scale and zero of both operands,
// their code ranges as floats, and quant_sub of their widths.
struct Quant {
  float sa, za, sb, zb, top_a, top_b;
  int sub_a, sub_b;
};

// One step of the quantize: the stage's X into ca, its dY into cb, the
// thread's dY column code sums into csum.  MASKED: the step or the tile
// reaches past the matrix, and codes outside it are 0.
template <bool MASKED>
__device__ __forceinline__ void quantize_step(const uint8_t* st, uint8_t* ca,
                                              uint8_t* cb, const Quant& q,
                                              int csum[UB][2], int k, int K,
                                              int m0, int M, int n0, int N,
                                              int t) {
  const int kq = t % KQ;
  // X: deterministic
#pragma unroll
  for (int i = 0; i < UA; ++i) {
    const int cp = (t + THREADS * i) / KQ;
    int c[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          st + raw_off<BM * 4>(4 * kq + j, cp >> 1) + 8 * (cp & 1));
      const float x[2] = {v.x, v.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        c[j][e] = quantize_code<false>(x[e], q.sa, q.za, 0u, q.top_a,
                                       q.sub_a);
        if (MASKED && !(k + j < K && m0 + 2 * cp + e < M)) c[j][e] = 0;
      }
    }
    const unsigned w[2] = {pack4(c[0][0], c[1][0], c[2][0], c[3][0]),
                           pack4(c[0][1], c[1][1], c[2][1], c[3][1])};
    store_unit(ca, cp, kq, w);
  }
  // dY: SR
#pragma unroll
  for (int i = 0; i < UB; ++i) {
    const int cp = (t + THREADS * i) / KQ;
    int c[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          st + XA_BYTES + raw_off<BN * 4>(4 * kq + j, cp >> 1) +
          8 * (cp & 1));
      const longlong2 rb = *reinterpret_cast<const longlong2*>(
          st + XA_BYTES + XB_BYTES + raw_off<BN * 8>(4 * kq + j, cp));
      const float x[2] = {v.x, v.y};
      const unsigned b[2] = {static_cast<unsigned>(rb.x),
                             static_cast<unsigned>(rb.y)};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        c[j][e] = quantize_code<true>(x[e], q.sb, q.zb, b[e], q.top_b,
                                      q.sub_b);
        if (MASKED && !(k + j < K && n0 + 2 * cp + e < N)) c[j][e] = 0;
        csum[i][e] += c[j][e];
      }
    }
    const unsigned w[2] = {pack4(c[0][0], c[1][0], c[2][0], c[3][0]),
                           pack4(c[0][1], c[1][1], c[2][1], c[3][1])};
    store_unit(cb, cp, kq, w);
  }
}

template <int SPLITS>
__global__ void __launch_bounds__(THREADS, 1)
fused_qboth_tn_kernel(const float* __restrict__ af,
                      const float* __restrict__ sa_ptr,
                      const float* __restrict__ za_ptr,
                      const float* __restrict__ bf,
                      const float* __restrict__ sb_ptr,
                      const float* __restrict__ zb_ptr,
                      const long long* __restrict__ rbits,
                      const float* __restrict__ a_vec,
                      float* __restrict__ out, int M, int N, int K,
                      int bits_a, int bits_b, int k_span) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int csum_s[BN], csum_tot_s[BN];
  __shared__ float a_s[BM];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  // K slice fastest (one tile's slices are one cluster), then M tile, then
  // N tile: the blocks that share one N tile's dY and bits run side by side
  const int m_tiles = (M + BM - 1) / BM;
  const int split = blockIdx.x % SPLITS;
  const int m0 = (blockIdx.x / SPLITS) % m_tiles * BM;
  const int n0 = blockIdx.x / (SPLITS * m_tiles) * BN;
  const int k_beg = split * k_span;
  const int k_end = min(K, k_beg + k_span);
  const int steps = (k_end - k_beg + BK - 1) / BK;
  uint8_t* ca = smem + RING_BYTES;
  uint8_t* cb = ca + CA_BYTES;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;

  const Sources src = {col_src(af, m0 + 4 * (t % XA_CPR), M, 4),
                       col_src(bf, n0 + 4 * (t % XB_CPR), N, 4),
                       col_src(rbits, n0 + 2 * (t % R_CPR), N, 8)};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(smem + s * STAGE_BYTES, src, K, k_beg + s * BK, t);
    cp_async_commit();
  }
  for (int i = t; i < BM; i += THREADS)
    a_s[i] = m0 + i < M ? a_vec[m0 + i] : 0.0f;
  const int off_a = 1 << (bits_a - 1), off_b = 1 << (bits_b - 1);
  const Quant q = {*sa_ptr, *za_ptr, *sb_ptr, *zb_ptr,
                   static_cast<float>((1 << bits_a) - 1),
                   static_cast<float>((1 << bits_b) - 1),
                   quant_sub(bits_a), quant_sub(bits_b)};
  // the tile lies inside the matrix: only a step past K needs masks
  const bool inside = m0 + BM <= M && n0 + BN <= N;

  int csum[UB][2];
#pragma unroll
  for (int i = 0; i < UB; ++i) csum[i][0] = csum[i][1] = 0;

  for (int kk = 0; kk < steps; ++kk) {
    cp_async_wait<STAGES - 2>();
    // also: the code tiles' readers of the previous step are done
    __syncthreads();
    const int next = kk + STAGES - 1;
    if (next < steps)
      load_stage(smem + (next % STAGES) * STAGE_BYTES, src, K,
                 k_beg + next * BK, t);
    cp_async_commit();
    const uint8_t* st = smem + (kk % STAGES) * STAGE_BYTES;
    const int k0 = k_beg + kk * BK;
    const int k = k0 + 4 * (t % KQ);
    if (inside && k0 + BK <= K)
      quantize_step<false>(st, ca, cb, q, csum, k, K, m0, M, n0, N, t);
    else
      quantize_step<true>(st, ca, cb, q, csum, k, K, m0, M, n0, N, t);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc)
      warp_mma_k32<MI, NJ, CH>(acc, ca, wm * WM, cb, wn * WN, kc, lane);
  }
  cp_async_wait<0>();

  // column code sums: the KQ lanes sharing a column pair reduce, the first
  // stores
#pragma unroll
  for (int i = 0; i < UB; ++i) {
    const int cp = (t + THREADS * i) / KQ;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int v = csum[i][e];
#pragma unroll
      for (int o = KQ / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (t % KQ == 0) csum_s[2 * cp + e] = v;
    }
  }
  __syncthreads();     // the ring is free and csum_s complete

  int* tile = reinterpret_cast<int*>(smem);
  acc_to_tile<MI, NJ, LDT>(tile, acc, wm * WM, wn * WN, lane);
  const int* cs = reduce_cols<BN, THREADS, SPLITS>(csum_s, csum_tot_s);
  const float alpha_a = __fdiv_rn(1.0f, q.sa);
  const float beta_a =
      __fadd_rn(__fmul_rn(static_cast<float>(off_a), alpha_a), q.za);
  const float alpha_b = __fdiv_rn(1.0f, q.sb);
  const float beta_b =
      __fadd_rn(__fmul_rn(static_cast<float>(off_b), alpha_b), q.zb);
  const float s_ab = __fmul_rn(alpha_a, alpha_b);
  const float k_beta_b = __fmul_rn(static_cast<float>(K), beta_b);
  reduce_tile<BM, BN, THREADS, SPLITS>(
      tile, nullptr, [&](int row, int col, int4 v, int) {
        const int m = m0 + row, n = n0 + col;
        if (m >= M) return;
        const int s4[4] = {v.x, v.y, v.z, v.w};
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float u_n = __fadd_rn(
              __fmul_rn(alpha_b, static_cast<float>(cs[col + j])), k_beta_b);
          o[j] = __fadd_rn(
              __fadd_rn(__fmul_rn(static_cast<float>(s4[j]), s_ab),
                        __fmul_rn(beta_a, u_n)),
              a_s[row]);
        }
        store4(out, m, n, N, o);
      });
}

template <int SPLITS>
int launch(const float* af, const float* sa, const float* za,
           const float* bf, const float* sb, const float* zb,
           const long long* rbits, const float* a_vec, float* out, int M,
           int N, int K, int bits_a, int bits_b, int k_span,
           cudaStream_t s) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  return launch_clustered<fused_qboth_tn_kernel<SPLITS>>(
      tiles * SPLITS, THREADS, SMEM_BYTES, SPLITS, s, af, sa, za, bf, sb, zb,
      rbits, a_vec, out, M, N, K, bits_a, bits_b, k_span);
}

}  // namespace

// The tile this library was built with, for the wrapper's split plan
// (kernels/splitk.py): {BM, BN, BK, THREADS, NACC, STAGES, smem bytes,
// smem bytes}.
extern "C" void fused_qboth_tn_tile(int* cfg) {
  const int v[8] = {BM, BN, BK, THREADS, NACC, STAGES, SMEM_BYTES,
                    SMEM_BYTES};
  for (int i = 0; i < 8; ++i) cfg[i] = v[i];
}

// Blocks the card runs at once in clusters of `cluster` (1..8) (minus the
// CUDA error on failure): what kernels/splitk.py plans with.  The first
// argument is unused (one mode).
extern "C" int fused_qboth_tn_capacity(int, int cluster) {
  return cluster_capacity<fused_qboth_tn_kernel<8>>(THREADS, SMEM_BYTES,
                                                    cluster);
}

// C interface, loaded with ctypes.  af: (K, M) and bf: (K, N) f32, rbits:
// (K, N) int64, all row-major; the four scalars are device pointers.  The
// wrapper's split plan gives `splits` K slices (1..8, one cluster a tile)
// of k_span rows (a multiple of BK; the last may be shorter).  One launch;
// returns its CUDA error (0 = launched).
extern "C" int fused_qboth_tn(const float* af, const float* scale_a,
                              const float* zero_a, const float* bf,
                              const float* scale_b, const float* zero_b,
                              const long long* rbits, const float* a_vec,
                              float* out, int M, int N, int K, int bits_a,
                              int bits_b, int splits, int k_span,
                              void* stream) {
  if (splits < 1 || splits > 8 || k_span < 1 || k_span % BK != 0 ||
      static_cast<long long>(splits) * k_span < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QBOTH_SPLIT(S)                                                       \
  case S:                                                                    \
    return launch<S>(af, scale_a, zero_a, bf, scale_b, zero_b, rbits, a_vec, \
                     out, M, N, K, bits_a, bits_b, k_span, s);
  switch (splits) {
    QBOTH_SPLIT(1) QBOTH_SPLIT(2) QBOTH_SPLIT(3) QBOTH_SPLIT(4)
    QBOTH_SPLIT(5) QBOTH_SPLIT(6) QBOTH_SPLIT(7) QBOTH_SPLIT(8)
  }
#undef QBOTH_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}
