// The int8 tensor-core GEMM tile shared by q8_matmul.cu (q8_matmul, both B
// layouts), fused_qlhs_gemm.cuh (the fused-quantize LHS GEMM: the dX
// entry fused_qlhs_dx.cu, the int8 forward fused_qlhs_fwd.cu and the
// packed forward fused_qlhs_packed.cu), packed_matmul.cu and
// fused_qboth_tn.cu (dW): mma.sync m16n8k32 (s8 x s8 -> s32) on operands
// that sit K-major in shared memory, a ring of cp.async stages, and split-K
// reduced exactly inside a thread-block cluster.
//
// Why mma.sync and not wgmma: at the training shapes (M = 512 tokens) the
// bound is bytes and latency, not the tensor cores (lm_head's 5.4 GOP take
// 2.7 us at the int8 peak); what the old __dp4a tile lacked was work in
// flight.  mma.sync keeps the fragments in registers, takes any warp
// tiling, and needs neither TMA descriptors nor warpgroup-sized tiles.
//
// Layout of an operand tile in shared memory: one row per M (or N) index,
// 16 * CH bytes of K codes a row (CH 16-byte chunks), the chunk index XORed
// with a function of the row (swz) so that the eight 16-byte rows one
// ldmatrix phase reads fall in eight distinct bank groups.  ldmatrix (.b16,
// no .trans) then hands each lane exactly the fragment
// mma.m16n8k32.row.col wants: four int8 K codes of one row a register.
// An operand stored N-major (K rows of N codes: the weight codes of the
// forward) lands as stored in a raw stage and is transposed 4 x 4 bytes at
// a time in registers (transpose4x4, transpose_b) into that tile; weights
// bit-packed along K (kernels/pack.py) land as stored too, and unpack_b
// turns each raw stage into the same tile.
//
// Split-K: a block owns one (M tile, N tile, K slice), and the slices of a
// tile are one cluster of 1 to 8 blocks (kernels/splitk.py picks the
// split).  After the K sweep each block writes its int32 accumulators into
// its own shared memory as a row-major tile; the cluster meets at a
// barrier, and each block sums its share of the rows over every block's
// tile through distributed shared memory and runs the epilogue on them,
// once, on the full sums.  Per-row extras (the LHS row code sums) join
// that pass (reduce_tile); per-column extras (dW's column code sums) are
// summed beside it (reduce_cols).  Integer addition is exact and commutes,
// so the result does not depend on the order in which the slices arrive;
// no workspace, no atomics, no second launch, and no float is ever summed
// across blocks.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace int8_mma {

// cp.async of one 16-byte chunk; bytes past src_bytes (0 or 16) are
// zero-filled.  L2 only (.cg): every byte is used once per block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 exact.
__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four codes, one byte each (byte j = the low byte of cj): three
// byte_perms.
__device__ __forceinline__ unsigned pack4(int c0, int c1, int c2, int c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

// Byte offset of 16-byte chunk c of row r in a tile of CH chunks a row:
// 128 / (16 * CH) rows share one 128-byte bank line, and the XOR key
// changes from one such group of rows to the next.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CH == 2 || CH == 4 || CH == 8, "CH");
  return r * (16 * CH) + ((c ^ ((r / (8 / CH)) & (CH - 1))) << 4);
}

// Sixteen bytes of one row from `src`, the first `n` of them (0..16) and
// the rest 0, into smem: one cp.async when all 16 lie inside the matrix and
// the source is 16-byte aligned, else byte by byte with plain loads and
// stores (ragged edges, unaligned rows).  Callers use it for chunks of
// int8 codes, f32 values and int64 bits alike.
__device__ __forceinline__ void load_chunk(void* smem, const uint8_t* src,
                                           int n) {
  if (n == 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(smem, src, 16);
  } else {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = 4 * q + j < n ? static_cast<int>(src[4 * q + j]) : 0;
      w[q] = pack4(b[0], b[1], b[2], b[3]);
    }
    *reinterpret_cast<uint4*>(smem) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The four words of a 4 x 4 byte block transposed: r[j] holds row j's
// bytes for columns 0..3 (byte q = column q); w[q] holds column q's bytes
// for rows 0..3 (byte j = row j).
__device__ __forceinline__ void transpose4x4(const unsigned r[4],
                                             unsigned w[4]) {
  const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned hi23 = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[1] = __byte_perm(lo01, lo23, 0x7632);
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Byte offset of 16-byte chunk c of row r in a raw stage of ROW_BYTES a
// row (an N-major stage of int8 codes, or dW's f32 and int64 rows), the
// chunk at c ^ ((r / 4) mod min(ROW_BYTES / 16, 8)): reads of four rows at
// a time, with the 4-row group the lanes' fastest index (transpose_b, dW's
// quantize), spread over the banks.
template <int ROW_BYTES>
__device__ __forceinline__ int raw_off(int r, int c) {
  constexpr int KEY = (ROW_BYTES / 16 < 8 ? ROW_BYTES / 16 : 8) - 1;
  return r * ROW_BYTES + ((c ^ ((r >> 2) & KEY)) << 4);
}

// B stored (K, N) row-major: rows k0 .. k0 + BK - 1, columns n0 ..
// n0 + BN - 1 into a raw stage as stored (bytes outside the matrix 0).
// Packed weights ((ceil(K / ppb), N) bytes) load the same way, BK / ppb
// byte rows a stage; a stage of fewer chunks than threads leaves the
// last threads idle.
template <int BK, int BN, int THREADS>
__device__ __forceinline__ void load_b_raw(uint8_t* bs, const uint8_t* y,
                                           int N, int K, int n0, int k0,
                                           int t) {
  constexpr int CHUNKS = BK * (BN / 16);
  static_assert(CHUNKS % THREADS == 0 || CHUNKS < THREADS,
                "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < (CHUNKS + THREADS - 1) / THREADS; ++i) {
    const int id = t + THREADS * i;
    if (CHUNKS < THREADS && id >= CHUNKS) break;
    const int r = id / (BN / 16), c = id % (BN / 16);
    const int k = k0 + r, nn = n0 + 16 * c;
    const int n = k < K ? min(max(N - nn, 0), 16) : 0;
    load_chunk(bs + raw_off<BN>(r, c), y + static_cast<size_t>(k) * N + nn,
               n);
  }
}

// Raw N-major stage -> K-major swizzled tile of BN rows and BK codes: each
// thread transposes BK * BN / 16 / THREADS blocks of 4 k x 4 n codes,
// consecutive threads taking consecutive 4-row groups of k (so the stores
// of one warp fill whole tile rows).
template <int BK, int BN, int THREADS>
__device__ __forceinline__ void transpose_b(uint8_t* bt, const uint8_t* raw,
                                            int t) {
  constexpr int CH = BK / 16;
  static_assert(BK * BN / 16 % THREADS == 0, "whole blocks a thread");
#pragma unroll
  for (int i = 0; i < BK * BN / 16 / THREADS; ++i) {
    const int id = t + THREADS * i;
    const int kq = id % (BK / 4);              // 4-row group of k
    const int nq = id / (BK / 4);              // 4-column group of n
    unsigned r[4], w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = *reinterpret_cast<const unsigned*>(
          raw + raw_off<BN>(4 * kq + j, nq >> 2) + 4 * (nq & 3));
    transpose4x4(r, w);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(bt + swz<CH>(4 * nq + j, kq >> 2) +
                                   4 * (kq & 3)) = w[j];
  }
}

// A raw stage of weights bit-packed at WBITS in {1, 2, 4, 8}
// (kernels/pack.py: unsigned code k of column n is bitfield WBITS * (k %
// ppb) of byte (k / ppb, n), ppb = 8 / WBITS; 8 bits is the identity
// pack), BK / ppb byte rows of BN columns as load_b_raw lands them, ->
// the K-major swizzled tile of BN rows and BK shifted codes (code minus
// 2^(WBITS-1), int8) that warp_mma_k32 reads.  A byte already holds ppb
// consecutive K codes of one column, so a thread takes 4 columns x R byte
// rows (R = 4 / ppb, at least 1): one word a row, whose bytes are the 4
// columns; shifts and masks split each word into ppb words of one code
// a column (byte q = column q), transpose4x4 turns each 4 of them into 4
// K-major words (one a column), and a per-byte subtract shifts the codes
// ((c | 0x80) - 2^(WBITS-1), then ^ 0x80: no borrow crosses a byte; at 8
// bits the ^ 0x80 alone, u ^ 0x80 = u - 128 as int8).  Codes at k >= K
// (the pack's padding, and rows past the matrix, which load as 0) become
// 0, not the shifted zero, as the Pallas kernels mask them.  k0 is the
// stage's first K index.  Consecutive threads take consecutive K groups
// of one 4-column group, as transpose_b does.
template <int WBITS, int BK, int BN, int THREADS>
__device__ __forceinline__ void unpack_b(uint8_t* bt, const uint8_t* raw,
                                         int k0, int K, int t) {
  static_assert(WBITS == 1 || WBITS == 2 || WBITS == 4 || WBITS == 8,
                "WBITS");
  constexpr int PPB = 8 / WBITS;
  constexpr int CH = BK / 16;
  constexpr int R = PPB >= 4 ? 1 : 4 / PPB;   // byte rows a unit
  constexpr int KW = R * PPB / 4;             // K words a column a unit
  constexpr int UK = BK / (4 * KW);           // units along K
  constexpr int UNITS = UK * (BN / 4);
  constexpr unsigned FIELD = ((1u << WBITS) - 1u) * 0x01010101u;
  constexpr unsigned SHIFT = (1u << (WBITS - 1)) * 0x01010101u;
  static_assert(BK % (4 * KW) == 0 && UNITS % THREADS == 0,
                "whole units a thread");
#pragma unroll
  for (int i = 0; i < UNITS / THREADS; ++i) {
    const int id = t + THREADS * i;
    const int uk = id % UK;                   // unit along K
    const int nq = id / UK;                   // 4-column group of n
    unsigned r[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
      r[j] = *reinterpret_cast<const unsigned*>(
          raw + raw_off<BN>(R * uk + j, nq >> 2) + 4 * (nq & 3));
    // f[q]: the code of K index 4 KW uk + q of each of the 4 columns
    unsigned f[4 * KW];
#pragma unroll
    for (int q = 0; q < 4 * KW; ++q) {
      if constexpr (WBITS == 8)
        f[q] = r[q];
      else
        f[q] = (r[q / PPB] >> (WBITS * (q % PPB))) & FIELD;
    }
#pragma unroll
    for (int g = 0; g < KW; ++g) {
      unsigned w[4];
      transpose4x4(f + 4 * g, w);
      const int kw = KW * uk + g;             // word of 4 codes along K
      const int kk = k0 + 4 * kw;
      const unsigned keep =
          kk + 4 <= K ? 0xffffffffu
                      : (kk >= K ? 0u : (1u << (8 * (K - kk))) - 1u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned c =
            WBITS == 8 ? w[j] ^ 0x80808080u
                       : ((w[j] | 0x80808080u) - SHIFT) ^ 0x80808080u;
        *reinterpret_cast<unsigned*>(bt + swz<CH>(4 * nq + j, kw >> 2) +
                                     4 * (kw & 3)) = c & keep;
      }
    }
  }
}

constexpr float U32_TO_UNIT = 2.3283064365386963e-10f;   // 2^-32, exact

// 1.5 * 2^23: a float in [0, 2^22] plus this lands where the float grid's
// step is 1, so the add rounds to an integer and the sum's bits are
// MAGIC_BITS plus that integer
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// What quantize_code subtracts from the bits of its rounded sum for b-bit
// codes: MAGIC_BITS and the shift 2^(b-1).
__host__ __device__ constexpr int quant_sub(int bits) {
  return MAGIC_BITS + (1 << (bits - 1));
}

// One shifted code of a quantize (the forward's and dX's per-row LHS, dW's
// per-tensor X and dY), every float operation rounded as the reference
// orders it:
//   t = s * (x - z);  q = rint(t)  or  floor(t + float(rb) * 2^-32) (SR);
//   clip to [0, top = 2^b - 1], minus 2^(b-1)  (sub = quant_sub(b)).
// It keeps off the conversion pipe (a quarter of the arithmetic rate):
// clamping to integer bounds commutes with rint and floor, so the value is
// clamped in float and rounded by adding MAGIC (to nearest even for rint,
// toward minus infinity for floor), whose bits then hold the integer.
// rb * 2^-32 is exact, so the fma rounds as the reference's add does; only
// SR's bits-to-float converts.
template <bool SR>
__device__ __forceinline__ int quantize_code(float x, float s, float z,
                                             unsigned rb, float top,
                                             int sub) {
  float t = __fmul_rn(s, __fsub_rn(x, z));
  if (SR) t = __fmaf_rn(__uint2float_rn(rb), U32_TO_UNIT, t);
  const float y = fminf(fmaxf(t, 0.0f), top);
  return __float_as_int(SR ? __fadd_rd(y, MAGIC) : __fadd_rn(y, MAGIC)) -
         sub;
}

// One row of an operand whose chunks a thread loads at every K step: the
// row's first byte, its length in bytes, and whether the row lies inside
// the matrix (rows past the edge load as 0) with 16-byte aligned chunks.
// Built once before the K sweep, so a step's load is an add, a compare
// and the cp.async.
struct RowSrc {
  const uint8_t* row;
  int bytes;
  bool inside, aligned;
};

__device__ __forceinline__ RowSrc row_src(const void* base, size_t row,
                                          int row_bytes, bool inside) {
  const uint8_t* p = static_cast<const uint8_t*>(base) + row * row_bytes;
  return {p, row_bytes, inside,
          inside && (reinterpret_cast<uintptr_t>(p) & 15) == 0};
}

// The 16 bytes at byte `kb` (a multiple of 16) of the row into smem.
__device__ __forceinline__ void load_row_chunk(void* smem, const RowSrc& s,
                                               int kb) {
  if (s.aligned && kb + 16 <= s.bytes)
    cp_async16(smem, s.row + kb, 16);
  else
    load_chunk(smem, s.row + kb, s.inside ? min(max(s.bytes - kb, 0), 16) : 0);
}

// One k32 step of a warp's MI x NJ grid of m16n8 tiles: A rows a_row0 ..
// a_row0 + 16 MI - 1 and B rows (N indices) b_row0 .. b_row0 + 8 NJ - 1 of
// two K-major swizzled tiles with CH chunks a row, K chunks 2 kc and
// 2 kc + 1.
template <int MI, int NJ, int CH>
__device__ __forceinline__ void warp_mma_k32(int acc[MI * NJ * 4],
                                             const uint8_t* As, int a_row0,
                                             const uint8_t* Bs, int b_row0,
                                             int kc, int lane) {
  unsigned a[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r = a_row0 + mi * 16 + (lane & 15);
    ldmatrix_x4(a[mi], As + swz<CH>(r, 2 * kc + (lane >> 4)));
  }
#pragma unroll
  for (int nj = 0; nj < NJ; nj += 2) {
    const int r = b_row0 + nj * 8 + (lane & 7) + ((lane >> 4) << 3);
    unsigned b[4];
    ldmatrix_x4(b, Bs + swz<CH>(r, 2 * kc + ((lane >> 3) & 1)));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      mma_s8(&acc[(mi * NJ + nj) * 4], a[mi], b[0], b[1]);
      mma_s8(&acc[(mi * NJ + nj + 1) * 4], a[mi], b[2], b[3]);
    }
  }
}

// The warp's MI x NJ grid of m16n8 accumulators into a row-major int32
// tile in shared memory, rows of LDT int32 (LDT = BN + 8: the eight rows
// of one int2 store phase fall in distinct banks).
template <int MI, int NJ, int LDT>
__device__ __forceinline__ void acc_to_tile(int* tile, const int* acc,
                                            int row0, int col0, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int* c = acc + (mi * NJ + nj) * 4;
      int* p = tile + (row0 + mi * 16 + g) * LDT + col0 + nj * 8 + 2 * tig;
      *reinterpret_cast<int2*>(p) = make_int2(c[0], c[1]);
      *reinterpret_cast<int2*>(p + 8 * LDT) = make_int2(c[2], c[3]);
    }
  }
}

// Split-K reduction and epilogue walk.  Every block has written its BM x BN
// partial (acc_to_tile) into `tile`, its own shared memory, and its BM
// row partials of some extra sum (the LHS row code sums of
// fused_qlhs_gemm.cuh) into
// extra_s, or extra_s is null.  With SPLITS > 1 the SPLITS blocks of the
// tile's cluster (SPLITS K slices, at most 8: a portable cluster) meet at
// the cluster barrier, and the block of rank r sums rows r * R ..
// (r + 1) * R - 1, R = ceil(BM / SPLITS), over all ranks' tiles
// (distributed shared memory, one 16-byte load a rank, all issued before
// the first add), so every block finalizes its share of the tile.  emit(row, col, sum,
// extra) gets each 4-column chunk's int32 sums and the row's extra sum.
// Integer sums are exact, so nothing depends on the order in which the
// slices arrive; nothing leaves the SMs, and no float is summed across
// blocks.
template <int BM, int BN, int THREADS, int SPLITS, typename Emit>
__device__ __forceinline__ void reduce_tile(const int* tile,
                                            const int* extra_s, Emit emit) {
  constexpr int LDT = BN + 8;
  constexpr int ROWS = (BM + SPLITS - 1) / SPLITS;
  namespace cg = cooperative_groups;
  int r0 = 0;
  if constexpr (SPLITS > 1) {
    cg::this_cluster().sync();
    r0 = static_cast<int>(cg::this_cluster().block_rank()) * ROWS;
  } else {
    __syncthreads();
  }
  for (int c = threadIdx.x; c < ROWS * (BN / 4); c += THREADS) {
    const int row = r0 + c / (BN / 4), col = (c % (BN / 4)) * 4;
    if (row >= BM) break;
    const int off = row * LDT + col;
    int4 sum;
    int ex = 0;
    if constexpr (SPLITS > 1) {
      int4 v[SPLITS];
      int e[SPLITS];
#pragma unroll
      for (int r = 0; r < SPLITS; ++r) {
        v[r] = *reinterpret_cast<const int4*>(
            cg::this_cluster().map_shared_rank(tile, r) + off);
        e[r] = extra_s ? cg::this_cluster().map_shared_rank(extra_s, r)[row]
                       : 0;
      }
      sum = v[0];
      ex = e[0];
#pragma unroll
      for (int r = 1; r < SPLITS; ++r) {
        sum.x += v[r].x; sum.y += v[r].y; sum.z += v[r].z; sum.w += v[r].w;
        ex += e[r];
      }
    } else {
      sum = *reinterpret_cast<const int4*>(tile + off);
      ex = extra_s ? extra_s[row] : 0;
    }
    emit(row, col, sum, ex);
  }
  // no block leaves while a peer still reads its tile
  if constexpr (SPLITS > 1) cg::this_cluster().sync();
}

// Per-column extra sums across the K slices of a cluster (dW's column
// code sums), beside reduce_tile: every block's BN partials in part_s
// (written and made visible to the block before the call); with SPLITS > 1
// the cluster meets at a barrier and each block sums every rank's part_s
// into its own total_s, else part_s is the total.  Returns the totals, which are visible to the
// whole block after reduce_tile's first barrier; reduce_tile's last
// barrier keeps every peer's part_s alive until all have read it.
template <int BN, int THREADS, int SPLITS>
__device__ __forceinline__ const int* reduce_cols(const int* part_s,
                                                  int* total_s) {
  if constexpr (SPLITS > 1) {
    namespace cg = cooperative_groups;
    cg::this_cluster().sync();
    for (int c = threadIdx.x; c < BN; c += THREADS) {
      int v[SPLITS];
#pragma unroll
      for (int r = 0; r < SPLITS; ++r)
        v[r] = cg::this_cluster().map_shared_rank(part_s, r)[c];
      int sum = v[0];
#pragma unroll
      for (int r = 1; r < SPLITS; ++r) sum += v[r];
      total_s[c] = sum;
    }
    return total_s;
  } else {
    return part_s;
  }
}

// Four outputs of row m, columns n .. n + 3, of a row-major (M, N) f32
// matrix: one 16-byte store where all four lie inside and align, else one
// by one up to column N.
__device__ __forceinline__ void store4(float* out, int m, int n, int N,
                                       const float o[4]) {
  float* p = out + static_cast<size_t>(m) * N + n;
  if (n + 3 < N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) p[j] = o[j];
  }
}

// Launch Kernel on a 1-D grid of `blocks`, clusters of `cluster`
// consecutive blocks.  Returns the launch's CUDA error.
template <auto Kernel, typename... Args>
int launch_clustered(int blocks, int threads, int smem, int cluster,
                     cudaStream_t stream, Args... args) {
  // once a kernel: the attribute call costs host time
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of Kernel the card runs at once in clusters of `cluster`
// (cudaOccupancyMaxActiveClusters times the cluster size), or minus the
// CUDA error.
template <auto Kernel>
int cluster_capacity(int threads, int smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, Kernel, &cfg);
  return e == cudaSuccess ? n * cluster : -static_cast<int>(e);
}

// The block's (M tile, N tile, K slice) from a 1-D grid ordered K slice
// fastest (one tile's slices are one cluster), then N tile, then M tile:
// the tiles that share one M tile's rows of A run side by side.
struct BlockCoords {
  int m_tile, n_tile, split;
};

__device__ __forceinline__ BlockCoords block_coords(int n_tiles, int splits) {
  const int id = blockIdx.x;
  BlockCoords c;
  c.split = id % splits;
  c.n_tile = (id / splits) % n_tiles;
  c.m_tile = id / (splits * n_tiles);
  return c;
}

}  // namespace int8_mma
