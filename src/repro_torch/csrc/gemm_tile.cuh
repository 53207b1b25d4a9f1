// The __dp4a GEMM tile of the packed-weight kernels, fused_qlhs.cu (the
// packed forward) and packed_matmul.cu: one block owns a BM x BN output
// tile and sweeps K in steps of BK.  Each step both operands land K-major in shared memory, four
// int8 codes to a 32-bit word, and __dp4a accumulates 2 x 4 outputs per
// thread.  Shared-memory rows are padded to LDS = 17 words so the inner
// loop's column reads hit 16 distinct banks.
//
// This header holds the pieces the two kernels have in common: the word
// loaders, the two B-tile loaders (row-major 8-bit codes, bit-packed
// sub-byte codes) and the __dp4a sweep of one K step.  Codes outside the
// matrix load as 0, so no wrapper pads or slices.  The int8 kernels
// (q8_matmul, the int8 forward, dX, dW) run on int8_mma.cuh's tensor-core
// tile instead.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gemm_tile {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int KQ = BK / 4;     // 32-bit words (4 codes) per tile row
constexpr int LDS = KQ + 1;    // padded shared-memory row stride, in words

__device__ __forceinline__ unsigned pack4(int c0, int c1, int c2, int c3) {
  return static_cast<unsigned>((c0 & 0xff) | ((c1 & 0xff) << 8) |
                               ((c2 & 0xff) << 16) | ((c3 & 0xff) << 24));
}

// Four consecutive bytes of one row starting at column c, as one word;
// columns at or beyond `cols` and rows out of range read 0.  A word that
// lies whole inside the row and 4-byte aligned comes in one load, any other
// byte by byte.
__device__ __forceinline__ unsigned load_word(const uint8_t* row, int c,
                                              int cols, bool row_ok) {
  const uint8_t* src = row + c;
  if (row_ok && c + 3 < cols && (reinterpret_cast<uintptr_t>(src) & 3) == 0)
    return *reinterpret_cast<const unsigned*>(src);
  int b[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    b[q] = (row_ok && c + q < cols) ? static_cast<int>(src[q]) : 0;
  return pack4(b[0], b[1], b[2], b[3]);
}

// The bytes of a load_word result that lie inside the matrix, as a mask.
__device__ __forceinline__ unsigned inside_mask(int c, int cols, bool row_ok) {
  const int n = row_ok ? min(max(cols - c, 0), 4) : 0;
  return n == 4 ? 0xffffffffu : (1u << (8 * n)) - 1u;
}

// B stored (K, N) row-major, one byte a code: one 4 x 4 byte block per
// thread, transposed in registers with __byte_perm so the tile lands
// K-major.  Each byte inside the matrix is XORed with `flip` (0x80 turns an
// unsigned 8-bit code u into the signed u - 128); bytes outside stay 0.  The
// flip comes after all four loads are issued: applied inside load_word it
// made each load wait for the one before (1.5x slower at decode shapes).
__device__ __forceinline__ void load_b_nmajor(int* Bs, const uint8_t* y,
                                              int N, int K, int n0, int k0,
                                              int t, unsigned flip) {
  const int b_nq = t & 15;
  const int b_kq = t >> 4;
  const int n = n0 + b_nq * 4;
  unsigned r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = k0 + b_kq * 4 + j;
    r[j] = load_word(y + static_cast<size_t>(kk) * N, n, N, kk < K);
  }
  if (flip) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] ^= flip & inside_mask(n, N, k0 + b_kq * 4 + j < K);
  }
  // word i holds column n+i at rows k..k+3
  const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned hi23 = __byte_perm(r[2], r[3], 0x7362);
  const int col = b_nq * 4;
  Bs[(col + 0) * LDS + b_kq] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  Bs[(col + 1) * LDS + b_kq] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  Bs[(col + 2) * LDS + b_kq] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  Bs[(col + 3) * LDS + b_kq] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

// B bit-packed at WBITS in {1, 2, 4} (kernels/pack.py layout): logical row
// k of column n is bitfield WBITS * (k % PPB) of byte (k / PPB, n), so one
// byte holds PPB consecutive K codes of one column and the tile needs no
// transpose: at 4 bits two bytes make a K-major word, at 2 bits one byte,
// at 1 bit one byte makes two.  BK is a multiple of every PPB, so a K step
// never splits a byte.  Each code is shifted by -2^(WBITS-1); rows at or
// beyond kdim (the pack's padding) and columns beyond N read 0.  Adjacent
// threads take adjacent columns, so each warp's byte loads are contiguous;
// every byte of the thread's four words is loaded before any is decoded,
// so the loads are in flight together.
template <int WBITS>
__device__ __forceinline__ void load_b_packed(int* Bs, const uint8_t* packed,
                                              int N, int kdim, int n0, int k0,
                                              int t) {
  constexpr int PPB = 8 / WBITS;
  constexpr int MASK = (1 << WBITS) - 1;
  constexpr int OFF = 1 << (WBITS - 1);
  constexpr int BYTES = PPB < 4 ? 4 / PPB : 1;   // bytes behind one word
  const int col = t & (BN - 1);
  const int n = n0 + col;
  const int rows = (kdim + PPB - 1) / PPB;        // packed byte rows
  int raw[4][BYTES];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + (t / BN + (THREADS / BN) * i) * 4;
#pragma unroll
    for (int b = 0; b < BYTES; ++b) {
      const int row = k / PPB + b;
      raw[i][b] = (n < N && row < rows)
                      ? packed[static_cast<size_t>(row) * N + n] : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kq = t / BN + (THREADS / BN) * i;
    const int k = k0 + kq * 4;
    int c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k + q;
      const int byte = raw[i][PPB < 4 ? q / PPB : 0];
      c[q] = (n < N && kk < kdim)
                 ? ((byte >> (WBITS * (kk % PPB))) & MASK) - OFF : 0;
    }
    Bs[col * LDS + kq] = static_cast<int>(pack4(c[0], c[1], c[2], c[3]));
  }
}

// One K step of the product: rows ty and ty + 16 of As against columns
// tx + 16 * cc of Bs, accumulated in exact int32.
__device__ __forceinline__ void dp4a_step(const int* As, const int* Bs,
                                          int ty, int tx, int acc[2][4]) {
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq) {
    const int a0 = As[ty * LDS + kq];
    const int a1 = As[(ty + 16) * LDS + kq];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int bw = Bs[(tx + 16 * cc) * LDS + kq];
      acc[0][cc] = __dp4a(a0, bw, acc[0][cc]);
      acc[1][cc] = __dp4a(a1, bw, acc[1][cc]);
    }
  }
}

}  // namespace gemm_tile
