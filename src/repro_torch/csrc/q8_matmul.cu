// int8 x int8 -> int32 GEMM with the affine epilogue, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/q8_matmul.py q8_matmul
// (body _kernel): the unfused quantized GEMM of core/backend.py q8_gemm.
// On the training path it is the activation-grad GEMM under BHQ,
// Q_b2(dY) @ Q_theta(W).T, computed on the raw Householder-domain codes
// before the S^-1 epilogue (core/backend.py qt_gemm_nt).
//
// What it computes, per output (i, j):
//   acc_ij = sum_k x8_ik * y8_kj                                (int32, exact)
//   out_ij = acc_ij*(rs_i*cs_j) + r2_i*u_j + a_i + b_j
// with every float operation rounded explicitly (__fmul_rn, __fadd_rn) in
// the reference's order, so nvcc contracts nothing into an FMA and the
// result is bit-identical to the plain PyTorch version in
// kernels/q8_matmul.py.
//
// Layouts: x8 is (M, K) row-major.  y8 is (K, N) either row-major
// (N-major: the unfused forward's weight codes) or K-major, i.e. stored
// (N, K) row-major: the BHQ dX GEMM reads the (d_in, d_out) weight codes
// as their transpose, whose K axis is already contiguous, so the wrapper
// passes the view and no copy of the weights is made in any backward.
//
// What bounds it on an H100: at the training shapes (M = 512 tokens,
// K, N <= 10240) it moves M*K + K*N int8 bytes and 4*M*N float bytes and
// does 2*M*N*K int8 operations; on the int8 tensor-core peak (1,979 TOP/s)
// the operations take about as long as the bytes at 3.35 TB/s, a few us.
// The design is deliberately simple (first port; wgmma/TMA come later):
// one block owns a 32 x 64 output tile and sweeps K in steps of 64.  Each
// step it stores both code tiles K-major in shared memory (four codes per
// 32-bit word; an N-major B tile is transposed 4 x 4 bytes at a time in
// registers with __byte_perm) and accumulates with __dp4a, 2 x 4 outputs
// per thread.  Shared-memory rows are padded to 17 words so the inner
// loop's column reads hit 16 distinct banks.  Ragged M, N and K edges are
// masked in the kernel (codes outside the matrix load as 0), so the
// wrapper never pads or slices.  A word of four codes that lies whole
// inside the matrix and 4-byte aligned comes in one load; any other byte
// by byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// Four consecutive int8 codes of one row starting at column c, as one word;
// columns at or beyond `cols` (and any row that is out of range) read 0.
__device__ __forceinline__ unsigned load_word(const int8_t* row, int c,
                                              int cols, bool row_ok) {
  const int8_t* src = row + c;
  if (row_ok && c + 3 < cols && (reinterpret_cast<uintptr_t>(src) & 3) == 0)
    return *reinterpret_cast<const unsigned*>(src);
  int b[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    b[q] = (row_ok && c + q < cols) ? static_cast<int>(src[q]) : 0;
  return pack4(b[0], b[1], b[2], b[3]);
}

template <bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS)
q8_matmul_kernel(const int8_t* __restrict__ x8,
                 const int8_t* __restrict__ y8,
                 const float* __restrict__ rs, const float* __restrict__ cs,
                 const float* __restrict__ r2, const float* __restrict__ u,
                 const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int M, int N, int K) {
  __shared__ int As[BM * LDS];
  __shared__ int Bs[BN * LDS];

  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ty = t >> 4;
  const int tx = t & 15;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 32 rows x 16 words, two words per thread.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + THREADS * i;
      const int row = idx >> 4;
      const int kq = idx & 15;
      const int m = m0 + row;
      As[row * LDS + kq] = static_cast<int>(load_word(
          x8 + static_cast<size_t>(m) * K, k0 + kq * 4, K, m < M));
    }
    if (B_KMAJOR) {
      // B stored (N, K): each word already holds four K-consecutive codes.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = t + THREADS * i;
        const int col = idx >> 4;
        const int kq = idx & 15;
        const int n = n0 + col;
        Bs[col * LDS + kq] = static_cast<int>(load_word(
            y8 + static_cast<size_t>(n) * K, k0 + kq * 4, K, n < N));
      }
    } else {
      // B stored (K, N): one 4 x 4 byte block per thread, transposed.
      const int b_nq = t & 15;
      const int b_kq = t >> 4;
      const int n = n0 + b_nq * 4;
      unsigned r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + b_kq * 4 + j;
        r[j] = load_word(y8 + static_cast<size_t>(kk) * N, n, N, kk < K);
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
    __syncthreads();
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
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
    const float rs_i = rs[m], r2_i = r2[m], a_i = a[m];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx + 16 * cc;
      if (n >= N) continue;
      const float o = __fadd_rn(
          __fadd_rn(
              __fadd_rn(__fmul_rn(static_cast<float>(acc[r][cc]),
                                  __fmul_rn(rs_i, cs[n])),
                        __fmul_rn(r2_i, u[n])),
              a_i),
          b[n]);
      out[static_cast<size_t>(m) * N + n] = o;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  y8 is (K, N) row-major when
// b_kmajor == 0 and stored (N, K) row-major when b_kmajor != 0.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int q8_matmul(const int8_t* x8, const int8_t* y8, const float* rs,
                         const float* cs, const float* r2, const float* u,
                         const float* a, const float* b, float* out, int M,
                         int N, int K, int b_kmajor, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_kmajor)
    q8_matmul_kernel<true><<<grid, THREADS, 0, s>>>(x8, y8, rs, cs, r2, u, a,
                                                    b, out, M, N, K);
  else
    q8_matmul_kernel<false><<<grid, THREADS, 0, s>>>(x8, y8, rs, cs, r2, u, a,
                                                     b, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
