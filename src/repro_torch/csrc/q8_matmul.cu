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
// the shared tile of gemm_tile.cuh.  One block owns a 32 x 64 output tile
// and sweeps K in steps of 64.  Each step it stores both code tiles K-major
// in shared memory (four codes per 32-bit word; an N-major B tile is
// transposed 4 x 4 bytes at a time in registers with __byte_perm) and
// accumulates with __dp4a, 2 x 4 outputs per thread.  Ragged M, N and K
// edges are masked in the kernel (codes outside the matrix load as 0), so
// the wrapper never pads or slices.

#include <cstdint>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

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
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x8);
  const uint8_t* yb = reinterpret_cast<const uint8_t*>(y8);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 32 rows x 16 words, two words per thread.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + THREADS * i;
      const int row = idx >> 4;
      const int kq = idx & 15;
      const int m = m0 + row;
      As[row * LDS + kq] = static_cast<int>(load_word(
          xb + static_cast<size_t>(m) * K, k0 + kq * 4, K, m < M));
    }
    if (B_KMAJOR)
      load_b_kmajor(Bs, yb, N, K, n0, k0, t);
    else
      load_b_nmajor(Bs, yb, N, K, n0, k0, t, 0u);
    __syncthreads();
    dp4a_step(As, Bs, ty, tx, acc);
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
