// int8 x bit-packed sub-byte -> int32 GEMM with the affine epilogue, for
// Hopper.
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
// explicitly (__fmul_rn, __fadd_rn) in the reference's order, so the result
// is bit-identical to the plain PyTorch version in kernels/q4_matmul.py.
//
// What bounds it on an H100: at decode (M = slot count) it must stream the
// K*N/ppb packed weight bytes once, 8.4 MB for the 2048 x 8192 MLP
// projection at 4 bits: it is bound by device memory.  The design is
// deliberately simple (first port): the shared tile of gemm_tile.cuh, the
// q8_matmul kernel with its B loader replaced.  Below 8 bits each packed
// byte already holds ppb consecutive K codes of one column, so the
// (64/ppb) x 64 byte tile unpacks straight into K-major words (two bytes a
// word at 4 bits, one at 2, half a byte at 1) with no transpose; at 8 bits
// (the identity pack) the row-major tile keeps q8_matmul's __byte_perm
// transpose, each byte XORed with 0x80 (u ^ 0x80 = u - 128 as int8).
// BK = 64 is a multiple of every ppb, so a K step never splits a byte.
// Ragged M, N and K edges are masked in the kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

template <int WBITS>
__global__ void __launch_bounds__(THREADS)
packed_matmul_kernel(const int8_t* __restrict__ x8,
                     const uint8_t* __restrict__ packed,
                     const float* __restrict__ rs,
                     const float* __restrict__ cs,
                     const float* __restrict__ r2,
                     const float* __restrict__ u,
                     const float* __restrict__ a,
                     const float* __restrict__ b,
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
    if constexpr (WBITS == 8)
      load_b_nmajor(Bs, packed, N, K, n0, k0, t, 0x80808080u);
    else
      load_b_packed<WBITS>(Bs, packed, N, K, n0, k0, t);
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

template <int WBITS>
int launch(const int8_t* x8, const uint8_t* packed, const float* rs,
           const float* cs, const float* r2, const float* u, const float* a,
           const float* b, float* out, int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  packed_matmul_kernel<WBITS>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          x8, packed, rs, cs, r2, u, a, b, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  x8: (M, K) int8; packed: (ceil(K/ppb),
// N) uint8 at wbits in {1, 2, 4, 8}; K is the logical contraction length.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for any other wbits.
extern "C" int packed_matmul(const int8_t* x8, const uint8_t* packed,
                             const float* rs, const float* cs,
                             const float* r2, const float* u, const float* a,
                             const float* b, float* out, int M, int N, int K,
                             int wbits, void* stream) {
  switch (wbits) {
    case 1:
      return launch<1>(x8, packed, rs, cs, r2, u, a, b, out, M, N, K, stream);
    case 2:
      return launch<2>(x8, packed, rs, cs, r2, u, a, b, out, M, N, K, stream);
    case 4:
      return launch<4>(x8, packed, rs, cs, r2, u, a, b, out, M, N, K, stream);
    case 8:
      return launch<8>(x8, packed, rs, cs, r2, u, a, b, out, M, N, K, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
