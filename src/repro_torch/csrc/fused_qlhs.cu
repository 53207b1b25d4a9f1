// Fused quantize -> int8 GEMM -> affine epilogue against bit-packed
// weights, for Hopper: the packed forward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_fqt.py
// fused_qlhs_packed_matmul (body _qlhs_packed_kernel): out = Q_f(xf) @
// W-hat, with the per-row deterministic quantize of the f32 LHS done on
// the fly, against weights bit-packed once at load (kernels/pack.py: 1, 2,
// 4 or 8 bits, ppb codes a byte along K): every forward GEMM of a
// weight_bits serving engine, and the training forward under the
// int4w/binary/ternary weight quantizers.  The other modes of the Pallas
// kernel fused_qlhs_matmul moved to the int8 tensor-core tile
// (fused_qlhs_gemm.cuh): the int8 forward is fused_qlhs_fwd.cu, dX
// fused_qlhs_dx.cu.  This kernel stays on gemm_tile.cuh's __dp4a tile for
// now; its quantize and epilogue are the same arithmetic, so at 8 bits its
// result is bit-identical to fused_qlhs_fwd.cu on the same codes (the sums
// are exact either way).
//
// What it computes, per output (i, j):
//   t_ik   = scale_i * (x_ik - zero_i)
//   c_ik   = clip(rint(t_ik), 0, 2^b-1) - 2^(b-1)
//   acc_ij = sum_k c_ik * w_kj,  w the unpacked codes minus 2^(wbits-1)
//   rsum_i = sum_k c_ik                                        (int32, exact)
//   out_ij = acc_ij*(alpha_a*alpha_b) + beta_a*u_j + (alpha_a*beta_b)*rsum_i
//   alpha_a = 1/scale_i,  beta_a = 2^(b-1)*alpha_a + zero_i
// evaluated with explicitly rounded float operations (__fmul_rn & co.), so
// nvcc contracts nothing into an FMA and the result is bit-identical to the
// plain PyTorch version in kernels/fused_fqt.py.  Deterministic rounding is
// rintf (half to even, as jnp.round).
//
// What bounds it on an H100: at decode (M = slot count, 1..16) the kernel
// must stream the K*N/ppb packed weight bytes once (4.2 MB at 4 bits for
// the 2048 x 8192 MLP projection): it is bound by device memory.  The
// design is deliberately simple (first port): the shared tile of
// gemm_tile.cuh, one block owning a 32 x 64 output tile and sweeping K in
// steps of 64.  Each step it
//   * loads its 32 x 64 f32 LHS tile, quantizes it in registers, and
//     stores the codes K-major in shared memory (4 codes per 32-bit word),
//     keeping each row's code sum in registers;
//   * loads the packed weight tile: at 8 bits it is transposed 4 x 4 bytes
//     at a time in registers (gemm_tile.cuh load_b_nmajor) so it lands
//     K-major; below 8 bits one byte holds ppb consecutive K codes of a
//     column (gemm_tile.cuh load_b_packed), unpacked into K-major words,
//     rows >= K (the pack's padding) masked to code 0, not to the shifted
//     zero;
//   * accumulates with __dp4a, 2 x 4 outputs per thread.
// Ragged M, N and K edges are masked in the kernel (codes of padded K
// columns are zero, as the Pallas kernel's col < kdim mask makes them), so
// the wrapper never pads or slices.  A quad of four LHS values that lies
// whole inside the matrix and aligned comes in one 16-byte load; quads on
// a ragged edge or in an unaligned row load element by element.

#include <cstdint>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

// One shifted code of the deterministic per-row quantize.
__device__ __forceinline__ int quantize_code(float x, float s, float z,
                                             float nbins, float off) {
  const float t = __fmul_rn(s, __fsub_rn(x, z));
  const float q = fminf(fmaxf(rintf(t), 0.0f), nbins);
  return static_cast<int>(__fsub_rn(q, off));
}

// B is the (ceil(K/ppb), N) bit-packed unsigned codes of kernels/pack.py
// at WBITS in {1, 2, 4, 8}.
template <int WBITS>
__global__ void __launch_bounds__(THREADS)
fused_qlhs_packed_kernel(const float* __restrict__ xf,
                         const float* __restrict__ sa,
                         const float* __restrict__ za,
                         const uint8_t* __restrict__ y8,
                         const float* __restrict__ ab_ptr,
                         const float* __restrict__ bb_ptr,
                         const float* __restrict__ u,
                         float* __restrict__ out,
                         int M, int N, int K, float nbins, float off) {
  __shared__ int As[BM * LDS];
  __shared__ int Bs[BN * LDS];
  __shared__ int rowsum_s[BM];

  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // LHS tile loader: two (row, 4-column) quads per thread, fixed rows.
  int a_row[2];
  float a_s[2], a_z[2];
  int rsum[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_row[i] = (t >> 4) + 16 * i;
    const int m = m0 + a_row[i];
    a_s[i] = m < M ? sa[m] : 0.0f;
    a_z[i] = m < M ? za[m] : 0.0f;
  }
  const int a_kq = t & 15;
  // Compute mapping: rows ty, ty+16; columns tx, tx+16, tx+32, tx+48.
  const int ty = t >> 4;
  const int tx = t & 15;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + a_row[i];
      const int k = k0 + a_kq * 4;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ok[j] = (m < M) && (k + j < K);
      const size_t off_mk = static_cast<size_t>(m) * K + k;
      const float* src = xf + off_mk;
      if (ok[3] && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4 p = *reinterpret_cast<const float4*>(src);
        v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ok[j]) v[j] = src[j];
      }
      int c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = ok[j] ? quantize_code(v[j], a_s[i], a_z[i], nbins, off) : 0;
      rsum[i] += c[0] + c[1] + c[2] + c[3];
      As[a_row[i] * LDS + a_kq] = static_cast<int>(pack4(c[0], c[1], c[2], c[3]));
    }
    if constexpr (WBITS == 8) {
      // the identity pack: unsigned codes u, u ^ 0x80 = u - 128 as int8
      load_b_nmajor(Bs, y8, N, K, n0, k0, t, 0x80808080u);
    } else {
      load_b_packed<WBITS>(Bs, y8, N, K, n0, k0, t);
    }
    __syncthreads();
    dp4a_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  // Row code sums: the 16 lanes sharing a row reduce, lane 0 of them stores.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int v = rsum[i];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    if ((t & 15) == 0) rowsum_s[a_row[i]] = v;
  }
  __syncthreads();

  const float ab = *ab_ptr;
  const float bb = *bb_ptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ty + 16 * r;
    const int m = m0 + row;
    if (m >= M) continue;
    const float alpha_a = __fdiv_rn(1.0f, sa[m]);
    const float beta_a = __fadd_rn(__fmul_rn(off, alpha_a), za[m]);
    const float a_i = __fmul_rn(__fmul_rn(alpha_a, bb),
                                static_cast<float>(rowsum_s[row]));
    const float s_ab = __fmul_rn(alpha_a, ab);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx + 16 * cc;
      if (n >= N) continue;
      const float o = __fadd_rn(
          __fadd_rn(__fmul_rn(static_cast<float>(acc[r][cc]), s_ab),
                    __fmul_rn(beta_a, u[n])),
          a_i);
      out[static_cast<size_t>(m) * N + n] = o;
    }
  }
}

template <int WBITS>
int launch(const float* xf, const float* sa, const float* za,
           const uint8_t* packed, const float* ab, const float* bb,
           const float* u, float* out, int M, int N, int K, int bits,
           void* stream) {
  const float nbins = static_cast<float>((1 << bits) - 1);
  const float off = static_cast<float>(1 << (bits - 1));
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_qlhs_packed_kernel<WBITS>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          xf, sa, za, packed, ab, bb, u, out, M, N, K, nbins, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes: the packed-weight forward
// (deterministic LHS quantize); packed is the (ceil(K/ppb), N) uint8 codes
// at wbits in {1, 2, 4, 8}.  Returns cudaErrorInvalidValue for any other
// wbits, else cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_qlhs_packed(const float* xf, const float* scale_a,
                                 const float* zero_a, const uint8_t* packed,
                                 const float* alpha_b, const float* beta_b,
                                 const float* u, float* out, int M, int N,
                                 int K, int bits, int wbits, void* stream) {
  switch (wbits) {
    case 1:
      return launch<1>(xf, scale_a, zero_a, packed, alpha_b, beta_b, u, out,
                       M, N, K, bits, stream);
    case 2:
      return launch<2>(xf, scale_a, zero_a, packed, alpha_b, beta_b, u, out,
                       M, N, K, bits, stream);
    case 4:
      return launch<4>(xf, scale_a, zero_a, packed, alpha_b, beta_b, u, out,
                       M, N, K, bits, stream);
    case 8:
      return launch<8>(xf, scale_a, zero_a, packed, alpha_b, beta_b, u, out,
                       M, N, K, bits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
