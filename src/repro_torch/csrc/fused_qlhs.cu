// Fused quantize -> int8 GEMM -> affine epilogue, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_fqt.py
// fused_qlhs_matmul (body _qlhs_kernel) in all its modes: out =
// Q(xf) @ B-hat with the per-row quantize of the f32 LHS done on the fly,
// so no int8 codes of the quantized operand ever reach device memory.
// The FQT step calls it twice per linear layer:
//   * forward (trans_b = 0, deterministic): Q_f(X) @ Q_theta(W), with
//     B = the (K, N) weight codes;
//   * activation grad (trans_b = 1, stochastic): Q_b2(dY) @ Q_theta(W).T
//     for PTQ/PSQ Q_b2, with B = the same (d_in, d_out) weight codes read
//     as their transpose, whose K axis is the contiguous one.
//
// What it computes, per output (i, j):
//   t_ik   = scale_i * (x_ik - zero_i)
//   c_ik   = clip(rint(t_ik), 0, 2^b-1) - 2^(b-1)                 (det)
//          = clip(floor(t_ik + float(rbits_ik) * 2^-32), 0, 2^b-1)
//            - 2^(b-1)                                            (SR)
//   acc_ij = sum_k c_ik * y8_kj                                (int32, exact)
//   rsum_i = sum_k c_ik
//   out_ij = acc_ij*(alpha_a*alpha_b) + beta_a*u_j + (alpha_a*beta_b)*rsum_i
//   alpha_a = 1/scale_i,  beta_a = 2^(b-1)*alpha_a + zero_i
// evaluated with explicitly rounded float operations (__fmul_rn & co.), so
// nvcc contracts nothing into an FMA and the result is bit-identical to the
// plain PyTorch version in kernels/fused_fqt.py.  Deterministic rounding is
// rintf (half to even, as jnp.round).  The SR bits convert to float with
// round-to-nearest (__uint2float_rn), as the reference's integer-to-f32
// cast does.  The bits arrive as prng.bits draws them, uint32 values held
// in int64; the kernel reads each entry's low 32 bits as unsigned (modulo
// 2^32, so values >= 2^31 never saturate), 8 bytes per bit.
//
// What bounds it on an H100: at decode (M = slot count, 1..16) the kernel
// must stream the K x N int8 weight codes once, K*N bytes (17 MB for the
// 2048 x 8192 MLP projection, 101 MB for lm_head): it is bound by device
// memory.  At training shapes (M = 512 tokens) and prefill the f32 LHS
// (and the int64 SR bits) dominate the bytes, and the int8 operations come
// close.  The design is deliberately simple (first port; wgmma/TMA come
// later): one block owns a 32 x 64 output tile and sweeps K in steps of 64.
// Each step it
//   * loads its 32 x 64 f32 LHS tile (and SR bits), quantizes it in
//     registers, and stores the codes K-major in shared memory (4 codes per
//     32-bit word), keeping each row's code sum in registers;
//   * loads the 64 x 64 weight-code tile: N-major (forward) it is
//     transposed 4 x 4 bytes at a time in registers (__byte_perm) so it
//     lands K-major in shared memory as well; K-major (dX) each 4-code word
//     is stored as it comes;
//   * accumulates with __dp4a, 2 x 4 outputs per thread.
// Shared-memory rows are padded to 17 words so the column reads of the
// inner loop hit 16 distinct banks.  Ragged M, N and K edges are masked in
// the kernel (codes of padded K columns are zero, as the Pallas kernel's
// col < kdim mask makes them), so the wrapper never pads or slices.
// A quad of four LHS values (or SR bits, or weight codes) that lies whole
// inside the matrix and aligned comes in one 16-byte load (two for the
// bits, one 4-byte load for codes); quads on a ragged edge or in an
// unaligned row load element by element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int KQ = BK / 4;     // 32-bit words (4 codes) per tile row
constexpr int LDS = KQ + 1;    // padded shared-memory row stride, in words
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

// Four SR bits from their int64 storage, masked: each entry's low 32 bits
// (the uint32 value drawn), 0 where ok is false.
__device__ __forceinline__ void load_quad_bits(const long long* src,
                                               const bool ok[4],
                                               unsigned v[4]) {
  if (ok[3] && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const longlong2 p0 = reinterpret_cast<const longlong2*>(src)[0];
    const longlong2 p1 = reinterpret_cast<const longlong2*>(src)[1];
    v[0] = static_cast<unsigned>(p0.x); v[1] = static_cast<unsigned>(p0.y);
    v[2] = static_cast<unsigned>(p1.x); v[3] = static_cast<unsigned>(p1.y);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = ok[q] ? static_cast<unsigned>(src[q]) : 0u;
  }
}

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

template <bool TRANS_B, bool SR>
__global__ void __launch_bounds__(THREADS)
fused_qlhs_kernel(const float* __restrict__ xf,
                  const float* __restrict__ sa,
                  const float* __restrict__ za,
                  const long long* __restrict__ rbits,
                  const int8_t* __restrict__ y8,
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
      unsigned rb[4] = {0u, 0u, 0u, 0u};
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
      if (SR) load_quad_bits(rbits + off_mk, ok, rb);
      int c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = ok[j] ? quantize_code<SR>(v[j], a_s[i], a_z[i], rb[j], nbins,
                                         off)
                     : 0;
      rsum[i] += c[0] + c[1] + c[2] + c[3];
      As[a_row[i] * LDS + a_kq] = static_cast<int>(pack4(c[0], c[1], c[2], c[3]));
    }
    if (TRANS_B) {
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
        const int b = Bs[(tx + 16 * cc) * LDS + kq];
        acc[0][cc] = __dp4a(a0, b, acc[0][cc]);
        acc[1][cc] = __dp4a(a1, b, acc[1][cc]);
      }
    }
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

template <bool TRANS_B, bool SR>
void launch(const float* xf, const float* sa, const float* za,
            const long long* rbits, const int8_t* y8, const float* ab,
            const float* bb, const float* u, float* out, int M, int N, int K,
            float nbins, float off, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_qlhs_kernel<TRANS_B, SR><<<grid, THREADS, 0, s>>>(
      xf, sa, za, rbits, y8, ab, bb, u, out, M, N, K, nbins, off);
}

}  // namespace

// C interface, loaded with ctypes.  rbits: (M, K) int64 SR bits, or
// nullptr for deterministic rounding; y8 is (K, N) row-major when trans_b == 0 and stored (N, K)
// row-major when trans_b != 0.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int fused_qlhs(const float* xf, const float* scale_a,
                          const float* zero_a, const long long* rbits,
                          const int8_t* y8, const float* alpha_b,
                          const float* beta_b, const float* u, float* out,
                          int M, int N, int K, int bits, int trans_b,
                          void* stream) {
  const float nbins = static_cast<float>((1 << bits) - 1);
  const float off = static_cast<float>(1 << (bits - 1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_b) {
    if (rbits)
      launch<true, true>(xf, scale_a, zero_a, rbits, y8, alpha_b, beta_b, u,
                         out, M, N, K, nbins, off, s);
    else
      launch<true, false>(xf, scale_a, zero_a, rbits, y8, alpha_b, beta_b, u,
                          out, M, N, K, nbins, off, s);
  } else {
    if (rbits)
      launch<false, true>(xf, scale_a, zero_a, rbits, y8, alpha_b, beta_b, u,
                          out, M, N, K, nbins, off, s);
    else
      launch<false, false>(xf, scale_a, zero_a, rbits, y8, alpha_b, beta_b, u,
                           out, M, N, K, nbins, off, s);
  }
  return static_cast<int>(cudaGetLastError());
}
