// Weight-gradient GEMM with both operands quantized in the K sweep, for
// Hopper.
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
// with a_m = alpha_a*beta_b*sum_k ca_km computed outside (the block never
// holds a whole column of A), and every float operation rounded explicitly
// in the reference's order (__fmul_rn & co.), so the result is
// bit-identical to the plain PyTorch version in kernels/fused_fqt.py.  The
// four scalars arrive as device pointers, so no launch waits on the host.
//
// What bounds it on an H100: it reads 4*K*(M + N) bytes of f32 operands
// and 8*K*N bytes of SR bits (uint32 values held in int64, as prng.bits
// draws them; the kernel reads each entry's low 32 bits as unsigned) and
// writes 4*M*N bytes of dW; at the training shapes (K = 512 tokens,
// M, N <= 10240) the bytes and the 2*M*N*K int8 operations take a few us
// each on the data-sheet peaks.
// The TPU kernel carries acc and csum in scratch across sequential grid
// steps; here each block loops over K itself.  The design is deliberately
// simple (first port; wgmma/TMA come later): one block owns a 32 x 64
// output tile and sweeps K in steps of 64.  Both f32 tiles arrive K-slow
// (row k holds consecutive m or n), while __dp4a wants four K-consecutive
// codes in one word: each thread loads a 4 (K) x 4 block, quantizes it in
// registers, and transposes the four packed rows with __byte_perm so each
// word it stores holds one column's four K-consecutive codes, K-major in
// shared memory (rows padded to 17 words against bank conflicts).  The B
// block's column code sums stay in the thread's registers over the whole
// sweep and meet in shared memory (integer atomics, exact) at the end.
// Ragged M, N and K edges are masked in the kernel (codes of padded K rows
// are 0, as the Pallas kernel's row < kdim mask makes them), so the wrapper
// never pads or slices.

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

__device__ __forceinline__ unsigned pack4(int c0, int c1, int c2, int c3) {
  return static_cast<unsigned>((c0 & 0xff) | ((c1 & 0xff) << 8) |
                               ((c2 & 0xff) << 16) | ((c3 & 0xff) << 24));
}

// r[j] holds row j's codes for columns 0..3 (byte q = column q); stores the
// four words that hold column q's codes for rows 0..3 at dst[q * LDS].
__device__ __forceinline__ void store_transposed(const unsigned r[4],
                                                 int* dst) {
  const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned hi23 = __byte_perm(r[2], r[3], 0x7362);
  dst[0 * LDS] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  dst[1 * LDS] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  dst[2 * LDS] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  dst[3 * LDS] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

// Four consecutive f32 values of row `row` from column c, masked: values
// outside the matrix read 0 and their ok flag is false.
__device__ __forceinline__ void load_quad_f32(const float* base, int row,
                                              int rows, int c, int cols,
                                              float v[4], bool ok[4]) {
  const float* src = base + static_cast<size_t>(row) * cols + c;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ok[q] = row < rows && c + q < cols;
    v[q] = 0.0f;
  }
  if (ok[3] && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4 p = *reinterpret_cast<const float4*>(src);
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (ok[q]) v[q] = src[q];
  }
}

// The four SR bits beside a quad, from their int64 storage, masked: each
// entry's low 32 bits (the uint32 value drawn), 0 where ok is false.
__device__ __forceinline__ void load_quad_bits(const long long* base,
                                               int row, int c, int cols,
                                               const bool ok[4],
                                               unsigned v[4]) {
  const long long* src = base + static_cast<size_t>(row) * cols + c;
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

__global__ void __launch_bounds__(THREADS)
fused_qboth_tn_kernel(const float* __restrict__ af,
                      const float* __restrict__ sa_ptr,
                      const float* __restrict__ za_ptr,
                      const float* __restrict__ bf,
                      const float* __restrict__ sb_ptr,
                      const float* __restrict__ zb_ptr,
                      const long long* __restrict__ rbits,
                      const float* __restrict__ a_vec,
                      float* __restrict__ out, int M, int N, int K,
                      float nbins_a, float off_a, float nbins_b,
                      float off_b) {
  __shared__ int As[BM * LDS];
  __shared__ int Bs[BN * LDS];
  __shared__ int csum_s[BN];

  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float sa = *sa_ptr, za = *za_ptr, sb = *sb_ptr, zb = *zb_ptr;
  if (t < BN) csum_s[t] = 0;
  __syncthreads();

  // A loader (threads 0..127): a 4 (K) x 4 (M) block of the 64 x 32 tile.
  const bool a_loads = t < (BK / 4) * (BM / 4);
  const int a_kq = t >> 3;
  const int a_mq = t & 7;
  // B loader (all threads): a 4 (K) x 4 (N) block of the 64 x 64 tile.
  const int b_kq = t >> 4;
  const int b_nq = t & 15;
  int csum[4] = {0, 0, 0, 0};
  // Compute mapping: rows ty, ty+16; columns tx, tx+16, tx+32, tx+48.
  const int ty = t >> 4;
  const int tx = t & 15;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (a_loads) {
      unsigned r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[4];
        bool ok[4];
        load_quad_f32(af, k0 + a_kq * 4 + j, K, m0 + a_mq * 4, M, v, ok);
        int c[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ta = __fmul_rn(sa, __fsub_rn(v[q], za));
          const float qa = fminf(fmaxf(rintf(ta), 0.0f), nbins_a);
          c[q] = ok[q] ? static_cast<int>(__fsub_rn(qa, off_a)) : 0;
        }
        r[j] = pack4(c[0], c[1], c[2], c[3]);
      }
      store_transposed(r, As + (a_mq * 4) * LDS + a_kq);
    }
    {
      unsigned r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + b_kq * 4 + j;
        float v[4];
        bool ok[4];
        unsigned rb[4];
        load_quad_f32(bf, k, K, n0 + b_nq * 4, N, v, ok);
        load_quad_bits(rbits, k, n0 + b_nq * 4, N, ok, rb);
        int c[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float tb = __fmul_rn(sb, __fsub_rn(v[q], zb));
          const float u01 = __fmul_rn(__uint2float_rn(rb[q]), U32_TO_UNIT);
          const float qb = fminf(fmaxf(floorf(__fadd_rn(tb, u01)), 0.0f),
                                 nbins_b);
          c[q] = ok[q] ? static_cast<int>(__fsub_rn(qb, off_b)) : 0;
          csum[q] += c[q];
        }
        r[j] = pack4(c[0], c[1], c[2], c[3]);
      }
      store_transposed(r, Bs + (b_nq * 4) * LDS + b_kq);
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

#pragma unroll
  for (int q = 0; q < 4; ++q) atomicAdd(&csum_s[b_nq * 4 + q], csum[q]);
  __syncthreads();

  const float alpha_a = __fdiv_rn(1.0f, sa);
  const float beta_a = __fadd_rn(__fmul_rn(off_a, alpha_a), za);
  const float alpha_b = __fdiv_rn(1.0f, sb);
  const float beta_b = __fadd_rn(__fmul_rn(off_b, alpha_b), zb);
  const float s_ab = __fmul_rn(alpha_a, alpha_b);
  const float k_beta_b = __fmul_rn(static_cast<float>(K), beta_b);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
    const float a_m = a_vec[m];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = tx + 16 * cc;
      const int n = n0 + col;
      if (n >= N) continue;
      const float u_n = __fadd_rn(
          __fmul_rn(alpha_b, static_cast<float>(csum_s[col])), k_beta_b);
      const float o = __fadd_rn(
          __fadd_rn(__fmul_rn(static_cast<float>(acc[r][cc]), s_ab),
                    __fmul_rn(beta_a, u_n)),
          a_m);
      out[static_cast<size_t>(m) * N + n] = o;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  af: (K, M) and bf: (K, N) f32, rbits:
// (K, N) int64, all row-major; the four scalars are device pointers.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_qboth_tn(const float* af, const float* scale_a,
                              const float* zero_a, const float* bf,
                              const float* scale_b, const float* zero_b,
                              const long long* rbits, const float* a_vec,
                              float* out, int M, int N, int K, int bits_a,
                              int bits_b, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_qboth_tn_kernel<<<grid, THREADS, 0, s>>>(
      af, scale_a, zero_a, bf, scale_b, zero_b, rbits, a_vec, out, M, N, K,
      static_cast<float>((1 << bits_a) - 1),
      static_cast<float>(1 << (bits_a - 1)),
      static_cast<float>((1 << bits_b) - 1),
      static_cast<float>(1 << (bits_b - 1)));
  return static_cast<int>(cudaGetLastError());
}
