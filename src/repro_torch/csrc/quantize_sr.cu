// Stochastic-rounding quantize of a gradient to int8 codes, for Hopper:
// the unfused backward quantizers of the FQT step.
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize_sr.py
// quantize_sr_rows (body _kernel, PSQ: one affine pair per row) and
// quantize_sr_tensor (body _tensor_kernel, PTQ: one pair for the tensor,
// its min/max reduced outside the kernel as the JAX package does).  Per
// element, with B = 2^bits - 1:
//
//   scale  = B / max(hi - lo, 1e-12)        (per row, or given)
//   t      = scale * (x - lo)
//   c      = clip(floor(t + float(rbits) * 2^-32), 0, B) - 2^(bits-1)
//
// evaluated with explicitly rounded float operations (__fmul_rn & co.), so
// nvcc contracts nothing into an FMA, and the scale divided with __fdiv_rn:
// the codes, scales and zeros are bit-identical to the plain PyTorch
// versions in kernels/quantize_sr.py.  The SR bits arrive as prng.bits
// draws them, uint32 values held in int64; the kernels read each entry's
// low 32 bits as unsigned (modulo 2^32: values >= 2^31 never saturate) and
// convert with round-to-nearest (__uint2float_rn), as the plain cast does,
// the same rule as csrc/fused_qlhs.cu.
//
// What bounds them on an H100: device memory.  Each element reads 4 bytes
// of x and 8 of SR bits and writes 1 code byte; the statquant-tx lm_head
// gradient (512, 10240) moves about 68 MB, about 20 us at 3.35 TB/s.  The
// designs:
//   * rows: one block of 256 threads per row.  A first sweep takes the
//     row's min and max over its N real columns (warp shuffles, then one
//     value per warp in shared memory; no edge padding as on the TPU), a
//     second sweep quantizes.  The second sweep reads x again, from L2 at
//     these sizes (a 40 KB row, 20 MB for the whole gradient).
//   * tensor: a grid-stride elementwise pass over the flat tensor, lo and
//     scale read from device memory (no host round trip).
// Both move four elements at a time: one 16-byte load of x, two of bits and
// one 4-byte store of codes where the quad lies whole and aligned, element
// by element on a ragged or unaligned edge.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float EPS = 1e-12f;
constexpr float U32_TO_UNIT = 2.3283064365386963e-10f;   // 2^-32, exact

__device__ __forceinline__ int sr_code(float x, float s, float z,
                                       unsigned rb, float nbins, float off) {
  const float t = __fmul_rn(s, __fsub_rn(x, z));
  float q = floorf(__fadd_rn(t, __fmul_rn(__uint2float_rn(rb), U32_TO_UNIT)));
  q = fminf(fmaxf(q, 0.0f), nbins);
  return static_cast<int>(__fsub_rn(q, off));
}

// Quantize elements [i, min(i + 4, n)) of x with the pair (s, z).
__device__ __forceinline__ void quantize_quad(
    const float* __restrict__ x, const long long* __restrict__ rbits,
    int8_t* __restrict__ codes, long long i, long long n, float s, float z,
    float nbins, float off) {
  const float* xs = x + i;
  const long long* bs = rbits + i;
  int8_t* cs = codes + i;
  if (i + 4 <= n && (reinterpret_cast<uintptr_t>(xs) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(bs) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(cs) & 3) == 0) {
    const float4 v = *reinterpret_cast<const float4*>(xs);
    const longlong2 b0 = reinterpret_cast<const longlong2*>(bs)[0];
    const longlong2 b1 = reinterpret_cast<const longlong2*>(bs)[1];
    const int c0 = sr_code(v.x, s, z, static_cast<unsigned>(b0.x), nbins, off);
    const int c1 = sr_code(v.y, s, z, static_cast<unsigned>(b0.y), nbins, off);
    const int c2 = sr_code(v.z, s, z, static_cast<unsigned>(b1.x), nbins, off);
    const int c3 = sr_code(v.w, s, z, static_cast<unsigned>(b1.y), nbins, off);
    *reinterpret_cast<unsigned*>(cs) = static_cast<unsigned>(
        (c0 & 0xff) | ((c1 & 0xff) << 8) | ((c2 & 0xff) << 16) |
        ((c3 & 0xff) << 24));
  } else {
    const int m = static_cast<int>(n - i < 4 ? n - i : 4);
    for (int q = 0; q < m; ++q)
      cs[q] = static_cast<int8_t>(
          sr_code(xs[q], s, z, static_cast<unsigned>(bs[q]), nbins, off));
  }
}

__global__ void __launch_bounds__(THREADS)
quantize_sr_rows_kernel(const float* __restrict__ x,
                        const long long* __restrict__ rbits,
                        int8_t* __restrict__ codes, float* __restrict__ scale,
                        float* __restrict__ zero, int N, float nbins,
                        float off) {
  const long long base = static_cast<long long>(blockIdx.x) * N;
  const float* xr = x + base;
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x * 4; i < N; i += THREADS * 4) {
    if (vec && i + 4 <= N) {
      const float4 v = *reinterpret_cast<const float4*>(xr + i);
      lo = fminf(lo, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
      hi = fmaxf(hi, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    } else {
      for (int q = i; q < N && q < i + 4; ++q) {
        lo = fminf(lo, xr[q]);
        hi = fmaxf(hi, xr[q]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __shared__ float s_lo[THREADS / 32], s_hi[THREADS / 32];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
  const float s = __fdiv_rn(nbins, fmaxf(__fsub_rn(hi, lo), EPS));
  if (threadIdx.x == 0) {
    scale[blockIdx.x] = s;
    zero[blockIdx.x] = lo;
  }
  for (int i = threadIdx.x * 4; i < N; i += THREADS * 4)
    quantize_quad(xr, rbits + base, codes + base, i, N, s, lo, nbins, off);
}

__global__ void __launch_bounds__(THREADS)
quantize_sr_tensor_kernel(const float* __restrict__ x,
                          const long long* __restrict__ rbits,
                          const float* __restrict__ lo_p,
                          const float* __restrict__ scale_p,
                          int8_t* __restrict__ codes, long long n,
                          float nbins, float off) {
  const float lo = *lo_p;
  const float s = *scale_p;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS * 4;
  for (long long i = (static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x) * 4;
       i < n; i += stride)
    quantize_quad(x, rbits, codes, i, n, s, lo, nbins, off);
}

}  // namespace

// C interfaces, loaded with ctypes.  Each returns cudaGetLastError() after
// its launch (0 = launched).
//
// x: (M, N) f32; rbits: (M, N) int64 SR bits; codes: (M, N) int8; scale,
// zero: (M,) f32 outputs.
extern "C" int quantize_sr_rows(const float* x, const long long* rbits,
                                int8_t* codes, float* scale, float* zero,
                                int M, int N, int bits, void* stream) {
  if (M == 0 || N == 0) return 0;
  const float nbins = static_cast<float>((1 << bits) - 1);
  const float off = static_cast<float>(1 << (bits - 1));
  quantize_sr_rows_kernel<<<M, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, rbits, codes, scale, zero, N, nbins, off);
  return static_cast<int>(cudaGetLastError());
}

// x: n f32; rbits: n int64; lo, scale: one f32 each on the device (the
// tensor's min and B / max(max - min, 1e-12)); codes: n int8.
extern "C" int quantize_sr_tensor(const float* x, const long long* rbits,
                                  const float* lo, const float* scale,
                                  int8_t* codes, long long n, int bits,
                                  void* stream) {
  if (n == 0) return 0;
  const float nbins = static_cast<float>((1 << bits) - 1);
  const float off = static_cast<float>(1 << (bits - 1));
  const long long quads = (n + 3) / 4;
  long long blocks = (quads + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond 16 waves
  quantize_sr_tensor_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, rbits, lo, scale, codes, n, nbins, off);
  return static_cast<int>(cudaGetLastError());
}
