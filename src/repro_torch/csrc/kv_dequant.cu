// Per-row affine dequantization of int8 KV-cache rows, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kv_dequant.py
// kv_dequant_rows (body _kernel): out_ij = (c8_ij + 2^(b-1)) / scale_i
// + zero_i, the int8 KV read of every dense decode step.
//
// What bounds it on an H100: it does one division per element and must
// move M*N code bytes in and 4*M*N float bytes out, so device memory bounds
// it (8 slots x 256 positions x 512 features: 1 MB in, 4 MB out, about
// 1.6 us at 3.35 TB/s).  The design is one pass with no shared memory:
// each thread owns 16 consecutive codes of one row.  Where they lie whole
// and 16-byte aligned (every chunk when N is a multiple of 16, as on the
// serving path) it reads them with one 16-byte load and writes four 16-byte
// stores, so a warp touches whole 512-byte code segments; the row's ragged
// tail, and chunks of rows that start unaligned, go element by element.
// The division is the IEEE one (__fdiv_rn, no fast-math), so the result is
// bit-identical to the plain PyTorch version in kernels/kv_dequant.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float dequant1(int c, float s, float z, float off) {
  return __fadd_rn(__fdiv_rn(__fadd_rn(static_cast<float>(c), off), s), z);
}

__global__ void __launch_bounds__(THREADS)
kv_dequant_kernel(const int8_t* __restrict__ codes,
                  const float* __restrict__ scale,
                  const float* __restrict__ zero, float* __restrict__ out,
                  long long M, int N, float off) {
  const int chunks = (N + 15) / 16;
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= M * chunks) return;
  const long long row = v / chunks;
  const int col = static_cast<int>(v - row * chunks) * 16;
  const long long base = row * N + col;
  const float s = scale[row];
  const float z = zero[row];
  const int8_t* src = codes + base;
  float* dst = out + base;
  const bool whole = col + 16 <= N &&
                     (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  if (whole) {
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int x = words[w];
      float4 o;
      o.x = dequant1(static_cast<int8_t>(x & 0xff), s, z, off);
      o.y = dequant1(static_cast<int8_t>((x >> 8) & 0xff), s, z, off);
      o.z = dequant1(static_cast<int8_t>((x >> 16) & 0xff), s, z, off);
      o.w = dequant1(static_cast<int8_t>((x >> 24) & 0xff), s, z, off);
      reinterpret_cast<float4*>(dst)[w] = o;
    }
  } else {
    const int n = min(16, N - col);
    for (int j = 0; j < n; ++j) dst[j] = dequant1(src[j], s, z, off);
  }
}

}  // namespace

// C interface, loaded with ctypes.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int kv_dequant_rows(const int8_t* codes, const float* scale,
                               const float* zero, float* out, long long M,
                               int N, int bits, void* stream) {
  const float off = static_cast<float>(1 << (bits - 1));
  const long long n = M * ((N + 15) / 16);
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  kv_dequant_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      codes, scale, zero, out, M, N, off);
  return static_cast<int>(cudaGetLastError());
}
