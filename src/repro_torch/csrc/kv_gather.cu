// Block-table page gather with a fused affine dequantize, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kv_gather.py
// kv_gather_pages (body _kernel): the paged serving engine keeps its int8
// KV cache as fixed-size pages in one pool, and every paged forward reads
// each request's cache back through its block table,
//
//   out[b, j*P + p, :] = (codes[table[b, j], p, :] + 2^(bits-1))
//                        / max(scale[table[b, j], p], 1e-12)
//                        + zero[table[b, j], p]
//
// for K and V of every layer.  On the TPU the table rides scalar prefetch
// and drives the input DMA; here each thread looks its page id up itself.
//
// What bounds it on an H100: one division per element, with (B*nb*P) rows
// of D code bytes in and 4*D float bytes out, so device memory bounds it
// (8 lanes x 256 positions x 512 features: 1 MB of codes in, 4 MB out,
// about 1.6 us at 3.35 TB/s).  The design is the dense read's
// (csrc/kv_dequant.cu) with one indirection: each thread owns 16
// consecutive codes of one gathered row, reads table[b, j] (the 8 KB table
// stays in L1/L2), and where the 16 codes lie whole and 16-byte aligned
// (every chunk when D is a multiple of 16, as at granite's D = 512) it
// moves them with one 16-byte load and four 16-byte stores, so a warp
// reads whole 512-byte runs of one page row.  A ragged D, or an unaligned
// row, goes element by element.  No TPU tiling is carried over: no lane
// padding of D to 128 and no row block that must divide P.  The scale
// clamp keeps the garbage page (page 0, read by every idle lane and
// unallocated block) finite, and the division is the IEEE one (__fdiv_rn,
// no fast-math), so the result is bit-identical to the plain PyTorch
// version in kernels/kv_gather.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float dequant1(int c, float s, float z, float off) {
  return __fadd_rn(__fdiv_rn(__fadd_rn(static_cast<float>(c), off), s), z);
}

__global__ void __launch_bounds__(THREADS)
kv_gather_kernel(const int8_t* __restrict__ codes,
                 const float* __restrict__ scale,
                 const float* __restrict__ zero,
                 const int* __restrict__ table, float* __restrict__ out,
                 long long rows, int P, int D, float off) {
  const int chunks = (D + 15) / 16;
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= rows * chunks) return;
  const long long row = v / chunks;           // gathered row: (b*nb + j)*P + p
  const int col = static_cast<int>(v - row * chunks) * 16;
  const long long bj = row / P;               // b*nb + j: table is (B, nb)
  const int p = static_cast<int>(row - bj * P);
  const long long page = table[bj];
  const long long src_row = page * P + p;
  const float s = fmaxf(scale[src_row], EPS);
  const float z = zero[src_row];
  const int8_t* src = codes + src_row * D + col;
  float* dst = out + row * D + col;
  const bool whole = col + 16 <= D &&
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
    const int n = min(16, D - col);
    for (int c = 0; c < n; ++c) dst[c] = dequant1(src[c], s, z, off);
  }
}

}  // namespace

// C interface, loaded with ctypes.  codes: (n_pages, P, D) int8; scale,
// zero: (n_pages, P) f32; table: (B, nb) int32 page ids in [0, n_pages);
// out: (B, nb*P, D) f32.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int kv_gather_pages(const int8_t* codes, const float* scale,
                               const float* zero, const int* table,
                               float* out, int B, int nb, int P, int D,
                               int bits, void* stream) {
  const float off = static_cast<float>(1 << (bits - 1));
  const long long rows = static_cast<long long>(B) * nb * P;
  const long long n = rows * ((D + 15) / 16);
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  kv_gather_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      codes, scale, zero, table, out, rows, P, D, off);
  return static_cast<int>(cudaGetLastError());
}
