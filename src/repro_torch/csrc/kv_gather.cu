// Block-table page gather with a fused affine dequantize, one side or K and
// V in one launch, for Hopper.
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
// and drives the input DMA; here the table drives bulk copies.
//
// What bounds it on an H100: one division per element, with (B*nb*P) rows
// of D code bytes in and 4*D float bytes out a side, so device memory
// (granite's paged decode at 8 lanes x 256 positions x 512 features: 2 MB
// of codes in and 8 MB out for both sides, about 3 us at 3.35 TB/s; at a
// 4,096-token context, 168 MB, about 50 us).  At the serving path's shapes
// a call costs a few us whatever its bytes (the launch), so the pair entry
// reads K and V in one launch.  The bulk body:
//
//   * one block per (lane, page), for both sides;
//   * one thread reads table[b, j] once and, since K and V share the page
//     id, issues cp.async.bulk copies of both sides' P x D codes (8 KB a
//     side at P = 16, D = 512, contiguous in the pool) and their P scales
//     and P zeros into shared memory, completing on one mbarrier;
//   * the threads take consecutive 4-code words, so a warp writes 512
//     consecutive bytes at a time, and the page's rows leave as one span.
//
// The blocks resident on an SM overlap one page's copy with another's
// divisions: runs of 2 and 4 pages a block through a two-stage ring
// measured 9% and 28% slower at a 4,096-token context (fewer warps to hide
// the divisions), and went.  Below one wave of pages (the smoke run's 128)
// a block's chain of table read, copy and divisions leaves the SMs idle, so
// the default there is the element path, which gives every 4 codes of a
// gathered row their own thread (looking the page up itself).  Bulk copies
// need 16-byte sizes and addresses: D a multiple of 16, P a multiple of 4
// (the scale and zero spans) and 16-byte aligned pools and outputs, and a
// page of both sides must fit 48 KB of shared memory; anything else takes
// the element path too.  No TPU tiling is carried over: no lane padding of
// D to 128 and no row block that must divide P.  The scale clamp keeps the
// garbage page (page 0, read by every idle lane and unallocated block)
// finite, and the division is the IEEE one (__fdiv_rn, no fast-math), so
// the result is bit-identical to the plain PyTorch version in
// kernels/kv_gather.py.

#include <algorithm>

#include "kv_read.cuh"

namespace {

using namespace kv_read;

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 48 * 1024;            // dynamic, without opting in

enum Body { AUTO = 0, BULK = 1, ELEMENT = 2 };

struct Pool {
  const int8_t* codes;
  const float* scale;
  const float* zero;
  float* out;
};
struct Pools {
  Pool s[2];
};

// side s (a select, so the parameter struct is not indexed)
__device__ __forceinline__ Pool side_of(const Pools& pools, int s) {
  return s ? pools.s[1] : pools.s[0];
}

// element path: one thread per 4 codes of a gathered row
__global__ void __launch_bounds__(THREADS)
kv_gather_element(Pools pools, const int* __restrict__ table, long long rows,
                  int P, int D, float off) {
  const Pool pl = side_of(pools, blockIdx.y);
  const int words = (D + 3) / 4;
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= rows * words) return;
  const long long row = v / words;            // gathered row: (b*nb + j)*P + p
  const int col = static_cast<int>(v - row * words) * 4;
  const long long bj = row / P;               // b*nb + j: table is (B, nb)
  const int p = static_cast<int>(row - bj * P);
  const long long src_row = static_cast<long long>(table[bj]) * P + p;
  dequant_upto4(pl.codes + src_row * D + col, min(4, D - col),
                fmaxf(pl.scale[src_row], EPS), pl.zero[src_row], off,
                pl.out + row * D + col);
}

// bulk body: one page of a lane a block, [codes P*D | scale P | zero P] of
// each side in shared memory
__global__ void __launch_bounds__(THREADS)
kv_gather_bulk(Pools pools, const int* __restrict__ table, int P, int D,
               int sides, float off) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t bar;
  const int page_codes = P * D;
  const int side_bytes = page_codes + 8 * P;
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    const long long page = table[blockIdx.x];  // blockIdx.x = b*nb + j
    mbar_expect(&bar, static_cast<uint32_t>(sides * side_bytes));
    for (int s = 0; s < sides; ++s) {
      const Pool pl = side_of(pools, s);
      unsigned char* dst = stage + s * side_bytes;
      bulk_load(dst, pl.codes + page * page_codes, page_codes, &bar);
      bulk_load(dst + page_codes, pl.scale + page * P, 4 * P, &bar);
      bulk_load(dst + page_codes + 4 * P, pl.zero + page * P, 4 * P, &bar);
    }
  }
  __syncthreads();                   // the barrier's init
  mbar_wait(&bar, 0);
  const int wpr = D >> 2;
  const int side_words = P * wpr;
  const long long out0 = static_cast<long long>(blockIdx.x) * page_codes;
  for (int w = threadIdx.x; w < sides * side_words; w += THREADS) {
    const int s = w >= side_words;
    const int ws = w - s * side_words;
    const int p = ws / wpr;
    const unsigned char* src = stage + s * side_bytes;
    const float* sz = reinterpret_cast<const float*>(src + page_codes);
    dequant4(reinterpret_cast<const int*>(src)[ws], fmaxf(sz[p], EPS),
             sz[P + p], off, side_of(pools, s).out + out0 + ws * 4);
  }
}

// resident blocks of the bulk body at `smem` bytes a block (the last
// call's, cached: a serving run gathers one shape)
int resident_bulk(int smem) {
  static int last_smem = -1, last = 1;
  if (smem != last_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kv_gather_bulk,
                                                  THREADS, smem);
    last = sms * std::max(per_sm, 1);
    last_smem = smem;
  }
  return last;
}

bool aligned16_host(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface, loaded with ctypes.  For K and, when sides is 2, for V:
// codes (n_pages, P, D) int8, scale and zero (n_pages, P) f32; table (B, nb)
// int32 page ids in [0, n_pages); out (sides, B, nb*P, D) f32.  body: 0 the
// default (the bulk body where the operands allow it and the pages fill a
// wave of its blocks, the element path elsewhere), 1 the bulk body
// (cudaErrorInvalidValue unlaunched where the operands do not allow it),
// 2 the element path.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int kv_gather(const int8_t* k_codes, const float* k_scale,
                         const float* k_zero, const int8_t* v_codes,
                         const float* v_scale, const float* v_zero,
                         const int* table, float* out, int B, int nb, int P,
                         int D, int bits, int sides, int body,
                         void* stream) {
  const long long rows = static_cast<long long>(B) * nb * P;
  if (rows * D == 0) return 0;
  if (sides < 1 || sides > 2) return static_cast<int>(cudaErrorInvalidValue);
  const float off = static_cast<float>(1 << (bits - 1));
  Pools pl{{{k_codes, k_scale, k_zero, out},
            {v_codes, v_scale, v_zero, out + rows * D}}};
  const int smem = sides * (P * D + 8 * P);
  bool ok = D % 16 == 0 && P % 4 == 0 && smem <= MAX_SMEM;
  for (int i = 0; i < sides; ++i)
    ok = ok && aligned16_host(pl.s[i].codes) && aligned16_host(pl.s[i].scale) &&
         aligned16_host(pl.s[i].zero) && aligned16_host(pl.s[i].out);
  const long long pages = static_cast<long long>(B) * nb;
  const int wave = ok ? resident_bulk(smem) : 1;
  Body b = static_cast<Body>(body);
  if (b == AUTO) b = ok && pages >= wave ? BULK : ELEMENT;
  if (b == BULK && !ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == ELEMENT) {
    const long long blocks = (rows * ((D + 3) / 4) + THREADS - 1) / THREADS;
    kv_gather_element<<<dim3(static_cast<unsigned>(blocks), sides), THREADS, 0,
                        st>>>(pl, table, rows, P, D, off);
    return static_cast<int>(cudaGetLastError());
  }
  kv_gather_bulk<<<static_cast<unsigned>(pages), THREADS, smem, st>>>(
      pl, table, P, D, sides, off);
  return static_cast<int>(cudaGetLastError());
}
