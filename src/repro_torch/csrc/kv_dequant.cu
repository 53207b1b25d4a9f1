// Per-row affine dequantization of int8 KV-cache rows, one side or K and V
// in one launch, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kv_dequant.py
// kv_dequant_rows (body _kernel): out_ij = (c8_ij + 2^(b-1)) / scale_i
// + zero_i, the int8 KV read of every dense decode step.  The pair entry
// reads a layer's K and V in one launch (blockIdx.y picks the side) and
// clamps each scale to 1e-12 inside the kernel, as the cache codec does
// before the single-side call.
//
// What bounds it on an H100: one division per element, M*N code bytes in
// and 4*M*N float bytes out a side, so device memory (granite's dense
// decode at 8 slots x 256 positions x 512 features: 2 MB in and 8 MB out
// for both sides, about 3 us at 3.35 TB/s; at a 4,096-token context, 168
// MB, about 50 us).  At the serving path's shapes a call costs a few us
// whatever its bytes (the launch), so the design first halves the
// launches: one kernel for both sides.  Then, for the bytes (the bulk body):
//
//   * a block owns a tile of whole rows, 4 KB of codes in one contiguous
//     span, and one thread moves it with a 1-D cp.async.bulk into shared
//     memory, completing on an mbarrier, while the threads load each row's
//     scale and zero once into shared memory;
//   * the threads take consecutive 4-code words, so a warp writes 512
//     consecutive bytes at a time (16 codes a thread, stored as 64 bytes in
//     four strided passes, measured 2.5x slower at a 4,096-token context).
//
// A body that loads the words straight from device memory, each thread's
// four before its first division, measured the same at 256 positions and
// 2% slower at 4,096, and went.  The bulk body needs N a multiple of 16, at
// most 16 KB, and 16-byte aligned codes and outputs; rows off that grid
// take the element path (one thread per 4 codes, a word where they are
// aligned).  The division is the IEEE one (__fdiv_rn, no fast-math), so
// both are bit-identical to the plain PyTorch version in
// kernels/kv_dequant.py.

#include "kv_read.cuh"

namespace {

using namespace kv_read;

constexpr int THREADS = 256;
constexpr int TILE_WORDS = THREADS * 4;        // 4 KB of codes a tile
constexpr int MAX_TILE_BYTES = 16 * 1024;      // a tile of one wide row
constexpr int MAX_ROWS = TILE_WORDS / 4;       // a tile of 16-code rows

enum Body { AUTO = 0, BULK = 1, ELEMENT = 2 };

struct Side {
  const int8_t* codes;
  const float* scale;
  const float* zero;
  float* out;
};
struct Sides {
  Side s[2];
};

// side y of the launch (a select, so the parameter struct is not indexed)
__device__ __forceinline__ Side side_of(const Sides& sides) {
  return blockIdx.y ? sides.s[1] : sides.s[0];
}

template <bool CLAMP>
__device__ __forceinline__ float row_scale(const float* scale, long long r) {
  const float s = scale[r];
  return CLAMP ? fmaxf(s, EPS) : s;
}

// element path: one thread per 4 codes of a row
template <bool CLAMP>
__global__ void __launch_bounds__(THREADS)
kv_dequant_element(Sides sides, long long M, int N, float off) {
  const Side sd = side_of(sides);
  const int words = (N + 3) / 4;
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= M * words) return;
  const long long row = v / words;
  const int col = static_cast<int>(v - row * words) * 4;
  const long long base = row * N + col;
  dequant_upto4(sd.codes + base, min(4, N - col), row_scale<CLAMP>(sd.scale, row),
                sd.zero[row], off, sd.out + base);
}

// a tile's rows' scales and zeros into shared memory, once a row
template <bool CLAMP>
__device__ __forceinline__ void load_rows(const Side& sd, long long r0,
                                          int rows, float* s_s, float* s_z) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    s_s[r] = row_scale<CLAMP>(sd.scale, r0 + r);
    s_z[r] = sd.zero[r0 + r];
  }
}

// bulk body: one tile of R whole rows a block
template <bool CLAMP>
__global__ void __launch_bounds__(THREADS)
kv_dequant_bulk(Sides sides, long long M, int N, int R, float off) {
  extern __shared__ __align__(128) unsigned char stage[];   // R*N codes
  __shared__ __align__(8) uint64_t bar;
  __shared__ float s_s[MAX_ROWS], s_z[MAX_ROWS];
  const Side sd = side_of(sides);
  const int wpr = N >> 2;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R), M - r0));
  const int n = rows * wpr;
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    const uint32_t bytes = static_cast<uint32_t>(rows) * N;
    mbar_expect(&bar, bytes);
    bulk_load(stage, sd.codes + r0 * N, bytes, &bar);
  }
  load_rows<CLAMP>(sd, r0, rows, s_s, s_z);
  __syncthreads();                   // the barrier's init and the rows
  mbar_wait(&bar, 0);
  const int* src = reinterpret_cast<const int*>(stage);
  float* dst = sd.out + r0 * N;
  for (int w = threadIdx.x; w < n; w += THREADS) {
    const int r = w / wpr;
    dequant4(src[w], s_s[r], s_z[r], off, dst + static_cast<long long>(w) * 4);
  }
}

template <bool CLAMP>
int launch(Body body, const Sides& sides, long long M, int N, int n_sides,
           float off, cudaStream_t stream) {
  if (body == ELEMENT) {
    const long long blocks = (M * ((N + 3) / 4) + THREADS - 1) / THREADS;
    kv_dequant_element<CLAMP><<<dim3(static_cast<unsigned>(blocks), n_sides),
                                THREADS, 0, stream>>>(sides, M, N, off);
    return static_cast<int>(cudaGetLastError());
  }
  const int wpr = N >> 2;
  const int R = wpr >= TILE_WORDS ? 1 : TILE_WORDS / wpr;
  const dim3 grid(static_cast<unsigned>((M + R - 1) / R), n_sides);
  kv_dequant_bulk<CLAMP><<<grid, THREADS, R * N, stream>>>(sides, M, N, R,
                                                           off);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16_host(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface, loaded with ctypes.  codes (M, N) int8, scale and zero (M,)
// f32 for K and, when sides is 2, for V; out (sides, M, N) f32.  clamp: 1
// clamps each scale to 1e-12 (the pair's contract), 0 leaves it (the
// single side's, as the reference kernel).  body: 0 the bulk body where
// the operands allow it and the element path elsewhere, 1 the bulk body
// (cudaErrorInvalidValue unlaunched where they do not), 2 the element path.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int kv_dequant(const int8_t* k_codes, const float* k_scale,
                          const float* k_zero, const int8_t* v_codes,
                          const float* v_scale, const float* v_zero,
                          float* out, long long M, int N, int bits,
                          int sides, int clamp, int body, void* stream) {
  if (M * N == 0) return 0;
  if (sides < 1 || sides > 2) return static_cast<int>(cudaErrorInvalidValue);
  const float off = static_cast<float>(1 << (bits - 1));
  Sides s{{{k_codes, k_scale, k_zero, out},
           {v_codes, v_scale, v_zero, out + M * N}}};
  bool ok = N % 16 == 0 && N <= MAX_TILE_BYTES;
  for (int i = 0; i < sides; ++i)
    ok = ok && aligned16_host(s.s[i].codes) && aligned16_host(s.s[i].out);
  Body b = static_cast<Body>(body);
  if (b == AUTO) b = ok ? BULK : ELEMENT;
  if (b == BULK && !ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return clamp ? launch<true>(b, s, M, N, sides, off, st)
               : launch<false>(b, s, M, N, sides, off, st);
}
