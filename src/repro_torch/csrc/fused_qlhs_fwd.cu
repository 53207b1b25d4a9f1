// The FQT forward with the quantize fused in, for Hopper's int8 tensor
// cores: out = Q_f(X) @ Q_theta(W).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_fqt.py
// fused_qlhs_matmul (body _qlhs_kernel) in its forward mode (trans_b =
// False), deterministic or SR: every forward GEMM of the serving engines
// (kernel backend, weights quantized per call) and of a fused FQT training
// step (core/backend.py fused_fqt_fwd).  X is (M, K) f32, K contiguous;
// W's codes are (K, N) int8, N contiguous.  The kernel is
// fused_qlhs_gemm.cuh's (the dX entry fused_qlhs_dx.cu is the same
// template with B K-major), with B N-major: each stage of weight codes
// lands as stored and is transposed in shared memory 4 x 4 bytes a thread
// (int8_mma.cuh transpose_b), as q8_matmul.cu's N-major B is.  The packed
// forward (fused_qlhs_packed_matmul) is the same template with B packed
// (fused_qlhs_packed.cu); at 8 bits it equals this kernel bit for bit (the
// sums are exact either way).
//
// What bounds it on an H100: at decode (M = 1..16 slots) the K x N weight
// bytes, read once: 16.8 MB at the MLP up-projection (2048, 8192), 5.0 us
// at 3.35 TB/s, and 101 MB at lm_head (2048, 49408).  The old __dp4a tile
// took 63.6 us at (8, 2048, 8192): 128 blocks of 32 x 64, each sweeping 32
// K steps with no load in flight.  At prefill and in training (M = 128 to
// 2048) the f32 LHS (4 bytes a code, read again by every N tile) and the
// int8 products come close.  The design picks the tile from M (the
// wrapper's kernels/splitk.py plan names it):
//   * decode (M <= 16): 16 x 256 outputs, 8 warps of m16 x n32, BK = 64
//     codes a stage, a 4-stage ring (48 KB of weight codes in flight a
//     block, two blocks an SM, one with SR bits in the ring; each weight
//     row is read 256 bytes at a time), K split in clusters: (8, 2048,
//     8192) runs 32 tiles x 7 slices, lm_head 193 x 1 (the old grid: 128
//     blocks at (8, 2048, 8192), one K step at a time).  An m16 tile
//     wastes half its rows at M = 8; the same tile with a __dp4a product,
//     which wastes none, was slower at every split of (8, 2048, 8192) on
//     the card (PERF.md);
//   * wide (M > 16): 64 x 256 outputs, 16 warps of 32 x 32, BK = 64, a
//     3-stage ring, one block an SM, split-K where the tiles do not fill
//     the card.
// Tiles, stages and warps were picked from split sweeps of candidates on
// the card (PERF.md): more warps a block mattered more than deeper rings.
// Ragged M, N and K edges and unaligned rows are masked in the loaders and
// the quantize, so the wrapper never pads or slices.

#include <cstdint>
#include <cuda_runtime.h>

#include "fused_qlhs_gemm.cuh"

namespace {

using namespace fused_qlhs_gemm;

struct DecodeTile : Tile<16, 256, 64, 1, 8, 4, BNMajor, 2> {};   // tile 0
struct WideTile : Tile<64, 256, 64, 2, 8, 3, BNMajor, 1> {};     // tile 1

}  // namespace

// A mode names a tile and a rounding, as kernels/splitk.py does: 2 * tile
// + 1 with SR bits (the ring holds them, so the decode tile fits one block
// an SM instead of two), 2 * tile deterministic.

// The tile of `mode` as built, for the wrapper's split plan
// (kernels/splitk.py): {BM, BN, BK, THREADS, NACC, STAGES, smem bytes with
// SR bits, smem bytes deterministic}; all -1 for an unknown mode.
extern "C" void fused_qlhs_fwd_tile(int mode, int* cfg) {
  switch (mode >> 1) {
    case 0: return tile_config<DecodeTile>(cfg);
    case 1: return tile_config<WideTile>(cfg);
  }
  for (int i = 0; i < 8; ++i) cfg[i] = -1;
}

// Blocks of the tile of `mode` the card runs at once in clusters of
// `cluster` (1..8), with that mode's rounding (minus the CUDA error on
// failure): what kernels/splitk.py plans with.
extern "C" int fused_qlhs_fwd_capacity(int mode, int cluster) {
  const bool sr = mode & 1;
  switch (mode >> 1) {
    case 0:
      return sr ? capacity<DecodeTile, true>(cluster)
                : capacity<DecodeTile, false>(cluster);
    case 1:
      return sr ? capacity<WideTile, true>(cluster)
                : capacity<WideTile, false>(cluster);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// C interface, loaded with ctypes.  rbits: (M, K) int64 SR bits, or
// nullptr for deterministic rounding; y8: the (K, N) row-major weight
// codes.  `mode` as above, its SR bit set exactly when rbits is given; the
// wrapper's split plan gives `splits` K slices (1..8, one cluster a tile)
// of k_span codes (a multiple of the tile's BK; the last may be shorter).
// One launch; returns its CUDA error (0 = launched).
extern "C" int fused_qlhs_fwd(const float* xf, const float* scale_a,
                              const float* zero_a, const long long* rbits,
                              const int8_t* y8, const float* alpha_b,
                              const float* beta_b, const float* u,
                              float* out, int M, int N, int K, int bits,
                              int mode, int splits, int k_span,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((mode & 1) != (rbits != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define FWD_LAUNCH(T)                                                       \
  if (!valid_split<T>(K, splits, k_span)) break;                            \
  return rbits ? launch<T, true>(xf, scale_a, zero_a, rbits, y8, alpha_b,   \
                                 beta_b, u, out, M, N, K, bits, splits,     \
                                 k_span, s)                                 \
               : launch<T, false>(xf, scale_a, zero_a, rbits, y8, alpha_b,  \
                                  beta_b, u, out, M, N, K, bits, splits,    \
                                  k_span, s);
  switch (mode >> 1) {
    case 0: FWD_LAUNCH(DecodeTile)
    case 1: FWD_LAUNCH(WideTile)
  }
#undef FWD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
