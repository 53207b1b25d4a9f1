// Fused quantize -> int8 GEMM -> affine epilogue against bit-packed
// weights, for Hopper's int8 tensor cores: the packed forward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_fqt.py
// fused_qlhs_packed_matmul (body _qlhs_packed_kernel): out = Q_f(xf) @
// W-hat, with the per-row deterministic quantize of the f32 LHS done in the
// K sweep, against weights bit-packed once at load (kernels/pack.py: 1, 2,
// 4 or 8 bits, ppb = 8 / wbits codes a byte along K): every forward GEMM of
// a weight_bits serving engine, and the training forward under the
// int4w/binary/ternary weight quantizers.
//
// What it computes, per output (i, j):
//   t_ik   = scale_i * (x_ik - zero_i)
//   c_ik   = clip(rint(t_ik), 0, 2^b-1) - 2^(b-1)
//   acc_ij = sum_k c_ik * w_kj,  w the unpacked codes minus 2^(wbits-1)
//   rsum_i = sum_k c_ik                                        (int32, exact)
//   out_ij = acc_ij*(alpha_a*alpha_b) + beta_a*u_j + (alpha_a*beta_b)*rsum_i
//   alpha_a = 1/scale_i,  beta_a = 2^(b-1)*alpha_a + zero_i
// The kernel is fused_qlhs_gemm.cuh's with B packed (BPacked<wbits>): its
// quantize and epilogue are the int8 forward's (fused_qlhs_fwd.cu), every
// float operation rounded explicitly, so the result is bit-identical to the
// plain PyTorch version in kernels/fused_fqt.py and, at 8 bits, to
// fused_qlhs_fwd on the same codes (the sums are exact either way).
//
// What bounds it on an H100: at decode (M = 1..16 slots) the K x N / ppb
// packed weight bytes, read once: 8.4 MB at 4 bits for the 2048 x 8192
// MLP up-projection, 2.5 us at 3.35 TB/s.  The first port's __dp4a tile
// took 60.6 us there: 128 blocks of 32 x 64 outputs, each sweeping 32 K
// steps with no load in flight, reading one byte a thread a load.  This
// design takes the int8 forward's tiles and ring (the wrapper's
// kernels/splitk.py plan names the tile and the split):
//   * each stage brings BK / ppb rows of BN packed bytes by cp.async in
//     16-byte chunks along N (int8_mma.cuh load_b_raw), and unpack_b turns
//     it into the swizzled K-major code tile the tensor cores read: a byte
//     already holds ppb consecutive K codes of one column, so a thread turns
//     the bytes of 4 columns into 4 K-major words with shifts, masks and
//     byte_perms, and shifts the codes by a per-byte subtract; codes at
//     k >= K become 0, as the Pallas kernel's row < kdim mask makes them;
//   * decode (M <= 16): 16 x 256 outputs, 8 warps, a 4-stage ring of 64
//     codes; wide (M > 16): 64 x 256 outputs, 16 warps, a 3-stage ring
//     (fused_qlhs_gemm.cuh PackedDecodeTile, PackedWideTile);
//   * split-K in clusters, the slices' int32 sums and row code sums
//     reduced exactly in distributed shared memory.  k_span is a multiple
//     of BK, itself a multiple of 8 codes, so no packed byte straddles two
//     slices.
// Ragged M, N and K edges and unaligned rows are masked in the loaders, the
// unpack and the quantize, so the wrapper never pads or slices.

#include <cstdint>
#include <cuda_runtime.h>

#include "fused_qlhs_gemm.cuh"

using namespace fused_qlhs_gemm;

// The tile of `mode` as built, for the wrapper's split plan
// (kernels/splitk.py): {BM, BN, BK, THREADS, NACC, STAGES, smem bytes,
// smem bytes}; all -1 for an unknown mode.
extern "C" void fused_qlhs_packed_tile(int mode, int* cfg) {
#define TILE_CONFIG(T) return tile_config<T>(cfg);
  PACKED_TILE_CASES(TILE_CONFIG)
#undef TILE_CONFIG
  for (int i = 0; i < 8; ++i) cfg[i] = -1;
}

// Blocks of the tile of `mode` the card runs at once in clusters of
// `cluster` (1..8) (minus the CUDA error on failure): what
// kernels/splitk.py plans with.
extern "C" int fused_qlhs_packed_capacity(int mode, int cluster) {
#define TILE_CAPACITY(T) return capacity<T, false>(cluster);
  PACKED_TILE_CASES(TILE_CAPACITY)
#undef TILE_CAPACITY
  return -static_cast<int>(cudaErrorInvalidValue);
}

// C interface, loaded with ctypes: the packed-weight forward (deterministic
// LHS quantize); packed is the (ceil(K/ppb), N) uint8 codes at the width
// of `mode` (above).  The wrapper's split plan gives `splits` K slices
// (1..8, one cluster a tile) of k_span codes (a multiple of the tile's BK;
// the last may be shorter).  One launch; returns its CUDA error (0 =
// launched), cudaErrorInvalidValue for an unknown mode or a bad split.
extern "C" int fused_qlhs_packed(const float* xf, const float* scale_a,
                                 const float* zero_a, const uint8_t* packed,
                                 const float* alpha_b, const float* beta_b,
                                 const float* u, float* out, int M, int N,
                                 int K, int bits, int mode, int splits,
                                 int k_span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TILE_LAUNCH(T)                                                    \
  if (!valid_split<T>(K, splits, k_span)) break;                          \
  return launch<T, false>(xf, scale_a, zero_a, nullptr, packed, alpha_b,  \
                          beta_b, u, out, M, N, K, bits, splits, k_span, s);
  PACKED_TILE_CASES(TILE_LAUNCH)
#undef TILE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
