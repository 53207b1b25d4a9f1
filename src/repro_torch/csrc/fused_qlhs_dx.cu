// The FQT activation grad with the quantize fused in, for Hopper's int8
// tensor cores: dX = Q_b2(dY) @ Q_theta(W).T.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_fqt.py
// fused_qlhs_matmul (body _qlhs_kernel) in its trans_b mode, deterministic
// or stochastic: the PTQ/PSQ activation-grad GEMM of core/backend.py
// fused_fqt_dx.  The kernel is fused_qlhs_gemm.cuh's, with B K-major; the
// int8 forward of the same Pallas kernel is fused_qlhs_fwd.cu (the same
// template, B N-major), and the packed forward (fused_qlhs_packed_matmul)
// fused_qlhs_packed.cu (B bit-packed).
//
// What it computes, per output (i, j), with B the (N, K) = (d_in, d_out)
// weight codes read as their transpose (K is the contiguous axis):
//   t_ik   = scale_i * (g_ik - zero_i)
//   c_ik   = clip(rint(t_ik), 0, 2^b-1) - 2^(b-1)                 (det)
//          = clip(floor(t_ik + float(rbits_ik) * 2^-32), 0, 2^b-1)
//            - 2^(b-1)                                            (SR)
//   acc_ij = sum_k c_ik * y8_jk                                (int32, exact)
//   rsum_i = sum_k c_ik
//   out_ij = acc_ij*(alpha_a*alpha_b) + beta_a*u_j + (alpha_a*beta_b)*rsum_i
//   alpha_a = 1/scale_i,  beta_a = 2^(b-1)*alpha_a + zero_i
// with every float operation rounded explicitly (int8_mma.cuh
// quantize_code), the epilogue applied once to the full sums,
// so the result is bit-identical to the plain PyTorch version in
// kernels/fused_fqt.py.  The SR bits arrive as prng.bits draws them,
// uint32 values held in int64; each entry's low 32 bits are read as
// unsigned.
//
// What bounds it on an H100: the f32 dY and the int64 bits, 12 bytes a
// code, against 1 byte a weight code: at lm_head (512, 10240, 512) 63 MB,
// 20.7 us at 3.35 TB/s; the 5.4 GOP of int8 products take 2.7 us at the
// tensor-core peak.  The old __dp4a tile took 532 us there: 128 blocks
// each swept 160 K steps in series.  This design (int8_mma.cuh):
//   * a 32 x 512 output tile a block, 16 warps of 32 x 32, mma.sync
//     m16n8k32 from ldmatrix fragments: 512 columns cover N = 512, so dY
//     and its bits stream once (the weight codes, 1 byte each and L2
//     resident, are what the M tiles read again);
//   * a ring of STAGES = 3 cp.async stages of BK = 64 codes: dY 8 KB, bits
//     16 KB, weight codes 32 KB a stage, 168 KB a block, one block an SM;
//   * each step the block quantizes its 32 x 64 dY tile from shared
//     memory, one quad a thread, always the same row, so each thread keeps
//     its row's code sum in a register, into a K-major code tile; then the
//     warps run the tensor cores on it;
//   * split-K in clusters (kernels/splitk.py): a cluster's blocks share a
//     GPC, and the H100 then holds only 102 to 120 of them at one an SM,
//     so lm_head runs 16 tiles x 6 slices of 27 steps (96 blocks, one
//     wave) instead of 16 x 1 of 160; the row code sums join the exact
//     reduction beside the accumulators;
//   * the epilogue's vectors and per-row factors go to shared memory while
//     the first stages are in flight, and the outputs leave as 16-byte
//     stores from the shared accumulator tile.
// What holds it back (PERF.md): each SM's streaming of dY, the bits and
// the weight codes in the K loop, and the cluster capacity, which leaves
// 36 SMs idle at lm_head.
// Ragged M, N and K edges and unaligned rows are masked in the loaders and
// the quantize (codes outside the matrix are 0, as the Pallas kernel's
// col < kdim mask makes them), so the wrapper never pads or slices.

#include <cstdint>
#include <cuda_runtime.h>

#include "fused_qlhs_gemm.cuh"

namespace {

using namespace fused_qlhs_gemm;

// 32 x 512 outputs, 16 warps of 32 x 32, 3 stages of 64 codes, B K-major,
// mma.sync, one block an SM
struct DxTile : Tile<32, 512, 64, 1, 16, 3, BKMajor, 1> {};

}  // namespace

// The tile this library was built with, for the wrapper's split plan
// (kernels/splitk.py): {BM, BN, BK, THREADS, NACC, STAGES,
// smem bytes with SR bits, smem bytes deterministic}.
extern "C" void fused_qlhs_dx_tile(int* cfg) { tile_config<DxTile>(cfg); }

// Blocks the card runs at once in clusters of `cluster` (1..8), with SR
// bits or deterministic (minus the CUDA error on failure): what
// kernels/splitk.py plans with.
extern "C" int fused_qlhs_dx_capacity(int sr, int cluster) {
  return sr ? capacity<DxTile, true>(cluster)
            : capacity<DxTile, false>(cluster);
}

// C interface, loaded with ctypes.  rbits: (M, K) int64 SR bits, or
// nullptr for deterministic rounding; y8: the (N, K) row-major weight
// codes.  The wrapper's split plan gives `splits` K slices (1..8, one
// cluster a tile) of k_span codes (a multiple of BK; the last may be
// shorter).  One launch; returns its CUDA error (0 = launched).
extern "C" int fused_qlhs_dx(const float* xf, const float* scale_a,
                             const float* zero_a, const long long* rbits,
                             const int8_t* y8, const float* alpha_b,
                             const float* beta_b, const float* u, float* out,
                             int M, int N, int K, int bits, int splits,
                             int k_span, void* stream) {
  if (!valid_split<DxTile>(K, splits, k_span))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rbits ? launch<DxTile, true>(xf, scale_a, zero_a, rbits, y8,
                                      alpha_b, beta_b, u, out, M, N, K, bits,
                                      splits, k_span, s)
               : launch<DxTile, false>(xf, scale_a, zero_a, rbits, y8,
                                       alpha_b, beta_b, u, out, M, N, K,
                                       bits, splits, k_span, s);
}
