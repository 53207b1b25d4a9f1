// The int8 tensor-core GEMM tile shared by q8_matmul.cu and
// fused_qlhs_dx.cu: mma.sync m16n8k32 (s8 x s8 -> s32) on operands that sit
// K-major in shared memory, a ring of cp.async stages, and split-K reduced
// exactly inside a thread-block cluster.
//
// Why mma.sync and not wgmma: at the training shapes (M = 512 tokens) the
// bound is bytes and latency, not the tensor cores (lm_head's 5.4 GOP take
// 2.7 us at the int8 peak); what the old __dp4a tile lacked was work in
// flight.  mma.sync keeps the fragments in registers, takes any warp
// tiling, and needs neither TMA descriptors nor warpgroup-sized tiles.
//
// Layout of an operand tile in shared memory: one row per M (or N) index,
// 16 * CH bytes of K codes a row (CH 16-byte chunks), the chunk index XORed
// with a function of the row (swz) so that the eight 16-byte rows one
// ldmatrix phase reads fall in eight distinct bank groups.  ldmatrix (.b16,
// no .trans) then hands each lane exactly the fragment
// mma.m16n8k32.row.col wants: four int8 K codes of one row a register.
//
// Split-K: a block owns one (M tile, N tile, K slice), and the slices of a
// tile are one cluster of 1 to 8 blocks (kernels/splitk.py picks the
// split).  After the K sweep each block writes its int32 accumulators into
// its own shared memory as a row-major tile; the cluster meets at a
// barrier, and each block sums its share of the rows over every block's
// tile through distributed shared memory and runs the epilogue on them,
// once, on the full sums.  Integer addition is exact and commutes, so the
// result does not depend on the order in which the slices arrive; no
// workspace, no atomics, no second launch, and no float is ever summed
// across blocks.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace int8_mma {

// cp.async of one 16-byte chunk; bytes past src_bytes (0 or 16) are
// zero-filled.  L2 only (.cg): every byte is used once per block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 exact.
__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack4(int c0, int c1, int c2, int c3) {
  return static_cast<unsigned>((c0 & 0xff) | ((c1 & 0xff) << 8) |
                               ((c2 & 0xff) << 16) | ((c3 & 0xff) << 24));
}

// Byte offset of 16-byte chunk c of row r in a tile of CH chunks a row:
// 128 / (16 * CH) rows share one 128-byte bank line, and the XOR key
// changes from one such group of rows to the next.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CH == 2 || CH == 4 || CH == 8, "CH");
  return r * (16 * CH) + ((c ^ ((r / (8 / CH)) & (CH - 1))) << 4);
}

// Sixteen bytes of one row from `src`, the first `n` of them (0..16) and
// the rest 0, into smem: one cp.async when all 16 lie inside the matrix and
// the source is 16-byte aligned, else byte by byte with plain loads and
// stores (ragged edges, unaligned rows).  Callers use it for chunks of
// int8 codes, f32 values and int64 bits alike.
__device__ __forceinline__ void load_chunk(void* smem, const uint8_t* src,
                                           int n) {
  if (n == 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(smem, src, 16);
  } else {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = 4 * q + j < n ? static_cast<int>(src[4 * q + j]) : 0;
      w[q] = pack4(b[0], b[1], b[2], b[3]);
    }
    *reinterpret_cast<uint4*>(smem) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One row of an operand whose chunks a thread loads at every K step: the
// row's first byte, its length in bytes, and whether the row lies inside
// the matrix (rows past the edge load as 0) with 16-byte aligned chunks.
// Built once before the K sweep, so a step's load is an add, a compare
// and the cp.async.
struct RowSrc {
  const uint8_t* row;
  int bytes;
  bool inside, aligned;
};

__device__ __forceinline__ RowSrc row_src(const void* base, size_t row,
                                          int row_bytes, bool inside) {
  const uint8_t* p = static_cast<const uint8_t*>(base) + row * row_bytes;
  return {p, row_bytes, inside,
          inside && (reinterpret_cast<uintptr_t>(p) & 15) == 0};
}

// The 16 bytes at byte `kb` (a multiple of 16) of the row into smem.
__device__ __forceinline__ void load_row_chunk(void* smem, const RowSrc& s,
                                               int kb) {
  if (s.aligned && kb + 16 <= s.bytes)
    cp_async16(smem, s.row + kb, 16);
  else
    load_chunk(smem, s.row + kb, s.inside ? min(max(s.bytes - kb, 0), 16) : 0);
}

// One k32 step of a warp's MI x NJ grid of m16n8 tiles: A rows a_row0 ..
// a_row0 + 16 MI - 1 and B rows (N indices) b_row0 .. b_row0 + 8 NJ - 1 of
// two K-major swizzled tiles with CH chunks a row, K chunks 2 kc and
// 2 kc + 1.
template <int MI, int NJ, int CH>
__device__ __forceinline__ void warp_mma_k32(int acc[MI * NJ * 4],
                                             const uint8_t* As, int a_row0,
                                             const uint8_t* Bs, int b_row0,
                                             int kc, int lane) {
  unsigned a[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r = a_row0 + mi * 16 + (lane & 15);
    ldmatrix_x4(a[mi], As + swz<CH>(r, 2 * kc + (lane >> 4)));
  }
#pragma unroll
  for (int nj = 0; nj < NJ; nj += 2) {
    const int r = b_row0 + nj * 8 + (lane & 7) + ((lane >> 4) << 3);
    unsigned b[4];
    ldmatrix_x4(b, Bs + swz<CH>(r, 2 * kc + ((lane >> 3) & 1)));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      mma_s8(&acc[(mi * NJ + nj) * 4], a[mi], b[0], b[1]);
      mma_s8(&acc[(mi * NJ + nj + 1) * 4], a[mi], b[2], b[3]);
    }
  }
}

// The warp's MI x NJ grid of m16n8 accumulators into a row-major int32
// tile in shared memory, rows of LDT int32 (LDT = BN + 8: the eight rows
// of one int2 store phase fall in distinct banks).
template <int MI, int NJ, int LDT>
__device__ __forceinline__ void acc_to_tile(int* tile, const int* acc,
                                            int row0, int col0, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int* c = acc + (mi * NJ + nj) * 4;
      int* p = tile + (row0 + mi * 16 + g) * LDT + col0 + nj * 8 + 2 * tig;
      *reinterpret_cast<int2*>(p) = make_int2(c[0], c[1]);
      *reinterpret_cast<int2*>(p + 8 * LDT) = make_int2(c[2], c[3]);
    }
  }
}

// Split-K reduction and epilogue walk.  Every block has written its BM x BN
// partial (acc_to_tile) into `tile`, its own shared memory, and its BM
// row partials of some extra sum (the dX kernel's row code sums) into
// extra_s, or extra_s is null.  With SPLITS > 1 the SPLITS blocks of the
// tile's cluster (SPLITS K slices, at most 8: a portable cluster) meet at
// the cluster barrier, and the block of rank r sums rows r * R ..
// (r + 1) * R - 1, R = ceil(BM / SPLITS), over all ranks' tiles
// (distributed shared memory, one 16-byte load a rank, all issued before
// the first add), so every block finalizes its share of the tile.  emit(row, col, sum,
// extra) gets each 4-column chunk's int32 sums and the row's extra sum.
// Integer sums are exact, so nothing depends on the order in which the
// slices arrive; nothing leaves the SMs, and no float is summed across
// blocks.
template <int BM, int BN, int THREADS, int SPLITS, typename Emit>
__device__ __forceinline__ void reduce_tile(const int* tile,
                                            const int* extra_s, Emit emit) {
  constexpr int LDT = BN + 8;
  constexpr int ROWS = (BM + SPLITS - 1) / SPLITS;
  namespace cg = cooperative_groups;
  int r0 = 0;
  if constexpr (SPLITS > 1) {
    cg::this_cluster().sync();
    r0 = static_cast<int>(cg::this_cluster().block_rank()) * ROWS;
  } else {
    __syncthreads();
  }
  for (int c = threadIdx.x; c < ROWS * (BN / 4); c += THREADS) {
    const int row = r0 + c / (BN / 4), col = (c % (BN / 4)) * 4;
    if (row >= BM) break;
    const int off = row * LDT + col;
    int4 sum;
    int ex = 0;
    if constexpr (SPLITS > 1) {
      int4 v[SPLITS];
      int e[SPLITS];
#pragma unroll
      for (int r = 0; r < SPLITS; ++r) {
        v[r] = *reinterpret_cast<const int4*>(
            cg::this_cluster().map_shared_rank(tile, r) + off);
        e[r] = extra_s ? cg::this_cluster().map_shared_rank(extra_s, r)[row]
                       : 0;
      }
      sum = v[0];
      ex = e[0];
#pragma unroll
      for (int r = 1; r < SPLITS; ++r) {
        sum.x += v[r].x; sum.y += v[r].y; sum.z += v[r].z; sum.w += v[r].w;
        ex += e[r];
      }
    } else {
      sum = *reinterpret_cast<const int4*>(tile + off);
      ex = extra_s ? extra_s[row] : 0;
    }
    emit(row, col, sum, ex);
  }
  // no block leaves while a peer still reads its tile
  if constexpr (SPLITS > 1) cg::this_cluster().sync();
}

// Four outputs of row m, columns n .. n + 3, of a row-major (M, N) f32
// matrix: one 16-byte store where all four lie inside and align, else one
// by one up to column N.
__device__ __forceinline__ void store4(float* out, int m, int n, int N,
                                       const float o[4]) {
  float* p = out + static_cast<size_t>(m) * N + n;
  if (n + 3 < N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) p[j] = o[j];
  }
}

// Launch Kernel on a 1-D grid of `blocks`, clusters of `cluster`
// consecutive blocks.  Returns the launch's CUDA error.
template <auto Kernel, typename... Args>
int launch_clustered(int blocks, int threads, int smem, int cluster,
                     cudaStream_t stream, Args... args) {
  // once a kernel: the attribute call costs host time
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of Kernel the card runs at once in clusters of `cluster`
// (cudaOccupancyMaxActiveClusters times the cluster size), or minus the
// CUDA error.
template <auto Kernel>
int cluster_capacity(int threads, int smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, Kernel, &cfg);
  return e == cudaSuccess ? n * cluster : -static_cast<int>(e);
}

// The block's (M tile, N tile, K slice) from a 1-D grid ordered K slice
// fastest (one tile's slices are one cluster), then N tile, then M tile:
// the tiles that share one M tile's rows of A run side by side.
struct BlockCoords {
  int m_tile, n_tile, split;
};

__device__ __forceinline__ BlockCoords block_coords(int n_tiles, int splits) {
  const int id = blockIdx.x;
  BlockCoords c;
  c.split = id % splits;
  c.n_tile = (id / splits) % n_tiles;
  c.m_tile = id / (splits * n_tiles);
  return c;
}

}  // namespace int8_mma
