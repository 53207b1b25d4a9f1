// Shared pieces of the int8 KV reads (kv_dequant.cu, kv_gather.cu): the
// affine dequantize of one code and of a 4-code word, and the Hopper bulk
// copy (cp.async.bulk, completing on an mbarrier) the table-driven and
// staged bodies use.
//
// Every division is the IEEE one (__fdiv_rn, no fast-math), so a kernel
// built on these is bit-identical to its plain PyTorch version.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kv_read {

constexpr float EPS = 1e-12f;

// (c + off) / s + z, rounded as the reference rounds each step
__device__ __forceinline__ float dequant1(int c, float s, float z, float off) {
  return __fadd_rn(__fdiv_rn(__fadd_rn(static_cast<float>(c), off), s), z);
}

// 4 codes (one 32-bit word) to 4 floats, one 16-byte store to a 16-byte
// aligned dst.  A warp's 32 lanes on 32 consecutive words store 512
// consecutive bytes: a lane that held 16 codes would store 64 bytes in four
// strided passes, which measured 2.5x slower on the H100.
__device__ __forceinline__ void dequant4(int x, float s, float z, float off,
                                         float* dst) {
  float4 o;
  o.x = dequant1(static_cast<int8_t>(x & 0xff), s, z, off);
  o.y = dequant1(static_cast<int8_t>((x >> 8) & 0xff), s, z, off);
  o.z = dequant1(static_cast<int8_t>((x >> 16) & 0xff), s, z, off);
  o.w = dequant1(static_cast<int8_t>((x >> 24) & 0xff), s, z, off);
  *reinterpret_cast<float4*>(dst) = o;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

// up to 4 codes at any alignment: a word and one 16-byte store where they
// allow it, else one code at a time
__device__ __forceinline__ void dequant_upto4(const int8_t* src, int n,
                                              float s, float z, float off,
                                              float* dst) {
  if (n == 4 && aligned4(src) && aligned16(dst)) {
    dequant4(*reinterpret_cast<const int*>(src), s, z, off, dst);
  } else {
    for (int j = 0; j < n; ++j) dst[j] = dequant1(src[j], s, z, off);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: an mbarrier expecting one arrival, visible to the async proxy
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the issuing thread's arrival, announcing the phase's bytes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// spin until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// global -> shared bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace kv_read
