// Helpers shared by the flash kernels that run on Hopper's tensor cores
// (flash_attention.cu in float32 as 3xTF32; flash_attention_bf16.cu and its
// backward flash_attention_bwd_bf16.cu in bfloat16): 16-byte cp.async and
// its groups, the wgmma fence / commit / wait, the shared-memory matrix
// descriptor, and ex2.  The wgmma instructions themselves differ by type:
// the float32 kernel's stay in its source, the bfloat16 ones are in
// wgmma_bf16.cuh.
#pragma once

#include <stdint.h>

namespace {

// cp.async of 16 bytes; with ok false the destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's writes to shared memory visible to wgmma (the async
// proxy); a barrier after it makes every thread's visible.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma's start and wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor: start address, leading byte offset
// (K-major under a swizzle: unused; MN-major: the step between chunks of
// columns), stride byte offset (the step between 8-row atoms) and the
// swizzle mode (1: 128 bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
