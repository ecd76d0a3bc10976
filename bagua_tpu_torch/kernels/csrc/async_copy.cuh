// Asynchronous global-to-shared copies (cp.async, sm_80 and later), for the
// kernels that stage tiles while they compute on others.  A copy names its
// size (4 or 16 bytes) and how many of those bytes to read; the rest of the
// destination is zero-filled, which is how ragged tile edges become zeros.
// A thread's copies form groups (commit); wait_pending<N> returns once at
// most N of its groups are still in flight.  Other threads see the data
// after a barrier that follows their own wait.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, or 4 zero bytes where !valid (src is then not read).
__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes, of which the first `bytes` (0..16) are read and the rest
// zero-filled.  dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
