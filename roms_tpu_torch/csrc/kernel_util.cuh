// Helpers shared by momentum_solve.cu and kpp_vmix.cu: cp.async of one 4-
// or 8-byte element from device to shared memory, with the group commit
// and wait around it (sm_80 and later; a thread sees its own copies once
// cp_async_wait has returned, other threads after a barrier as well), and
// the dynamic shared memory a kernel is allowed.

#pragma once

#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Allow kernel k `smem` bytes of dynamic shared memory on the current
// device.  allowed[device] holds what was allowed so far, so the attribute
// is set once per device and size.  false if refused.
inline bool allow_smem(const void* k, int smem, int* allowed) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return false;
  if (smem > allowed[dev]) {
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return false;
    allowed[dev] = smem;
  }
  return true;
}
