// Helpers shared by the kernels of this directory: cp.async of one 4- or
// 8-byte element from device to shared memory, with the group commit and
// wait around it (sm_80 and later; a thread sees its own copies once
// cp_async_wait has returned, other threads after a barrier as well), the
// dynamic shared memory a kernel is allowed, and the one entry form.

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

// The one entry form of every kernel here (bound in ops/_build.py):
//   int roms_<kernel>_<f32|f64>(const void* const* p, const int* n,
//                               const double* d, void* stream)
//   int roms_<kernel>_occupancy(const int* n, int* out)
// A launch's n opens with the lengths of p, of the ints that follow and of
// d; an occupancy query's with those of its ints and of out.  Lengths
// other than the kernel's are refused (cudaErrorInvalidValue), so a
// missing argument cannot shift the later ones.
struct Lengths {
  int p, n, d;         // a launch's pointers, ints and doubles
  int occ_n, occ_out;  // an occupancy query's ints and outputs
};

// the ints past the lengths heading n; nullptr if those are not L's
inline const int* launch_ints(const Lengths& L, const int* n) {
  return n[0] == L.p && n[1] == L.n && n[2] == L.d ? n + 3 : nullptr;
}
inline const int* occupancy_ints(const Lengths& L, const int* n) {
  return n[0] == L.occ_n && n[1] == L.occ_out ? n + 2 : nullptr;
}

// The five ints of an occupancy query for kernel k (nullptr: refused) in
// blocks of `threads` threads and `smem` bytes: threads and shared-memory
// bytes per block, resident blocks per SM, registers and stack bytes per
// thread.
inline int occupancy_of(const void* k, int threads, int smem, int* out) {
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], k, threads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = smem;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}
