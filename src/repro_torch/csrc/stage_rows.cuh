// Staging of rows into shared memory with cp.async, shared by the
// recurrence kernels (wkv6.cu, mamba_scan.cu: a chunk of time steps) and
// sivf_pq_fused_search.cu (a query's ADC table). Hopper (sm_90a).
//
// A chunk is `rows` rows of `width` float32, row r read from
// src + r * src_stride and written to dst + r * dst_stride. With `vec` each
// copy moves 16 bytes (the caller guarantees that src, dst, both strides and
// width are multiples of 4 floats and 16-byte aligned), else 4 bytes;
// neighbouring threads copy neighbouring addresses either way. The copies
// are asynchronous: the caller commits them as a group and waits for it
// before a barrier (cp_async_commit / cp_async_wait_all).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace rec {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void stage_rows(float* dst, int dst_stride,
                                           const float* src,
                                           long long src_stride, int rows,
                                           int width, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    const int w4 = width >> 2;
    for (int idx = tid; idx < rows * w4; idx += nthreads) {
      const int r = idx / w4, x = 4 * (idx - r * w4);
      cp_async16(dst + r * dst_stride + x, src + r * src_stride + x);
    }
  } else {
    for (int idx = tid; idx < rows * width; idx += nthreads) {
      const int r = idx / width, x = idx - r * width;
      cp_async4(dst + r * dst_stride + x, src + r * src_stride + x);
    }
  }
}

}  // namespace rec
