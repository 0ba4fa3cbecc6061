// The raw fp32 scan's arithmetic, shared by the fused scan -> top-k
// (sivf_fused_search.cu) and the unfused scan (sivf_scan.cu). Hopper
// (sm_90a).
//
// Every sum runs in index order with each product and each sum rounded on
// its own (__fmul_rn / __fadd_rn: no fused multiply-add), as the plain
// versions do (kernels/sivf_scan/ref.py dot_in_order), so the two kernels
// and the plain versions agree bit for bit. An L2 distance is
// (qq - 2 dot) + norm, an IP distance -dot.
#pragma once

#include <cuda_runtime.h>

namespace sivf {

// q.x over d_dim entries; x in device memory, qs in shared memory. vec4:
// both 16-byte aligned and d_dim % 4 == 0 (float4 loads, same order).
__device__ __forceinline__ float dot_row(const float* __restrict__ x,
                                         const float* qs, int d_dim,
                                         bool vec4) {
  float acc = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int i = 0; i < (d_dim >> 2); ++i) {
      const float4 a = __ldg(x4 + i);
      const float4 b = q4[i];
      acc = __fadd_rn(acc, __fmul_rn(b.x, a.x));
      acc = __fadd_rn(acc, __fmul_rn(b.y, a.y));
      acc = __fadd_rn(acc, __fmul_rn(b.z, a.z));
      acc = __fadd_rn(acc, __fmul_rn(b.w, a.w));
    }
  } else {
    for (int i = 0; i < d_dim; ++i)
      acc = __fadd_rn(acc, __fmul_rn(qs[i], __ldg(x + i)));
  }
  return acc;
}

// ||q||^2 of the query staged in shared memory, summed in index order.
__device__ __forceinline__ float query_norm(const float* qs, int d_dim) {
  float qq = 0.f;
  for (int i = 0; i < d_dim; ++i) qq = __fadd_rn(qq, __fmul_rn(qs[i], qs[i]));
  return qq;
}

// The distance of a live slot from its dot product.
template <bool kL2>
__device__ __forceinline__ float distance(float qq, float dot, float norm) {
  return kL2 ? __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, dot)), norm) : -dot;
}

}  // namespace sivf
