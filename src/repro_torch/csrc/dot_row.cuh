// The raw fp32 scan's arithmetic, shared by the fused scan -> top-k
// (sivf_fused_search.cu) and the unfused scan (sivf_scan.cu). Hopper
// (sm_90a).
//
// The order of every sum over d (q.x and ||q||^2): eight float32 lane
// accumulators a0..a7, each from +0.0; term d goes into lane d mod 8 as
// __fadd_rn(a, __fmul_rn(q_d, x_d)); the result is
// ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7)), each sum __fadd_rn.
// Each product and each sum is rounded on its own (no fused multiply-add),
// as the plain versions do (kernels/sivf_scan/ref.py dot_lanes), so the two
// kernels and the plain versions agree bit for bit. A term past D adds
// 0 * 0 to its lane, which leaves the lane as it is (a sum from +0.0 is
// never -0.0). One thread holds the eight lanes as two float4 (dot_row,
// query_norm); the grouped scans spread them over four warps, two lanes
// each (slab_plan.cuh). An L2 distance is (qq - 2 dot) + norm, an IP
// distance -dot.
#pragma once

#include <cuda_runtime.h>

namespace sivf {

// acc.<i> += q.<i> * x.<i> for each lane i.
__device__ __forceinline__ void lanes_add(float4& acc, const float4 q,
                                          const float4 x) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(q.x, x.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(q.y, x.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(q.z, x.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(q.w, x.w));
}

// Lanes 0..3 (lo) and 4..7 (hi) combined:
// ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7)).
__device__ __forceinline__ float lanes_sum(const float4 lo, const float4 hi) {
  return __fadd_rn(__fadd_rn(__fadd_rn(lo.x, lo.y), __fadd_rn(lo.z, lo.w)),
                   __fadd_rn(__fadd_rn(hi.x, hi.y), __fadd_rn(hi.z, hi.w)));
}

// q.x over d_dim entries by 4-byte loads (load(i) reads x_i), eight terms
// at a time, the terms past d_dim zero.
template <class Load>
__device__ __forceinline__ float lanes_scalar(const float* qs, int d_dim,
                                              Load load) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  auto q_at = [&](int i) { return i < d_dim ? qs[i] : 0.f; };
  auto x_at = [&](int i) { return i < d_dim ? load(i) : 0.f; };
  for (int i = 0; i < d_dim; i += 8) {
    lanes_add(lo, make_float4(q_at(i), q_at(i + 1), q_at(i + 2), q_at(i + 3)),
              make_float4(x_at(i), x_at(i + 1), x_at(i + 2), x_at(i + 3)));
    lanes_add(hi,
              make_float4(q_at(i + 4), q_at(i + 5), q_at(i + 6), q_at(i + 7)),
              make_float4(x_at(i + 4), x_at(i + 5), x_at(i + 6), x_at(i + 7)));
  }
  return lanes_sum(lo, hi);
}

// q.x over d_dim entries; x in device memory, qs in shared memory. vec4:
// both 16-byte aligned and d_dim % 4 == 0 (float4 loads, same order).
__device__ __forceinline__ float dot_row(const float* __restrict__ x,
                                         const float* qs, int d_dim,
                                         bool vec4) {
  if (vec4) {
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const int n4 = d_dim >> 2;
    for (int i = 0; i < n4; i += 2) {
      lanes_add(lo, q4[i], __ldg(x4 + i));
      if (i + 1 < n4) lanes_add(hi, q4[i + 1], __ldg(x4 + i + 1));
    }
    return lanes_sum(lo, hi);
  }
  return lanes_scalar(qs, d_dim, [&](int i) { return __ldg(x + i); });
}

// ||q||^2 of a query row (shared or device memory), in the same order.
__device__ __forceinline__ float query_norm(const float* qs, int d_dim) {
  return lanes_scalar(qs, d_dim, [&](int i) { return qs[i]; });
}

// The distance of a live slot from its dot product.
template <bool kL2>
__device__ __forceinline__ float distance(float qq, float dot, float norm) {
  return kL2 ? __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, dot)), norm) : -dot;
}

}  // namespace sivf
