// The grouped raw scans' plan and row scoring, shared by kernel 1's route
// grouped (sivf_fused_search.cu: scan -> per-entry top-k -> merge) and
// kernel 3's (sivf_scan.cu: the whole [Q, T*C] candidate rows). Hopper
// (sm_90a).
//
// The plan inverts a slab table [Q, T] on the card, with no host sync,
// into work chunks of at most kEntries live (q, t) entries of one slab:
// a histogram of the live entries over slabs (and ||q||^2 of every
// query), each probed slab's range of entries and its chunk records taken
// by warp-aggregated atomics, and each entry q * T + t scattered into its
// slab's range. The order of ranges, of chunks and inside a range is free:
// every output is keyed by (q, t). An entry outside [0, n_slabs) is not in
// the plan.
//
// The scoring streams one slab row a thread through the thread's own
// cp.async ring and keeps one accumulator per query of the chunk, the
// queries' columns staged kQd at a time in shared memory; each product and
// each sum is rounded on its own, in index order over d (dot_row.cuh's
// arithmetic), so both kernels agree with the plain versions bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "dot_row.cuh"

namespace sivf {
namespace group {

constexpr int kThreads = 128;            // scan block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kEntries = 16;             // (q, t) entries of one chunk, at most
constexpr int kRows = kThreads;          // live rows scored at once: one a thread
constexpr int kQd = 128;                 // query columns staged at a time
constexpr int kRing = 2;                 // float4 of a row in flight (cp.async)
constexpr int kRingStride = 4 * kRing + 4;   // a thread's ring, padded (floats)
constexpr int kPlanThreads = 256;

// The plan's device scratch, the head of each grouped route's workspace
// (4-byte elements; the chunk records first, 16-byte aligned).
struct Plan {
  int4* chunks;       // [max_chunks] (slab, first entry, entries, 0)
  int* counts;        // [n_slabs] entries a slab; zeroed again for the scatter
  int* counters;      // [3] entries taken, chunks taken, the scan's work
                      // counter: zeroed with counts by one memset
  int* offsets;       // [n_slabs] each slab's first entry
  int* entries;       // [Q * T] q * T + t, grouped by slab
  float* qq;          // [Q] ||q||^2
};

inline size_t max_chunks(size_t n_entries, int n_slabs) {
  const size_t s = (size_t)n_slabs;
  return (n_entries + kEntries - 1) / kEntries + (s < n_entries ? s : n_entries);
}

// 4-byte words of the plan. The wrappers' fused.plan_bytes() mirrors this
// formula (it sizes the workspace without a call into a library): change
// both together.
inline size_t plan_words(int n_queries, int t_len, int n_slabs) {
  const size_t n = (size_t)n_queries * t_len;
  return 4 * max_chunks(n, n_slabs) + 2 * (size_t)n_slabs + 3 + n +
         (size_t)n_queries;
}

// The plan's arrays at the head of `base`; *rest: the first word past them.
inline Plan carve_plan(void* base, int n_queries, int t_len, int n_slabs,
                       float** rest) {
  const size_t n = (size_t)n_queries * t_len;
  Plan p;
  p.chunks = static_cast<int4*>(base);
  p.counts = reinterpret_cast<int*>(p.chunks + max_chunks(n, n_slabs));
  p.counters = p.counts + n_slabs;
  p.offsets = p.counters + 3;
  p.entries = p.offsets + n_slabs;
  p.qq = reinterpret_cast<float*>(p.entries + n);
  *rest = p.qq + n_queries;
  return p;
}

// 1a. Live entries per slab, and ||q||^2 of every query (in index order).
__global__ void plan_count(const int* __restrict__ table, long long n_entries,
                           int n_slabs, int* __restrict__ counts,
                           const float* __restrict__ queries, int n_queries,
                           int d_dim, float* __restrict__ qq) {
  const long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = i0; q < n_queries; q += stride)
    qq[q] = sivf::query_norm(queries + q * d_dim, d_dim);
  for (long long e = i0; e < n_entries; e += stride) {
    const int s = table[e];
    if (s >= 0 && s < n_slabs) atomicAdd(counts + s, 1);
  }
}

// 1b. Each probed slab takes its range of entries and its chunk records,
// a warp's slabs with one atomicAdd on each counter (the order of ranges
// and of chunks is free: every output is keyed by (q, t)); counts are
// zeroed for the scatter.
__global__ void plan_alloc(int* __restrict__ counts, int n_slabs,
                           int* __restrict__ counters,
                           int* __restrict__ offsets,
                           int4* __restrict__ chunks) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = s < n_slabs ? counts[s] : 0;
  const int nc = (n + kEntries - 1) / kEntries;
  int xe = n, xc = nc;                   // inclusive scans over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ye = __shfl_up_sync(~0u, xe, o);
    const int yc = __shfl_up_sync(~0u, xc, o);
    if (lane >= o) {
      xe += ye;
      xc += yc;
    }
  }
  int be = 0, bc = 0;
  if (lane == 31) {
    be = atomicAdd(counters, xe);
    bc = atomicAdd(counters + 1, xc);
  }
  const int e = __shfl_sync(~0u, be, 31) + xe - n;
  const int c = __shfl_sync(~0u, bc, 31) + xc - nc;
  if (s < n_slabs) {
    offsets[s] = e;
    for (int j = 0; j < nc; ++j)
      chunks[c + j] = make_int4(s, e + j * kEntries,
                                min(kEntries, n - j * kEntries), 0);
    counts[s] = 0;
  }
}

// 1c. Each live entry into its slab's range.
__global__ void plan_scatter(const int* __restrict__ table, long long n_entries,
                             int n_slabs, const int* __restrict__ offsets,
                             int* __restrict__ fill, int* __restrict__ entries) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n_entries; e += stride) {
    const int s = table[e];
    if (s >= 0 && s < n_slabs)
      entries[offsets[s] + atomicAdd(fill + s, 1)] = (int)e;
  }
}

inline int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  return n_sm;
}

// 1. The plan on `s`: the memset, plan_count, plan_alloc, plan_scatter.
// Returns the first cudaError_t (0 = ok).
inline cudaError_t launch_plan(const int* table, int n_queries, int t_len,
                               int n_slabs, const float* queries, int d_dim,
                               const Plan& w, cudaStream_t s) {
  const long long n = (long long)n_queries * t_len;
  cudaError_t err =
      cudaMemsetAsync(w.counts, 0, sizeof(int) * (n_slabs + 3), s);
  if (err) return err;
  const long long want = (n > n_queries ? n : n_queries);
  const int grid = (int)std::min<long long>((want + kPlanThreads - 1) /
                                                kPlanThreads,
                                            (long long)sm_count() * 16);
  plan_count<<<grid, kPlanThreads, 0, s>>>(table, n, n_slabs, w.counts,
                                           queries, n_queries, d_dim, w.qq);
  if (n_slabs > 0)
    plan_alloc<<<(n_slabs + kPlanThreads - 1) / kPlanThreads, kPlanThreads,
                 0, s>>>(w.counts, n_slabs, w.counters, w.offsets, w.chunks);
  plan_scatter<<<grid, kPlanThreads, 0, s>>>(table, n, n_slabs, w.offsets,
                                             w.counts, w.entries);
  return cudaGetLastError();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// acc[j] += q_j . x for the chunk's first kQ queries over `len` columns in
// index order, each product and sum rounded on its own (dot_row.cuh);
// x: this thread's row from the staged columns' first on, qs: [kEntries]
// [kQd] staged query columns, zero from len to a multiple of 4.
//  * kRingPath (16-byte aligned rows, len % 4 == 0): the row streams
//    through this thread's ring of kRing float4 in shared memory by
//    cp.async, each a commit group; only this thread reads its ring, so
//    waiting on its own groups is enough: kRing copies in flight, no
//    registers held for them.
//  * otherwise: 4-byte loads, the next four columns read while these are
//    used, zero past len (a zero times a zero adds +0.0, which leaves every
//    sum as it is: a sum from +0.0 is never -0.0).
template <bool kRingPath, int kQ>
__device__ __forceinline__ void score_row(const float* __restrict__ x,
                                          int len, const float* qs,
                                          float* ring,
                                          float (&acc)[kEntries]) {
  auto add = [&](const float4 a, int i) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(qs + j * kQd + 4 * i);
      float s = acc[j];
      s = __fadd_rn(s, __fmul_rn(v.x, a.x));
      s = __fadd_rn(s, __fmul_rn(v.y, a.y));
      s = __fadd_rn(s, __fmul_rn(v.z, a.z));
      s = __fadd_rn(s, __fmul_rn(v.w, a.w));
      acc[j] = s;
    }
  };
  const int n4 = (len + 3) >> 2;
  if constexpr (kRingPath) {
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
      if (u < n4) cp_async16(ring + 4 * u, x + 4 * u);
      cp_async_commit();
    }
    for (int i = 0; i < n4; ++i) {
      cp_async_wait<kRing - 1>();        // copy i has landed
      float* slot = ring + 4 * (i % kRing);
      add(*reinterpret_cast<const float4*>(slot), i);
      if (i + kRing < n4) cp_async16(slot, x + 4 * (i + kRing));
      cp_async_commit();
    }
    cp_async_wait<0>();
  } else {
    auto load = [&](int i) {
      const int c = 4 * i;
      return make_float4(c < len ? __ldg(x + c) : 0.f,
                         c + 1 < len ? __ldg(x + c + 1) : 0.f,
                         c + 2 < len ? __ldg(x + c + 2) : 0.f,
                         c + 3 < len ? __ldg(x + c + 3) : 0.f);
    };
    float4 cur = load(0);
    for (int i = 0; i < n4; ++i) {
      const float4 nxt = load(i + 1);
      add(cur, i);
      cur = nxt;
    }
  }
}

// score_row<ne>: one instantiation for each count of queries.
template <bool kRingPath, int kQ = kEntries>
__device__ __forceinline__ void score_rows(int ne, const float* __restrict__ x,
                                           int len, const float* qs,
                                           float* ring,
                                           float (&acc)[kEntries]) {
  if constexpr (kQ > 1) {
    if (ne < kQ) {
      score_rows<kRingPath, kQ - 1>(ne, x, len, qs, ring, acc);
      return;
    }
  }
  score_row<kRingPath, kQ>(x, len, qs, ring, acc);
}

// Copy columns [d0, d0 + len) of the query rows of `ne` entries (each
// q * T + t) into qs [kEntries][kQd], asynchronously, and zero the columns
// from len to a multiple of 4 (the caller waits, then syncs).
__device__ __forceinline__ void stage_queries(
    float* qs, const float* __restrict__ queries,
    const int* __restrict__ entries, int ne, int t_len, int d_dim, int d0,
    int len, bool vec4) {
  const int tid = threadIdx.x;
  if (vec4) {
    const int w4 = len >> 2;
    for (int i = tid; i < ne * w4; i += kThreads) {
      const int r = i / w4, c = 4 * (i - r * w4);
      cp_async16(qs + r * kQd + c,
                 queries + (size_t)(entries[r] / t_len) * d_dim + d0 + c);
    }
  } else {
    for (int i = tid; i < ne * len; i += kThreads) {
      const int r = i / len, c = i - r * len;
      cp_async4(qs + r * kQd + c,
                queries + (size_t)(entries[r] / t_len) * d_dim + d0 + c);
    }
  }
  const int pad = ((len + 3) & ~3) - len;
  for (int i = tid; i < ne * pad; i += kThreads)
    qs[(i / pad) * kQd + len + i % pad] = 0.f;
}

}  // namespace group
}  // namespace sivf
