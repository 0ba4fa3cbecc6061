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
// The scoring (score_chunk) takes a chunk's live rows kPassRows at a time,
// a row a lane of every warp: the pass's rows and the queries' columns are
// staged kQd columns at a time in shared memory, and warp w sums lanes 2w
// and 2w + 1 of dot_row.cuh's eight (term d into lane d mod 8), a float2
// of accumulators per query of the chunk; each product and each sum is
// rounded on its own. Each thread adds its two lanes, and the four warps'
// pairs are added pairwise in shared memory, so both kernels agree with
// the plain versions bit for bit. A warp's lanes read the same query
// columns (one broadcast a load) and each its own row.
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
constexpr int kQd = 128;                 // columns staged at a time
static_assert(kQd % 16 == 0, "a staged column keeps its lane, d mod 8, "
              "and its place in a block of 16");
static_assert(kWarps == 4, "warp w sums lanes 2w and 2w + 1 of eight");
constexpr int kPassRows = 32;            // live rows scored at once: a lane's
constexpr int kXs = kQd + 4;             // a staged row's stride (floats)
// the scoring's shared memory after the staged queries (floats): the
// pass's rows [kPassRows][kXs], the warps' lane pairs
// [kWarps][kEntries][kPassRows]
constexpr int kScoreFloats = kPassRows * kXs + kWarps * kEntries * kPassRows;
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

// 1a. Live entries per slab, and ||q||^2 of every query (dot_row.cuh's
// order).
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

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// Where column c of a block of staged columns lies: in each block of 16,
// warp w's four (2w, 2w + 1, 8 + 2w, 9 + 2w) side by side, so that one
// 16-byte load gives a warp's lane its two lanes of two groups of eight.
__device__ __forceinline__ int staged_at(int c) {
  return (c & ~15) | (((c >> 1) & 3) << 2) | (((c >> 3) & 1) << 1) | (c & 1);
}

// Copy columns [d0, d0 + len) of the pass's nr rows (row i: slab row
// row0 + live[i]) into xs [kPassRows][kXs] at staged_at, asynchronously,
// and zero the columns from len to a multiple of 16 (the caller waits,
// then syncs). vec4: the rows 16-byte aligned and d_dim % 4 == 0.
__device__ __forceinline__ void stage_rows(float* xs,
                                           const float* __restrict__ data,
                                           size_t row0, const int* live,
                                           int nr, int d_dim, int d0, int len,
                                           bool vec4) {
  const int tid = threadIdx.x;
  if (vec4) {
    const int w4 = len >> 2;
    for (int i = tid; i < nr * w4; i += kThreads) {
      const int r = i / w4, c = 4 * (i - r * w4);
      const float* src = data + (row0 + live[r]) * d_dim + d0 + c;
      float* row = xs + r * kXs;
      cp_async8(row + staged_at(c), src);
      cp_async8(row + staged_at(c + 2), src + 2);
    }
  } else {
    for (int i = tid; i < nr * len; i += kThreads) {
      const int r = i / len, c = i - r * len;
      cp_async4(xs + r * kXs + staged_at(c),
                data + (row0 + live[r]) * d_dim + d0 + c);
    }
  }
  const int pad = ((len + 15) & ~15) - len;
  for (int i = tid; i < nr * pad; i += kThreads)
    xs[(i / pad) * kXs + staged_at(len + i % pad)] = 0.f;
}

// acc[j] += lanes 2w and 2w + 1 of q_j . x over `len` staged columns for
// the chunk's first kQ queries, x this lane's row of xs: in each block of
// 16 columns, group 2b's two columns, then group 2b + 1's, each product
// and sum rounded on its own (dot_row.cuh). A column past len adds 0 * 0
// to its lane, which leaves it as it is.
template <int kQ>
__device__ __forceinline__ void score_pass(const float* qs, const float* xs,
                                           int len, float2 (&acc)[kEntries]) {
  const int w4 = 4 * (threadIdx.x >> 5);
  const float* x = xs + (threadIdx.x & 31) * kXs + w4;
  for (int b = 0; b < ((len + 15) >> 4); ++b) {
    const float4 a = *reinterpret_cast<const float4*>(x + 16 * b);
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(qs + j * kQd + 16 * b + w4);
      acc[j].x = __fadd_rn(acc[j].x, __fmul_rn(v.x, a.x));
      acc[j].y = __fadd_rn(acc[j].y, __fmul_rn(v.y, a.y));
      acc[j].x = __fadd_rn(acc[j].x, __fmul_rn(v.z, a.z));
      acc[j].y = __fadd_rn(acc[j].y, __fmul_rn(v.w, a.w));
    }
  }
}

// score_pass<ne>: one instantiation for each count of queries.
template <int kQ = kEntries>
__device__ __forceinline__ void score_pass_n(int ne, const float* qs,
                                             const float* xs, int len,
                                             float2 (&acc)[kEntries]) {
  if constexpr (kQ > 1) {
    if (ne < kQ) {
      score_pass_n<kQ - 1>(ne, qs, xs, len, acc);
      return;
    }
  }
  score_pass<kQ>(qs, xs, len, acc);
}

// Copy columns [d0, d0 + len) of the query rows of `ne` entries (each
// q * T + t) into qs [kEntries][kQd] at staged_at, asynchronously, and
// zero the columns from len to a multiple of 16 (the caller waits, then
// syncs).
__device__ __forceinline__ void stage_queries(
    float* qs, const float* __restrict__ queries,
    const int* __restrict__ entries, int ne, int t_len, int d_dim, int d0,
    int len) {
  const int tid = threadIdx.x;
  for (int i = tid; i < ne * len; i += kThreads) {
    const int r = i / len, c = i - r * len;
    cp_async4(qs + r * kQd + staged_at(c),
              queries + (size_t)(entries[r] / t_len) * d_dim + d0 + c);
  }
  const int pad = ((len + 15) & ~15) - len;
  for (int i = tid; i < ne * pad; i += kThreads)
    qs[(i / pad) * kQd + staged_at(len + i % pad)] = 0.f;
}

// Score a chunk of `ne` entries (entries[i]: q * T + t) of one slab against
// its n_live live rows (row i: slab row row0 + live[i]) in passes of
// kPassRows rows, and emit(j, i, dot) for each entry j and live row i.
// qs [kEntries][kQd]: columns [0, min(kQd, d_dim)) of the entries' query
// rows staged (or in flight) by stage_queries; the other columns are
// staged here. sm: kScoreFloats floats, 16-byte aligned. Called by every
// thread of the block; emit runs after a sync, and the caller syncs before
// it reads what emit wrote.
template <class Emit>
__device__ __forceinline__ void score_chunk(
    int ne, const float* __restrict__ queries, const int* entries, int t_len,
    int d_dim, const float* __restrict__ data, size_t row0, const int* live,
    int n_live, bool vec4, float* qs, float* sm, Emit emit) {
  float* xs = sm;                                  // [kPassRows][kXs]
  float* pairs = sm + kPassRows * kXs;             // [kWarps][kEntries][kPassRows]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r0 = 0; r0 < n_live; r0 += kPassRows) {
    const int nr = min(kPassRows, n_live - r0);
    float2 acc[kEntries];
#pragma unroll
    for (int j = 0; j < kEntries; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int d0 = 0; d0 < d_dim; d0 += kQd) {
      const int len = min(kQd, d_dim - d0);
      __syncthreads();                             // xs, qs, pairs are free
      if (d_dim > kQd && (d0 > 0 || r0 > 0))       // the next query columns
        stage_queries(qs, queries, entries, ne, t_len, d_dim, d0, len);
      stage_rows(xs, data, row0, live + r0, nr, d_dim, d0, len, vec4);
      cp_async_wait_all();
      __syncthreads();
      if (lane < nr) score_pass_n(ne, qs, xs, len, acc);
    }
#pragma unroll
    for (int j = 0; j < kEntries; ++j)
      if (j < ne)
        pairs[(warp * kEntries + j) * kPassRows + lane] =
            __fadd_rn(acc[j].x, acc[j].y);
    __syncthreads();
    constexpr int kW = kEntries * kPassRows;       // a warp's pairs
    for (int i = tid; i < ne * nr; i += kThreads) {
      const int j = i / nr, r = i - j * nr;
      const float* p = pairs + j * kPassRows + r;
      emit(j, r0 + r,
           __fadd_rn(__fadd_rn(p[0], p[kW]), __fadd_rn(p[2 * kW], p[3 * kW])));
    }
  }
}

}  // namespace group
}  // namespace sivf
