// Fused slab scan -> top-k search for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/sivf_scan/fused.py::sivf_fused_search_pallas,
// unfiltered and filtered: for each query, score every live slot of every
// slab in its table row as ||q||^2 - 2 q.x + ||x||^2 (L2) or -q.x (IP) in
// fp32, mask dead slots with the validity bitmap and, when filtered, the
// slots whose attributes fail the predicate, and keep the k best. Only
// [Q, k] distances and labels, and the grouped route's scratch (below),
// reach device memory. The arithmetic is the plain version's
// (kernels/sivf_scan/ref.py) in the same order with the same roundings
// (dot_row.cuh: term d of a sum over d into lane d mod 8 of eight float32
// accumulators, each product and each sum rounded on its own, the lanes
// combined pairwise), so distances agree bit for bit.
//
// What the result is. The reference folds its table row column by column
// into a running top-k whose merge row is [running k | C candidates in
// slot order], the lowest merge-row index winning a tie. Every running
// entry comes from an earlier column than every new candidate, so the fold
// returns the k smallest candidates (d, t, c) under the total order
// (distance, table column t, slot c), in that order; `<` on floats ties
// -0.0 with +0.0, and every +inf result carries label -1. The k smallest
// of a total order are one set whatever the order the candidates are seen
// in, so slabs may be scored in any order and in parallel; and a candidate
// outside its own (q, t) entry's min(k, C) smallest under (d, c) can never
// reach the answer, so a per-entry partial top-k merged under
// (d, t, position) is exact (ref.py sivf_fused_search_split_ref, tested
// against the fold).
//
// What bounds it on this card: the bytes of the live rows of each probed
// slab, and the fp32 products and sums (no FMA: two instructions a term).
// The main path's table probes each slab about 15 times, so a design that
// reads a slab once per probing query streams 15x the bytes it needs.
//
// Two routes, chosen by the wrapper from shapes alone:
//  * grouped (k < C; its partials [Q, T, k] are then strictly smaller than
//    the unfused pair's [Q, T*C]): each probed slab is read once for all
//    the queries that probe it, up to kEntries of them at a time.
//     1. plan (slab_plan.cuh, shared with the unfused scan's route
//        grouped), on the card, no host sync: a histogram of the table's
//        live entries over slabs (and ||q||^2 per query); each probed slab
//        takes its range of entries and its work chunks (kEntries entries
//        of one slab each) by warp-aggregated atomics; each entry q * T + t
//        is scattered into its slab's range. The order of ranges, of
//        chunks and inside a range is free: every output is keyed by
//        (q, t).
//     2. scan: a persistent grid takes chunks from an atomic counter (the
//        next one's record read while this one is scored). A block
//        compacts the slab's live (and, filtered, passing: the predicate
//        runs once per slot for the whole batch) slots in slot order while
//        the chunk's query rows are copied to shared memory; then the
//        live rows are scored 32 at a time (slab_plan.cuh's score_chunk:
//        the pass's rows staged in shared memory, a row a lane of each
//        warp, warp w summing two of the eight lanes of every query, the
//        query loads broadcasts to the warp, the warps' pairs added in
//        shared memory; one instantiation for each count of queries).
//        Then a warp selects each of its
//        entries' k smallest under (d, position): rounds of warp minima on an
//        order-preserving key (-0.0 keyed as +0.0), its entries' rounds
//        side by side, each row of k written at once.
//     3. merge: a block per query compacts its live table columns and
//        folds their partials, in (t, position) order, with topk_fold.cuh's
//        fold (ties to the lower index); +inf is written as -1.
//  * per_query (k >= C): one thread block per query, one thread per slot,
//    the running top-k of topk_fold.cuh folded slab by slab (the first
//    port's kernel, kept where the grouped partials would not be smaller).
//
// Filtered (kFiltered): the predicate is a conjunction of leaves, passed as
// a flat int32 program of (kind, attr, n_consts) triples plus constants, so
// one compiled instantiation serves every predicate; a slot that fails
// reads no payload row. The unfiltered instantiation compiles the test out.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "dot_row.cuh"
#include "slab_plan.cuh"
#include "topk_fold.cuh"

namespace {

// ---------------------------------------------------------------------------
// Route per_query: one block per query
// ---------------------------------------------------------------------------

template <bool kL2, bool kFiltered>
__global__ void sivf_fused_search_kernel(
    const float* __restrict__ queries, const int* __restrict__ table,
    const float* __restrict__ data, const int* __restrict__ ids,
    const float* __restrict__ norms, const int* __restrict__ bitmap,
    const int* __restrict__ attrs, const int* __restrict__ prog,
    int n_leaves, const int* __restrict__ consts, int n_attrs,
    float* __restrict__ out_d, int* __restrict__ out_l,
    int t_len, int cap, int d_dim, int words, int k, bool vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [D] (padded to 4)
  const sivf::Fold fold = sivf::carve_fold(qs + ((d_dim + 3) & ~3), k);

  const int q = blockIdx.x;
  const int c = threadIdx.x;
  for (int i = c; i < d_dim; i += blockDim.x)
    qs[i] = queries[(size_t)q * d_dim + i];
  sivf::fold_init(fold, k);
  __syncthreads();
  const float qq = kL2 ? sivf::query_norm(qs, d_dim) : 0.f;

  const int* trow = table + (size_t)q * t_len;
  for (int t = 0; t < t_len; ++t) {
    const int slab = trow[t];
    if (slab < 0) continue;                      // uniform: one value per block
    const size_t slot = (size_t)slab * cap + c;
    const unsigned word = (unsigned)bitmap[(size_t)slab * words + (c >> 5)];
    bool live = (word >> (c & 31)) & 1u;
    if (kFiltered && live)
      live = sivf::passes(attrs + slot * n_attrs, prog, n_leaves, consts);
    float d = CUDART_INF_F;
    int lab = -1;
    if (live) {
      const float dot = sivf::dot_row(data + slot * d_dim, qs, d_dim, vec4);
      d = sivf::distance<kL2>(qq, dot, kL2 ? norms[slot] : 0.f);
      lab = ids[slot];
    }
    sivf::fold_candidates(fold, d, lab, k, cap);
  }
  sivf::fold_write(fold, out_d + (size_t)q * k, out_l + (size_t)q * k, k);
}

template <bool kL2, bool kFiltered>
void launch(const float* queries, const int* table, const float* data,
            const int* ids, const float* norms, const int* bitmap,
            const int* attrs, const int* prog, int n_leaves,
            const int* consts, int n_attrs, float* out_d, int* out_l,
            int n_queries, int t_len, int cap, int d_dim, int words, int k,
            bool vec4, size_t smem, cudaStream_t s) {
  sivf_fused_search_kernel<kL2, kFiltered><<<n_queries, cap, smem, s>>>(
      queries, table, data, ids, norms, bitmap, attrs, prog, n_leaves,
      consts, n_attrs, out_d, out_l, t_len, cap, d_dim, words, k, vec4);
}

// ---------------------------------------------------------------------------
// Route grouped: plan, scan, merge
// ---------------------------------------------------------------------------

using namespace sivf::group;   // the plan, the row scoring, their constants

constexpr int kMergeThreads = 128;       // merge block: one candidate a thread
constexpr int kWarpEntries = kEntries / kWarps;  // entries a warp selects at once
constexpr int kMergeSeg = 8 * kMergeThreads;   // table columns compacted at once

// The grouped route's device scratch, carved from one workspace of
// sivf_fused_search_grouped_scratch_bytes(): the plan (slab_plan.cuh), then
// the partials (4-byte elements).
struct Scratch {
  Plan plan;
  float* part_d;      // [Q * T * k] each live entry's k smallest ...
  int* part_l;        // [Q * T * k] ... and their labels
};

// The wrapper's fused.grouped_scratch_bytes() mirrors this formula (it sizes
// the workspace without a call into this library): change both together.
size_t scratch_words(int n_queries, int t_len, int n_slabs, int k) {
  const size_t n = (size_t)n_queries * t_len;
  return plan_words(n_queries, t_len, n_slabs) + 2 * n * (size_t)k;
}

Scratch carve(void* base, int n_queries, int t_len, int n_slabs, int k) {
  const size_t n = (size_t)n_queries * t_len;
  Scratch s;
  s.plan = carve_plan(base, n_queries, t_len, n_slabs, &s.part_d);
  s.part_l = reinterpret_cast<int*>(s.part_d + n * (size_t)k);
  return s;
}

// An unsigned key whose order is the floats' `<` order: -0.0 keys as +0.0,
// +inf above every finite value, NaN above +inf.
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned b = d == 0.f ? 0u : __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Each entry's k smallest of its row of n distances under (d, position),
// ascending, into part_d / part_l at entry * k (labels: labs[position]);
// +inf / -1 past the finite ones. One warp selects the chunk's entries
// warp, warp + kWarps, ... by rounds of warp minima on order_key, the
// lowest position winning a tie. With n <= 128 and k <= 32 (4 keys a lane
// in registers) its entries' rounds run side by side, branch-free, lane j
// keeps round j's position, and each row of k is written at once.
template <int kE>
__device__ __forceinline__ void select_entries(
    float* dist, int dstride, int ne, int n, int k, const int* labs,
    const int* ent, float* __restrict__ part_d, int* __restrict__ part_l) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned inf_key = order_key(CUDART_INF_F);
  if constexpr (kE > 1) {                // kE: ceil(ne / kWarps) entries
    if (ne <= kWarps * (kE - 1)) {
      select_entries<kE - 1>(dist, dstride, ne, n, k, labs, ent, part_d,
                             part_l);
      return;
    }
  }
  if (n <= 128 && k <= 32) {
    unsigned key[kE][4];
    int mine[kE];                        // lane j: round j's position
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = warp + kWarps * e;
      mine[e] = -1;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int p = lane + 32 * m;
        key[e][m] = i < ne && p < n ? order_key(dist[i * dstride + p])
                                    : 0xFFFFFFFFu;
      }
    }
    for (int j = 0; j < k; ++j) {
      bool more = false;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        unsigned best = key[e][0];
        int bm = 0;
#pragma unroll
        for (int m = 1; m < 4; ++m)
          if (key[e][m] < best) { best = key[e][m]; bm = m; }
        const unsigned wbest = __reduce_min_sync(~0u, best);
        const int p = lane + 32 * bm;
        const int wpos = __reduce_min_sync(~0u, best == wbest ? p : INT_MAX);
        const bool hit = wbest < inf_key;
        if (lane == j && hit) mine[e] = wpos;
        if (hit && wpos == p) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (m == bm) key[e][m] = 0xFFFFFFFFu;
        }
        more |= hit;
      }
      if (!more) break;                  // uniform: only +inf left
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {       // k contiguous lanes a row
      const int i = warp + kWarps * e;
      if (i < ne && lane < k) {
        const size_t at = (size_t)ent[i] * k + lane;
        part_d[at] = mine[e] < 0 ? CUDART_INF_F : dist[i * dstride + mine[e]];
        part_l[at] = mine[e] < 0 ? -1 : labs[mine[e]];
      }
    }
    return;
  }
  for (int i = warp; i < ne; i += kWarps) {
    float* row = dist + i * dstride;
    float* out_d = part_d + (size_t)ent[i] * k;
    int* out_l = part_l + (size_t)ent[i] * k;
    int j = 0;
    for (; j < k; ++j) {
      unsigned best = 0xFFFFFFFFu;
      int pos = INT_MAX;
      for (int p = lane; p < n; p += 32) {
        const unsigned key = order_key(row[p]);
        if (key < best) { best = key; pos = p; }
      }
      const unsigned wbest = __reduce_min_sync(~0u, best);
      if (wbest >= inf_key) break;
      const int wpos = __reduce_min_sync(~0u, best == wbest ? pos : INT_MAX);
      if (wpos == pos) {
        out_d[j] = row[pos];
        out_l[j] = labs[pos];
        row[pos] = CUDART_INF_F;
      }
      __syncwarp();
    }
    for (int jj = j + lane; jj < k; jj += 32) {
      out_d[jj] = CUDART_INF_F;
      out_l[jj] = -1;
    }
  }
}

__host__ __device__ constexpr size_t grouped_smem_bytes(int cap) {
  return sizeof(float) * ((size_t)kEntries * kQd +
                          (size_t)kEntries * (cap + 1) +
                          (size_t)kScoreFloats) +
         2 * sizeof(int) * (size_t)cap;
}

// 2. The scan: a chunk is up to kEntries entries of one slab.
// 5 blocks an SM (96 registers a thread): fewer measured slower; the
// filtered IP instance spills at 96, so it takes 4.
template <bool kL2, bool kFiltered>
__global__ void __launch_bounds__(kThreads, kL2 || !kFiltered ? 5 : 4)
    grouped_scan_kernel(
    const float* __restrict__ queries, const float* __restrict__ data,
    const int* __restrict__ ids, const float* __restrict__ norms,
    const int* __restrict__ bitmap, const int* __restrict__ attrs,
    const int* __restrict__ prog, int n_leaves,
    const int* __restrict__ consts, int n_attrs,
    const int4* __restrict__ chunks, const int* __restrict__ n_chunks,
    int* __restrict__ next_chunk, const int* __restrict__ entries,
    const float* __restrict__ qq, float* __restrict__ part_d,
    int* __restrict__ part_l, int t_len, int cap, int d_dim, int words,
    int k, bool vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);      // [kEntries][kQd]
  const int dstride = cap + 1;                      // distinct banks a row
  float* dist = qs + kEntries * kQd;                // [kEntries][dstride]
  int* live = reinterpret_cast<int*>(dist + kEntries * dstride);  // [cap]
  int* labs = live + cap;                           // [cap] live rows' ids
  float* sm = reinterpret_cast<float*>(labs + cap);  // [kScoreFloats]
  __shared__ int s_ent[kEntries];
  __shared__ float s_qq[kEntries];
  __shared__ int s_warp[kWarps];
  __shared__ int4 s_info;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = *n_chunks;
  if (tid == 0) {
    const int c = atomicAdd(next_chunk, 1);
    s_info = c < total ? chunks[c] : make_int4(-1, 0, 0, 0);
  }
  __syncthreads();
  for (;;) {
    const int4 info = s_info;
    if (info.x < 0) break;                          // uniform: no chunk left
    const int slab = info.x, ne = info.z;
    int c_next = 0;                                 // tid 0: the next chunk,
    if (tid == 0) c_next = atomicAdd(next_chunk, 1);  // read after scoring
    const size_t row0 = (size_t)slab * cap;
    // the first kQd columns of the chunk's query rows, copied while the
    // slots are compacted
    const int len0 = min(kQd, d_dim);
    stage_queries(qs, queries, entries + info.y, ne, t_len, d_dim, 0, len0);
    if (tid < ne) {
      const int e = entries[info.y + tid];
      s_ent[tid] = e;
      s_qq[tid] = kL2 ? qq[e / t_len] : 0.f;
    }
    // the slab's live (and passing) slots, compacted in slot order
    int n_live = 0;
    for (int c0 = 0; c0 < cap; c0 += kThreads) {
      const int c = c0 + tid;
      bool ok = false;
      if (c < cap) {
        ok = ((unsigned)bitmap[(size_t)slab * words + (c >> 5)] >> (c & 31)) &
             1u;
        if (kFiltered && ok)
          ok = sivf::passes(attrs + (row0 + c) * n_attrs, prog, n_leaves,
                            consts);
      }
      const unsigned b = __ballot_sync(~0u, ok);
      if (lane == 0) s_warp[warp] = __popc(b);
      __syncthreads();
      int before = n_live;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before += s_warp[w];
        n_live += s_warp[w];
      }
      if (ok) live[before + __popc(b & ((1u << lane) - 1u))] = c;
      __syncthreads();
    }
    cp_async_wait_all();
    __syncthreads();

    int4 next = make_int4(-1, 0, 0, 0);             // read while scoring
    if (tid == 0 && c_next < total) next = chunks[c_next];

    // the live rows scored against the chunk's queries (slab_plan.cuh)
    for (int r = tid; r < n_live; r += kThreads) labs[r] = ids[row0 + live[r]];
    score_chunk(ne, queries, entries + info.y, t_len, d_dim, data, row0, live,
                n_live, vec4, qs, sm, [&](int j, int r, float dot) {
                  dist[j * dstride + r] = sivf::distance<kL2>(
                      s_qq[j], dot, kL2 ? norms[row0 + live[r]] : 0.f);
                });
    __syncthreads();
    select_entries<kWarpEntries>(dist, dstride, ne, n_live, k, labs, s_ent,
                                 part_d, part_l);
    if (tid == 0) s_info = next;
    __syncthreads();
  }
}

// 3. The merge: a block per query compacts its live table columns
// kMergeSeg at a time and folds their partials in (t, position) order;
// ties go to the lower index, +inf is written as -1.
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    const int* __restrict__ table, int t_len, int n_slabs,
    const float* __restrict__ part_d, const int* __restrict__ part_l,
    float* __restrict__ out_d, int* __restrict__ out_l, int k) {
  extern __shared__ float4 smem4[];
  const sivf::Fold fold = sivf::carve_fold(reinterpret_cast<float*>(smem4), k);
  __shared__ int cols[kMergeSeg];
  __shared__ int warp_sum[kMergeThreads / 32];
  const int q = blockIdx.x, tid = threadIdx.x;
  sivf::fold_init(fold, k);
  const int* trow = table + (size_t)q * t_len;
  const size_t row = (size_t)q * t_len * k;
  const int step_t = kMergeThreads / k, step_j = kMergeThreads % k;
  for (int t0 = 0; t0 < t_len; t0 += kMergeSeg) {
    const int tb = t0 + 8 * tid;
    unsigned flags = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int s = tb + u < t_len ? trow[tb + u] : -1;
      flags |= (unsigned)(s >= 0 && s < n_slabs) << u;
    }
    int n_cols;
    int at = sivf::block_exclusive_scan<kMergeThreads>(__popc(flags),
                                                       &n_cols, warp_sum);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if ((flags >> u) & 1u) cols[at++] = tb + u;
    __syncthreads();
    // this thread's candidate (column li, position j), kMergeThreads apart
    int li = tid / k, j = tid % k;
    for (int i0 = 0; i0 < n_cols * k; i0 += kMergeThreads) {
      float d = CUDART_INF_F;
      int lab = -1;
      if (li < n_cols) {
        const size_t p = row + (size_t)cols[li] * k + j;
        d = part_d[p];
        lab = part_l[p];
      }
      sivf::fold_candidates(fold, d, lab, k, kMergeThreads);
      li += step_t;
      j += step_j;
      if (j >= k) {
        j -= k;
        ++li;
      }
    }
    __syncthreads();                                // cols reused
  }
  sivf::fold_write(fold, out_d + (size_t)q * k, out_l + (size_t)q * k, k);
}

template <bool kL2, bool kFiltered>
int launch_grouped(const float* queries, const int* table, const float* data,
                   const int* ids, const float* norms, const int* bitmap,
                   const int* attrs, const int* prog, int n_leaves,
                   const int* consts, int n_attrs, float* out_d, int* out_l,
                   int n_queries, int t_len, int n_slabs, int cap, int d_dim,
                   int words, int k, bool vec4, const Scratch& w,
                   cudaStream_t s) {
  const long long n = (long long)n_queries * t_len;
  const Plan& p = w.plan;
  cudaError_t err =
      launch_plan(table, n_queries, t_len, n_slabs, queries, d_dim, p, s);
  if (err) return err;
  auto* kern = &grouped_scan_kernel<kL2, kFiltered>;
  const size_t smem = grouped_smem_bytes(cap);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err) return err;
  const long long most = (long long)max_chunks((size_t)n, n_slabs);
  const int blocks = (int)std::max<long long>(
      1, std::min<long long>((long long)sm_count() * std::max(per_sm, 1),
                             most));
  kern<<<blocks, kThreads, smem, s>>>(
      queries, data, ids, norms, bitmap, attrs, prog, n_leaves, consts,
      n_attrs, p.chunks, p.counters + 1, p.counters + 2, p.entries, p.qq,
      w.part_d, w.part_l, t_len, cap, d_dim, words, k, vec4);
  err = cudaGetLastError();
  if (err) return err;
  merge_kernel<<<n_queries, kMergeThreads, sivf::fold_smem_bytes(
                                               k, kMergeThreads), s>>>(
      table, t_len, n_slabs, w.part_d, w.part_l, out_d, out_l, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t sivf_fused_search_smem_bytes(int d_dim, int cap, int k) {
  return sizeof(float) * (size_t)((d_dim + 3) & ~3) +
         sivf::fold_smem_bytes(k, cap);
}

// Launches the per_query route on `stream`; returns the cudaError_t of the
// launch (0 = ok). `attrs` null selects the unfiltered instantiation (prog,
// consts unused); otherwise attrs [S, C, n_attrs], prog [3 * n_leaves],
// consts int32.
extern "C" int sivf_fused_search_launch(
    const float* queries, const int* table, const float* data,
    const int* ids, const float* norms, const int* bitmap, const int* attrs,
    const int* prog, int n_leaves, const int* consts, int n_attrs,
    float* out_d, int* out_l, int n_queries, int t_len, int cap, int d_dim,
    int words, int k, int metric_l2, void* stream) {
  if (n_queries == 0) return 0;
  const size_t smem = sivf_fused_search_smem_bytes(d_dim, cap, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 loads need every payload row 16-byte aligned
  const bool vec4 = (d_dim % 4 == 0) &&
                    (reinterpret_cast<size_t>(data) % 16 == 0);
  auto* fn = metric_l2 ? (attrs ? &launch<true, true> : &launch<true, false>)
                       : (attrs ? &launch<false, true> : &launch<false, false>);
  fn(queries, table, data, ids, norms, bitmap, attrs, prog, n_leaves, consts,
     n_attrs, out_d, out_l, n_queries, t_len, cap, d_dim, words, k, vec4,
     smem, s);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the grouped route's scratch workspace for these shapes.
extern "C" size_t sivf_fused_search_grouped_scratch_bytes(
    int n_queries, int t_len, int n_slabs, int k) {
  return sizeof(int) * scratch_words(n_queries, t_len, n_slabs, k);
}

// Launches the grouped route (plan, scan, merge) on `stream`; returns the
// first cudaError_t (0 = ok). `scratch` holds scratch_bytes bytes, at least
// sivf_fused_search_grouped_scratch_bytes(); arguments otherwise as for
// sivf_fused_search_launch. Reads no device value on the host.
extern "C" int sivf_fused_search_grouped_launch(
    const float* queries, const int* table, const float* data,
    const int* ids, const float* norms, const int* bitmap, const int* attrs,
    const int* prog, int n_leaves, const int* consts, int n_attrs,
    float* out_d, int* out_l, int n_queries, int t_len, int n_slabs, int cap,
    int d_dim, int words, int k, int metric_l2, void* scratch,
    size_t scratch_bytes, void* stream) {
  if (n_queries == 0) return 0;
  if (scratch_bytes <
      sivf_fused_search_grouped_scratch_bytes(n_queries, t_len, n_slabs, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch w = carve(scratch, n_queries, t_len, n_slabs, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8-byte cp.async of payload rows: 16-byte aligned rows
  const bool vec4 = (d_dim % 4 == 0) &&
                    (reinterpret_cast<size_t>(data) % 16 == 0);
  auto* fn = metric_l2 ? (attrs ? &launch_grouped<true, true>
                                : &launch_grouped<true, false>)
                       : (attrs ? &launch_grouped<false, true>
                                : &launch_grouped<false, false>);
  return fn(queries, table, data, ids, norms, bitmap, attrs, prog, n_leaves,
            consts, n_attrs, out_d, out_l, n_queries, t_len, n_slabs, cap,
            d_dim, words, k, vec4, w, s);
}
