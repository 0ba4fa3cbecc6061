// Unfused slab scan for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/sivf_scan/sivf_scan.py::sivf_scan_pallas: for each
// query q and each entry t of its slab table row, every slot c of the slab
// gets a distance and a label, written at (q * T + t) * C + c of the
// [Q, T*C] outputs. A live slot (table entry >= 0, validity bit set)
// scores ||q||^2 - 2 q.x + ||x||^2 (L2) or -q.x (IP) and carries its id;
// any other slot is +inf / -1. The arithmetic is dot_row.cuh's, the same
// as the fused kernel's (sivf_fused_search.cu) and the plain version's
// (kernels/sivf_scan/ref.py), so on one table the top-k of these outputs
// (topk.cu) equals the fused kernel's result bit for bit.
//
// What bounds it on this card: bytes. The [Q, T*C] outputs are 8 bytes a
// slot whether the slot is live or not (1 GiB at Q = T = 1024, C = 128:
// 0.32 ms at the H100 SXM's published 3.35 TB/s), and on the main path's
// table about 90 % of them belong to -1 entries; the live rows of the
// distinct probed slabs add about a third of that. A design that reads a
// slab once per probing query reads those rows about 15 times.
//
// Two routes, chosen by the wrapper from shapes alone:
//  * grouped (C <= 1024, Q*T < 2**31): each probed slab is read once for
//    all the queries that probe it, up to kEntries of them at a time.
//     1. the plan of slab_plan.cuh (shared with kernel 1's route grouped):
//        the table inverted on the card into chunks of one slab's live
//        (q, t) entries, with no host sync.
//     2. one persistent kernel takes work items from an atomic counter (the
//        next item's record read while this one is worked on), two kinds
//        spread evenly over one sequence so that an SM mixes them:
//        - a chunk: the slab's live slots are compacted in slot order while
//          the chunk's query rows and ||q||^2 are staged; the live rows
//          are scored 32 at a time (slab_plan.cuh's score_chunk); the
//          distances land in shared memory in slot order
//          (dead slots +inf, their labels -1), and each entry's C distances
//          and labels are written as 16-byte stores, C * 4 contiguous
//          bytes a plane;
//        - a fill tile: kFill consecutive table entries, whose rows are
//          contiguous in the outputs; the tile's table entries are read at
//          once, then the rows of those outside [0, n_slabs) (not in the
//          plan) are written +inf / -1, a warp a row, 16 bytes a store.
//        Every output byte is written exactly once. Interleaving the two
//        kinds measured faster than either kind first; the chunks, whose
//        cost is mostly fixed per chunk, overlap the fill only a little.
//  * per_entry (any C): the first port's kernel. One warp per (query,
//    table entry), a block holding kWarpsPerEntryBlock consecutive entries
//    of one query whose row is staged in shared memory once; lane l scores
//    slots l, l + 32, ... (each store of the warp writes 32 consecutive
//    floats); a -1 entry writes its +inf / -1 row and reads no slab. The
//    grid is one-dimensional (gridDim.y stops at 65,535); offsets are
//    64-bit.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

#include "dot_row.cuh"
#include "slab_plan.cuh"

namespace {

// ---------------------------------------------------------------------------
// Route per_entry: one warp per (query, table entry)
// ---------------------------------------------------------------------------

constexpr int kWarpsPerEntryBlock = 8;   // table entries (warps) per block

template <bool kL2>
__global__ void sivf_scan_kernel(
    const float* __restrict__ queries, const int* __restrict__ table,
    const float* __restrict__ data, const int* __restrict__ ids,
    const float* __restrict__ norms, const int* __restrict__ bitmap,
    float* __restrict__ out_d, int* __restrict__ out_l, int t_len,
    int t_blocks, int cap, int d_dim, int words, bool vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [D] (padded to 4)

  const int q = blockIdx.x / t_blocks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = (blockIdx.x % t_blocks) * kWarpsPerEntryBlock + warp;
  for (int i = threadIdx.x; i < d_dim; i += blockDim.x)
    qs[i] = queries[(size_t)q * d_dim + i];
  __syncthreads();
  if (t >= t_len) return;                        // ragged last block

  const int slab = table[(size_t)q * t_len + t];
  const size_t base = ((size_t)q * t_len + t) * cap;
  float* od = out_d + base;
  int* ol = out_l + base;
  if (slab < 0) {                                // uniform across the warp
    for (int c = lane; c < cap; c += 32) {
      od[c] = CUDART_INF_F;
      ol[c] = -1;
    }
    return;
  }
  const float qq = kL2 ? sivf::query_norm(qs, d_dim) : 0.f;
  const int* words_of = bitmap + (size_t)slab * words;
  for (int c = lane; c < cap; c += 32) {
    // bit 31 makes the int32 word negative: shift it as unsigned
    const unsigned word = (unsigned)__ldg(words_of + (c >> 5));
    float d = CUDART_INF_F;
    int lab = -1;
    if ((word >> (c & 31)) & 1u) {
      const size_t slot = (size_t)slab * cap + c;
      const float dot = sivf::dot_row(data + slot * d_dim, qs, d_dim, vec4);
      d = sivf::distance<kL2>(qq, dot, kL2 ? __ldg(norms + slot) : 0.f);
      lab = __ldg(ids + slot);
    }
    od[c] = d;
    ol[c] = lab;
  }
}

// ---------------------------------------------------------------------------
// Route grouped: plan, then chunks and fill tiles in one persistent kernel
// ---------------------------------------------------------------------------

using namespace sivf::group;   // the plan, the row scoring, their constants

constexpr int kFill = 256;     // table entries of one fill tile

// Work item w of n_chunks + n_fill, the chunks spread evenly among the fill
// tiles: (slab, first entry, entries, 0) for a chunk, (-1, tile, 0, 0) for
// a fill tile, (-2, ...) past the end.
__device__ __forceinline__ int4 item_of(long long w, long long n_chunks,
                                        long long total,
                                        const int4* __restrict__ chunks) {
  if (w >= total) return make_int4(-2, 0, 0, 0);
  const long long a0 = w * n_chunks / total;
  const long long a1 = (w + 1) * n_chunks / total;
  if (a1 > a0) return chunks[a0];
  return make_int4(-1, (int)(w - a0), 0, 0);
}

// Shared memory of the grouped kernel: staged query columns, the chunk's
// distances, labels and live slots, and the scoring's rows and pairs.
constexpr size_t grouped_smem_bytes(int cap) {
  return sizeof(float) * ((size_t)kEntries * kQd + (size_t)kEntries * cap +
                          (size_t)kScoreFloats) +
         2 * sizeof(int) * (size_t)cap;
}

// 5 blocks an SM (96 registers a thread): fewer measured slower.
template <bool kL2>
__global__ void __launch_bounds__(kThreads, 5) grouped_scan_kernel(
    const float* __restrict__ queries, const int* __restrict__ table,
    const float* __restrict__ data, const int* __restrict__ ids,
    const float* __restrict__ norms, const int* __restrict__ bitmap,
    const int4* __restrict__ chunks, const int* __restrict__ n_chunks,
    int* __restrict__ next_item, const int* __restrict__ entries,
    const float* __restrict__ qq, float* __restrict__ out_d,
    int* __restrict__ out_l, long long n_entries, int t_len, int n_slabs,
    int cap, int d_dim, int words, bool vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);      // [kEntries][kQd]
  float* dist = qs + kEntries * kQd;                // [kEntries][cap]
  int* labs = reinterpret_cast<int*>(dist + kEntries * cap);   // [cap]
  int* live = labs + cap;                           // [cap] live slots
  float* sm = reinterpret_cast<float*>(live + cap);  // [kScoreFloats]
  __shared__ int s_ent[kEntries];
  __shared__ float s_qq[kEntries];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tab[kFill];                      // fill: entry in the plan?
  __shared__ int4 s_info;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long nc = *n_chunks;
  const long long total = nc + (n_entries + kFill - 1) / kFill;
  const int c4 = cap >> 2;                          // 16-byte stores a row
  if (tid == 0) s_info = item_of(atomicAdd(next_item, 1), nc, total, chunks);
  __syncthreads();
  for (;;) {
    const int4 info = s_info;
    if (info.x == -2) break;                        // uniform: no item left
    int w_next = 0;                                 // tid 0: the next item,
    if (tid == 0) w_next = atomicAdd(next_item, 1); // decoded during this one
    int4 nxt = make_int4(-2, 0, 0, 0);
    if (info.x < 0) {
      // a fill tile: the rows of its entries that are not in the plan, the
      // tile's table entries read at once, then a warp an entry
      const long long e0 = (long long)info.y * kFill;
      const int cnt = (int)(n_entries - e0 < kFill ? n_entries - e0 : kFill);
      for (int i = tid; i < cnt; i += kThreads) {
        const int s = table[e0 + i];
        s_tab[i] = s >= 0 && s < n_slabs;
      }
      __syncthreads();
      if (tid == 0) nxt = item_of(w_next, nc, total, chunks);
      const float4 inf4 = make_float4(CUDART_INF_F, CUDART_INF_F,
                                      CUDART_INF_F, CUDART_INF_F);
      const int4 none4 = make_int4(-1, -1, -1, -1);
      for (int e = warp; e < cnt; e += kWarps) {
        if (s_tab[e]) continue;                     // uniform per warp
        const size_t base = (size_t)(e0 + e) * cap;
        for (int j = 4 * lane; j < cap; j += 128) {
          *reinterpret_cast<float4*>(out_d + base + j) = inf4;
          *reinterpret_cast<int4*>(out_l + base + j) = none4;
        }
      }
    } else {
      // a chunk: up to kEntries live entries of one slab
      const int slab = info.x, ne = info.z;
      const size_t row0 = (size_t)slab * cap;
      const int len0 = min(kQd, d_dim);
      stage_queries(qs, queries, entries + info.y, ne, t_len, d_dim, 0, len0);
      if (tid < ne) {
        const int e = entries[info.y + tid];
        s_ent[tid] = e;
        s_qq[tid] = kL2 ? qq[e / t_len] : 0.f;
      }
      // the slab's live slots, compacted in slot order; a dead slot's
      // distances are +inf and its label -1
      int n_live = 0;
      for (int c0 = 0; c0 < cap; c0 += kThreads) {
        const int c = c0 + tid;
        bool ok = false;
        if (c < cap) {
          ok = ((unsigned)bitmap[(size_t)slab * words + (c >> 5)] >>
                (c & 31)) & 1u;
          labs[c] = ok ? ids[row0 + c] : -1;
          if (!ok)
            for (int i = 0; i < ne; ++i) dist[i * cap + c] = CUDART_INF_F;
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
      // the next item's record, read while this chunk is scored
      if (tid == 0) nxt = item_of(w_next, nc, total, chunks);
      // the live rows scored against the chunk's queries (slab_plan.cuh)
      score_chunk(ne, queries, entries + info.y, t_len, d_dim, data, row0,
                  live, n_live, vec4, qs, sm, [&](int j, int r, float dot) {
                    const int c = live[r];
                    dist[j * cap + c] = sivf::distance<kL2>(
                        s_qq[j], dot, kL2 ? norms[row0 + c] : 0.f);
                  });
      __syncthreads();
      // each entry's row of C distances and labels, 16 bytes a store
      for (int i = tid; i < ne * c4; i += kThreads) {
        const int r = i / c4, j = 4 * (i - r * c4);
        const size_t at = (size_t)s_ent[r] * cap + j;
        *reinterpret_cast<float4*>(out_d + at) =
            *reinterpret_cast<const float4*>(dist + r * cap + j);
        *reinterpret_cast<int4*>(out_l + at) =
            *reinterpret_cast<const int4*>(labs + j);
      }
    }
    if (tid == 0) s_info = nxt;
    __syncthreads();
  }
}

template <bool kL2>
int launch_grouped(const float* queries, const int* table, const float* data,
                   const int* ids, const float* norms, const int* bitmap,
                   float* out_d, int* out_l, int n_queries, int t_len,
                   int n_slabs, int cap, int d_dim, int words, bool vec4,
                   const Plan& p, cudaStream_t s) {
  cudaError_t err =
      launch_plan(table, n_queries, t_len, n_slabs, queries, d_dim, p, s);
  if (err) return err;
  auto* kern = &grouped_scan_kernel<kL2>;
  const size_t smem = grouped_smem_bytes(cap);
  // the shared-memory limit and the occupancy it allows, set and asked once
  // per device and size (host calls that cost more than the launch itself)
  static int known_dev = -1, per_sm = 0;
  static size_t known_smem = 0;
  int dev;
  err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev != known_dev || smem != known_smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
    if (err) return err;
    known_dev = dev;
    known_smem = smem;
  }
  const long long n = (long long)n_queries * t_len;
  const long long most =
      (long long)max_chunks((size_t)n, n_slabs) + (n + kFill - 1) / kFill;
  const int blocks = (int)std::max<long long>(
      1, std::min<long long>((long long)sm_count() * std::max(per_sm, 1),
                             most));
  kern<<<blocks, kThreads, smem, s>>>(
      queries, table, data, ids, norms, bitmap, p.chunks, p.counters + 1,
      p.counters + 2, p.entries, p.qq, out_d, out_l, n, t_len, n_slabs, cap,
      d_dim, words, vec4);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t sivf_scan_smem_bytes(int d_dim) {
  return sizeof(float) * (size_t)((d_dim + 3) & ~3);
}

// Launches the per_entry route on `stream`; returns the cudaError_t of the
// launch (0 = ok). queries [Q, D], table [Q, T] int32 (-1 pad), data
// [S, C, D], ids and norms [S, C], bitmap [S, W] int32 words -> out_d,
// out_l [Q, T*C].
extern "C" int sivf_scan_launch(
    const float* queries, const int* table, const float* data,
    const int* ids, const float* norms, const int* bitmap, float* out_d,
    int* out_l, int n_queries, int t_len, int cap, int d_dim, int words,
    int metric_l2, void* stream) {
  if (n_queries == 0 || t_len == 0) return 0;
  const int t_blocks = (t_len + kWarpsPerEntryBlock - 1) / kWarpsPerEntryBlock;
  const long long blocks = (long long)n_queries * t_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sivf_scan_smem_bytes(d_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 loads need every payload row 16-byte aligned
  const bool vec4 = (d_dim % 4 == 0) &&
                    (reinterpret_cast<size_t>(data) % 16 == 0);
  const dim3 grid((unsigned)blocks), block(kWarpsPerEntryBlock * 32);
  if (metric_l2)
    sivf_scan_kernel<true><<<grid, block, smem, s>>>(
        queries, table, data, ids, norms, bitmap, out_d, out_l, t_len,
        t_blocks, cap, d_dim, words, vec4);
  else
    sivf_scan_kernel<false><<<grid, block, smem, s>>>(
        queries, table, data, ids, norms, bitmap, out_d, out_l, t_len,
        t_blocks, cap, d_dim, words, vec4);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the grouped route's scratch workspace (the plan) for these
// shapes; the wrapper's fused.plan_bytes() gives the same.
extern "C" size_t sivf_scan_grouped_scratch_bytes(int n_queries, int t_len,
                                                  int n_slabs) {
  return sizeof(int) * plan_words(n_queries, t_len, n_slabs);
}

// Launches the grouped route (plan, then one persistent kernel) on
// `stream`; returns the first cudaError_t (0 = ok). `scratch` holds
// scratch_bytes bytes, at least sivf_scan_grouped_scratch_bytes(); C a
// multiple of 32 up to 1024 and out_d / out_l 16-byte aligned (the wrapper
// checks). Reads no device value on the host.
extern "C" int sivf_scan_grouped_launch(
    const float* queries, const int* table, const float* data,
    const int* ids, const float* norms, const int* bitmap, float* out_d,
    int* out_l, int n_queries, int t_len, int n_slabs, int cap, int d_dim,
    int words, int metric_l2, void* scratch, size_t scratch_bytes,
    void* stream) {
  if (n_queries == 0 || t_len == 0) return 0;
  if (scratch_bytes < sivf_scan_grouped_scratch_bytes(n_queries, t_len,
                                                      n_slabs) ||
      cap % 32 || cap > 1024 || reinterpret_cast<size_t>(out_d) % 16 ||
      reinterpret_cast<size_t>(out_l) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  float* rest;
  const Plan p = carve_plan(scratch, n_queries, t_len, n_slabs, &rest);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8-byte cp.async of payload rows: 16-byte aligned rows
  const bool vec4 = (d_dim % 4 == 0) &&
                    (reinterpret_cast<size_t>(data) % 16 == 0);
  auto* fn = metric_l2 ? &launch_grouped<true> : &launch_grouped<false>;
  return fn(queries, table, data, ids, norms, bitmap, out_d, out_l,
            n_queries, t_len, n_slabs, cap, d_dim, words, vec4, p, s);
}
