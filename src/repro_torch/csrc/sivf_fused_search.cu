// Fused slab scan -> top-k search for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/sivf_scan/fused.py::sivf_fused_search_pallas,
// unfiltered and filtered: for each query, score every live slot of every
// slab in its table row as ||q||^2 - 2 q.x + ||x||^2 (L2) or -q.x (IP) in
// fp32, mask dead slots with the validity bitmap and, when filtered, the
// slots whose attributes fail the predicate, and fold the candidates into
// a running top-k (topk_fold.cuh). Only [Q, k] distances and labels reach
// device memory. The arithmetic is the plain version's
// (kernels/sivf_scan/ref.py) in the same order with the same roundings,
// so distances agree bit for bit.
//
// Design (simple and correct first):
//  * one thread block per query, one thread per slab slot (blockDim = C);
//    the query row is staged in shared memory and the block loops over the
//    T entries of its table row. A -1 entry is skipped before any load; the
//    test reads one value that every thread sees, so the skip is uniform.
//  * thread c reads slot c's payload row, with float4 loads when rows are
//    16-byte aligned.
//  * filtered (kFiltered): the predicate is a conjunction of leaves (the
//    algebra is closed under And only), passed as a flat int32 program of
//    (kind, attr, n_consts) triples plus its constants, so one compiled
//    instantiation serves every predicate. A live slot reads its attribute
//    row in place from the state's [S, C, A] plane; a slot that fails reads
//    no payload. The unfiltered instantiation compiles the test away.
//
// What bounds it on this card: bytes of live slabs read (C*D*4 + C*8 + W*4
// per live table entry); the FMAs are a small fraction of fp32 peak. The
// design does nothing about that yet: each query reads its own slabs, with
// no reuse across queries that probe the same lists and no asynchronous
// staging (cp.async / TMA). Later work does those.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dot_row.cuh"
#include "topk_fold.cuh"

namespace {

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

}  // namespace

extern "C" size_t sivf_fused_search_smem_bytes(int d_dim, int cap, int k) {
  return sizeof(float) * (size_t)((d_dim + 3) & ~3) +
         sivf::fold_smem_bytes(k, cap);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `attrs` null selects the unfiltered instantiation (prog, consts unused);
// otherwise attrs [S, C, n_attrs], prog [3 * n_leaves], consts int32.
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
