// Fused slab scan -> top-k search for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/sivf_scan/fused.py::sivf_fused_search_pallas (the
// unfiltered variant): for each query, score every live slot of every slab
// in its table row as ||q||^2 - 2 q.x + ||x||^2 (L2) or -q.x (IP) in fp32,
// mask dead slots with the validity bitmap, and fold the candidates into a
// running top-k. Only [Q, k] distances and labels reach device memory.
// The arithmetic is the plain version's (kernels/sivf_scan/ref.py) in the
// same order with the same roundings, so distances agree bit for bit.
//
// Design (simple and correct first):
//  * one thread block per query, one thread per slab slot (blockDim = C);
//    the query row is staged in shared memory and the block loops over the
//    T entries of its table row. A -1 entry is skipped before any load; the
//    test reads one value that every thread sees, so the skip is uniform.
//  * thread c reads slot c's payload row, with float4 loads when rows are
//    16-byte aligned.
//  * fold: the merge row is [running k | C candidates in slot order],
//    ordered by (distance, merge-row index). Rank-based selection: a
//    candidate can enter only if it beats the current k-th entry strictly
//    (the running entry has the lower index), and __syncthreads_count skips
//    the fold when none does. Each entering candidate counts the running
//    entries <= it and the entering candidates that beat it; each running
//    entry j moves to j + (candidates < it). Ranks are distinct, so every
//    output position has exactly one writer. Every +inf result carries -1.
//
// What bounds it on this card: bytes of live slabs read (C*D*4 + C*8 + W*4
// per live table entry); the FMAs are a small fraction of fp32 peak. The
// design does nothing about that yet: each query reads its own slabs, with
// no reuse across queries that probe the same lists and no asynchronous
// staging (cp.async / TMA). Later work does those.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// q.x summed in index order, each product and sum rounded on its own (no
// fused multiply-add): the plain version's arithmetic, bit for bit.
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

template <bool kL2>
__global__ void sivf_fused_search_kernel(
    const float* __restrict__ queries, const int* __restrict__ table,
    const float* __restrict__ data, const int* __restrict__ ids,
    const float* __restrict__ norms, const int* __restrict__ bitmap,
    float* __restrict__ out_d, int* __restrict__ out_l,
    int t_len, int cap, int d_dim, int words, int k, bool vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [D] (padded to 4)
  float* run_d = qs + ((d_dim + 3) & ~3);          // [k]
  int* run_l = reinterpret_cast<int*>(run_d + k);  // [k]
  float* new_d = reinterpret_cast<float*>(run_l + k);
  int* new_l = reinterpret_cast<int*>(new_d + k);
  float* cand_d = reinterpret_cast<float*>(new_l + k);  // [C]

  const int q = blockIdx.x;
  const int c = threadIdx.x;
  for (int i = c; i < d_dim; i += blockDim.x)
    qs[i] = queries[(size_t)q * d_dim + i];
  for (int j = c; j < k; j += blockDim.x) {
    run_d[j] = CUDART_INF_F;
    run_l[j] = -1;
  }
  __syncthreads();
  float qq = 0.f;
  if (kL2) {
    for (int i = 0; i < d_dim; ++i)
      qq = __fadd_rn(qq, __fmul_rn(qs[i], qs[i]));
  }

  const int* trow = table + (size_t)q * t_len;
  for (int t = 0; t < t_len; ++t) {
    const int slab = trow[t];
    if (slab < 0) continue;                      // uniform: one value per block
    const size_t slot = (size_t)slab * cap + c;
    const unsigned word = (unsigned)bitmap[(size_t)slab * words + (c >> 5)];
    float d = CUDART_INF_F;
    int lab = -1;
    if ((word >> (c & 31)) & 1u) {
      const float dot = dot_row(data + slot * d_dim, qs, d_dim, vec4);
      d = kL2 ? __fadd_rn(__fsub_rn(qq, __fmul_rn(2.f, dot)), norms[slot])
              : -dot;
      lab = ids[slot];
    }
    const bool enter = d < run_d[k - 1];
    if (__syncthreads_count(enter) == 0) continue;   // uniform
    cand_d[c] = enter ? d : CUDART_INF_F;
    __syncthreads();
    if (enter) {
      int r = 0;
      for (int j = 0; j < k; ++j) r += run_d[j] <= d;
      for (int o = 0; o < cap; ++o) {
        const float e = cand_d[o];
        r += (e < d) || (e == d && o < c);
      }
      if (r < k) {
        new_d[r] = d;
        new_l[r] = lab;
      }
    }
    for (int j = c; j < k; j += blockDim.x) {
      const float dj = run_d[j];
      int r = j;
      for (int o = 0; o < cap; ++o) r += cand_d[o] < dj;
      if (r < k) {
        new_d[r] = dj;
        new_l[r] = run_l[j];
      }
    }
    __syncthreads();
    for (int j = c; j < k; j += blockDim.x) {
      run_d[j] = new_d[j];
      run_l[j] = new_l[j];
    }
    __syncthreads();
  }
  for (int j = c; j < k; j += blockDim.x) {
    const float dj = run_d[j];
    out_d[(size_t)q * k + j] = dj;
    out_l[(size_t)q * k + j] = isinf(dj) ? -1 : run_l[j];
  }
}

}  // namespace

extern "C" size_t sivf_fused_search_smem_bytes(int d_dim, int cap, int k) {
  return sizeof(float) * (size_t)(((d_dim + 3) & ~3) + 4 * k + cap);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int sivf_fused_search_launch(
    const float* queries, const int* table, const float* data,
    const int* ids, const float* norms, const int* bitmap, float* out_d,
    int* out_l, int n_queries, int t_len, int cap, int d_dim, int words,
    int k, int metric_l2, void* stream) {
  if (n_queries == 0) return 0;
  const size_t smem = sivf_fused_search_smem_bytes(d_dim, cap, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 loads need every payload row 16-byte aligned
  const bool vec4 = (d_dim % 4 == 0) &&
                    (reinterpret_cast<size_t>(data) % 16 == 0);
  if (metric_l2) {
    sivf_fused_search_kernel<true><<<n_queries, cap, smem, s>>>(
        queries, table, data, ids, norms, bitmap, out_d, out_l, t_len, cap,
        d_dim, words, k, vec4);
  } else {
    sivf_fused_search_kernel<false><<<n_queries, cap, smem, s>>>(
        queries, table, data, ids, norms, bitmap, out_d, out_l, t_len, cap,
        d_dim, words, k, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
