// Running top-k fold, predicate test and block scan shared by the fused
// scan kernels (sivf_fused_search.cu, sivf_pq_fused_search.cu). Hopper
// (sm_90a).
//
// The fold serves the kernels' per_query routes, one thread block per
// query and one thread per slab slot, and kernel 1's grouped merge. After
// scoring a slab, every thread holds one candidate (distance, label;
// +inf / -1 for a dead, padded or filtered-out slot) and the block folds
// the C candidates into its running top-k, kept in shared memory.
//
// The fold reproduces the reference's merge exactly
// (repro/kernels/sivf_scan/fused.py:61-91): the merge row is
// [running k | C candidates in slot order], ordered by (distance,
// merge-row index), so on ties the lower index wins; every +inf result
// carries label -1. Selection is by rank: a candidate can enter only if
// it beats the current k-th entry strictly (the running entry has the
// lower index), and __syncthreads_count skips the fold when none does.
// Each entering candidate counts the running entries <= it and the
// entering candidates that beat it; each running entry j moves to
// j + (candidates < it). Ranks are distinct, so every output position has
// exactly one writer.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace sivf {

// The fold's shared-memory arrays, carved from one float-aligned buffer:
// run_d/run_l [k] (the running top-k), new_d/new_l [k] (the next one),
// cand_d [C] (this slab's entering candidates).
struct Fold {
  float* run_d;
  int* run_l;
  float* new_d;
  int* new_l;
  float* cand_d;
};

__host__ __device__ constexpr size_t fold_smem_bytes(int k, int cap) {
  return sizeof(float) * (4 * (size_t)k + (size_t)cap);
}

__device__ __forceinline__ Fold carve_fold(float* base, int k) {
  Fold f;
  f.run_d = base;
  f.run_l = reinterpret_cast<int*>(f.run_d + k);
  f.new_d = reinterpret_cast<float*>(f.run_l + k);
  f.new_l = reinterpret_cast<int*>(f.new_d + k);
  f.cand_d = reinterpret_cast<float*>(f.new_l + k);
  return f;
}

// Empty running top-k. The caller synchronises before the first fold.
__device__ __forceinline__ void fold_init(const Fold& f, int k) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    f.run_d[j] = CUDART_INF_F;
    f.run_l[j] = -1;
  }
}

// Fold thread c's candidate (d, lab) into the running top-k. Every thread
// of the block calls it with its own slot c = threadIdx.x (cap threads).
__device__ __forceinline__ void fold_candidates(const Fold& f, float d,
                                                int lab, int k, int cap) {
  const int c = threadIdx.x;
  const bool enter = d < f.run_d[k - 1];
  if (__syncthreads_count(enter) == 0) return;   // uniform
  f.cand_d[c] = enter ? d : CUDART_INF_F;
  __syncthreads();
  if (enter) {
    int r = 0;
    for (int j = 0; j < k; ++j) r += f.run_d[j] <= d;
    for (int o = 0; o < cap; ++o) {
      const float e = f.cand_d[o];
      r += (e < d) || (e == d && o < c);
    }
    if (r < k) {
      f.new_d[r] = d;
      f.new_l[r] = lab;
    }
  }
  for (int j = c; j < k; j += blockDim.x) {
    const float dj = f.run_d[j];
    int r = j;
    for (int o = 0; o < cap; ++o) r += f.cand_d[o] < dj;
    if (r < k) {
      f.new_d[r] = dj;
      f.new_l[r] = f.run_l[j];
    }
  }
  __syncthreads();
  for (int j = c; j < k; j += blockDim.x) {
    f.run_d[j] = f.new_d[j];
    f.run_l[j] = f.new_l[j];
  }
  __syncthreads();
}

// Write the running top-k as the query's output row; +inf carries -1.
__device__ __forceinline__ void fold_write(const Fold& f, float* out_d,
                                           int* out_l, int k) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float dj = f.run_d[j];
    out_d[j] = dj;
    out_l[j] = isinf(dj) ? -1 : f.run_l[j];
  }
}

// Exclusive scan over the block of one value a thread; returns this
// thread's prefix and the block's total. warp_sum: kNT / 32 ints of shared
// memory, free on entry, free again on return.
template <int kNT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kNT / 32; ++w) {
    const int sw = warp_sum[w];
    before += w < warp ? sw : 0;
    all += sw;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Leaf kinds of a compiled predicate's flat program
// (repro_torch/core/filters.py leaf_program): (kind, attr, n_consts).
enum LeafKind { kEq = 0, kIn = 1, kRange = 2 };

// Does the attribute row `row` [A] pass the conjunction of `n_leaves`
// leaves in `prog` [3 * n_leaves], with constants `consts` consumed in
// leaf order? The same predicate as core/filters.py eval_structure.
__device__ __forceinline__ bool passes(const int* __restrict__ row,
                                       const int* __restrict__ prog,
                                       int n_leaves,
                                       const int* __restrict__ consts) {
  int base = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const int kind = __ldg(prog + 3 * i);
    const int n = __ldg(prog + 3 * i + 2);
    const int a = __ldg(row + __ldg(prog + 3 * i + 1));
    bool m;
    if (kind == kEq) {
      m = a == __ldg(consts + base);
    } else if (kind == kIn) {
      m = false;
      for (int j = 0; j < n; ++j) m |= a == __ldg(consts + base + j);
    } else {
      m = a >= __ldg(consts + base) && a < __ldg(consts + base + 1);
    }
    if (!m) return false;
    base += n;
  }
  return true;
}

}  // namespace sivf
