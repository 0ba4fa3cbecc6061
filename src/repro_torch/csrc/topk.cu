// Row-wise k smallest for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/topk/topk.py::topk_pallas with the semantics of
// its plain version topk_ref (lax.top_k of -dists): for each row of
// dists [Q, L] the k smallest entries in ascending order, and the label
// at each chosen column. Entries are ordered by the key (dist, column):
// dists in IEEE total order (-inf < ... < -0.0 < +0.0 < ... < +inf, as
// XLA's top-k compares), equal dists by the lower column. A chosen +inf
// keeps its own label, whatever it is. The keys are distinct, so the
// result is exact and independent of the order threads run in; it equals
// the plain version (kernels/topk/ref.py) bit for bit.
//
// Design (simple and correct first): one block per row, one pass.
//  * a key is one 64-bit integer: the dist's order-preserving 32 bits
//    above the column, so "smaller key" is the whole ordering rule.
//  * thread i reads columns i, i + kThreads, ... (coalesced) and keeps the
//    kList smallest keys of its slice, sorted, in registers.
//  * k rounds of a block-wide minimum over the threads' heads: the owner
//    of the winning key pops it and writes output j. A thread whose list
//    runs dry while its slice has keys left refills it with the kList
//    smallest keys above the last one it gave up (a rescan of its slice;
//    only needed when k > kList).
//
// What bounds it on this card: bytes, one read of each row's dists plus
// the k labels and outputs, 4 L + 12 k bytes a row. The row is read once
// when k <= kList; the k rounds cost two block barriers each.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 16;   // covers the search k (10) in one pass
constexpr unsigned long long kNone = ~0ull;

// dist -> 32 bits whose unsigned order is the IEEE total order
__device__ __forceinline__ unsigned order_bits(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long key_of(float d, int col) {
  return ((unsigned long long)order_bits(d) << 32) | (unsigned)col;
}

// Insert `key` into the sorted list if it is among its kList smallest.
__device__ __forceinline__ void insert(unsigned long long (&list)[kList],
                                       unsigned long long key) {
  if (key >= list[kList - 1]) return;
  list[kList - 1] = key;
#pragma unroll
  for (int i = kList - 1; i > 0; --i) {
    if (list[i] < list[i - 1]) {
      const unsigned long long t = list[i];
      list[i] = list[i - 1];
      list[i - 1] = t;
    }
  }
}

// The kList smallest keys >= lo of this thread's slice of the row.
__device__ __forceinline__ void fill(unsigned long long (&list)[kList],
                                     const float* __restrict__ row, int len,
                                     unsigned long long lo) {
#pragma unroll
  for (int i = 0; i < kList; ++i) list[i] = kNone;
  int c = threadIdx.x;
  for (; c + 3 * kThreads < len; c += 4 * kThreads) {   // 4 loads in flight
    const float d0 = __ldg(row + c), d1 = __ldg(row + c + kThreads);
    const float d2 = __ldg(row + c + 2 * kThreads);
    const float d3 = __ldg(row + c + 3 * kThreads);
    const unsigned long long k0 = key_of(d0, c);
    const unsigned long long k1 = key_of(d1, c + kThreads);
    const unsigned long long k2 = key_of(d2, c + 2 * kThreads);
    const unsigned long long k3 = key_of(d3, c + 3 * kThreads);
    if (k0 >= lo) insert(list, k0);
    if (k1 >= lo) insert(list, k1);
    if (k2 >= lo) insert(list, k2);
    if (k3 >= lo) insert(list, k3);
  }
  for (; c < len; c += kThreads) {
    const unsigned long long key = key_of(__ldg(row + c), c);
    if (key >= lo) insert(list, key);
  }
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) topk_kernel(
    const float* __restrict__ dists, const int* __restrict__ labels,
    float* __restrict__ out_d, int* __restrict__ out_l, int len, int k) {
  __shared__ unsigned long long heads[kWarps];
  __shared__ unsigned long long winner;
  const size_t r = blockIdx.x;
  const float* row = dists + r * len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mine = threadIdx.x < len
                       ? (len - 1 - threadIdx.x) / kThreads + 1 : 0;
  int given = 0;                                 // keys popped so far
  unsigned long long list[kList];
  fill(list, row, len, 0ull);
  for (int j = 0; j < k; ++j) {
    const unsigned long long v = warp_min(list[0]);
    if (lane == 0) heads[warp] = v;
    __syncthreads();
    if (warp == 0) {
      const unsigned long long w = warp_min(lane < kWarps ? heads[lane]
                                                          : kNone);
      if (lane == 0) winner = w;
    }
    __syncthreads();
    const unsigned long long w = winner;         // distinct keys: one owner
    if (list[0] == w) {
      const int col = (int)(w & 0xffffffffu);
      out_d[r * k + j] = row[col];
      out_l[r * k + j] = labels[r * len + col];
#pragma unroll
      for (int i = 0; i < kList - 1; ++i) list[i] = list[i + 1];
      list[kList - 1] = kNone;
      if (++given < mine && list[0] == kNone) fill(list, row, len, w + 1);
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// dists [Q, L] float32, labels [Q, L] int32 -> out_d, out_l [Q, k], with
// 1 <= k <= L (the wrapper checks).
extern "C" int topk_launch(const float* dists, const int* labels,
                           float* out_d, int* out_l, int n_rows, int len,
                           int k, void* stream) {
  if (n_rows == 0) return 0;
  topk_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dists, labels, out_d, out_l, len, k);
  return static_cast<int>(cudaGetLastError());
}
