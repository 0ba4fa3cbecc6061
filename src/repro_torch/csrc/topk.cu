// Row-wise k smallest for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/topk/topk.py::topk_pallas with the semantics of
// its plain version topk_ref (lax.top_k of -dists): for each row of
// dists [Q, L] the k smallest entries in ascending order, and the label
// at each chosen column. Entries are ordered by the key (dist, column):
// dists in IEEE total order (-inf < ... < -0.0 < +0.0 < ... < +inf, as
// XLA's top-k compares), equal dists by the lower column. A chosen +inf
// keeps its own label, whatever it is. A key is one 64-bit integer, the
// dist's order-preserving 32 bits above the column, so "smaller key" is
// the whole ordering rule; the keys are distinct, so the result is exact
// and independent of the order threads run in, and equals the plain
// version (kernels/topk/ref.py) bit for bit.
//
// What bounds it on this card: bytes, one read of each row's dists plus
// the k labels and outputs, 4 L + 12 k bytes a row (0.16 ms at
// [1024, 131072], k = 10, at the H100 SXM's published 3.35 TB/s).
//
// Two routes, chosen by the wrapper from k alone:
//  * warp (k <= 32): a block of kWarpThreads a row. Each warp keeps the k
//    smallest keys it has seen as a sorted list across its lanes (lane j:
//    the j-th) and screens the row against the list's k-th key. 16-byte
//    loads (__ldcs: the row is read once), kUnroll a thread a step, the
//    next step's loaded before this one's are screened, with a scalar head
//    and tail where a row's start is not 16-byte aligned. A float4 is
//    first screened as a whole: its smallest dist as a float against the
//    k-th key's (one compare and one vote for four dists, the common case
//    once the list has settled); only then dist by dist, the 32-bit order
//    bits first and the column on equal bits. The few keys that pass are
//    appended to the warp's buffer in shared memory; at 32 the warp sorts
//    them (a bitonic sort across its lanes) and merges them into its list
//    (the minimum of the list and the reversed batch, then a bitonic
//    merge), which lowers the threshold. Last, warp 0 merges the other
//    warps' lists the same way and writes the k results, reading each
//    label once.
//  * block (any k; the default for k > 32): the first port's kernel, one
//    block a row. Thread i keeps the kList smallest keys of its strided
//    slice, sorted, in registers; then k rounds of a block-wide minimum,
//    the owner of the winning key popping it; a thread whose list runs dry
//    while its slice has keys left refills it with the kList smallest keys
//    above the last one it gave up (a rescan of its slice; only when
//    k > kList).
//
// kernels/topk/ref.py::topk_warp_ref is the warp route's steps in plain
// Python.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// ---------------------------------------------------------------------------
// Route block: the first port's kernel, one block a row, k rounds
// ---------------------------------------------------------------------------

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


// ---------------------------------------------------------------------------
// Route warp: sorted lists across a warp's lanes
// ---------------------------------------------------------------------------

constexpr int kWarpThreads = 256;
constexpr int kListWarps = kWarpThreads / 32;
constexpr int kUnroll = 2;                 // float4 a thread a step
constexpr int kBuf = 64;                   // a warp's buffer of passing keys

// Sort one key a lane ascending over the warp (bitonic).
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v,
                                                        int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(~0u, v, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  }
  return v;
}

// The 32 smallest of two ascending lists a lane (`list`, and `batch`),
// ascending: the minimum of list and reversed batch is bitonic; merge it.
__device__ __forceinline__ unsigned long long warp_merge(
    unsigned long long list, unsigned long long batch, int lane) {
  const unsigned long long r = __shfl_sync(~0u, batch, 31 - lane);
  unsigned long long v = r < list ? r : list;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const unsigned long long o = __shfl_xor_sync(~0u, v, stride);
    v = (lane & stride) == 0 ? (o < v ? o : v) : (o > v ? o : v);
  }
  return v;
}

// A warp's running list, its threshold (the k-th key, as order bits and
// column) and its buffer of passing keys.
struct WarpList {
  unsigned long long key;                  // lane j: the j-th smallest
  unsigned tb, tc;                         // the k-th key's bits and column
  float tf;                                // ... as a float (+inf: no k-th)
  int cnt;                                 // keys in the buffer (uniform)
};

// The float whose order bits are b (order_bits' inverse).
__device__ __forceinline__ float from_order_bits(unsigned b) {
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ void flush(WarpList& w, unsigned long long* buf,
                                      int lane, int k) {
  __syncwarp();
  for (int o = 0; o < w.cnt; o += 32) {
    const unsigned long long b = lane < w.cnt - o ? buf[o + lane] : kNone;
    w.key = warp_merge(w.key, warp_sort(b, lane), lane);
  }
  __syncwarp();
  w.cnt = 0;
  const unsigned long long t = __shfl_sync(~0u, w.key, k - 1);
  w.tb = (unsigned)(t >> 32);
  w.tc = t == kNone ? 0u : (unsigned)t;    // an empty slot: below any column
  w.tf = t == kNone ? CUDART_INF_F : from_order_bits(w.tb);
}

// Screen one dist a lane (valid: the lane holds one) against the warp's
// threshold; the passing keys go to the buffer, a full buffer is merged.
__device__ __forceinline__ void screen(WarpList& w, unsigned long long* buf,
                                       float d, unsigned col, bool valid,
                                       int lane, int k) {
  const unsigned b = order_bits(d);
  const bool pass = valid && (b < w.tb || (b == w.tb && col < w.tc));
  const unsigned m = __ballot_sync(~0u, pass);
  if (m == 0) return;                      // uniform
  if (pass)
    buf[w.cnt + __popc(m & ((1u << lane) - 1u))] =
        ((unsigned long long)b << 32) | col;
  w.cnt += __popc(m);
  if (w.cnt >= 32) flush(w, buf, lane, k);
}

// Block r: row r's k smallest into row r of out_d / out_l. Each float4 is
// first screened as a whole: its smallest dist against the threshold as a
// float (`<=`, which takes -0.0 and +0.0 alike: a superset of the keys
// that can pass); only a warp with a lane through screens it key by key.
// The next step's kUnroll float4 are loaded before this step's are
// screened.
__global__ void __launch_bounds__(kWarpThreads) warp_topk_kernel(
    const float* __restrict__ dists, const int* __restrict__ labels,
    float* __restrict__ out_d, int* __restrict__ out_l, int len, int k) {
  __shared__ unsigned long long bufs[kListWarps][kBuf];
  __shared__ unsigned long long lists[kListWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t r = blockIdx.x;
  const float* row = dists + r * len;
  unsigned long long* buf = bufs[warp];
  WarpList w{kNone, ~0u, 0u, CUDART_INF_F, 0};

  // the scalar head (up to a 16-byte boundary) and tail, by warp 0
  const int mis = (int)((reinterpret_cast<size_t>(row) >> 2) & 3);
  const int a0 = min(len, (4 - mis) & 3);
  const int n4 = (len - a0) >> 2;
  const int a1 = a0 + 4 * n4;
  if (warp == 0) {
    const int c = lane < 4 ? lane : a1 + lane - 4;
    const bool valid = lane < 4 ? c < a0 : (lane < 8 && c < len);
    screen(w, buf, valid ? __ldg(row + c) : 0.f, (unsigned)c, valid, lane, k);
  }
  // the body: float4 i of the row's aligned part, i = warp * 32 +
  // lane + kWarpThreads * j
  const float4* body = reinterpret_cast<const float4*>(row + a0);
  auto load = [&](float4 (&v)[kUnroll], int i0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarpThreads + lane;
      v[u] = i < n4 ? __ldcs(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float4 v[kUnroll];
  load(v, warp * 32);
  for (int i0 = warp * 32; i0 < n4; i0 += kUnroll * kWarpThreads) {
    float4 nx[kUnroll];
    load(nx, i0 + kUnroll * kWarpThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarpThreads + lane;
      const bool valid = i < n4;
      const float mn = fminf(fminf(v[u].x, v[u].y), fminf(v[u].z, v[u].w));
      if (__ballot_sync(~0u, valid && mn <= w.tf) == 0) continue;
      const unsigned c = (unsigned)(a0 + 4 * i);
      screen(w, buf, v[u].x, c, valid, lane, k);
      screen(w, buf, v[u].y, c + 1, valid, lane, k);
      screen(w, buf, v[u].z, c + 2, valid, lane, k);
      screen(w, buf, v[u].w, c + 3, valid, lane, k);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = nx[u];
  }
  if (w.cnt) flush(w, buf, lane, k);
  lists[warp][lane] = w.key;
  __syncthreads();
  if (warp != 0) return;
  for (int o = 1; o < kListWarps; ++o)     // each list ascending already
    w.key = warp_merge(w.key, lists[o][lane], lane);
  if (lane < k) {                          // k <= len: lane k-1 holds a key
    const int col = (int)(w.key & 0xffffffffu);
    out_d[r * k + lane] = row[col];
    out_l[r * k + lane] = labels[r * len + col];
  }
}

}  // namespace

// Launches the block route on `stream`; returns the cudaError_t of the
// launch (0 = ok). dists [Q, L] float32, labels [Q, L] int32 -> out_d,
// out_l [Q, k], with 1 <= k <= L (the wrapper checks).
extern "C" int topk_launch(const float* dists, const int* labels,
                           float* out_d, int* out_l, int n_rows, int len,
                           int k, void* stream) {
  if (n_rows == 0) return 0;
  topk_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dists, labels, out_d, out_l, len, k);
  return static_cast<int>(cudaGetLastError());
}

// Launches the warp route on `stream`; returns the cudaError_t of the
// launch (0 = ok). As topk_launch, with 1 <= k <= min(32, L).
extern "C" int topk_warp_launch(const float* dists, const int* labels,
                                float* out_d, int* out_l, int n_rows,
                                int len, int k, void* stream) {
  if (n_rows == 0) return 0;
  if (k < 1 || k > 32 || k > len)
    return static_cast<int>(cudaErrorInvalidValue);
  warp_topk_kernel<<<n_rows, kWarpThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      dists, labels, out_d, out_l, len, k);
  return static_cast<int>(cudaGetLastError());
}
