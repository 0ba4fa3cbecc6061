// One-token decode attention over a paged KV cache, for Hopper (sm_90a),
// plain C interface.
//
// Replaces repro/kernels/paged_attention/paged_attention.py:66
// paged_attention_pallas (and matches its plain version, ref.py
// paged_attention_ref): for each sequence b and query head h, attention of
// q[b, h] over the slots start <= slot < length of the sequence's pages
// (block table row b, -1 entries skipped), q head h reading KV head h / g,
// scores scaled by `scale`, softmax and sums in float32 from float32 or
// bfloat16 inputs, output in q's dtype, 0 where no slot is live. dv may
// differ from dk.
//
// What bounds it on this card: bytes. Every live K/V row of the window is
// read once (sum of window lengths * Hkv * (dk + dv) * element size), and
// the arithmetic is a few FMAs per byte.
//
// Design (simple and correct first): one block per (KV head, sequence),
// serving that head's g query heads, so each live page row is read from
// device memory once, not g times as in the Pallas grid (B, Hq, maxp).
// Blocks run in no order and share nothing; the walk over the sequence's
// table entries is a loop inside the block:
//  * the window is walked in chunks of 32 slots. Warp 0 translates the
//    chunk's slots through the block table (one lane per slot); then all
//    threads copy the chunk's K and V rows to shared memory as float32,
//    neighbouring threads on neighbouring elements (coalesced loads).
//  * each warp holds one query head at a time: lane j scores slot j of the
//    chunk, a warp max and sum give the chunk's online-softmax update, and
//    each lane accumulates the neighbouring dv elements lane, lane + 32, ...
//    of the output in registers (the running sums live in shared memory
//    between chunks, so one warp can serve several heads).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;            // slots per step: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);               // round to nearest even
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// NV: output chunks of 32 elements a lane holds (ceil(dv / 32) rounded up
// to a power of two; lanes past dv are idle).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    T* __restrict__ out, int hq, int hkv, int dk, int dv, int page,
    int maxp, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long row_of[kChunk];   // K/V row of each chunk slot, -1 dead
  const int g = hq / hkv;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldk = dk + 1;                // padded: lanes read distinct banks
  float* ks = smem;                      // [kChunk][dk + 1]
  float* vs = ks + kChunk * ldk;         // [kChunk][dv]
  float* qs = vs + kChunk * dv;          // [g][dk]  this KV head's q heads
  float* acc = qs + g * dk;              // [g][dv]  running sums
  float* run = acc + g * dv;             // [g][2]   running max, denominator

  const size_t q_base = ((size_t)b * hq + (size_t)kvh * g);
  for (int i = tid; i < g * dk; i += kThreads) qs[i] = to_f(q[q_base * dk + i]);
  for (int i = tid; i < g * dv; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < g; i += kThreads) {
    run[2 * i] = neg_inf();
    run[2 * i + 1] = 0.f;
  }
  const int start = max(starts[b], 0);
  const int end = min(lengths[b], maxp * page);

  for (int c0 = (start / kChunk) * kChunk; c0 < end; c0 += kChunk) {
    __syncthreads();                     // last chunk's readers are done
    if (warp == 0) {
      const int t = c0 + lane;
      long long r = -1;
      if (t >= start && t < end) {
        const int pid = tables[(size_t)b * maxp + t / page];
        if (pid >= 0) r = ((long long)pid * page + t % page) * hkv + kvh;
      }
      row_of[lane] = r;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const long long r = row_of[j];
      for (int d = tid; d < dk; d += kThreads)
        ks[j * ldk + d] = r >= 0 ? to_f(kp[r * dk + d]) : 0.f;
      for (int d = tid; d < dv; d += kThreads)
        vs[j * dv + d] = r >= 0 ? to_f(vp[r * dv + d]) : 0.f;
    }
    __syncthreads();
    const bool live = row_of[lane] >= 0;
    for (int h = warp; h < g; h += kWarps) {
      float s = neg_inf();
      if (live) {
        const float* qh = qs + h * dk;
        const float* kr = ks + lane * ldk;
        float dot = 0.f;
        for (int d = 0; d < dk; ++d) dot = fmaf(qh[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_old = run[2 * h], l_old = run[2 * h + 1];
      const float m_new = fmaxf(m_old, warp_max(s));
      if (m_new == neg_inf()) continue;  // warp-uniform: nothing live yet
      const float alpha = expf(m_old - m_new);    // 0 on the first live chunk
      const float p = live ? expf(s - m_new) : 0.f;
      const float l_new = l_old * alpha + warp_sum(p);
      float a[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        a[i] = d < dv ? acc[h * dv + d] * alpha : 0.f;
      }
      for (int j = 0; j < kChunk; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float* vr = vs + j * dv;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int d = lane + 32 * i;
          if (d < dv) a[i] = fmaf(pj, vr[d], a[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        if (d < dv) acc[h * dv + d] = a[i];
      }
      __syncwarp();                      // every lane has read run[h]
      if (lane == 0) {
        run[2 * h] = m_new;
        run[2 * h + 1] = l_new;
      }
    }
  }
  __syncthreads();
  for (int h = warp; h < g; h += kWarps) {
    const float l = run[2 * h + 1];
    for (int d = lane; d < dv; d += 32) {
      const float o = l > 0.f ? acc[h * dv + d] / fmaxf(l, 1e-30f) : 0.f;
      store(out + (q_base + h) * dv + d, o);
    }
  }
}

template <typename T, int NV>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, const int* starts, void* out, int b, int hq,
           int hkv, int dk, int dv, int page, int maxp, float scale,
           cudaStream_t stream) {
  const int g = hq / hkv;
  const size_t smem = sizeof(float) * ((size_t)kChunk * (dk + 1) +
                                       (size_t)kChunk * dv +
                                       (size_t)g * (dk + dv) + 2 * g);
  auto kernel = paged_attention_kernel<T, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(hkv, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, starts,
      static_cast<T*>(out), hq, hkv, dk, dv, page, maxp, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp,
             const int* tables, const int* lengths, const int* starts,
             void* out, int b, int hq, int hkv, int dk, int dv, int page,
             int maxp, float scale, cudaStream_t stream) {
  const int nv = (dv + 31) / 32;
#define PA_CASE(N)                                                         \
  if (nv <= N)                                                             \
    return launch<T, N>(q, kp, vp, tables, lengths, starts, out, b, hq,    \
                        hkv, dk, dv, page, maxp, scale, stream);
  PA_CASE(1) PA_CASE(2) PA_CASE(4) PA_CASE(8) PA_CASE(16)
#undef PA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// q [B, Hq, dk]; k_pages [P, page, Hkv, dk]; v_pages [P, page, Hkv, dv];
// tables [B, maxp] int32 (-1 pad); lengths, starts [B] int32;
// out [B, Hq, dv]; all contiguous, one dtype (bf16 if is_bf16, else f32).
// The wrapper checks Hkv | Hq, 1 <= dk, dv <= 512 and the shared memory.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* lengths, const int* starts, void* out,
    int b, int hq, int hkv, int dk, int dv, int page, int maxp, float scale,
    int is_bf16, void* stream) {
  if (b == 0 || hq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths,
                                   starts, out, b, hq, hkv, dk, dv, page,
                                   maxp, scale, s);
  return dispatch<float>(q, k_pages, v_pages, tables, lengths, starts, out,
                         b, hq, hkv, dk, dv, page, maxp, scale, s);
}
