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
// Design: the window is split over blocks (flash-decoding), then merged.
//  * pass 1, one block per (split, KV head, sequence): the sequence's
//    window [start, min(length, maxp * page)) is cut into n_split equal
//    parts of whole 32-slot chunks, read on the card from lengths and
//    starts, and block i takes part i. The number of splits comes from
//    the static shapes only (the wrapper never reads lengths or starts),
//    and so does `split`, the most slots a part can hold; a block whose
//    part is empty writes an empty partial (m = -inf, l = 0) and exits.
//    Equal parts keep every block of a sequence busy for the same 1-2
//    chunks, many blocks to an SM: one block walking many chunks alone
//    is latency-bound (about 5 us a chunk on an H100). A block serves
//    the g query heads of its KV head, so each live row is read from
//    device memory once.
//  * the block's table entries are read once per page into shared
//    memory; its slots are walked in chunks of 32, each chunk's K and V
//    rows copied to a 2-stage shared-memory ring (1 stage where 2 do not
//    fit) with 16-byte cp.async (zero-filled for a dead slot), the next
//    chunk in flight while this one is computed. Rows whose byte width is
//    not a multiple of 16 (or pages not 16-byte aligned) take plain loads.
//  * lane j of a warp scores slot j of the chunk for one query head at a
//    time (16-byte reads of the padded K row: no bank conflicts); a warp
//    per head then updates the online softmax (max, sum in float32), and
//    every thread owns (head, column) pairs of the running sum P V in
//    shared memory.
//  * the partials (m, l) [B, Hq, n_split, 2] and the unnormalised sums
//    [B, Hq, n_split, dv] (float32 scratch from the wrapper) are merged
//    by a second small kernel, one block per (sequence, q head):
//    out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i over the
//    splits with l_i > 0, and 0 where there is none.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// q . k over one 16-byte vector of k (4 float32 or 8 bf16), q in float32
__device__ __forceinline__ float dot16(const float* k, const float* q,
                                       float acc) {
  const float4 kv = *reinterpret_cast<const float4*>(k);
  const float4 qv = *reinterpret_cast<const float4*>(q);
  acc = fmaf(kv.x, qv.x, acc);
  acc = fmaf(kv.y, qv.y, acc);
  acc = fmaf(kv.z, qv.z, acc);
  return fmaf(kv.w, qv.w, acc);
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* k,
                                       const float* q, float acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* kv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(kv[i]);
    acc = fmaf(f.x, q[2 * i], acc);
    acc = fmaf(f.y, q[2 * i + 1], acc);
  }
  return acc;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the split kernel's shared memory (mirrored by
// paged_attention.py::smem_bytes): K ring, V ring, q [g][dk] f32, running
// sums [g][dv] f32, chunk scores [g][32] f32, (m, l, alpha) [g][3] f32,
// page ids of the split. K and V rows are padded by 16 bytes.
struct Layout {
  size_t v, q, acc, sc, run, pid, total;
  int ldk, ldv;                         // row strides, elements
};

__host__ __device__ inline Layout layout(int g, int dk, int dv, int es,
                                         int split, int page, int stages) {
  const int ve = 16 / es;
  Layout s;
  s.ldk = (dk + ve - 1) / ve * ve + ve;
  s.ldv = (dv + ve - 1) / ve * ve + ve;
  s.v = align16((size_t)stages * kChunk * s.ldk * es);
  s.q = s.v + align16((size_t)stages * kChunk * s.ldv * es);
  s.acc = s.q + align16((size_t)g * dk * 4);
  s.sc = s.acc + align16((size_t)g * dv * 4);
  s.run = s.sc + align16((size_t)g * kChunk * 4);
  s.pid = s.run + align16((size_t)g * 3 * 4);
  s.total = s.pid + align16((size_t)((split - 1) / page + 2) * 4);
  return s;
}

// VEC: rows are whole 16-byte vectors and the pages 16-byte aligned.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ lengths, const int* __restrict__ starts,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int hq,
    int hkv, int dk, int dv, int page, int maxp, int split, int n_split,
    int stages, float scale) {
  constexpr int kVe = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = hq / hkv;
  const int si = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t h0 = (size_t)b * hq + (size_t)kvh * g;   // its first q head

  // the window's share of split si: n_split equal parts, each a whole
  // number of chunks (at most `split` slots)
  const int start = max(starts[b], 0);
  const int end = min(lengths[b], maxp * page);
  const int part = end > start
      ? ((end - start + n_split - 1) / n_split + kChunk - 1) / kChunk * kChunk
      : 0;
  const int lo = start + si * part;
  const int hi = min(end, lo + part);
  if (lo >= hi) {                       // an empty partial
    for (int h = tid; h < g; h += kThreads) {
      part_ml[((h0 + h) * n_split + si) * 2] = neg_inf();
      part_ml[((h0 + h) * n_split + si) * 2 + 1] = 0.f;
    }
    return;
  }

  const Layout L = layout(g, dk, dv, sizeof(T), split, page, stages);
  T* kbuf = reinterpret_cast<T*>(smem);
  T* vbuf = reinterpret_cast<T*>(smem + L.v);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* run = reinterpret_cast<float*>(smem + L.run);
  int* pid = reinterpret_cast<int*>(smem + L.pid);
  const int ldk = L.ldk, ldv = L.ldv;
  const int pg0 = lo / page;

  for (int i = tid; i < g * dk; i += kThreads) qs[i] = to_f(q[h0 * dk + i]);
  for (int i = tid; i < g * dv; i += kThreads) acc[i] = 0.f;
  for (int h = tid; h < g; h += kThreads) {
    run[3 * h] = neg_inf();
    run[3 * h + 1] = 0.f;
  }
  for (int i = tid; i <= (hi - 1) / page - pg0; i += kThreads)
    pid[i] = tables[(size_t)b * maxp + pg0 + i];
  __syncthreads();

  // the K/V rows of chunk c into ring slot `buf`; a dead slot reads zeros
  auto load = [&](int c, int buf) {
    const int c0 = lo + c * kChunk;
    T* kd = kbuf + (size_t)buf * kChunk * ldk;
    T* vd = vbuf + (size_t)buf * kChunk * ldv;
    if (VEC) {
      const int nk = dk / kVe, nv = dv / kVe;
      for (int e = tid; e < kChunk * (nk + nv); e += kThreads) {
        const bool is_k = e < kChunk * nk;
        const int e2 = is_k ? e : e - kChunk * nk;
        const int n = is_k ? nk : nv;
        const int j = e2 / n, x = e2 - j * n;
        const int slot = c0 + j;
        const int p = slot < hi ? pid[slot / page - pg0] : -1;
        const int d = is_k ? dk : dv;
        const T* src = is_k ? kp : vp;
        if (p >= 0)
          src += (((size_t)p * page + slot % page) * hkv + kvh) * d + x * kVe;
        cp_async16((is_k ? kd + j * ldk : vd + j * ldv) + x * kVe, src,
                   p >= 0 ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < kChunk * (dk + dv); e += kThreads) {
        const bool is_k = e < kChunk * dk;
        const int e2 = is_k ? e : e - kChunk * dk;
        const int n = is_k ? dk : dv;
        const int j = e2 / n, x = e2 - j * n;
        const int slot = c0 + j;
        const int p = slot < hi ? pid[slot / page - pg0] : -1;
        const T* src = is_k ? kp : vp;
        float val = 0.f;
        if (p >= 0)
          val = to_f(src[(((size_t)p * page + slot % page) * hkv + kvh) * n +
                         x]);
        store((is_k ? kd + j * ldk : vd + j * ldv) + x, val);
      }
    }
  };

  const int n_chunks = (hi - lo + kChunk - 1) / kChunk;
  load(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = stages == 2 ? (c & 1) : 0;
    if (VEC) {
      if (stages == 2 && c + 1 < n_chunks) {
        load(c + 1, (c + 1) & 1);
        cp_async_wait<1>();               // chunk c has landed
      } else {
        cp_async_wait<0>();
      }
    } else if (stages == 2 && c + 1 < n_chunks) {
      load(c + 1, (c + 1) & 1);
    }
    __syncthreads();
    const T* kd = kbuf + (size_t)buf * kChunk * ldk;
    const T* vd = vbuf + (size_t)buf * kChunk * ldv;
    const int slot = lo + c * kChunk + lane;
    const bool live = slot < hi && pid[slot / page - pg0] >= 0;

    for (int h = warp; h < g; h += kWarps) {          // scores
      float dot = 0.f;
      const T* kr = kd + lane * ldk;
      const float* qh = qs + h * dk;
      if (VEC) {
        for (int x = 0; x < dk; x += kVe) dot = dot16(kr + x, qh + x, dot);
      } else {
        for (int d = 0; d < dk; ++d) dot = fmaf(to_f(kr[d]), qh[d], dot);
      }
      sc[h * kChunk + lane] = live ? dot * scale : neg_inf();
    }
    __syncthreads();
    for (int h = warp; h < g; h += kWarps) {          // online softmax
      const float s = sc[h * kChunk + lane];
      const float m_old = run[3 * h], l_old = run[3 * h + 1];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float mu = m_new == neg_inf() ? 0.f : m_new;
      const float alpha = expf(m_old - mu);     // 0 before the first live
      const float p = expf(s - mu);             // dead -> exp(-inf) = 0
      const float l_new = l_old * alpha + warp_sum(p);
      sc[h * kChunk + lane] = p;
      __syncwarp();                             // every lane has read run[h]
      if (lane == 0) {
        run[3 * h] = m_new;
        run[3 * h + 1] = l_new;
        run[3 * h + 2] = alpha;
      }
    }
    __syncthreads();
    for (int e = tid; e < g * dv; e += kThreads) {    // P V
      const int h = e / dv, d = e - h * dv;
      const float* ph = sc + h * kChunk;
      float a = acc[e] * run[3 * h + 2];
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) a = fmaf(ph[j], to_f(vd[j * ldv + d]), a);
      acc[e] = a;
    }
    __syncthreads();                    // the ring slot and scores are free
    if (stages == 1 && c + 1 < n_chunks) load(c + 1, 0);
  }

  for (int h = tid; h < g; h += kThreads) {
    part_ml[((h0 + h) * n_split + si) * 2] = run[3 * h];
    part_ml[((h0 + h) * n_split + si) * 2 + 1] = run[3 * h + 1];
  }
  for (int e = tid; e < g * dv; e += kThreads) {
    const int h = e / dv, d = e - h * dv;
    part_acc[((h0 + h) * n_split + si) * dv + d] = acc[e];
  }
}

// max (is_max) or sum over the block, every thread gets the result
__device__ __forceinline__ float block_reduce(float v, bool is_max,
                                              float* red) {
  v = is_max ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kWarps; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();                      // red is free again
  return v;
}

// one block per (sequence, q head): combine its splits' partials
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out, int n_split, int dv) {
  extern __shared__ float w[];          // [n_split] weight of each split
  __shared__ float red[kWarps];
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float m = neg_inf();
  for (int i = threadIdx.x; i < n_split; i += kThreads)
    if (ml[2 * i + 1] > 0.f) m = fmaxf(m, ml[2 * i]);
  m = block_reduce(m, true, red);
  float l = 0.f;
  for (int i = threadIdx.x; i < n_split; i += kThreads) {
    const float wi = ml[2 * i + 1] > 0.f ? expf(ml[2 * i] - m) : 0.f;
    w[i] = wi;
    l += wi * ml[2 * i + 1];
  }
  l = block_reduce(l, false, red);      // its barriers publish w
  for (int d = threadIdx.x; d < dv; d += kThreads) {
    float o = 0.f;
    if (l > 0.f) {
      for (int i = 0; i < n_split; ++i)
        if (w[i] > 0.f)
          o = fmaf(part_acc[(bh * n_split + i) * dv + d], w[i], o);
      o /= l;
    }
    store(out + bh * dv + d, o);
  }
}

template <typename T, bool VEC>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, const int* starts, void* out, float* part_ml,
           float* part_acc, int b, int hq, int hkv, int dk, int dv, int page,
           int maxp, int split, int n_split, int stages, float scale,
           cudaStream_t stream) {
  const size_t smem =
      layout(hq / hkv, dk, dv, sizeof(T), split, page, stages).total;
  auto kernel = paged_split_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // all of the SM's unified memory as shared memory, so that as many
  // blocks as fit run at once (the default carveout may hold one)
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_split, hkv, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, starts, part_ml, part_acc,
      hq, hkv, dk, dv, page, maxp, split, n_split, stages, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_merge_kernel<T><<<b * hq, kThreads, n_split * sizeof(float),
                          stream>>>(
      part_ml, part_acc, static_cast<T*>(out), n_split, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int vec, const void* q, const void* kp, const void* vp,
             const int* tables, const int* lengths, const int* starts,
             void* out, float* part_ml, float* part_acc, int b, int hq,
             int hkv, int dk, int dv, int page, int maxp, int split,
             int n_split, int stages, float scale, cudaStream_t stream) {
  if (vec)
    return launch<T, true>(q, kp, vp, tables, lengths, starts, out, part_ml,
                           part_acc, b, hq, hkv, dk, dv, page, maxp, split,
                           n_split, stages, scale, stream);
  return launch<T, false>(q, kp, vp, tables, lengths, starts, out, part_ml,
                          part_acc, b, hq, hkv, dk, dv, page, maxp, split,
                          n_split, stages, scale, stream);
}

}  // namespace

// Launches both passes on `stream`; returns the cudaError_t of the
// launches (0 = ok). q [B, Hq, dk]; k_pages [P, page, Hkv, dk];
// v_pages [P, page, Hkv, dv]; tables [B, maxp] int32 (-1 pad); lengths,
// starts [B] int32; out [B, Hq, dv]; all contiguous, one dtype (bf16 if
// is_bf16, else f32). part_ml [B, Hq, n_split, 2] and part_acc
// [B, Hq, n_split, dv] are float32 scratch. The wrapper checks Hkv | Hq,
// 1 <= dk, dv <= 512, split a multiple of 32, n_split * split >=
// maxp * page, `vec` (16-byte rows and pages) and the shared memory of
// `stages` (1 or 2) at `split` slots.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* lengths, const int* starts, void* out,
    float* part_ml, float* part_acc, int b, int hq, int hkv, int dk, int dv,
    int page, int maxp, int split, int n_split, int stages, int vec,
    float scale, int is_bf16, void* stream) {
  if (b == 0 || hq == 0) return 0;
  if (split % kChunk || n_split < 1 || (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(vec, q, k_pages, v_pages, tables, lengths,
                                   starts, out, part_ml, part_acc, b, hq,
                                   hkv, dk, dv, page, maxp, split, n_split,
                                   stages, scale, s);
  return dispatch<float>(vec, q, k_pages, v_pages, tables, lengths, starts,
                         out, part_ml, part_acc, b, hq, hkv, dk, dv, page,
                         maxp, split, n_split, stages, scale, s);
}
