// Mamba (S6) selective scan with a carried state, for Hopper (sm_90a),
// plain C interface.
//
// Replaces repro/kernels/mamba_scan/mamba_scan.py:44 mamba_scan_pallas
// (its pallas_call at :65) with the semantics of its plain version
// (kernels/mamba_scan/ref.py mamba_scan_ref, the reference's
// models/mamba.py _ssm_sequential): for each batch row b and channel ch,
// from h = h0[b, ch] ([n]), over t = 0 .. T-1
//     h[i]        = exp(delta_t * a[ch][i]) * h[i] + (delta_t * u_t) * b_t[i]
//     y[b, t, ch] = sum_i h[i] * c_t[i] + d[ch] * u_t
// with delta_t = delta[b, t, ch], u_t = u[b, t, ch], and h_out[b, ch] = h
// after the last step. Everything is float32. Unlike the Pallas kernel,
// which starts from zero, returns no state and needs di % 128 == 0, one
// launch serves prefill (T = the prompt, zero state) and decode (T = 1,
// the carried state), and any T >= 1, any di and any n <= 64 run.
//
// What bounds it on this card: the T * di * n exponentials at the SFU rate
// (16 a clock per SM; 0.064 ms at a 2048-token Jamba admit) and, about as
// much, bytes (u, delta and y once, b and c once per batch row, the two
// states once). The recurrence is sequential in T, but its chain is one
// multiply and one add per state element and step: exp(delta_t a_i) and
// delta_t u_t b_t[i] do not depend on h, and the sum over i for y feeds
// nothing later.
//
// Design. The state of a channel is split over lanes and y is taken off
// the chain:
//   * a thread holds E = 4 consecutive state elements of one channel (h
//     and a in registers; E = 2 or 1 where n is 2 or 1), L threads a
//     channel (E * L >= n, L a power of two), a block of 128 threads
//     128 / L channels; at n = 16 (4 lanes) a 8192-channel row is 256
//     blocks of 4 warps (1,024 warps). E and L are
//     template parameters, so the block's shared-memory strides are
//     constants.
//   * u, delta (the block's channels) and b, c for `chunk` steps (32;
//     fewer for a shorter T) are copied to shared memory with 16-byte
//     cp.async (4-byte where an operand is not 16-byte aligned, di % 4 or
//     n % 4 != 0), double-buffered: the next chunk loads while this one
//     computes.
//   * four steps at a time, a thread first computes exp(delta_t a_i) and
//     (delta_t u_t) b_t[i] for all four (independent of h), then runs the
//     chain h = da h + dbu over them, and writes its elements' partial of
//     y (sum of h_i c_t[i], ascending) to shared memory as [chunk]
//     [channels][lanes]; the last steps of a chunk run one at a time, so
//     the chain carries no predicate.
//   * after the chunk the block sums each channel's lanes in ascending
//     order (16-byte reads) and adds d u_t, one thread per (step,
//     channel), neighbouring threads on neighbouring channels (coalesced
//     stores), a thread's outputs side by side.
// Every product and sum rounds on its own as the plain version's does
// (__fmul_rn / __fadd_rn: no FMA contraction), expf is the accurate one,
// and only the order of the y sum changes (E terms, then the lanes). The
// launch plan (E, L, chunk, shared bytes) comes from shapes alone
// (kernels/mamba_scan/mamba_scan.py launch_plan); ref.py
// mamba_scan_split_ref is this order of operations in plain PyTorch. A
// thread reads its h0 before it writes h_out, so h_out may be h0.
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kAhead = 4;             // steps whose exps precede the chain

constexpr int kThreads = 128;         // threads a block

// Shared memory of one block, in floats: u, delta [2][2][chunk][cpb],
// b, c [2][2][chunk][lanes * E], the lanes' partials of y
// [chunk][cpb][lanes], d [cpb], with cpb = kThreads / lanes channels a
// block. kernels/mamba_scan/mamba_scan.py smem_bytes says the same.
__host__ __device__ constexpr long long smem_floats(int lanes, int e,
                                                    int chunk) {
  return 4LL * chunk * (kThreads / lanes + lanes * e) +
         static_cast<long long>(chunk) * kThreads + kThreads / lanes;
}

template <int E>
__device__ __forceinline__ void load_e(const float* p, float (&o)[E]) {
  if constexpr (E == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (E == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = p[e];
  }
}

// One step's operands that do not depend on h, for the thread's E
// elements: exp(delta_t a_i), (delta_t u_t) b_t[i] and c_t[i]
template <int E>
struct Ahead {
  float da[E], dbu[E], cv[E];
};

template <int E>
__device__ __forceinline__ void ahead(Ahead<E>& o, float dt, float ut,
                                      const float* b_row, const float* c_row,
                                      const float (&av)[E]) {
  const float dtu = __fmul_rn(dt, ut);
  float bv[E];
  load_e<E>(b_row, bv);
  load_e<E>(c_row, o.cv);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    o.da[e] = expf(__fmul_rn(dt, av[e]));
    o.dbu[e] = __fmul_rn(dtu, bv[e]);
  }
}

// h = da h + dbu for the thread's elements; returns their part of y,
// sum h_i c_i in element order (elements past n left out)
template <int E>
__device__ __forceinline__ float chain(float (&h)[E], const Ahead<E>& o,
                                       int i0, int n) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    h[e] = __fadd_rn(__fmul_rn(o.da[e], h[e]), o.dbu[e]);
    const float hc = __fmul_rn(h[e], o.cv[e]);
    if (i0 + e < n) acc = e == 0 ? hc : __fadd_rn(acc, hc);
  }
  return acc;
}

template <int E, int L>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const float* __restrict__ u, const float* __restrict__ delta,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ d,
    const float* h0, float* __restrict__ y, float* h_out, int t_len, int di,
    int n, int chunk, int vec) {
  constexpr int kCpb = kThreads / L, kNpad = L * E;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // u, delta [2][2][chunk][kCpb]
  float* bc = xs + 4 * chunk * kCpb;         // b, c [2][2][chunk][kNpad]
  float* yp = bc + 4 * chunk * kNpad;        // [chunk][kCpb][L]
  float* ds = yp + chunk * kThreads;         // d [kCpb]

  const int tid = threadIdx.x;
  const int chl = tid / L, jl = tid % L, i0 = jl * E;
  const int bi = blockIdx.y, ch0 = blockIdx.x * kCpb, ch = ch0 + chl;
  const int nch = min(kCpb, di - ch0);
  const int used = (n + E - 1) / E;          // lanes that hold elements
  const bool live = chl < nch && jl < used;
  const long long hbase = (static_cast<long long>(bi) * di + ch) * n;
  const long long xbase = static_cast<long long>(bi) * t_len * di + ch0;
  const long long bcbase = static_cast<long long>(bi) * t_len * n;

  float h[E], av[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool in = live && i0 + e < n;
    av[e] = in ? a[static_cast<long long>(ch) * n + i0 + e] : 0.f;
    h[e] = in ? h0[hbase + i0 + e] : 0.f;
  }

  const int n_chunks = (t_len + chunk - 1) / chunk;
  auto stage = [&](int cc) {
    const int t0 = cc * chunk, steps = min(chunk, t_len - t0);
    float* xd = xs + (cc & 1) * 2 * chunk * kCpb;
    float* bd = bc + (cc & 1) * 2 * chunk * kNpad;
    const long long xo = xbase + static_cast<long long>(t0) * di;
    const long long bo = bcbase + static_cast<long long>(t0) * n;
    rec::stage_rows(xd, kCpb, u + xo, di, steps, nch, vec, tid, kThreads);
    rec::stage_rows(xd + chunk * kCpb, kCpb, delta + xo, di, steps, nch, vec,
                    tid, kThreads);
    rec::stage_rows(bd, kNpad, b + bo, n, steps, n, vec, tid, kThreads);
    rec::stage_rows(bd + chunk * kNpad, kNpad, c + bo, n, steps, n, vec, tid,
                    kThreads);
    rec::cp_async_commit();
  };

  // d and the first chunk in flight together (one round trip at decode)
  rec::stage_rows(ds, kCpb, d + ch0, 0, 1, nch, vec, tid, kThreads);
  stage(0);
  for (int cc = 0; cc < n_chunks; ++cc) {
    const int t0 = cc * chunk, steps = min(chunk, t_len - t0);
    rec::cp_async_wait_all();
    __syncthreads();     // chunk cc has landed; chunk cc-1's y is written
    if (cc + 1 < n_chunks) stage(cc + 1);
    const float* us = xs + (cc & 1) * 2 * chunk * kCpb;
    const float* dls = us + chunk * kCpb;
    const float* bs = bc + (cc & 1) * 2 * chunk * kNpad;
    const float* cs = bs + chunk * kNpad;

    if (live) {
      // kAhead steps at a time: first what does not depend on h, then
      // the chain; the last steps of a chunk one at a time
      const int full = steps - steps % kAhead;
      for (int tt = 0; tt < full; tt += kAhead) {
        Ahead<E> op[kAhead];
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          const int row = tt + q;
          ahead<E>(op[q], dls[row * kCpb + chl], us[row * kCpb + chl],
                   bs + row * kNpad + i0, cs + row * kNpad + i0, av);
        }
#pragma unroll
        for (int q = 0; q < kAhead; ++q)
          yp[(tt + q) * kThreads + tid] = chain<E>(h, op[q], i0, n);
      }
      for (int tt = full; tt < steps; ++tt) {
        Ahead<E> op;
        ahead<E>(op, dls[tt * kCpb + chl], us[tt * kCpb + chl],
                 bs + tt * kNpad + i0, cs + tt * kNpad + i0, av);
        yp[tt * kThreads + tid] = chain<E>(h, op, i0, n);
      }
    }
    __syncthreads();

    // y = the lanes' partials in ascending order + d u_t, one thread per
    // (step, channel), neighbouring threads on neighbouring channels, a
    // thread's outputs side by side (independent sums)
    constexpr int kOut = 32 / L > 0 ? 32 / L : 1;        // chunk <= 32
#pragma unroll
    for (int m = 0; m < kOut; ++m) {
      const int idx = tid + m * kThreads;
      const int tt = idx / kCpb, q = idx % kCpb;
      if (tt < steps && q < nch) {
        const float* pt = yp + tt * kThreads + q * L;
        float part[L];
        if constexpr (L % 4 == 0) {
#pragma unroll
          for (int l = 0; l < L; l += 4) {
            const float4 x = *reinterpret_cast<const float4*>(pt + l);
            part[l] = x.x; part[l + 1] = x.y; part[l + 2] = x.z;
            part[l + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int l = 0; l < L; ++l) part[l] = pt[l];
        }
        float acc = part[0];
#pragma unroll
        for (int l = 1; l < L; ++l)
          if (l < used) acc = __fadd_rn(acc, part[l]);
        y[xbase + static_cast<long long>(t0 + tt) * di + q] =
            __fadd_rn(acc, __fmul_rn(ds[q], us[tt * kCpb + q]));
      }
    }
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (i0 + e < n) h_out[hbase + i0 + e] = h[e];
  }
}

template <int E, int L>
int launch(const float* u, const float* delta, const float* a,
           const float* b, const float* c, const float* d, const float* h0,
           float* y, float* h_out, int bsz, int t_len, int di, int n,
           int chunk, int vec, cudaStream_t stream) {
  if (L * E < n || chunk < 1 || chunk > 32 || bsz >= 65536)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(L, E, chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_kernel<E, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((di + kThreads / L - 1) / (kThreads / L), bsz);
  mamba_scan_kernel<E, L><<<grid, kThreads, smem, stream>>>(
      u, delta, a, b, c, d, h0, y, h_out, t_len, di, n, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mamba_scan_launch(const float* u, const float* delta,
                                 const float* a, const float* b,
                                 const float* c, const float* d,
                                 const float* h0, float* y, float* h_out,
                                 int bsz, int t_len, int di, int n, int elems,
                                 int lanes, int chunk, int vec,
                                 void* stream) {
  if (bsz == 0 || di == 0) return 0;
  if (t_len < 1 || n < 1 || n > 64) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MAMBA_CASE(E, L)                                                   \
  if (elems == E && lanes == L)                                            \
    return launch<E, L>(u, delta, a, b, c, d, h0, y, h_out, bsz, t_len, di, \
                        n, chunk, vec, s);
  MAMBA_CASE(4, 1)
  MAMBA_CASE(4, 2)
  MAMBA_CASE(4, 4)
  MAMBA_CASE(4, 8)
  MAMBA_CASE(4, 16)
  MAMBA_CASE(2, 1)
  MAMBA_CASE(1, 1)
#undef MAMBA_CASE
  return cudaErrorInvalidValue;
}
