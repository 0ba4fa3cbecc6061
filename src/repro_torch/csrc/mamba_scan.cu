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
// What bounds it on this card: bytes (u, delta and y once, b and c once
// per batch row, the two states once) and, about as much, the T * di * n
// exponentials at the SFU rate (16 a clock per SM). The
// recurrence is sequential in T; the work splits over (b, channel) only.
//
// Design (simple and correct first): one thread per (b, channel), with
// its h[n] and a[ch][:] in registers (n rounded up to a power of two at
// compile time, the lanes past n idle); 64 threads a block so that a
// 8192-channel row fills 128 blocks, about one per SM. b_t and c_t are
// shared by the block's channels: all threads stage them in shared memory
// 32 steps at a time (one pair of barriers per 32 steps); u and delta are
// read per step, neighbouring threads on neighbouring channels. The
// elementwise products round as the plain version's do (no FMA
// contraction there: __fmul_rn / __fadd_rn), expf is the accurate one,
// and y sums over i in ascending order. A thread reads its h0 before it
// writes h_out, so h_out may be h0 (in place).
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;            // time steps staged per pass
constexpr int kThreads = 64;          // channels per block

template <int N>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const float* __restrict__ u, const float* __restrict__ delta,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ d,
    const float* h0, float* __restrict__ y, float* h_out, int t_len, int di,
    int n) {
  __shared__ float bs[kChunk * N];
  __shared__ float cs[kChunk * N];
  const int bi = blockIdx.y, tid = threadIdx.x;
  const int ch = blockIdx.x * kThreads + tid;
  const bool live = ch < di;
  const long long hbase = (static_cast<long long>(bi) * di + ch) * n;
  const long long xbase = static_cast<long long>(bi) * t_len * di + ch;
  const long long bcbase = static_cast<long long>(bi) * t_len * n;

  float h[N], av[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool in = live && i < n;
    av[i] = in ? a[static_cast<long long>(ch) * n + i] : 0.f;
    h[i] = in ? h0[hbase + i] : 0.f;
  }
  const float dch = live ? d[ch] : 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int steps = min(kChunk, t_len - t0);
    __syncthreads();                      // the previous chunk is consumed
    for (int idx = tid; idx < steps * n; idx += kThreads) {
      const int tt = idx / n, i = idx % n;
      const long long off = bcbase + static_cast<long long>(t0) * n + idx;
      bs[tt * N + i] = b[off];
      cs[tt * N + i] = c[off];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < steps; ++tt) {
      const long long off = xbase + static_cast<long long>(t0 + tt) * di;
      const float ut = u[off], dt = delta[off];
      const float dtu = __fmul_rn(dt, ut);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < n) {
          const float da = expf(__fmul_rn(dt, av[i]));
          h[i] = __fadd_rn(__fmul_rn(da, h[i]),
                           __fmul_rn(dtu, bs[tt * N + i]));
          acc = __fadd_rn(acc, __fmul_rn(h[i], cs[tt * N + i]));
        }
      }
      y[off] = __fadd_rn(acc, __fmul_rn(dch, ut));
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) h_out[hbase + i] = h[i];
  }
}

template <int N>
int launch(const float* u, const float* delta, const float* a,
           const float* b, const float* c, const float* d, const float* h0,
           float* y, float* h_out, int bsz, int t_len, int di, int n,
           cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, bsz);
  mamba_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      u, delta, a, b, c, d, h0, y, h_out, t_len, di, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mamba_scan_launch(const float* u, const float* delta,
                                 const float* a, const float* b,
                                 const float* c, const float* d,
                                 const float* h0, float* y, float* h_out,
                                 int bsz, int t_len, int di, int n,
                                 void* stream) {
  if (bsz == 0 || di == 0) return 0;
  if (t_len < 1 || n < 1 || n > 64) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 4)
    return launch<4>(u, delta, a, b, c, d, h0, y, h_out, bsz, t_len, di, n,
                     s);
  if (n <= 8)
    return launch<8>(u, delta, a, b, c, d, h0, y, h_out, bsz, t_len, di, n,
                     s);
  if (n <= 16)
    return launch<16>(u, delta, a, b, c, d, h0, y, h_out, bsz, t_len, di,
                      n, s);
  if (n <= 32)
    return launch<32>(u, delta, a, b, c, d, h0, y, h_out, bsz, t_len, di,
                      n, s);
  return launch<64>(u, delta, a, b, c, d, h0, y, h_out, bsz, t_len, di, n,
                    s);
}
