// RWKV6 (Finch) WKV recurrence with a carried state, for Hopper (sm_90a),
// plain C interface.
//
// Replaces repro/kernels/wkv6/wkv6.py:44 wkv6_pallas (its pallas_call at
// :56) with the semantics of its plain version (kernels/wkv6/ref.py
// wkv6_ref, the reference's models/rwkv.py _wkv_sequential): for each
// batch row b and head h, from the initial state S = s0[b, h] ([dk, dv]),
// over t = 0 .. T-1
//     y[b, t, h, j] = sum_i r_t[i] * (S[i][j] + u[h][i] * k_t[i] * v_t[j])
//     S[i][j]       = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// and s_out[b, h] = S after the last step. Inputs, output and states are
// float32. Unlike the Pallas kernel, which starts from zero and returns no
// state, one launch serves prefill (T = the prompt, zero state) and decode
// (T = 1, the carried state), and any T >= 1 runs.
//
// What bounds it on this card: bytes. r, k, v, w and y are touched once
// each and the state twice (106 MB at a 2048-token RWKV6-3B admit, 0.032
// ms at 3.35 TB/s). The function needs 5 flops per state element and step
// (2 for r . S, 3 for S = w S + k v; the bonus term sum_i r_i u_i k_i v_j
// is a per-step scalar times v_j), 1.68 GFLOP there, 0.025 ms at the fp32
// peak. This kernel spends 7 (it adds the bonus per element, which keeps
// one pass over i; 0.035 ms at the peak), a cost a later design can drop.
// But the recurrence is sequential in T and the work splits only over
// (b, h) and the dv columns: at B = 1 and 40 heads, 40 blocks of 64
// threads run, a third of the SMs with two warps each, so a step's
// latency (a chain of dk dependent multiply-adds into y) and not the
// memory sets the time. A later design splits dk
// across threads or runs the chunked (parallel-in-T) form.
//
// Design (simple and correct first): one block per (b, h); thread j owns
// column j of S, dk floats in registers, so the state never leaves the
// SM between steps. The step's r, k and w rows (shared by every column)
// and the v row are staged in shared memory 32 steps at a time by all
// threads together (coalesced loads, one pair of barriers per 32 steps),
// and each thread then walks those steps reading them as broadcasts. y
// sums over i in ascending order. A thread reads its column of s0 before
// it writes s_out, so s_out may be s0 (in place).
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;            // time steps staged per pass
constexpr int kMaxThreads = 256;      // dv <= 256: one thread per column

template <int DK>
__global__ void __launch_bounds__(kMaxThreads) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ y,
    float* s_out, int t_len, int h_len, int dv) {
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                       // [kChunk][DK]
  float* ks = rs + kChunk * DK;
  float* ws = ks + kChunk * DK;
  float* vs = ws + kChunk * DK;           // [kChunk][dv]
  __shared__ float us[DK];
  const int b = blockIdx.x / h_len, h = blockIdx.x % h_len;
  const int j = threadIdx.x, nthreads = blockDim.x;
  const bool live = j < dv;
  const long long krow = static_cast<long long>(h_len) * DK;   // step stride
  const long long vrow = static_cast<long long>(h_len) * dv;
  const long long kbase = static_cast<long long>(b) * t_len * krow +
                          static_cast<long long>(h) * DK;
  const long long vbase = static_cast<long long>(b) * t_len * vrow +
                          static_cast<long long>(h) * dv;
  const long long sbase = static_cast<long long>(blockIdx.x) * DK * dv;

  float s[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) s[i] = live ? s0[sbase + i * dv + j] : 0.f;
  for (int i = j; i < DK; i += nthreads) us[i] = u[h * DK + i];

  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int n = min(kChunk, t_len - t0);
    __syncthreads();                      // the previous chunk is consumed
    for (int idx = j; idx < n * DK; idx += nthreads) {
      const long long off = kbase + (t0 + idx / DK) * krow + idx % DK;
      rs[idx] = r[off];
      ks[idx] = k[off];
      ws[idx] = w[off];
    }
    for (int idx = j; idx < n * dv; idx += nthreads)
      vs[idx] = v[vbase + (t0 + idx / dv) * vrow + idx % dv];
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt * dv + j];
      const float* rt = rs + tt * DK;
      const float* kt = ks + tt * DK;
      const float* wt = ws + tt * DK;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        const float kv = kt[i] * vj;
        acc += rt[i] * (s[i] + us[i] * kv);
        s[i] = wt[i] * s[i] + kv;
      }
      y[vbase + (t0 + tt) * vrow + j] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DK; ++i) s_out[sbase + i * dv + j] = s[i];
  }
}

template <int DK>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int b,
           int t_len, int h_len, int dv, cudaStream_t stream) {
  const int threads = (dv + 31) / 32 * 32;
  const size_t smem = sizeof(float) * kChunk * (3 * DK + dv);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wkv6_kernel<DK><<<b * h_len, threads, smem, stream>>>(
      r, k, v, w, u, s0, y, s_out, t_len, h_len, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* s_out, int b, int t_len,
                           int h_len, int dk, int dv, void* stream) {
  if (b == 0 || h_len == 0) return 0;
  if (dv < 1 || dv > kMaxThreads || t_len < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 16:
      return launch<16>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len, dv, s);
    case 32:
      return launch<32>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len, dv, s);
    case 64:
      return launch<64>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len, dv, s);
    case 128:
      return launch<128>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len, dv,
                         s);
    default:
      return cudaErrorInvalidValue;
  }
}
