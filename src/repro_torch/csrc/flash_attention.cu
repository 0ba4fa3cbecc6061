// Tiled attention with an online softmax (GQA, causal or not) for Hopper
// (sm_90a), plain C interface.
//
// Replaces repro/kernels/flash_attention/flash_attention.py:68
// flash_attention_pallas (and matches its plain version, ref.py mha_ref):
// out[b, h] = softmax(scale * q[b, h] k[b, h / g]^T) v[b, h / g], causal
// masking aligned at the ends (q row i sits at absolute position
// i + Sk - Sq), products, softmax and sums in float32 from float32 or
// bfloat16 inputs, output in the input dtype. Any Sq, Sk >= 1: the ragged
// last q and k tiles are masked here (the Pallas wrapper asserts that its
// blocks divide the lengths).
//
// What bounds it on this card: operations. A causal prefill of S tokens
// does about 4 * Hq * dh * S^2 / 2 flops per layer and moves a few bytes
// per q/k/v/out element; at S = 2048 that is 34.4 GFLOP against 42 MB.
//
// Design (simple and correct first): one block per (q tile of 64 rows,
// batch * q head), 256 threads, FMA on the CUDA cores in float32 (the
// Pallas kernel's f32 products and f32 P.V; no tensor cores and no
// rounding of P to bf16 yet).
//  * the q tile stays in shared memory for the whole block, transposed
//    ([dh][64]); each k/v tile of 64 rows is staged in shared memory as
//    float32 (k transposed, v as it lies), in dynamic shared memory
//    above 48 KB.
//  * thread (ty, tx) of a 16 x 16 grid owns q rows 4ty..4ty+3: it scores
//    them against k columns 4tx..4tx+3 (16 FMAs per pair of 16-byte
//    shared loads), the 16 threads of a row group reduce the row max and
//    sum with shuffles, and each owns output columns 4tx + 64j.. of those
//    rows, accumulated over the tile's probabilities (staged transposed
//    in shared memory) in registers.
//  * under causal masking the k tiles above the diagonal band are never
//    loaded, as the Pallas kernel skips them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64, kBk = 64;
constexpr int kThreads = 256;
constexpr int kLd = 68;   // stride of the transposed tiles: 16-byte aligned
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

// max / sum over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// NJ: 64-column groups of the output each thread covers (ceil(dh / 64)).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int hq, int hkv, int sq,
    int sk, int dh, int causal, float scale) {
  constexpr int kLdv = NJ * 64;          // row stride of the v tile
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [dh][kLd]   q tile, transposed
  float* kt = qt + dh * kLd;             // [dh][kLd]   k tile, transposed
  float* vs = kt + dh * kLd;             // [kBk][kLdv] v tile
  float* pt = vs + kBk * kLdv;           // [kBk][kLd]  probabilities^T

  const int bh = blockIdx.y;             // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const size_t kvh = (size_t)b * hkv + h / (hq / hkv);
  const int q0 = blockIdx.x * kBq;
  const T* qb = q + (size_t)bh * sq * dh;
  const T* kb = k + kvh * sk * dh;
  const T* vb = v + kvh * sk * dh;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int shift = sk - sq;             // q row i sits at i + shift

  for (int e = tid; e < kBq * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    qt[d * kLd + r] = q0 + r < sq ? to_f(qb[(size_t)(q0 + r) * dh + d]) : 0.f;
  }
  float m[4], l[4], o[4][NJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ * 4; ++j) o[i][j] = 0.f;
  }
  // under causal masking no row of this tile sees a column >= k_end
  const int k_end = causal ? min(sk, q0 + kBq + shift) : sk;

  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();                     // last tile's readers are done
    for (int e = tid; e < kBk * dh; e += kThreads) {
      const int c = e / dh, d = e - c * dh;
      const bool in = k0 + c < sk;
      const size_t at = (size_t)(k0 + c) * dh + d;
      kt[d * kLd + c] = in ? to_f(kb[at]) : 0.f;
      vs[c * kLdv + d] = in ? to_f(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kLd + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(kt + d * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(lane_of(qa, i), lane_of(ka, j), s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      float mt = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + 4 * tx + j;
        const bool dead = c >= sk || (causal && c > r + shift);
        s[i][j] = dead ? neg_inf() : s[i][j] * scale;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      float alpha = 1.f, rs = 0.f;
      if (m_new != neg_inf()) {          // uniform over the row group
        alpha = expf(m[i] - m_new);      // 0 on the row's first live tile
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);    // dead -> exp(-inf) = 0
          rs += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ * 4; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) pt[(4 * tx + j) * kLd + 4 * ty + i] = s[i][j];
    }
    __syncthreads();

    for (int c = 0; c < kBk; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + c * kLd + 4 * ty);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 va =
            *reinterpret_cast<const float4*>(vs + c * kLdv + 64 * jj + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            o[i][4 * jj + u] =
                fmaf(lane_of(pa, i), lane_of(va, u), o[i][4 * jj + u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    T* orow = out + ((size_t)bh * sq + r) * dh;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = 64 * jj + 4 * tx + u;
        if (d < dh)
          store(orow + d,
                l[i] > 0.f ? o[i][4 * jj + u] / fmaxf(l[i], 1e-30f) : 0.f);
      }
  }
}

template <int NJ>
size_t smem_bytes(int dh) {
  return sizeof(float) *
         (2 * (size_t)dh * kLd + (size_t)kBk * NJ * 64 + (size_t)kBk * kLd);
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int sk, int dh, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<NJ>(dh);
  auto kernel = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBq - 1) / kBq, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, sk, dh,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int sq, int sk, int dh, int causal,
             float scale, cudaStream_t stream) {
  switch ((dh + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                                scale, stream);
    case 2: return launch<T, 2>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                                scale, stream);
    case 3: return launch<T, 3>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                                scale, stream);
    case 4: return launch<T, 4>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                                scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// q [B, Hq, Sq, dh]; k, v [B, Hkv, Sk, dh]; out [B, Hq, Sq, dh]; all
// contiguous, one dtype (bf16 if is_bf16, else f32). The wrapper checks
// Hkv | Hq, Sq, Sk >= 1, dh a multiple of 4 in [4, 256], B * Hq < 65536.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b,
                                      int hq, int hkv, int sq, int sk,
                                      int dh, int causal, float scale,
                                      int is_bf16, void* stream) {
  if (b == 0 || hq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, sk, dh,
                                   causal, scale, s);
  return dispatch<float>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                         scale, s);
}
