// Tiled attention with an online softmax (GQA, causal or not) for Hopper
// (sm_90a), plain C interface: two hand-written kernels, one per route.
//
// Replaces repro/kernels/flash_attention/flash_attention.py:68
// flash_attention_pallas (and matches its plain version, ref.py mha_ref):
// out[b, h] = softmax(scale * q[b, h] k[b, h / g]^T) v[b, h / g], causal
// masking aligned at the ends (q row i sits at absolute position
// i + Sk - Sq), softmax and sums in float32, output in the input dtype.
// Any Sq, Sk >= 1: the ragged last q and k tiles are masked here (the
// Pallas wrapper asserts that its blocks divide the lengths). A row that
// sees no key gives 0.
//
// What bounds it on this card: operations. A causal prefill of S tokens
// does about 4 * Hq * dh * S^2 / 2 flops per layer and moves a few bytes
// per q/k/v/out element; at S = 2048 that is 34.4 GFLOP against 42 MB.
//
// Route "tensor_core" (flash_attention_tc_launch): bf16 inputs with
// dh % 16 == 0 and dh <= 256, the LM paths' prefill. Both products run on
// the tensor cores (wgmma, bf16 in, float32 accumulators in registers):
//  * one CTA per (128-row q tile, batch * q head): two consumer
//    warpgroups of 64 rows each and a producer warpgroup, one thread of
//    which issues the loads (setmaxnreg hands the producer's registers to
//    the consumers; ptxas still fits the consumers in 168 a thread, so a
//    tile is 64 keys: S, P in two bf16 terms and O fit without spills).
//    The q tiles are walked from the last, so the longest causal tiles
//    start first.
//  * the producer loads the q tile once and then K and V tiles of
//    64 keys into a 3-stage ring (2 at dh > 128) in shared memory with
//    TMA (cp.async.bulk.tensor, 128-byte swizzle, completion counted on
//    mbarriers; "empty" mbarriers hand a stage back). dh is cut into
//    64-column chunks of 128 bytes; a dh that is not a multiple of 64
//    reads zeros past its end (TMA's out-of-range fill), and so do rows
//    past Sq or Sk, whose scores are then masked to -inf here.
//  * S = Q K^T: wgmma m64n64k16 with Q and K read from shared memory
//    (both K-major). The online softmax runs in registers (a row lives in
//    the 4 threads of a quad); the causal / ragged mask is applied only
//    on tiles that cross the diagonal or the end of Sk, and the tiles
//    above the causal band are never loaded.
//  * O += P V: P goes to wgmma's register A operand (the accumulator
//    layout of S is the A fragment layout) as two bf16 terms, hi =
//    bf16(P) and lo = bf16(P - hi), each multiplied by V; V is the
//    shared-memory B operand, read transposed through the descriptor (it
//    lies [keys, dh]: MN-major).
//  * each warpgroup runs one tile behind on P V: it issues S of tile t
//    and O += P V of tile t - 1 together, and computes the softmax of
//    tile t on the CUDA cores while the tensor cores finish P V.
//  Precision: Q K^T of bf16 inputs is exact per product in float32; only
//  the summation order differs from the plain version. P enters P V as
//  hi + lo, about 16 significant bits (a relative error below 2^-16),
//  where scaled_dot_product_attention rounds it to one bf16 (8 bits):
//  one rounding to bf16 alone fails the LM path's full-width check
//  (2^-7 |plain| + 2^-7 RMS(plain)) on rows that average few keys. The
//  row sum l is taken from the float32 P. The extra term costs half again
//  the tensor-core work of one.
//  Tensor maps are encoded on the host with cuTensorMapEncodeTiled, taken
//  through cudaGetDriverEntryPoint (no -lcuda), and passed as
//  __grid_constant__ parameters.
//
// Route "simt" (flash_attention_launch): float32 inputs, and bf16 with
// dh % 16 != 0. No TF32: FMA on the CUDA cores in float32 (the Pallas
// kernel's f32 products and f32 P.V, P not rounded):
//  * one block per (q tile of 64 rows, batch * q head), 256 threads; the
//    q tile stays in shared memory for the whole block, transposed
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
#include <cuda.h>          // CUtensorMap and its enums (the header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// Route "tensor_core": wgmma + TMA, bf16 inputs, dh % 16 == 0, dh <= 256
// ---------------------------------------------------------------------------

namespace {

constexpr int kRows = 128;              // q rows per CTA: 2 warpgroups x 64
constexpr int kConsumers = 256;         // threads of the two warpgroups
constexpr int kTcThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kCol = 64;                // dh columns per 128-byte chunk
constexpr int kRowBytes = kCol * 2;     // one swizzled row of a chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` has completed. A completion
// that never comes (a refused TMA copy) stops the kernel with an error
// after about 10 s of clock instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > 20000000000LL) asm volatile("trap;");
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-d tensor map ({dh column, row, batch * head}) into
// shared memory, completion counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows written by TMA
// with the 128-byte swizzle: start address, LBO 16 bytes (not read: every
// product here is one 64-column chunk wide), SBO 1024 bytes (the stride of
// 8-row groups), layout 128B swizzle. Every tile base is 1024-aligned; a
// K-major operand steps through its 128-byte rows 32 bytes (k16) at a time.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {    // at most N groups pending
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define WG_D4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D32(d)                                                       \
  WG_D4(d, 0), WG_D4(d, 4), WG_D4(d, 8), WG_D4(d, 12), WG_D4(d, 16),    \
      WG_D4(d, 20), WG_D4(d, 24), WG_D4(d, 28)
#define WG_REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// P of columns c, c + 1 as two bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
// (column c in the low half of each word)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// o[64 x 64 NC] += (P_hi + P_lo)[64 x BK] V[BK x 64 NC], V the ring stage
// at v_tile
template <int NC, int BK>
__device__ __forceinline__ void pv(float (&o)[NC][32],
                                   const uint32_t (&pa)[2][BK / 16][4],
                                   uint32_t v_tile) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const uint64_t d =
          sw128_desc(v_tile + j * BK * kRowBytes + 16 * ks * kRowBytes);
      wgmma_rs(o[j], pa[0][ks], d);
      wgmma_rs(o[j], pa[1][ks], d);
    }
}

template <int NC, int BK, int ST>
constexpr int tc_smem_bytes() {
  return NC * kRows * kRowBytes                 // q tile
         + 2 * ST * NC * BK * kRowBytes         // K and V rings
         + 8 * (1 + 2 * ST)                     // mbarriers
         + 1024;                                // alignment of the base
}

// S[64 x BK] = Q[64 x 64 NC] K^T for one consumer warpgroup: q_wg its 64
// q rows, k_tile the ring stage
template <int NC, int BK>
__device__ __forceinline__ void qk(float (&sc)[BK / 2], uint32_t q_wg,
                                   uint32_t k_tile) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sc, sw128_desc(q_wg + j * kRows * kRowBytes + 32 * kk),
               sw128_desc(k_tile + j * BK * kRowBytes + 32 * kk),
               (j | kk) != 0);
}

// The online softmax of one tile: S (sc) -> float32 P (sc), in log2
// units. Columns at or past sk, and under causal masking past a row's own
// position, are -inf when `edge` (the tile crosses the end of Sk or the
// diagonal). Updates the running max and this thread's share of the row
// sums (from the float32 P); returns the factors that rescale o's rows.
template <int BK>
__device__ __forceinline__ float2 online_softmax(
    float (&sc)[BK / 2], float& m0, float& m1, float& l0, float& l1, int k0,
    int sk, bool edge, int causal, int pos0, int pos1, int cq,
    float scale_log2) {
  float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i] * scale_log2;
    if (edge) {
      const int c = k0 + 8 * (i >> 2) + cq + (i & 1);
      if (c >= sk || (causal && c > ((i & 2) ? pos1 : pos0))) x = neg_inf();
    }
    sc[i] = x;
    if (i & 2)
      mx1 = fmaxf(mx1, x);
    else
      mx0 = fmaxf(mx0, x);
  }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  // a row with nothing live yet subtracts 0: every exp2 below is then 0
  const float mu0 = mn0 == neg_inf() ? 0.f : mn0;
  const float mu1 = mn1 == neg_inf() ? 0.f : mn1;
  const float2 alpha = make_float2(exp2f(m0 - mu0), exp2f(m1 - mu1));
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float p = exp2f(sc[i] - ((i & 2) ? mu1 : mu0));
    sc[i] = p;
    if (i & 2)
      rs1 += p;
    else
      rs0 += p;
  }
  l0 = l0 * alpha.x + rs0;
  l1 = l1 * alpha.y + rs1;
  return alpha;
}

// o *= alpha (by row); P (sc) -> the hi and lo bf16 A fragments of BK / 16
// k16 steps
template <int NC, int BK>
__device__ __forceinline__ void rescale_and_split(
    float (&o)[NC][32], const float (&sc)[BK / 2],
    uint32_t (&pa)[2][BK / 16][4], float2 alpha) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] *= (i & 2) ? alpha.y : alpha.x;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      split_bf16(sc[8 * ks + 2 * u], sc[8 * ks + 2 * u + 1], pa[0][ks][u],
                 pa[1][ks][u]);
}

// NC: 64-column chunks of dh (dh padded up to 64 NC with zeros); BK: keys
// per K/V tile; ST: stages of the K/V ring. Accumulator element i of a thread (lane, warp w of its
// warpgroup) sits at row 16 w + lane / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (lane % 4) + i % 2 of its 64 x N product.
template <int NC, int BK, int ST>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
    int hq, int hkv, int sq, int sk, int dh, int causal, float scale_log2) {
  constexpr int kQChunk = kRows * kRowBytes;    // bytes of a q chunk
  constexpr int kKChunk = BK * kRowBytes;       // bytes of a K or V chunk
  constexpr int kTile = NC * kKChunk;           // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + NC * kQChunk;
  const uint32_t v_s = k_s + ST * kTile;
  const uint32_t q_full = v_s + ST * kTile;
  const uint32_t full = q_full + 8, empty = full + 8 * ST;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kRows;
  const int bh = blockIdx.y;                    // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int shift = sk - sq;                    // q row i sits at i + shift
  const int k_end = causal ? min(sk, q0 + kRows + shift) : sk;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer warpgroup keeps 24 registers a thread and hands the
    // rest to the consumers; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(q_full, NC * kQChunk);
      for (int j = 0; j < NC; ++j)
        tma_load(q_s + j * kQChunk, &qmap, q_full, j * kCol, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(empty + 8 * s, ((t / ST) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kTile);
        for (int j = 0; j < NC; ++j) {
          tma_load(k_s + s * kTile + j * kKChunk, &kmap, full + 8 * s,
                   j * kCol, t * BK, kvh);
          tma_load(v_s + s * kTile + j * kKChunk, &vmap, full + 8 * s,
                   j * kCol, t * BK, kvh);
        }
      }
    }
  } else {
    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the CTA's q tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = warp >> 2;
    const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);   // and r0 + 8
    const int first = q0 + 64 * wg + shift;     // position of its 1st row
    const int pos0 = q0 + r0 + shift, pos1 = pos0 + 8;
    const int cq = 2 * (lane & 3);
    const uint32_t q_wg = q_s + 64 * wg * kRowBytes;
    float o[NC][32];
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
    float m0 = neg_inf(), m1 = neg_inf();       // running max (log2 units)
    float l0 = 0.f, l1 = 0.f;                   // this thread's share of l
    float sc[BK / 2];                           // S of a tile, then its P
    uint32_t pa[2][BK / 16][4];                 // P of the tile before
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    auto edge = [&](int k0) {
      return k0 + BK > sk || (causal && k0 + BK - 1 > first);
    };
    mbar_wait(q_full, 0);

    // One tile behind: S of tile t and O += P V of tile t - 1 are issued
    // together, and the softmax of tile t runs on the CUDA cores while the
    // tensor cores finish P V.
    if (n_tiles > 0) {
      mbar_wait(full, 0);
      wg_fence();
      qk<NC, BK>(sc, q_wg, k_s);
      wg_commit();
      wg_wait<0>();
      float2 alpha = online_softmax<BK>(sc, m0, m1, l0, l1, 0, sk, edge(0),
                                        causal, pos0, pos1, cq, scale_log2);
      rescale_and_split<NC, BK>(o, sc, pa, alpha);
      for (int t = 1; t < n_tiles; ++t) {
        const int s = t % ST, sp = (t - 1) % ST;
        mbar_wait(full + 8 * s, (t / ST) & 1);
        wg_fence();                             // o and pa were just written
        qk<NC, BK>(sc, q_wg, k_s + s * kTile);
        wg_commit();
        pv<NC, BK>(o, pa, v_s + sp * kTile);
        wg_commit();
        wg_wait<1>();                           // S of tile t has landed
        alpha = online_softmax<BK>(sc, m0, m1, l0, l1, t * BK, sk,
                                   edge(t * BK), causal, pos0, pos1, cq,
                                   scale_log2);
        wg_wait<0>();                           // P V of tile t - 1 is done
        mbar_arrive(empty + 8 * sp);
        rescale_and_split<NC, BK>(o, sc, pa, alpha);
      }
      const int sp = (n_tiles - 1) % ST;
      wg_fence();
      pv<NC, BK>(o, pa, v_s + sp * kTile);
      wg_commit();
      wg_wait<0>();
      mbar_arrive(empty + 8 * sp);
    }

    const float lt0 = quad_sum(l0), lt1 = quad_sum(l1);
    const float inv0 = lt0 > 0.f ? 1.f / lt0 : 0.f;
    const float inv1 = lt1 > 0.f ? 1.f / lt1 : 0.f;
    const int row0 = q0 + r0, row1 = row0 + 8;
    __nv_bfloat16* ob = out + (size_t)bh * sq * dh;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = kCol * j + 8 * (i >> 2) + cq;
        const int r = (i & 2) ? row1 : row0;
        const float inv = (i & 2) ? inv1 : inv0;
        if (c < dh && r < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * dh + c) =
              __floats2bfloat162_rn(o[j][i] * inv, o[j][i + 1] * inv);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [heads][rows][dh] bf16 as a 3-d map with boxes of 64 columns x box_rows
// rows x 1 head, 128-byte swizzle, zeros outside the tensor
bool encode(CUtensorMap* map, const void* ptr, int dh, int rows, int heads,
            int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)rows * dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kCol, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int BK, int ST>
int launch_tc(const void* q, const void* k, const void* v, void* out, int b,
              int hq, int hkv, int sq, int sk, int dh, int causal,
              float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!encode(&qmap, q, dh, sq, b * hq, kRows) ||
      !encode(&kmap, k, dh, sk, b * hkv, BK) ||
      !encode(&vmap, v, dh, sk, b * hkv, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = tc_smem_bytes<NC, BK, ST>();
  auto kernel = flash_attention_tc_kernel<NC, BK, ST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, b * hq);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, sk,
      dh, causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// q [B, Hq, Sq, dh]; k, v [B, Hkv, Sk, dh]; out [B, Hq, Sq, dh]; all
// contiguous bf16, 16-byte aligned. The wrapper checks Hkv | Hq,
// Sq, Sk >= 1, dh % 16 == 0 and dh <= 256, B * Hq < 65536.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int b,
                                         int hq, int hkv, int sq, int sk,
                                         int dh, int causal, float scale,
                                         void* stream) {
  if (b == 0 || hq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh % 16 || dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 64)
    return launch_tc<1, 64, 3>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                               scale, s);
  if (dh <= 128)
    return launch_tc<2, 64, 3>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                               scale, s);
  return launch_tc<4, 64, 2>(q, k, v, out, b, hq, hkv, sq, sk, dh, causal,
                             scale, s);
}
