// Fused ADC scan -> top-k over PQ codes for Hopper (sm_90a), plain C
// interface.
//
// Replaces repro/kernels/sivf_scan/pq_fused.py::sivf_pq_fused_search_pallas,
// unfiltered and filtered: for each query, a live slot's distance is the
// sum of its m lookups adc[q, s, code[s]] in ascending subspace s, starting
// from the s = 0 term, each add rounded on its own (__fadd_rn). Dead slots
// (validity bitmap), -1 table entries and, when filtered, slots whose
// attributes fail the predicate score +inf / -1; the candidates fold into
// a running top-k (topk_fold.cuh). The ADC table is already metric-shaped
// (core/pq.py adc_tables), so the kernel is metric-agnostic. Fed the same
// table, it equals its plain version (kernels/sivf_scan/ref.py) bit for
// bit, labels included.
//
// Design (simple and correct first):
//  * one thread block per query, one thread per slab slot (blockDim = C).
//    The block stages its query's [m, ksub] table in shared memory (32 KB
//    at m=32, ksub=256; above 48 KB the launcher raises the block's
//    dynamic shared-memory limit) and gathers from it directly. The TPU
//    kernel's one-hot [C, ksub] matrix product per subspace works around a
//    TPU's lack of a fast gather; it is not ported.
//  * thread c reads slot c's m code bytes, 16 at a time (uint4) when m is
//    a multiple of 16 and the plane is 16-byte aligned, else byte by byte.
//  * filtered: the same flat leaf program and in-place [S, C, A] attribute
//    reads as sivf_fused_search.cu (topk_fold.cuh, sivf::passes).
//
// What bounds it on this card: bytes. Each query reads its m*ksub*4-byte
// table once (the largest single term at Q=1024, m=32, ksub=256: 33.5 MB),
// plus m + 4 bytes per live slot of its probed slabs; the m adds per slot
// are far below fp32 peak. Table gathers from shared memory may conflict
// on banks (correct, only slower). Reading one table per query dominates
// the bound, so sharing slabs between queries that probe the same lists
// helps this kernel less than it helps the raw scan.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_fold.cuh"

namespace {

template <bool kFiltered>
__global__ void sivf_pq_fused_search_kernel(
    const float* __restrict__ adc, const int* __restrict__ table,
    const unsigned char* __restrict__ codes, const int* __restrict__ ids,
    const int* __restrict__ bitmap, const int* __restrict__ attrs,
    const int* __restrict__ prog, int n_leaves,
    const int* __restrict__ consts, int n_attrs, float* __restrict__ out_d,
    int* __restrict__ out_l, int t_len, int cap, int m, int ksub, int words,
    int k, bool vec16) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);  // [m * ksub]
  const int tab_len = m * ksub;
  const sivf::Fold fold = sivf::carve_fold(tab + tab_len, k);

  const int q = blockIdx.x;
  const int c = threadIdx.x;
  const float* adc_q = adc + (size_t)q * tab_len;
  for (int i = c; i < tab_len; i += blockDim.x) tab[i] = __ldg(adc_q + i);
  sivf::fold_init(fold, k);
  __syncthreads();

  const int* trow = table + (size_t)q * t_len;
  for (int t = 0; t < t_len; ++t) {
    const int slab = trow[t];
    if (slab < 0) continue;                      // uniform: one value per block
    const size_t slot = (size_t)slab * cap + c;
    const unsigned word = (unsigned)bitmap[(size_t)slab * words + (c >> 5)];
    bool live = (word >> (c & 31)) & 1u;
    if (kFiltered && live)
      live = sivf::passes(attrs + slot * n_attrs, prog, n_leaves, consts);
    float d = CUDART_INF_F;
    int lab = -1;
    if (live) {
      const unsigned char* code = codes + slot * m;
      if (vec16) {
        const uint4* code16 = reinterpret_cast<const uint4*>(code);
        for (int g = 0; g < (m >> 4); ++g) {
          const uint4 v = __ldg(code16 + g);
          const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 16; ++j) {     // little-endian byte order
            const int s = (g << 4) + j;
            const float term =
                tab[s * ksub + ((w[j >> 2] >> (8 * (j & 3))) & 0xffu)];
            d = s == 0 ? term : __fadd_rn(d, term);
          }
        }
      } else {
        d = tab[__ldg(code)];
        for (int s = 1; s < m; ++s)
          d = __fadd_rn(d, tab[s * ksub + __ldg(code + s)]);
      }
      lab = ids[slot];
    }
    sivf::fold_candidates(fold, d, lab, k, cap);
  }
  sivf::fold_write(fold, out_d + (size_t)q * k, out_l + (size_t)q * k, k);
}

}  // namespace

extern "C" size_t sivf_pq_fused_search_smem_bytes(int m, int ksub, int cap,
                                                  int k) {
  return sizeof(float) * (size_t)m * ksub + sivf::fold_smem_bytes(k, cap);
}

// Launches on `stream`; returns the cudaError_t of the launch or of the
// shared-memory attribute (0 = ok). `attrs` null selects the unfiltered
// instantiation (prog, consts unused); otherwise attrs [S, C, n_attrs],
// prog [3 * n_leaves], consts int32.
extern "C" int sivf_pq_fused_search_launch(
    const float* adc, const int* table, const unsigned char* codes,
    const int* ids, const int* bitmap, const int* attrs, const int* prog,
    int n_leaves, const int* consts, int n_attrs, float* out_d, int* out_l,
    int n_queries, int t_len, int cap, int m, int ksub, int words, int k,
    void* stream) {
  if (n_queries == 0) return 0;
  const size_t smem = sivf_pq_fused_search_smem_bytes(m, ksub, cap, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec16 = (m % 16 == 0) &&
                     (reinterpret_cast<size_t>(codes) % 16 == 0);
  auto* kernel = attrs ? &sivf_pq_fused_search_kernel<true>
                       : &sivf_pq_fused_search_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_queries, cap, smem, s>>>(
      adc, table, codes, ids, bitmap, attrs, prog, n_leaves, consts, n_attrs,
      out_d, out_l, t_len, cap, m, ksub, words, k, vec16);
  return static_cast<int>(cudaGetLastError());
}
