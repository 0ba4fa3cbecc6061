// Unfused slab scan for Hopper (sm_90a), plain C interface.
//
// Replaces repro/kernels/sivf_scan/sivf_scan.py::sivf_scan_pallas: for each
// query q and each entry t of its slab table row, every slot c of the slab
// gets a distance and a label, written at (q * T + t) * C + c of the
// [Q, T*C] outputs. A live slot (table entry >= 0, validity bit set)
// scores ||q||^2 - 2 q.x + ||x||^2 (L2) or -q.x (IP) and carries its id;
// any other slot is +inf / -1. The arithmetic is dot_row.cuh's, the same
// as the fused kernel's (sivf_fused_search.cu) and the plain version's
// (kernels/sivf_scan/ref.py), so on one table the top-k of these outputs
// (topk.cu) equals the fused kernel's result bit for bit.
//
// Design (simple and correct first):
//  * one warp per (query, table entry); a block holds kWarps consecutive
//    entries of one query, whose row is staged in shared memory once.
//    Lane l scores slots l, l + 32, ...: each store of the warp writes 32
//    consecutive floats (coalesced). A -1 entry writes its +inf / -1 row
//    and reads no slab.
//  * the grid is one-dimensional (Q * ceil(T / kWarps) blocks in x), since
//    gridDim.y stops at 65,535; output offsets are 64-bit.
//
// What bounds it on this card: bytes. The [Q, T*C] outputs are 8 bytes a
// slot whether the slot is live or not (1 GiB at Q = T = 1024, C = 128:
// 0.32 ms at the H100 SXM's published 3.35 TB/s); the reads of the
// probed slabs' live rows add about a third of that. The design writes
// each output once, coalesced; its slab reads are the fused kernel's (one
// row per lane, no reuse across queries). The whole point of the fused
// kernel is not to pay this bound.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dot_row.cuh"

namespace {

constexpr int kWarps = 8;   // table entries (warps) per block

template <bool kL2>
__global__ void sivf_scan_kernel(
    const float* __restrict__ queries, const int* __restrict__ table,
    const float* __restrict__ data, const int* __restrict__ ids,
    const float* __restrict__ norms, const int* __restrict__ bitmap,
    float* __restrict__ out_d, int* __restrict__ out_l, int t_len,
    int t_blocks, int cap, int d_dim, int words, bool vec4) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [D] (padded to 4)

  const int q = blockIdx.x / t_blocks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = (blockIdx.x % t_blocks) * kWarps + warp;
  for (int i = threadIdx.x; i < d_dim; i += blockDim.x)
    qs[i] = queries[(size_t)q * d_dim + i];
  __syncthreads();
  if (t >= t_len) return;                        // ragged last block

  const int slab = table[(size_t)q * t_len + t];
  const size_t base = ((size_t)q * t_len + t) * cap;
  float* od = out_d + base;
  int* ol = out_l + base;
  if (slab < 0) {                                // uniform across the warp
    for (int c = lane; c < cap; c += 32) {
      od[c] = CUDART_INF_F;
      ol[c] = -1;
    }
    return;
  }
  const float qq = kL2 ? sivf::query_norm(qs, d_dim) : 0.f;
  const int* words_of = bitmap + (size_t)slab * words;
  for (int c = lane; c < cap; c += 32) {
    // bit 31 makes the int32 word negative: shift it as unsigned
    const unsigned word = (unsigned)__ldg(words_of + (c >> 5));
    float d = CUDART_INF_F;
    int lab = -1;
    if ((word >> (c & 31)) & 1u) {
      const size_t slot = (size_t)slab * cap + c;
      const float dot = sivf::dot_row(data + slot * d_dim, qs, d_dim, vec4);
      d = sivf::distance<kL2>(qq, dot, kL2 ? __ldg(norms + slot) : 0.f);
      lab = __ldg(ids + slot);
    }
    od[c] = d;
    ol[c] = lab;
  }
}

}  // namespace

extern "C" size_t sivf_scan_smem_bytes(int d_dim) {
  return sizeof(float) * (size_t)((d_dim + 3) & ~3);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// queries [Q, D], table [Q, T] int32 (-1 pad), data [S, C, D], ids and
// norms [S, C], bitmap [S, W] int32 words -> out_d, out_l [Q, T*C].
extern "C" int sivf_scan_launch(
    const float* queries, const int* table, const float* data,
    const int* ids, const float* norms, const int* bitmap, float* out_d,
    int* out_l, int n_queries, int t_len, int cap, int d_dim, int words,
    int metric_l2, void* stream) {
  if (n_queries == 0 || t_len == 0) return 0;
  const int t_blocks = (t_len + kWarps - 1) / kWarps;
  const long long blocks = (long long)n_queries * t_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sivf_scan_smem_bytes(d_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 loads need every payload row 16-byte aligned
  const bool vec4 = (d_dim % 4 == 0) &&
                    (reinterpret_cast<size_t>(data) % 16 == 0);
  const dim3 grid((unsigned)blocks), block(kWarps * 32);
  if (metric_l2)
    sivf_scan_kernel<true><<<grid, block, smem, s>>>(
        queries, table, data, ids, norms, bitmap, out_d, out_l, t_len,
        t_blocks, cap, d_dim, words, vec4);
  else
    sivf_scan_kernel<false><<<grid, block, smem, s>>>(
        queries, table, data, ids, norms, bitmap, out_d, out_l, t_len,
        t_blocks, cap, d_dim, words, vec4);
  return static_cast<int>(cudaGetLastError());
}
