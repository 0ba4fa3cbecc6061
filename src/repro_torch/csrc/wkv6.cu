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
// (2 for r . S, 3 for S = w S + k v), since the bonus term factors:
// sum_i r_i u_i k_i v_j = beta_t v_j with beta_t = sum_i r_i u_i k_i, one
// scalar per (step, head). The recurrence is sequential in T, but its
// chain is one multiply-add per state element and step: every S[i][j] is
// independent of every other, and the sum over i for y feeds nothing
// later.
//
// Design. The state is split over many threads and y is taken off the
// chain:
//   * one block per (b, h, group of 32 columns); a thread holds a 4 x 4
//     block of the state in registers (4 rows, a "slice", by 4 columns),
//     8 threads a slice across the group's columns, dk / 4 slices a block
//     (2 dk threads). 16 floats a thread whatever dk, so the state never
//     leaves the SM between steps and dk = 128 does not spill. At B = 1,
//     H = 40, dk = dv = 64: 80 blocks of 4 warps (512 threads a head),
//     each thread using every r, k and w it loads for 4 columns and every
//     v for 4 rows.
//   * per step a thread does kv = k_i v_j, S = w_i S + kv (one FMA) and
//     p_j += r_i S_ij (one FMA) for its 16 elements, reading the next
//     step's r, k, w and v (16-byte shared loads) before it stores this
//     step's partials; it writes its slice's partial of y to shared memory
//     as [chunk steps][slices][32 columns]. After the chunk the block sums
//     the slices in ascending order (a thread's outputs side by side) and
//     adds beta_t v_j: y costs no barrier per step and no chain longer
//     than four multiply-adds.
//   * beta_t is computed once per (step, head) after the chunk lands, a
//     warp per step (lanes over i, then a butterfly sum), a warp's steps
//     side by side.
//   * r, k, w and the group's v columns for `chunk` steps (32; fewer for a
//     shorter T, or where dk = 128 would need more shared memory than a
//     block has) are copied to shared memory with 16-byte cp.async (4-byte
//     where an operand is not 16-byte aligned or dv % 4 != 0),
//     double-buffered: the next chunk loads while this one computes.
//   * at decode (T = 1) the state is the bytes that matter: each thread
//     reads and writes its rows as 16-byte vectors, a slice's 8 threads on
//     128 contiguous bytes, and the T = 1 instance is compiled for more
//     resident blocks (fewer registers), so that a decode step is one wave.
// The launch plan (chunk, shared bytes) comes from shapes alone
// (kernels/wkv6/wkv6.py launch_plan); ref.py wkv6_split_ref is this order
// of operations in plain PyTorch. A block reads its columns of s0 before it
// writes them to s_out, so s_out may be s0 (in place).
#include <cuda_runtime.h>

#include "stage_rows.cuh"

namespace {

constexpr int kRows = 4;              // state rows a thread holds
constexpr int kQuad = 4;              // state columns a thread holds
constexpr int kCols = 32;             // state columns a block holds
constexpr int kQuads = kCols / kQuad; // threads a slice of rows
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

// Shared memory of one block, in floats: r, k, w [2][3][chunk][dk], v
// [2][chunk][kCols], the slices' partials [chunk][dk / kRows][kCols], u
// [dk], beta [chunk]. kernels/wkv6/wkv6.py smem_bytes says the same.
__host__ __device__ constexpr long long smem_floats(int dk, int chunk) {
  return 2LL * chunk * (3 * dk + kCols) + dk + chunk +
         static_cast<long long>(chunk) * (dk / kRows) * kCols;
}

// A block's fewest blocks a multiprocessor at decode (T = 1): a decode
// step is one wave of many short blocks, so more of them resident (fewer
// registers) beats the registers a long prefill uses.
constexpr int decode_blocks(int threads) {
  return threads >= 256 ? 2 : threads >= 128 ? 5 : 8;
}

template <int DK, bool kDecode>
__global__ void __launch_bounds__(
    DK / kRows * kQuads, kDecode ? decode_blocks(DK / kRows * kQuads) : 1)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s0,
                float* __restrict__ y, float* s_out, int t_len, int h_len,
                int dv, int chunk, int vec) {
  constexpr int kSlices = DK / kRows, kThreads = kSlices * kQuads;
  constexpr int kWarps = (kThreads + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* rkw = smem;                               // [2][3][chunk][DK]
  float* vs = rkw + 6 * chunk * DK;                // [2][chunk][kCols]
  float* yp = vs + 2 * chunk * kCols;              // [chunk][kSlices][kCols]
  float* us = yp + chunk * kSlices * kCols;        // [DK]
  float* beta = us + DK;                           // [chunk]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = tid % kQuads, slice = tid / kQuads;
  const int groups = (dv + kCols - 1) / kCols;
  const int bh = blockIdx.x / groups, g = blockIdx.x - bh * groups;
  const int b = bh / h_len, h = bh - b * h_len;
  const int col0 = g * kCols, ncols = min(kCols, dv - col0);
  const int row0 = slice * kRows, c0 = quad * kQuad;   // c0: in the group
  const long long krow = static_cast<long long>(h_len) * DK;   // step stride
  const long long vrow = static_cast<long long>(h_len) * dv;
  const long long kbase = static_cast<long long>(b) * t_len * krow +
                          static_cast<long long>(h) * DK;
  const long long vbase = static_cast<long long>(b) * t_len * vrow +
                          static_cast<long long>(h) * dv + col0;
  const float* s0b = s0 + static_cast<long long>(bh) * DK * dv + col0 + c0;
  float* s_outb = s_out + static_cast<long long>(bh) * DK * dv + col0 + c0;

  // the thread's 4 x 4 block of the state, rows row0.., columns c0..
  float s[kRows][kQuad];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float* src = s0b + static_cast<long long>(row0 + i) * dv;
    if (vec && c0 < ncols) {
      ld4(src, s[i]);
    } else {
#pragma unroll
      for (int q = 0; q < kQuad; ++q) s[i][q] = c0 + q < ncols ? src[q] : 0.f;
    }
  }

  const int n_chunks = (t_len + chunk - 1) / chunk;
  auto stage = [&](int c) {
    const int t0 = c * chunk, n = min(chunk, t_len - t0);
    float* dst = rkw + (c & 1) * 3 * chunk * DK;
    const long long off = kbase + t0 * krow;
    rec::stage_rows(dst, DK, r + off, krow, n, DK, vec, tid, kThreads);
    rec::stage_rows(dst + chunk * DK, DK, k + off, krow, n, DK, vec, tid,
                    kThreads);
    rec::stage_rows(dst + 2 * chunk * DK, DK, w + off, krow, n, DK, vec, tid,
                    kThreads);
    rec::stage_rows(vs + (c & 1) * chunk * kCols, kCols,
                    v + vbase + t0 * vrow, vrow, n, ncols, vec, tid,
                    kThreads);
    rec::cp_async_commit();
  };

  // u and the first chunk in flight together (one round trip at decode)
  rec::stage_rows(us, DK, u + h * DK, 0, 1, DK, vec, tid, kThreads);
  stage(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk, n = min(chunk, t_len - t0);
    rec::cp_async_wait_all();
    __syncthreads();     // chunk c has landed; chunk c-1's y is written
    if (c + 1 < n_chunks) stage(c + 1);
    const float* rs = rkw + (c & 1) * 3 * chunk * DK;
    const float* ks = rs + chunk * DK;
    const float* ws = ks + chunk * DK;
    const float* vc = vs + (c & 1) * chunk * kCols;

    // beta_t = sum_i r_i u_i k_i, a warp per step, each warp's steps
    // side by side (independent sums: their shuffles overlap)
    {
      // steps a warp takes: chunk <= 32, and 1 at decode (T = 1)
      constexpr int kPer = kDecode ? 1 : (32 + kWarps - 1) / kWarps;
      float acc[kPer];
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int tt = warp + m * kWarps;
        acc[m] = 0.f;
        if (tt < n) {
#pragma unroll
          for (int i = lane; i < DK; i += 32)
            acc[m] = fmaf(rs[tt * DK + i] * us[i], ks[tt * DK + i], acc[m]);
        }
      }
      if constexpr (kDecode) {                   // T = 1: warp 0's step
        if (warp == 0)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[0] += __shfl_xor_sync(kFull, acc[0], off);
      } else {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int m = 0; m < kPer; ++m)
            acc[m] += __shfl_xor_sync(kFull, acc[m], off);
      }
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int tt = warp + m * kWarps;
        if (lane == 0 && tt < n) beta[tt] = acc[m];
      }
    }

    // the recurrence: p = r . S over the thread's rows, then
    // S = w S + k v. Step tt + 1's operands are read before step tt's
    // partials are stored: a store to shared memory would hold the next
    // loads back.
    float rr[4], kk[4], ww[4], vv[4];
    ld4(rs + row0, rr);
    ld4(ks + row0, kk);
    ld4(ws + row0, ww);
    ld4(vc + c0, vv);
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      const int nx = min(tt + 1, n - 1);
      float rn[4], kn[4], wn[4], vn[4];
      ld4(rs + nx * DK + row0, rn);
      ld4(ks + nx * DK + row0, kn);
      ld4(ws + nx * DK + row0, wn);
      ld4(vc + nx * kCols + c0, vn);
      float p[kQuad];
#pragma unroll
      for (int q = 0; q < kQuad; ++q) {
        p[q] = rr[0] * s[0][q];
#pragma unroll
        for (int i = 1; i < kRows; ++i) p[q] = fmaf(rr[i], s[i][q], p[q]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int q = 0; q < kQuad; ++q)
          s[i][q] = fmaf(ww[i], s[i][q], kk[i] * vv[q]);
      *reinterpret_cast<float4*>(yp + (tt * kSlices + slice) * kCols + c0) =
          make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rr[i] = rn[i];
        kk[i] = kn[i];
        ww[i] = wn[i];
        vv[i] = vn[i];
      }
    }
    __syncthreads();

    // y = the slices' partials in ascending order + beta_t v_j, a
    // thread's outputs side by side (independent sums)
    {
      // outputs a thread takes: chunk <= 32, and 1 at decode (T = 1)
      constexpr int kOut = kDecode ? 1 : 32 * kCols / kThreads;
#pragma unroll
      for (int m = 0; m < kOut; ++m) {
        const int idx = tid + m * kThreads;
        const int tt = idx / kCols, col = idx % kCols;
        if (tt < n && col < ncols) {
          const float* pt = yp + tt * kSlices * kCols + col;
          float acc = pt[0];
#pragma unroll
          for (int sl = 1; sl < kSlices; ++sl) acc += pt[sl * kCols];
          y[vbase + (t0 + tt) * vrow + col] =
              fmaf(beta[tt], vc[tt * kCols + col], acc);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float* dst = s_outb + static_cast<long long>(row0 + i) * dv;
    if (vec && c0 < ncols) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    } else {
#pragma unroll
      for (int q = 0; q < kQuad; ++q)
        if (c0 + q < ncols) dst[q] = s[i][q];
    }
  }
}

template <int DK, bool kDecode>
int launch_one(const float* r, const float* k, const float* v,
               const float* w, const float* u, const float* s0, float* y,
               float* s_out, int b, int t_len, int h_len, int dv, int chunk,
               int vec, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(b) * h_len * ((dv + kCols - 1) / kCols);
  const size_t smem = sizeof(float) * smem_floats(DK, chunk);
  if (blocks >= (1LL << 31) || smem > 232448 || chunk > 32)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<DK, kDecode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wkv6_kernel<DK, kDecode>
      <<<static_cast<unsigned>(blocks), DK / kRows * kQuads, smem, stream>>>(
          r, k, v, w, u, s0, y, s_out, t_len, h_len, dv, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DK>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int b,
           int t_len, int h_len, int dv, int chunk, int vec,
           cudaStream_t stream) {
  if (t_len == 1)
    return launch_one<DK, true>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len,
                                dv, chunk, vec, stream);
  return launch_one<DK, false>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len,
                               dv, chunk, vec, stream);
}

}  // namespace

extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* s_out, int b, int t_len,
                           int h_len, int dk, int dv, int chunk, int vec,
                           void* stream) {
  if (b == 0 || h_len == 0) return 0;
  if (dv < 1 || t_len < 1 || chunk < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 16:
      return launch<16>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len, dv,
                        chunk, vec, s);
    case 32:
      return launch<32>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len, dv,
                        chunk, vec, s);
    case 64:
      return launch<64>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len, dv,
                        chunk, vec, s);
    case 128:
      return launch<128>(r, k, v, w, u, s0, y, s_out, b, t_len, h_len, dv,
                         chunk, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}
