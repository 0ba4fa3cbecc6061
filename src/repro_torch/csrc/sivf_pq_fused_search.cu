// Fused ADC scan -> top-k over PQ codes for Hopper (sm_90a), plain C
// interface.
//
// Replaces repro/kernels/sivf_scan/pq_fused.py::sivf_pq_fused_search_pallas,
// unfiltered and filtered: for each query, a live slot's distance is the
// sum of its m lookups adc[q, s, code[s]] in ascending subspace s, starting
// from the s = 0 term, each add rounded on its own (__fadd_rn). Dead slots
// (validity bitmap), -1 table entries and, when filtered, slots whose
// attributes fail the predicate score +inf / -1. The ADC table is already
// metric-shaped (core/pq.py adc_tables), so the kernel is metric-agnostic.
// The TPU kernel's one-hot [C, ksub] matrix product per subspace works
// around a TPU's lack of a fast gather; it is not ported: the table sits
// in shared memory and each lookup is one load.
//
// What the result is: the reference folds its table row column by column
// into a running top-k, so it returns the k smallest candidates (d, t, c)
// under the total order (distance, table column t, slot c); `<` on floats
// ties -0.0 with +0.0, and every +inf result carries label -1. The k
// smallest of a total order are one set whatever grouping the candidates
// arrive in, so the candidates may be folded many at a time in several
// lists and the lists merged under (distance, candidate)
// (ref.py sivf_pq_fused_search_split_ref, tested against the fold). Fed
// the same table, the kernel equals its plain version bit for bit, labels
// included.
//
// What bounds it on this card: the table lookups, not the bytes. A live
// slot costs m shared-memory loads at addresses set by random codes, so the
// 32 lanes of a load fall on 32 banks with a worst bank of about 3.5, and
// an SM serves one 32-bank wavefront a clock: about 9 lookups a clock per
// SM by that model, a quarter of the 32 a conflict-free load would serve,
// and only when every lane is live. At the PQ path's shape (Q = T = 1024,
// C = 128, m = 32, ksub = 256) the 11.5M live slots scored are 367M
// lookups; the 33.5 MB of tables and the codes of the probed slabs take
// well under half of that time in HBM. Every other shared-memory load and
// shuffle waits in the same queue, so the design spends them sparingly.
// The first port (route per_query below) took 29x its byte bound: it
// walked all T table entries of a query one at a time, mostly -1 pads,
// with a chain of dependent loads before each slab's lookups and three
// barriers after, on 1.29 waves of one block a query.
//
// Two routes, chosen by the wrapper from shapes alone:
//  * compacted (m a multiple of 4 up to 64, ksub a power of two, and a
//    block's shared memory within the card's limit): a grid of one block
//    of kNT = 256 threads a query; block q
//     1. loads its row's table columns and starts the copy of its query's
//        [m, ksub] table into shared memory (cp.async); filtered, it
//        stages the leaf program and constants;
//     2. compacts the row's live entries in t order (a block scan, no host
//        sync);
//     3. walks their candidates g = entry * C + slot in windows of
//        kWin = 2048 (16 entries at C = 128): the block screens a window,
//        kR = 8 slots a thread from one bitmap word (filtered: and their
//        attribute words, loaded at once with it), and lists the live
//        (passing) slots in g order; then each warp scores 32 listed slots
//        a step, so every lane does lookups, with the next step's item and
//        codes in flight in registers of fixed roles, and the m lookups of
//        16 subspaces issued ahead of their in-order adds (the code is
//        straight-line for 8-bit codes at m = 8, 16, 32, 64);
//     4. folds each step into the warp's own running top-k in shared
//        memory, with no block barrier: entrants rank themselves by binary
//        search and shuffles, and only they read their ids; a candidate
//        above any warp's k-th distance (a shared minimum) cannot reach the
//        block's top-k and is dropped unranked;
//     5. merges its 8 warps' lists under (distance, g) into the output row.
//  * per_query (any other shape): the first port's kernel, one thread block
//    a query and one thread a slot, folding slab by slab with
//    topk_fold.cuh.
//
// Filtered (kFiltered): the predicate is a conjunction of leaves, passed as
// a flat int32 program of (kind, attr, n_consts) triples plus constants, so
// one compiled instantiation serves every predicate; a failing slot is not
// listed: it loads no codes and does no lookups.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "stage_rows.cuh"
#include "topk_fold.cuh"

namespace {

// ---------------------------------------------------------------------------
// Route per_query: one block per query
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Route compacted: compacted entries, screened windows, warp folds, a merge
// ---------------------------------------------------------------------------

constexpr int kNT = 256;          // threads a block
constexpr int kWarps = kNT / 32;
constexpr int kR = 8;             // slots a thread screens a window
constexpr int kWin = kR * kNT;    // candidates a window
constexpr int kSegPer = 4;        // table columns a thread compacts at once
constexpr int kSeg = kSegPer * kNT;

// Of slots slot0 + r (r < kR), the bits of those whose attribute rows
// pass every leaf. A leaf's kR attribute words are loaded together (the
// first leaf's for every slot, at once with the caller's bitmap word; a
// later leaf's only for the slots still passing), and each constant is
// read once for all kR.
__device__ __forceinline__ unsigned passing(int slot0,
                                            const int* __restrict__ attrs,
                                            int n_attrs, const int* sprog,
                                            int n_leaves, const int* sconst) {
  unsigned mask = (1u << kR) - 1u;
  for (int i = 0, base = 0; i < n_leaves && mask; ++i) {
    const int* p = sprog + 3 * i;
    const int* cs = sconst + base;
    int a[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      a[r] = (mask >> r) & 1u
                 ? __ldg(attrs + (size_t)(slot0 + r) * n_attrs + p[1])
                 : 0;
    unsigned ok = 0u;
    if (p[0] == sivf::kEq) {
      const int c = cs[0];
#pragma unroll
      for (int r = 0; r < kR; ++r) ok |= (unsigned)(a[r] == c) << r;
    } else if (p[0] == sivf::kIn) {
      for (int j = 0; j < p[2]; ++j) {
        const int c = cs[j];
#pragma unroll
        for (int r = 0; r < kR; ++r) ok |= (unsigned)(a[r] == c) << r;
      }
    } else {
      const int lo = cs[0], hi = cs[1];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        ok |= (unsigned)(a[r] >= lo && a[r] < hi) << r;
    }
    mask &= ok;
    base += p[2];
  }
  return mask;
}

// A slot's m code bytes as m / 4 little-endian words, `vec` words a load.
template <int kW>
__device__ __forceinline__ void load_codes(uint32_t (&w)[kW],
                                           const unsigned char* p, int mw,
                                           int vec) {
  if (vec == 4) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int g = 0; g < kW / 4; ++g)
      if (4 * g < mw) {
        const uint4 v = __ldg(p4 + g);
        w[4 * g] = v.x;
        w[4 * g + 1] = v.y;
        w[4 * g + 2] = v.z;
        w[4 * g + 3] = v.w;
      }
  } else if (vec == 2) {
    const uint2* p2 = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int g = 0; g < kW / 2; ++g)
      if (2 * g < mw) {
        const uint2 v = __ldg(p2 + g);
        w[2 * g] = v.x;
        w[2 * g + 1] = v.y;
      }
  } else {
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int g = 0; g < kW; ++g)
      if (g < mw) w[g] = __ldg(p1 + g);
  }
}

// sum_s tab[s << nbits | code_s] in ascending s from the s = 0 term, each
// add rounded on its own. kNbits > 0: m = 4 * kW and nbits = kNbits are
// compile-time, the code straight: the lookups of 16 subspaces are issued
// before their adds, each one load at an immediate offset. kNbits = 0: m
// (a multiple of 4 up to 4 * kW) and nbits at run time, a word (four
// subspaces) at a time.
template <int kW, int kNbits>
__device__ __forceinline__ float score(const uint32_t (&w)[kW],
                                       const float* tab, int m, int nbits) {
  float d = 0.f;
  if constexpr (kNbits > 0) {
#pragma unroll
    for (int g0 = 0; g0 < kW; g0 += 4) {
      float term[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (4 * g0 + j < 4 * kW)
          term[j] = tab[((4 * g0 + j) << kNbits) +
                        ((w[g0 + (j >> 2)] >> (8 * (j & 3))) & 0xffu)];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (4 * g0 + j < 4 * kW)
          d = g0 + j == 0 ? term[j] : __fadd_rn(d, term[j]);
    }
  } else {
#pragma unroll
    for (int g = 0; g < kW; ++g) {
      if (4 * g < m) {
        float term[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          term[j] = tab[((4 * g + j) << nbits) + ((w[g] >> (8 * j)) & 0xffu)];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d = g + j == 0 ? term[j] : __fadd_rn(d, term[j]);
      }
    }
  }
  return d;
}

// An int that orders as its float does, -0.0 as +0.0 (NaN excluded).
__device__ __forceinline__ int ordered_key(float f) {
  const int b = __float_as_int(f == 0.f ? 0.f : f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Fold a warp's 32 candidates (d, g; lane order is g order) into its
// running top-k (wd, wl, wg) [k] in shared memory, sorted under (d, g):
// thr is its k-th distance, uniform over the warp. A candidate enters if
// it beats thr (a running entry, seen earlier, wins a tie) and is not
// above any warp's k-th distance (gk, read from *gkey at the step's start:
// their least as ordered_key; the fold lowers *gkey to its own): k
// candidates of that warp come before it, so it cannot reach the block's
// top-k. Entering candidates rank themselves by binary search in the list
// and by shuffles among each other; the list moves up from its top, 32
// entries at a time, from the first rank taken; only an entrant that
// stays reads its id.
__device__ __forceinline__ void warp_fold(float d, int g, int slot,
                                          const int* __restrict__ ids,
                                          float* wd, int* wl, int* wg, int k,
                                          float& thr, int gk, int* gkey) {
  const int lane = threadIdx.x & 31;
  const bool enter = d < thr && ordered_key(d) <= gk;
  const unsigned bal = __ballot_sync(~0u, enter);
  if (!bal) return;
  int rank = 0;
  if (enter) {
    int a = 0, b = k;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (wd[mid] <= d) a = mid + 1; else b = mid;
    }
    rank = a;
  }
  for (unsigned bb = bal; bb; bb &= bb - 1) {
    const int j = __ffs(bb) - 1;
    const float dj = __shfl_sync(~0u, d, j);
    rank += enter && (dj < d || (dj == d && j < lane));
  }
  const int r0 = (int)__reduce_min_sync(~0u, (unsigned)(enter ? rank : k));
  for (int base = (k - 1) & ~31; base >= (r0 & ~31); base -= 32) {
    const int j = base + lane;
    const bool mine = j >= r0 && j < k;
    float dj = 0.f;
    int lj = 0, gj = 0, shift = 0;
    if (mine) {
      dj = wd[j];
      lj = wl[j];
      gj = wg[j];
    }
    for (unsigned bb = bal; bb; bb &= bb - 1)
      shift += __shfl_sync(~0u, d, __ffs(bb) - 1) < dj;
    __syncwarp();
    if (mine && j + shift < k) {
      wd[j + shift] = dj;
      wl[j + shift] = lj;
      wg[j + shift] = gj;
    }
    __syncwarp();
  }
  if (enter && rank < k) {
    wd[rank] = d;
    wl[rank] = __ldg(ids + slot);
    wg[rank] = g;
  }
  __syncwarp();
  thr = wd[k - 1];
  if (lane == 0) atomicMin(gkey, ordered_key(thr));
}

// kNbits > 0: m = 4 * kW and nbits = kNbits (the arguments agree);
// kNbits = 0: any m a multiple of 4 up to 4 * kW, any nbits up to 8.
template <int kW, int kNbits, bool kFiltered>
__global__ void __launch_bounds__(kNT, kW <= 8 ? 4 : 2) compacted_scan_kernel(
    const float* __restrict__ adc, const int* __restrict__ table,
    const unsigned char* __restrict__ codes, const int* __restrict__ ids,
    const int* __restrict__ bitmap, const int* __restrict__ attrs,
    const int* __restrict__ prog, int n_leaves,
    const int* __restrict__ consts, int n_consts, int n_attrs,
    float* __restrict__ out_d, int* __restrict__ out_l, int t_len, int cap,
    int m, int nbits, int words, int k, int code_vec, bool tab_vec) {
  extern __shared__ float4 smem4[];
  __shared__ int warp_sum[kWarps];
  __shared__ int gkey;             // ordered_key of the least warp k-th
  if constexpr (kNbits > 0) {
    m = 4 * kW;
    nbits = kNbits;
  }
  const int tab_len = m << nbits;
  float* tab = reinterpret_cast<float*>(smem4);        // [m << nbits]
  int2* items = reinterpret_cast<int2*>(tab + ((tab_len + 3) & ~3));
  float* all_d = reinterpret_cast<float*>(items + kWin);   // [kWarps][k]
  int* all_l = reinterpret_cast<int*>(all_d + kWarps * k);
  int* all_g = all_l + kWarps * k;                     // [kWarps][k]
  int* lst = all_g + kWarps * k;                       // [t_len] slabs
  int* sprog = lst + t_len;                            // [3 * n_leaves]
  int* sconst = sprog + 3 * n_leaves;                  // [n_consts]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x;

  // 1. the row's first kSeg columns, then the query's table, in flight;
  // the program; empty warp lists
  const int* trow = table + (size_t)q * t_len;
  int v[kSegPer];
#pragma unroll
  for (int u = 0; u < kSegPer; ++u) {
    const int t = kSegPer * tid + u;
    v[u] = t < t_len ? __ldg(trow + t) : -1;
  }
  rec::stage_rows(tab, 0, adc + (size_t)q * tab_len, 0, 1, tab_len, tab_vec,
                  tid, kNT);
  rec::cp_async_commit();
  if (kFiltered) {
    for (int i = tid; i < 3 * n_leaves; i += kNT) sprog[i] = __ldg(prog + i);
    for (int i = tid; i < n_consts; i += kNT) sconst[i] = __ldg(consts + i);
  }
  for (int j = tid; j < kWarps * k; j += kNT) {
    all_d[j] = CUDART_INF_F;
    all_l[j] = -1;
    all_g[j] = -1;
  }

  // 2. the row's live entries, in t order, kSeg columns at a time
  int n_live = 0;
  for (int s0 = 0; s0 < t_len; s0 += kSeg) {
    if (s0 > 0) {
#pragma unroll
      for (int u = 0; u < kSegPer; ++u) {
        const int t = s0 + kSegPer * tid + u;
        v[u] = t < t_len ? __ldg(trow + t) : -1;
      }
    }
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kSegPer; ++u) cnt += v[u] >= 0;
    int seg;
    int at = n_live + sivf::block_exclusive_scan<kNT>(cnt, &seg, warp_sum);
    n_live += seg;
#pragma unroll
    for (int u = 0; u < kSegPer; ++u)
      if (v[u] >= 0) lst[at++] = v[u];
  }
  __syncthreads();

  // 3. the row's candidates g = entry * C + slot, (t, c) in order, in
  // windows of kWin: the block screens a window (each thread kR slots of
  // one bitmap word: their bits and, filtered, the predicate on their
  // attribute words) and lists its live slots in g order (a block scan);
  // then warp w scores items w * 32 + lane, w * 32 + 256 + lane, ..., 32
  // dense slots a step, and folds them into its own top-k. The next
  // step's item and codes are in flight while a step is scored, in
  // registers of fixed roles (two steps a turn), so no step waits on a
  // load it issued itself.
  const int n_cand = n_live * cap;
  const int mw = m >> 2;
  if (tid == 0) gkey = ordered_key(CUDART_INF_F);
  rec::cp_async_wait_all();
  __syncthreads();                                     // the table is in

  float* wd = all_d + warp * k;
  int* wl = all_l + warp * k;
  int* wg = all_g + warp * k;
  float thr = CUDART_INF_F;                            // wd[k - 1]
  uint32_t ca[kW] = {};
  uint32_t cb[kW] = {};
  for (int w0 = 0; w0 < n_cand; w0 += kWin) {
    // A. screen: this thread's kR slots g0 .. g0 + kR - 1
    const int g0 = w0 + kR * tid;
    unsigned mask = 0u;
    int slot0 = 0;
    if (g0 < n_cand) {
      const int e = g0 / cap;
      const int c0 = g0 - e * cap;
      const int slab = lst[e];
      slot0 = slab * cap + c0;
      const unsigned word = __ldg(reinterpret_cast<const unsigned*>(bitmap) +
                                  (size_t)slab * words + (c0 >> 5));
      mask = (1u << kR) - 1u;
      if (kFiltered)
        mask = passing(slot0, attrs, n_attrs, sprog, n_leaves, sconst);
      mask &= word >> (c0 & 31);
    }
    int n_w;
    int at = sivf::block_exclusive_scan<kNT>(__popc(mask), &n_w, warp_sum);
    for (unsigned b = mask; b; b &= b - 1) {
      const int r = __ffs(b) - 1;
      items[at++] = make_int2(slot0 + r, g0 + r);
    }
    __syncthreads();

    // B. score: steps s = 0 .. n_st - 1 of this warp
    const int first = warp * 32 + lane;
    const int n_st = n_w > warp * 32 ? (n_w - warp * 32 + kNT - 1) / kNT : 0;
    auto item = [&](int s) {
      const int i = first + s * kNT;
      return i < n_w ? items[i] : make_int2(-1, 0);
    };
    const int2 i0 = item(0);
    int2 ib = item(1);                                 // roles: item s + 1
    int2 ia = item(2);                                 // and item s + 2
    int slot = i0.x, g = i0.y;
    if (slot >= 0) load_codes<kW>(ca, codes + (size_t)slot * m, mw, code_vec);
    // step s: item s + 1 (it_next) starts its codes' load into c_next and
    // its role then reads item s + 3; c_now is scored
    auto step = [&](int s, int2& it_next, uint32_t (&c_now)[kW],
                    uint32_t (&c_next)[kW]) {
      const int gk = *static_cast<volatile int*>(&gkey);
      const int slot_n = it_next.x, g_n = it_next.y;
      if (slot_n >= 0)
        load_codes<kW>(c_next, codes + (size_t)slot_n * m, mw, code_vec);
      it_next = item(s + 3);
      const float d =
          slot >= 0 ? score<kW, kNbits>(c_now, tab, m, nbits) : CUDART_INF_F;
      warp_fold(d, g, slot, ids, wd, wl, wg, k, thr, gk, &gkey);
      slot = slot_n;
      g = g_n;
    };
    for (int s = 0; s < n_st; s += 2) {
      step(s, ib, ca, cb);
      if (s + 1 < n_st) step(s + 1, ia, cb, ca);
    }
    __syncthreads();                                   // items reused
  }

  // 4. the warps' lists merged under (d, g) into the output row: entry
  // (w, p) lands at p + the entries before it in the other lists (counted
  // one by one for k <= 32, else by binary search). A +inf pad is keyed
  // after every candidate, by its place.
  float* pd = out_d + (size_t)q * k;
  int* pl = out_l + (size_t)q * k;
  const int pad = n_cand;
  for (int i = tid; i < kWarps * k; i += kNT) {
    const int w = i / k;
    const float d = all_d[i];
    const int gi = isinf(d) ? pad + i : all_g[i];
    int rank = i - w * k;
    for (int w2 = 0; w2 < kWarps && rank < k; ++w2) {
      if (w2 == w) continue;
      if (k <= 32) {                 // independent loads, not a chain
        for (int j = 0; j < k; ++j) {
          const float x = all_d[w2 * k + j];
          const int gx = isinf(x) ? pad + w2 * k + j : all_g[w2 * k + j];
          rank += x < d || (x == d && gx < gi);
        }
        continue;
      }
      int a = 0, b = k;
      while (a < b) {
        const int mid = (a + b) >> 1;
        const float x = all_d[w2 * k + mid];
        const int gx = isinf(x) ? pad + w2 * k + mid : all_g[w2 * k + mid];
        if (x < d || (x == d && gx < gi)) a = mid + 1; else b = mid;
      }
      rank += a;
    }
    if (rank < k) {
      pd[rank] = d;
      pl[rank] = isinf(d) ? -1 : all_l[i];
    }
  }
}

template <int kW, int kNbits, bool kFiltered>
int launch_compacted(const float* adc, const int* table,
                     const unsigned char* codes, const int* ids,
                     const int* bitmap, const int* attrs, const int* prog,
                     int n_leaves, const int* consts, int n_consts,
                     int n_attrs, float* out_d, int* out_l, int n_queries,
                     int t_len, int cap, int m, int nbits, int words, int k,
                     int code_vec, bool tab_vec, size_t smem,
                     cudaStream_t s) {
  auto* kern = &compacted_scan_kernel<kW, kNbits, kFiltered>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<n_queries, kNT, smem, s>>>(
      adc, table, codes, ids, bitmap, attrs, prog, n_leaves, consts,
      n_consts, n_attrs, out_d, out_l, t_len, cap, m, nbits, words, k,
      code_vec, tab_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t sivf_pq_fused_search_smem_bytes(int m, int ksub, int cap,
                                                  int k) {
  return sizeof(float) * (size_t)m * ksub + sivf::fold_smem_bytes(k, cap);
}

// Launches the per_query route on `stream`; returns the cudaError_t of the
// launch or of the shared-memory attribute (0 = ok). `attrs` null selects
// the unfiltered instantiation (prog, consts unused); otherwise attrs
// [S, C, n_attrs], prog [3 * n_leaves], consts int32.
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

// Shared memory of one compacted-route block: the table (padded to 16
// bytes), a window's items (slot, g), each warp's top-k (distance, label,
// g), the row's slabs (t_len), the leaf program and its constants.
extern "C" size_t sivf_pq_fused_search_compacted_smem_bytes(
    int m, int ksub, int k, int t_len, int n_leaves, int n_consts) {
  return sizeof(float) * ((((size_t)m * ksub + 3) & ~(size_t)3) + 2 * kWin +
                          3 * (size_t)kWarps * k + t_len + 3 * n_leaves +
                          n_consts);
}

// Launches the compacted route on `stream`; returns the cudaError_t of the
// launch or of the shared-memory attribute (0 = ok). Takes m a multiple of
// 4 in [4, 64] and ksub a power of two; n_consts is the constants' count.
// Other arguments as for sivf_pq_fused_search_launch. Reads no device
// value on the host.
extern "C" int sivf_pq_fused_search_compacted_launch(
    const float* adc, const int* table, const unsigned char* codes,
    const int* ids, const int* bitmap, const int* attrs, const int* prog,
    int n_leaves, const int* consts, int n_consts, int n_attrs, float* out_d,
    int* out_l, int n_queries, int t_len, int cap, int m, int ksub,
    int words, int k, void* stream) {
  if (n_queries == 0) return 0;
  int nbits = 0;
  while ((1 << nbits) < ksub) ++nbits;
  if (m % 4 || m < 4 || m > 64 || (1 << nbits) != ksub || nbits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t cp = reinterpret_cast<size_t>(codes);
  const int code_vec = (m % 16 == 0 && cp % 16 == 0) ? 4
                       : (m % 8 == 0 && cp % 8 == 0) ? 2
                       : cp % 4 == 0                 ? 1
                                                     : 0;
  if (code_vec == 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const bool tab_vec = (m * ksub) % 4 == 0 &&
                       reinterpret_cast<size_t>(adc) % 16 == 0;
  const size_t smem = sivf_pq_fused_search_compacted_smem_bytes(
      m, ksub, k, t_len, attrs ? n_leaves : 0, attrs ? n_consts : 0);
  using Fn = int (*)(const float*, const int*, const unsigned char*,
                     const int*, const int*, const int*, const int*, int,
                     const int*, int, int, float*, int*, int, int, int, int,
                     int, int, int, int, bool, size_t, cudaStream_t);
  // straight-line scoring for 8-bit codes at m = 8, 16, 32, 64; any other
  // m and nbits the route takes score a word at a time
  const int fast = nbits != 8 ? -1 : m == 8 ? 0 : m == 16 ? 1 : m == 32 ? 2
                                   : m == 64 ? 3 : -1;
  const Fn fns[2][5] = {
      {&launch_compacted<2, 8, false>, &launch_compacted<4, 8, false>,
       &launch_compacted<8, 8, false>, &launch_compacted<16, 8, false>,
       &launch_compacted<16, 0, false>},
      {&launch_compacted<2, 8, true>, &launch_compacted<4, 8, true>,
       &launch_compacted<8, 8, true>, &launch_compacted<16, 8, true>,
       &launch_compacted<16, 0, true>}};
  const Fn fn = fns[attrs != nullptr][fast < 0 ? 4 : fast];
  return fn(adc, table, codes, ids, bitmap, attrs, prog,
            attrs ? n_leaves : 0, consts, attrs ? n_consts : 0, n_attrs,
            out_d, out_l, n_queries, t_len, cap, m, nbits, words, k,
            code_vec, tab_vec, smem, static_cast<cudaStream_t>(stream));
}
