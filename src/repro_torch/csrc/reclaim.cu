// Sequential slab reclamation for a delete batch (paper Alg. 4 lines 15-19),
// plain C interface.
//
// Not a port of a TPU kernel: it replaces the body of the fori_loop in
// repro/core/index.py::_delete_impl (index.py:361-401), which walks every
// batch row on the device. The caller has already found, vectorised, which
// rows reclaim a slab and packed those slabs first, in row order; only the
// unlink, the dense-table swap-with-last and the free-stack push stay
// sequential, because a later slab's unlink reads the links an earlier one
// wrote. One thread runs them, reading the count from device memory, so a
// delete needs no host sync.
//
// What bounds it: latency of dependent global loads and stores (about 20
// per reclaimed slab), not bandwidth. Reclaimed slabs are few per batch;
// the design keeps them on one thread rather than adding synchronisation.
#include <cuda_runtime.h>

namespace {

__global__ void reclaim_kernel(const int* __restrict__ slabs,
                               const int* __restrict__ count, int* heads,
                               int* nxt, int* prv, int* owner, int* cursor,
                               int* free_stack, int* free_top, int* tables,
                               int* table_len, int* table_pos,
                               int max_chain) {
  const int n = *count;
  int top = *free_top;
  for (int i = 0; i < n; ++i) {
    const int si = slabs[i];
    const int li = owner[si];
    const int p = prv[si];
    const int nx = nxt[si];
    // unlink from the doubly-linked chain
    if (p < 0) heads[li] = nx; else nxt[p] = nx;
    if (nx >= 0) prv[nx] = p;
    // dense-table removal: swap-with-last
    int* row = tables + (size_t)li * max_chain;
    const int pos = max(table_pos[si], 0);
    const int last = max(table_len[li] - 1, 0);
    const int moved = row[last];
    row[pos] = moved;
    row[last] = -1;
    if (moved >= 0) table_pos[moved] = pos;
    table_pos[si] = -1;
    table_len[li] -= 1;
    // recycle (instant reuse; paper §3.1 "immediate reclamation")
    free_stack[top] = si;
    top += 1;
    owner[si] = -1;
    cursor[si] = 0;
    nxt[si] = -1;
    prv[si] = -1;
  }
  *free_top = top;
}

}  // namespace

// Launches one thread on `stream`; returns the cudaError_t of the launch.
extern "C" int reclaim_launch(const int* slabs, const int* count, int* heads,
                              int* nxt, int* prv, int* owner, int* cursor,
                              int* free_stack, int* free_top, int* tables,
                              int* table_len, int* table_pos, int max_chain,
                              void* stream) {
  reclaim_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      slabs, count, heads, nxt, prv, owner, cursor, free_stack, free_top,
      tables, table_len, table_pos, max_chain);
  return static_cast<int>(cudaGetLastError());
}
