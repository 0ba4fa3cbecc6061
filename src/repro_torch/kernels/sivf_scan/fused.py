"""Fused slab-scan -> top-k search: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/sivf_scan/fused.py::sivf_fused_search_pallas``
(unfiltered). The kernel is ``csrc/sivf_fused_search.cu``: one thread
block per query, one thread per slab slot, the running top-k in shared
memory, folded by rank with the reference's merge-row order. Its plain
version is ``ref.sivf_fused_search_ref``.

What bounds it on an H100: the bytes of live slabs it reads
(``C*D*4 + C*8 + W*4`` per live table entry). This first version does
nothing about that yet; warp-per-row coalesced loads, cp.async / TMA
staging of slab tiles and sharing slabs between queries that probe the
same lists are queued in ROADMAP.md.

Limits (checked, ``ValueError`` otherwise): ``C`` a multiple of 32 up to
1024; ``1 <= k <= 1024``; the query row, ``4k`` top-k entries and ``C``
candidates must fit the 48 KB of shared memory a block gets by default.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0        # kernel launches made by this wrapper

_MAX_SMEM = 48 * 1024
_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    lib = _build.load("sivf_fused_search")
    fn = lib.sivf_fused_search_launch
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}; "
                         "the CPU path is ref.sivf_fused_search_ref")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} with {ndim} dims, "
                         f"got {t.dtype} {tuple(t.shape)}")


def sivf_fused_search_cuda(queries: torch.Tensor, table: torch.Tensor,
                           data: torch.Tensor, ids: torch.Tensor,
                           norms: torch.Tensor, bitmap: torch.Tensor, k: int,
                           metric: str = "l2"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q,D] f32, table [Q,T] i32 -> (dists [Q,k] f32, labels [Q,k]).

    data [n_slabs,C,D] f32, ids [n_slabs,C] i32, norms [n_slabs,C] f32,
    bitmap [n_slabs,C/32] i32, all contiguous on one CUDA device. Launches
    on the current stream and raises if the launch is refused.
    """
    global launches
    for name, t, dt, nd in (("queries", queries, torch.float32, 2),
                            ("table", table, torch.int32, 2),
                            ("data", data, torch.float32, 3),
                            ("ids", ids, torch.int32, 2),
                            ("norms", norms, torch.float32, 2),
                            ("bitmap", bitmap, torch.int32, 2)):
        _check(name, t, dt, nd)
    qn, d_dim = queries.shape
    n_slabs, c, _ = data.shape
    words = c // 32
    if {t.device for t in (queries, table, data, ids, norms, bitmap)} \
            != {queries.device}:
        raise ValueError("all operands must be on one device")
    if c % 32 or not 32 <= c <= 1024:
        raise ValueError(f"slab capacity C={c} must be a multiple of 32 in "
                         "[32, 1024]")
    if not 1 <= k <= 1024:
        raise ValueError(f"k={k} must be in [1, 1024]")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric}")
    if table.shape[0] != qn or data.shape[2] != d_dim \
            or tuple(ids.shape) != (n_slabs, c) \
            or tuple(norms.shape) != (n_slabs, c) \
            or tuple(bitmap.shape) != (n_slabs, words):
        raise ValueError("inconsistent operand shapes")
    if 4 * ((d_dim + 3) // 4 * 4 + 4 * k + c) > _MAX_SMEM:
        raise ValueError(f"D={d_dim}, k={k}, C={c} exceed the kernel's "
                         f"{_MAX_SMEM} bytes of shared memory")
    dists = torch.empty((qn, k), dtype=torch.float32, device=queries.device)
    labels = torch.empty((qn, k), dtype=torch.int32, device=queries.device)
    fn = _fn()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), table.data_ptr(), data.data_ptr(),
                 ids.data_ptr(), norms.data_ptr(), bitmap.data_ptr(),
                 dists.data_ptr(), labels.data_ptr(), qn, table.shape[1], c,
                 d_dim, words, k, int(metric == "l2"), stream)
    if err:
        raise RuntimeError(f"sivf_fused_search launch failed: cudaError {err}")
    launches += 1
    return dists, labels
