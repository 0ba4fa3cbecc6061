"""Fused slab-scan -> top-k search: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/sivf_scan/fused.py::sivf_fused_search_pallas``,
unfiltered and filtered. The kernel is ``csrc/sivf_fused_search.cu``: one
thread block per query, one thread per slab slot, the running top-k in
shared memory, folded by rank with the reference's merge-row order
(``csrc/topk_fold.cuh``). Its plain version is ``ref.sivf_fused_search_ref``.

A filtered search passes the compiled predicate as a flat int32 leaf
program (``core.filters.leaf_program``, cached on the card per structure)
and its constants, and reads the state's ``[S, C, A]`` attribute plane in
place: one compiled instantiation serves every predicate.

What bounds it on an H100: the bytes of live slabs it reads
(``C*D*4 + C*8 + W*4`` per live table entry). This first version does
nothing about that yet: warp-per-row coalesced loads, cp.async / TMA
staging of slab tiles and sharing slabs between queries that probe the
same lists are queued in ROADMAP.md.

Limits (checked, ``ValueError`` otherwise): ``C`` a multiple of 32 up to
1024; ``1 <= k <= 1024``; the query row, ``4k`` top-k entries and ``C``
candidates must fit the 48 KB of shared memory a block gets by default.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.filters import leaf_program
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand

launches = 0            # unfiltered kernel launches made by this wrapper
filtered_launches = 0   # filtered kernel launches made by this wrapper

_MAX_SMEM = 48 * 1024
_P = ctypes.c_void_p
_I = ctypes.c_int

_programs: dict[tuple, torch.Tensor] = {}   # (structure, device) -> program


def _fn():
    lib = _build.load("sivf_fused_search")
    fn = lib.sivf_fused_search_launch
    fn.argtypes = [_P] * 8 + [_I, _P, _I, _P, _P] + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def raw_scan_operands(queries: torch.Tensor, table: torch.Tensor,
                      data: torch.Tensor, ids: torch.Tensor,
                      norms: torch.Tensor, bitmap: torch.Tensor, metric: str
                      ) -> tuple[int, int, int, int, int]:
    """Check the operands both raw scans take (fused and unfused) and
    return ``(Q, D, n_slabs, C, W)``: contiguous on one CUDA device, of
    consistent shapes, ``C`` a positive multiple of 32, a known metric."""
    dev = queries.device
    for name, t, dt, nd in (("queries", queries, torch.float32, 2),
                            ("table", table, torch.int32, 2),
                            ("data", data, torch.float32, 3),
                            ("ids", ids, torch.int32, 2),
                            ("norms", norms, torch.float32, 2),
                            ("bitmap", bitmap, torch.int32, 2)):
        check_operand(name, t, dev, dt, nd)
    qn, d_dim = queries.shape
    n_slabs, c, _ = data.shape
    words = c // 32
    if c % 32 or c == 0:
        raise ValueError(f"slab capacity C={c} must be a positive multiple "
                         "of 32")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric}")
    if table.shape[0] != qn or data.shape[2] != d_dim \
            or tuple(ids.shape) != (n_slabs, c) \
            or tuple(norms.shape) != (n_slabs, c) \
            or tuple(bitmap.shape) != (n_slabs, words):
        raise ValueError("inconsistent operand shapes")
    return qn, d_dim, n_slabs, c, words


def filter_operands(attrs: torch.Tensor | None, fstruct: tuple | None,
                    fconsts: torch.Tensor | None, n_slabs: int, c: int,
                    device: torch.device) -> tuple:
    """The launch's filter arguments ``(attrs, prog, n_leaves, consts,
    n_attrs, keep)``: pointers (``None`` when unfiltered) and the tensors
    they point into. ``attrs`` [n_slabs, C, A] int32 on ``device``."""
    if fstruct is None:
        return None, None, 0, None, 0, ()
    check_operand("attrs", attrs, device, torch.int32, 3)
    if tuple(attrs.shape[:2]) != (n_slabs, c):
        raise ValueError(f"attrs shape {tuple(attrs.shape)} does not match "
                         f"the slab planes {(n_slabs, c)}")
    flat = leaf_program(fstruct)
    n_leaves = len(flat) // 3
    if sum(flat[2::3]) != fconsts.numel():
        raise ValueError(f"{fconsts.numel()} constants for a structure that "
                         f"takes {sum(flat[2::3])}")
    if max(flat[1::3]) >= attrs.shape[2]:
        raise ValueError(f"structure {fstruct} tests an attribute beyond "
                         f"the plane's {attrs.shape[2]}")
    key = (fstruct, device)
    prog = _programs.get(key)
    if prog is None:
        prog = _programs[key] = torch.tensor(flat, dtype=torch.int32,
                                             device=device)
    consts = fconsts.to(device=device, dtype=torch.int32).contiguous()
    return (attrs.data_ptr(), prog.data_ptr(), n_leaves, consts.data_ptr(),
            attrs.shape[2], (attrs, prog, consts))


def sivf_fused_search_cuda(queries: torch.Tensor, table: torch.Tensor,
                           data: torch.Tensor, ids: torch.Tensor,
                           norms: torch.Tensor, bitmap: torch.Tensor, k: int,
                           metric: str = "l2",
                           attrs: torch.Tensor | None = None,
                           fstruct: tuple | None = None,
                           fconsts: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q,D] f32, table [Q,T] i32 -> (dists [Q,k] f32, labels [Q,k]).

    data [n_slabs,C,D] f32, ids [n_slabs,C] i32, norms [n_slabs,C] f32,
    bitmap [n_slabs,C/32] i32, all contiguous on one CUDA device. With
    ``fstruct`` (``core.filters.compile_filter``), ``attrs`` [n_slabs,C,A]
    i32 and ``fconsts`` [n_consts] i32 select the filtered kernel.
    Launches on the current stream and raises if the launch is refused.
    """
    global launches, filtered_launches
    dev = queries.device
    qn, d_dim, n_slabs, c, words = raw_scan_operands(
        queries, table, data, ids, norms, bitmap, metric)
    if c > 1024:
        raise ValueError(f"slab capacity C={c} exceeds 1024 (one thread "
                         "per slot)")
    if not 1 <= k <= 1024:
        raise ValueError(f"k={k} must be in [1, 1024]")
    if 4 * ((d_dim + 3) // 4 * 4 + 4 * k + c) > _MAX_SMEM:
        raise ValueError(f"D={d_dim}, k={k}, C={c} exceed the kernel's "
                         f"{_MAX_SMEM} bytes of shared memory")
    a_ptr, prog, n_leaves, consts, n_attrs, _keep = filter_operands(
        attrs, fstruct, fconsts, n_slabs, c, dev)
    dists = torch.empty((qn, k), dtype=torch.float32, device=dev)
    labels = torch.empty((qn, k), dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), table.data_ptr(), data.data_ptr(),
                 ids.data_ptr(), norms.data_ptr(), bitmap.data_ptr(), a_ptr,
                 prog, n_leaves, consts, n_attrs, dists.data_ptr(),
                 labels.data_ptr(), qn, table.shape[1], c, d_dim, words, k,
                 int(metric == "l2"), stream)
    if err:
        raise RuntimeError(f"sivf_fused_search launch failed: cudaError {err}")
    if fstruct is None:
        launches += 1
    else:
        filtered_launches += 1
    return dists, labels
