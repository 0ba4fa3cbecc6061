"""Fused ADC scan -> top-k over PQ codes: the hand-written CUDA kernel's
wrapper.

Replaces ``repro/kernels/sivf_scan/pq_fused.py::sivf_pq_fused_search_pallas``,
unfiltered and filtered. The kernel is ``csrc/sivf_pq_fused_search.cu``,
in two routes chosen by :func:`route` from shapes alone:

* ``compacted`` (``m`` a multiple of 4 up to 64, ``ksub`` a power of two,
  and a block's shared memory within the card's limit): a block per query
  stages the query's ``[m, ksub]`` ADC table in shared memory, compacts
  the query's live table entries in ``t`` order, then scores their slots
  ``kNT = 256`` at a time, the next rounds' bitmap words, attribute words
  and codes in flight while one is scored, and folds each round at once
  into its warps' running top-k, which it merges at the end. It needs no
  scratch.
* ``per_query`` (any other shape): the first port's kernel, one thread
  block a query and one thread a slot, folding slab by slab
  (``csrc/topk_fold.cuh``).

Both give the reference fold's result bit for bit: the k smallest
candidates under the total order ``(distance, t, slot)``, each distance
the sum of its ``m`` lookups in ascending subspace order. Their plain
versions are ``ref.sivf_pq_fused_search_ref`` (the fold) and
``ref.sivf_pq_fused_search_split_ref`` (the compacted route's order at
``n_split=1``). Filtered searches take the same leaf program and
constants as ``fused.py``.

What bounds it on an H100: the table lookups, ``m`` shared-memory loads a
live slot at bank-conflicting random addresses (``live slots x m`` at 32
lookups a clock per SM), well above the bytes of the tables and codes.

The wrapper reads no device value on the host: the compaction runs on
the card and every shape comes from the operands.

Limits (checked, ``ValueError`` otherwise): ``C`` a multiple of 32 up to
1024; ``1 <= k <= 1024``; a block's shared memory (the table, the top-k
and, on ``compacted``, the row's slab list and the leaf program) within
the 227 KB a block may use (the launcher raises the block's limit above
48 KB).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.sivf_scan.fused import filter_operands

launches = 0            # unfiltered searches launched by this wrapper
filtered_launches = 0   # filtered searches launched by this wrapper
launches_compacted = 0  # ... of either kind, on the compacted route
launches_per_query = 0  # ... of either kind, on the per_query route

ROUTES = ("compacted", "per_query")
MAX_SMEM = 227 * 1024
COMPACTED_THREADS = 256     # csrc kNT: threads a block
COMPACTED_WINDOW = 8 * COMPACTED_THREADS    # csrc kWin: candidates screened
_MAX_SLOTS = 2 ** 31 - 1    # slots slab * C + c are int32 on the card
_P = ctypes.c_void_p
_I = ctypes.c_int
_fns: dict[str, ctypes._CFuncPtr] = {}      # route -> bound C entry point


def _fn(name: str):
    fn = _fns.get(name)
    if fn is not None:
        return fn
    lib = _build.load("sivf_pq_fused_search")
    if name == "per_query":
        fn = lib.sivf_pq_fused_search_launch
        fn.argtypes = [_P] * 7 + [_I, _P, _I, _P, _P] + [_I] * 7 + [_P]
    else:
        fn = lib.sivf_pq_fused_search_compacted_launch
        fn.argtypes = [_P] * 7 + [_I, _P, _I, _I, _P, _P] + [_I] * 7 + [_P]
    fn.restype = _I
    _fns[name] = fn
    return fn


def smem_bytes(m: int, ksub: int, c: int, k: int) -> int:
    """Shared memory of one ``per_query`` block: the table, 4k top-k
    entries, C candidates (``sivf_pq_fused_search_smem_bytes``)."""
    return 4 * (m * ksub + 4 * k + c)


def compacted_smem_bytes(m: int, ksub: int, k: int, t_len: int,
                         filter_words: int = 0) -> int:
    """Shared memory of one ``compacted`` block
    (``sivf_pq_fused_search_compacted_smem_bytes``): the table padded to
    16 bytes, a window's items, each warp's top-k, the row's ``t_len``
    slabs and ``filter_words`` of leaf program and constants."""
    return 4 * ((m * ksub + 3) // 4 * 4 + 2 * COMPACTED_WINDOW
                + 3 * (COMPACTED_THREADS // 32) * k + t_len + filter_words)


def _compacted_takes(m: int, ksub: int) -> bool:
    return m % 4 == 0 and 4 <= m <= 64 and ksub & (ksub - 1) == 0 \
        and 1 <= ksub <= 256


def route(m: int, ksub: int, k: int, t_len: int,
          filter_words: int = 0) -> str:
    """The kernel route for ``m`` subspaces of ``ksub`` centroids, top-k
    ``k`` over ``t_len`` table columns, from shapes alone: ``compacted``
    where its register-held codes take ``m`` (a multiple of 4 up to 64),
    ``ksub`` is a power of two and its block's shared memory
    (:func:`compacted_smem_bytes`) fits ``MAX_SMEM``, else ``per_query``."""
    fits = compacted_smem_bytes(m, ksub, k, t_len, filter_words) <= MAX_SMEM
    return "compacted" if _compacted_takes(m, ksub) and fits \
        else "per_query"


def launch_plan(adc: torch.Tensor, table: torch.Tensor, codes: torch.Tensor,
                k: int, route_name: str | None = None,
                filter_words: int = 0) -> dict:
    """The launch's shape-only plan: ``route`` (:func:`route` unless
    ``route_name`` names one) and a block's ``smem_bytes``;
    ``filter_words`` counts the leaf program's and constants' words.
    Reads shapes only (meta tensors do); raises ``ValueError`` where the
    route cannot take the shapes."""
    _, m, ksub = adc.shape
    t_len = table.shape[1]
    n_slabs, c, _ = codes.shape
    if c % 32 or not 32 <= c <= 1024:
        raise ValueError(f"slab capacity C={c} must be a multiple of 32 in "
                         "[32, 1024]")
    if not 1 <= k <= 1024:
        raise ValueError(f"k={k} must be in [1, 1024]")
    name = route_name or route(m, ksub, k, t_len, filter_words)
    if name not in ROUTES:
        raise ValueError(f"unknown route {name}; one of {ROUTES}")
    if name == "per_query":
        smem = smem_bytes(m, ksub, c, k)
    else:
        if not _compacted_takes(m, ksub):
            raise ValueError(f"the compacted route takes m a multiple of 4 "
                             f"in [4, 64] and ksub a power of two up to 256 "
                             f"(m={m}, ksub={ksub})")
        if n_slabs * c > _MAX_SLOTS:
            raise ValueError(f"{n_slabs} slabs of {c} slots exceed int32")
        smem = compacted_smem_bytes(m, ksub, k, t_len, filter_words)
    if smem > MAX_SMEM:
        raise ValueError(f"m={m}, ksub={ksub}, k={k}, C={c}, T={t_len} "
                         f"exceed the {name} kernel's {MAX_SMEM} bytes of "
                         "shared memory")
    return {"route": name, "smem_bytes": smem}


def sivf_pq_fused_search_cuda(adc: torch.Tensor, table: torch.Tensor,
                              codes: torch.Tensor, ids: torch.Tensor,
                              bitmap: torch.Tensor, k: int,
                              attrs: torch.Tensor | None = None,
                              fstruct: tuple | None = None,
                              fconsts: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """adc [Q,m,ksub] f32, table [Q,T] i32 -> (dists [Q,k] f32, labels [Q,k]).

    codes [n_slabs,C,m] uint8, ids [n_slabs,C] i32, bitmap [n_slabs,C/32]
    i32, all contiguous on one CUDA device. With ``fstruct``, ``attrs``
    [n_slabs,C,A] i32 and ``fconsts`` [n_consts] i32 select the filtered
    kernel. The route is :func:`launch_plan`'s. Launches
    on the current stream and raises if a launch (or the shared-memory
    limit it needs) is refused.
    """
    return search_route(None, adc, table, codes, ids, bitmap, k, attrs,
                        fstruct, fconsts)


def search_route(route_name: str | None, adc: torch.Tensor,
                 table: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
                 bitmap: torch.Tensor, k: int,
                 attrs: torch.Tensor | None = None,
                 fstruct: tuple | None = None,
                 fconsts: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sivf_pq_fused_search_cuda` on the named route (``None``: the
    shapes' own), so that both routes can be held to the same inputs."""
    global launches, filtered_launches, launches_compacted, launches_per_query
    dev = adc.device
    for name, t, dt, nd in (("adc", adc, torch.float32, 3),
                            ("table", table, torch.int32, 2),
                            ("codes", codes, torch.uint8, 3),
                            ("ids", ids, torch.int32, 2),
                            ("bitmap", bitmap, torch.int32, 2)):
        check_operand(name, t, dev, dt, nd)
    qn, m, ksub = adc.shape
    n_slabs, c, _ = codes.shape
    words = c // 32
    if table.shape[0] != qn or codes.shape[2] != m \
            or tuple(ids.shape) != (n_slabs, c) \
            or tuple(bitmap.shape) != (n_slabs, words):
        raise ValueError("inconsistent operand shapes")
    a_ptr, prog, n_leaves, consts, n_attrs, keep = filter_operands(
        attrs, fstruct, fconsts, n_slabs, c, dev)
    n_consts = keep[2].numel() if keep else 0
    plan = launch_plan(adc, table, codes, k, route_name,
                       3 * n_leaves + n_consts)
    dists = torch.empty((qn, k), dtype=torch.float32, device=dev)
    labels = torch.empty((qn, k), dtype=torch.int32, device=dev)
    compacted = plan["route"] == "compacted"
    fn = _fn(plan["route"])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if compacted:
            err = fn(adc.data_ptr(), table.data_ptr(), codes.data_ptr(),
                     ids.data_ptr(), bitmap.data_ptr(), a_ptr, prog,
                     n_leaves, consts, n_consts, n_attrs, dists.data_ptr(),
                     labels.data_ptr(), qn, table.shape[1], c, m, ksub,
                     words, k, stream)
        else:
            err = fn(adc.data_ptr(), table.data_ptr(), codes.data_ptr(),
                     ids.data_ptr(), bitmap.data_ptr(), a_ptr, prog,
                     n_leaves, consts, n_attrs, dists.data_ptr(),
                     labels.data_ptr(), qn, table.shape[1], c, m, ksub,
                     words, k, stream)
    if err:
        raise RuntimeError(f"sivf_pq_fused_search ({plan['route']}) launch "
                           f"failed: cudaError {err}")
    if fstruct is None:
        launches += 1
    else:
        filtered_launches += 1
    if compacted:
        launches_compacted += 1
    else:
        launches_per_query += 1
    return dists, labels
