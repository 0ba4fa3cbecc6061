"""Fused slab-scan -> top-k search: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/sivf_scan/fused.py::sivf_fused_search_pallas``,
unfiltered and filtered. The kernel is ``csrc/sivf_fused_search.cu``, in
two routes chosen by :func:`route` from shapes alone:

* ``grouped`` (``k < C``): a plan on the card inverts the table into a
  CSR map from slab to the ``(q, t)`` entries that probe it, a persistent
  scan reads each probed slab's live rows once for all of its entries and
  keeps each entry's k smallest under ``(distance, slot)``, and a merge
  folds each query's partials under ``(distance, t, position)``. Its
  scratch (:func:`launch_plan`) is ``[Q, T, k]`` partials plus the plan,
  strictly below the unfused pair's ``[Q, T*C]``.
* ``per_query`` (``k >= C``, where the partials would not be smaller):
  one thread block per query, one thread per slab slot, the running top-k
  folded slab by slab in shared memory (``csrc/topk_fold.cuh``).

Both give the reference fold's result bit for bit: the k smallest
candidates under the total order ``(distance, t, slot)``. Their plain
versions are ``ref.sivf_fused_search_ref`` (the fold) and
``ref.sivf_fused_search_split_ref`` (the grouped order).

A filtered search passes the compiled predicate as a flat int32 leaf
program (``core.filters.leaf_program``, cached on the card per structure)
and its constants, and reads the state's ``[S, C, A]`` attribute plane in
place: one compiled instantiation serves every predicate.

The wrapper reads no device value on the host: the plan is built on the
card and every shape comes from the operands.

Limits (checked, ``ValueError`` otherwise): ``C`` a multiple of 32 up to
1024; ``1 <= k <= 1024``. On the ``per_query`` route (and on the grouped
one's shapes when ``Q*T`` reaches 2**31) the query row, ``4k`` top-k
entries and ``C`` candidates must fit the 48 KB of shared memory a block
gets by default; the ``grouped`` route takes any ``D``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.filters import leaf_program
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand

launches = 0            # unfiltered searches launched by this wrapper
filtered_launches = 0   # filtered searches launched by this wrapper
launches_grouped = 0    # ... of either kind, on the grouped route
launches_per_query = 0  # ... of either kind, on the per_query route

ROUTES = ("grouped", "per_query")
_MAX_SMEM = 48 * 1024
_MAX_ENTRIES = 2 ** 31 - 1        # entries q * T + t are int32 on the card
_P = ctypes.c_void_p
_I = ctypes.c_int

_programs: dict[tuple, torch.Tensor] = {}   # (structure, device) -> program
_fns: dict[str, ctypes._CFuncPtr] = {}      # route -> bound C entry point


def _fn(name: str):
    fn = _fns.get(name)
    if fn is not None:
        return fn
    lib = _build.load("sivf_fused_search")
    if name == "per_query":
        fn = lib.sivf_fused_search_launch
        fn.argtypes = [_P] * 8 + [_I, _P, _I, _P, _P] + [_I] * 7 + [_P]
    else:
        fn = lib.sivf_fused_search_grouped_launch
        fn.argtypes = [_P] * 8 + [_I, _P, _I, _P, _P] + [_I] * 8 + [
            _P, ctypes.c_size_t, _P]
    fn.restype = _I
    _fns[name] = fn
    return fn


def route(qn: int, t_len: int, c: int, k: int) -> str:
    """The kernel route for ``Q x T`` tables, slab capacity ``C`` and
    ``k``, from shapes alone: ``grouped`` where its ``[Q, T, k]`` partials
    are strictly smaller than the unfused pair's ``[Q, T*C]`` candidates
    (``k < C``) and its int32 entries hold ``Q*T``, else ``per_query``."""
    return "grouped" if k < c and qn * t_len <= _MAX_ENTRIES else "per_query"


def plan_bytes(qn: int, t_len: int, n_slabs: int) -> int:
    """Bytes of the grouped scans' plan (``csrc/slab_plan.cuh``
    ``plan_words``; shared with the unfused scan's route ``grouped``): a
    16-byte record per work chunk (at most 16 entries of one slab), a count
    and an offset per slab, the chunk count and work counter, the entries
    and ``||q||^2``."""
    n = qn * t_len
    chunks = -(-n // 16) + min(n_slabs, n)
    return 4 * (4 * chunks + 2 * n_slabs + 3 + n + qn)


def grouped_scratch_bytes(qn: int, t_len: int, n_slabs: int, k: int) -> int:
    """Bytes of the grouped route's scratch (``csrc/sivf_fused_search.cu``
    ``scratch_words``; the C side refuses a smaller workspace): the plan
    (:func:`plan_bytes`) and ``[Q*T, k]`` partial distances and labels."""
    return plan_bytes(qn, t_len, n_slabs) + 8 * qn * t_len * k


def launch_plan(queries: torch.Tensor, table: torch.Tensor,
                data: torch.Tensor, k: int, route_name: str | None = None
                ) -> dict:
    """The launch's shape-only plan: ``route`` (:func:`route` unless
    ``route_name`` names one) and its ``scratch_bytes``. Reads shapes only
    (meta tensors do); raises ``ValueError`` where the route cannot take
    the shapes."""
    qn, d_dim = queries.shape
    t_len = table.shape[1]
    n_slabs, c, _ = data.shape
    if c > 1024:
        raise ValueError(f"slab capacity C={c} exceeds 1024 (one thread "
                         "per slot)")
    if not 1 <= k <= 1024:
        raise ValueError(f"k={k} must be in [1, 1024]")
    name = route_name or route(qn, t_len, c, k)
    if name not in ROUTES:
        raise ValueError(f"unknown route {name}; one of {ROUTES}")
    if name == "grouped":
        if k >= c or qn * t_len > _MAX_ENTRIES:
            raise ValueError(f"the grouped route takes k < C={c} and "
                             f"Q*T <= 2**31 - 1 (k={k}, Q*T={qn * t_len})")
        return {"route": name,
                "scratch_bytes": grouped_scratch_bytes(qn, t_len, n_slabs, k)}
    if 4 * ((d_dim + 3) // 4 * 4 + 4 * k + c) > _MAX_SMEM:
        raise ValueError(f"D={d_dim}, k={k}, C={c} exceed the per_query "
                         f"kernel's {_MAX_SMEM} bytes of shared memory")
    return {"route": name, "scratch_bytes": 0}


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
    i32 and ``fconsts`` [n_consts] i32 select the filtered kernel. The
    route is :func:`route`'s. Launches on the current stream and raises if
    a launch is refused.
    """
    return search_route(None, queries, table, data, ids, norms, bitmap, k,
                        metric, attrs, fstruct, fconsts)


def search_route(route_name: str | None, queries: torch.Tensor,
                 table: torch.Tensor, data: torch.Tensor, ids: torch.Tensor,
                 norms: torch.Tensor, bitmap: torch.Tensor, k: int,
                 metric: str = "l2", attrs: torch.Tensor | None = None,
                 fstruct: tuple | None = None,
                 fconsts: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sivf_fused_search_cuda` on the named route (``None``: the
    shapes' own), so that both routes can be held to the same inputs."""
    global launches, filtered_launches, launches_grouped, launches_per_query
    dev = queries.device
    qn, d_dim, n_slabs, c, words = raw_scan_operands(
        queries, table, data, ids, norms, bitmap, metric)
    plan = launch_plan(queries, table, data, k, route_name)
    a_ptr, prog, n_leaves, consts, n_attrs, _keep = filter_operands(
        attrs, fstruct, fconsts, n_slabs, c, dev)
    dists = torch.empty((qn, k), dtype=torch.float32, device=dev)
    labels = torch.empty((qn, k), dtype=torch.int32, device=dev)
    grouped = plan["route"] == "grouped"
    fn = _fn(plan["route"])
    args = [queries.data_ptr(), table.data_ptr(), data.data_ptr(),
            ids.data_ptr(), norms.data_ptr(), bitmap.data_ptr(), a_ptr,
            prog, n_leaves, consts, n_attrs, dists.data_ptr(),
            labels.data_ptr(), qn, table.shape[1]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if grouped:
            scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                                  device=dev)
            err = fn(*args, n_slabs, c, d_dim, words, k,
                     int(metric == "l2"), scratch.data_ptr(),
                     plan["scratch_bytes"], stream)
        else:
            err = fn(*args, c, d_dim, words, k, int(metric == "l2"), stream)
    if err:
        raise RuntimeError(f"sivf_fused_search ({plan['route']}) launch "
                           f"failed: cudaError {err}")
    if fstruct is None:
        launches += 1
    else:
        filtered_launches += 1
    if grouped:
        launches_grouped += 1
    else:
        launches_per_query += 1
    return dists, labels
