"""Unfused slab scan: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/sivf_scan/sivf_scan.py::sivf_scan_pallas``. The
kernel is ``csrc/sivf_scan.cu``, in two routes chosen by :func:`route`
from shapes alone:

* ``grouped`` (``C <= 1024``, ``Q*T < 2**31``): the plan of kernel 1's
  grouped route (``csrc/slab_plan.cuh``) inverts the table on the card
  into chunks of one slab's live ``(q, t)`` entries; one persistent
  kernel reads each probed slab's live rows once for up to 16 of its
  entries and writes their rows of ``C`` distances and labels, and fills
  the rows of the ``-1`` entries with ``+inf`` / ``-1``, the two kinds of
  work interleaved. Its scratch is the plan (:func:`launch_plan`).
* ``per_entry`` (any other shape whose query row fits a block's 48 KB of
  shared memory): the first port's kernel, one warp per (query, table
  entry), lanes over slots.

Both use the fused kernel's arithmetic (``csrc/dot_row.cuh``), so the
top-k of their output (``kernels/topk``) equals ``sivf_fused_search`` bit
for bit. Its plain version is ``ref.sivf_scan_ref``.

What bounds it on an H100: bytes, above all the ``[Q, T*C]`` outputs
(8 bytes a slot, live or not); each is written once, 16 bytes a store on
the grouped route.

The wrapper reads no device value on the host. A shape that neither
route takes raises ``ValueError``; there is no fallback to the plain
version on a CUDA tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sivf_scan.fused import plan_bytes, raw_scan_operands

launches = 0            # kernel launches made by this wrapper (either route)
launches_grouped = 0    # ... on the grouped route
launches_per_entry = 0  # ... on the per_entry route

ROUTES = ("grouped", "per_entry")
_MAX_SMEM = 48 * 1024
_MAX_GROUPED_C = 1024
_MAX_ENTRIES = 2 ** 31 - 1        # entries q * T + t are int32 on the card
_WARPS = 8              # table entries per per_entry block (in the source)
_P = ctypes.c_void_p
_I = ctypes.c_int
_fns: dict[str, ctypes._CFuncPtr] = {}      # route -> bound C entry point


def _fn(name: str):
    fn = _fns.get(name)
    if fn is not None:
        return fn
    lib = _build.load("sivf_scan")
    if name == "per_entry":
        fn = lib.sivf_scan_launch
        fn.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    else:
        fn = lib.sivf_scan_grouped_launch
        fn.argtypes = [_P] * 8 + [_I] * 7 + [_P, ctypes.c_size_t, _P]
    fn.restype = _I
    _fns[name] = fn
    return fn


def route(qn: int, t_len: int, c: int) -> str:
    """The kernel route for ``Q x T`` tables of slab capacity ``C``, from
    shapes alone: ``grouped`` where its block holds a slab's ``C`` slots
    (``C <= 1024``) and its int32 entries hold ``Q*T``, else
    ``per_entry``."""
    return "grouped" if c <= _MAX_GROUPED_C and qn * t_len <= _MAX_ENTRIES \
        else "per_entry"


def launch_plan(queries: torch.Tensor, table: torch.Tensor,
                data: torch.Tensor, route_name: str | None = None) -> dict:
    """The launch's shape-only plan: ``route`` (:func:`route` unless
    ``route_name`` names one) and its ``scratch_bytes`` (the grouped
    route's plan, ``fused.plan_bytes``; none for ``per_entry``). Reads
    shapes only (meta tensors do); raises ``ValueError`` where the route
    cannot take the shapes."""
    qn, d_dim = queries.shape
    t_len = table.shape[1]
    n_slabs, c, _ = data.shape
    name = route_name or route(qn, t_len, c)
    if name not in ROUTES:
        raise ValueError(f"unknown route {name}; one of {ROUTES}")
    if name == "grouped":
        if c > _MAX_GROUPED_C or qn * t_len > _MAX_ENTRIES:
            raise ValueError(f"the grouped route takes C <= {_MAX_GROUPED_C}"
                             f" and Q*T <= 2**31 - 1 (C={c}, Q*T={qn * t_len})")
        return {"route": name, "scratch_bytes": plan_bytes(qn, t_len, n_slabs)}
    if 4 * ((d_dim + 3) // 4 * 4) > _MAX_SMEM:
        raise ValueError(f"D={d_dim} exceeds the per_entry kernel's "
                         f"{_MAX_SMEM} bytes of shared memory")
    if qn * -(-t_len // _WARPS) >= 2 ** 31:
        raise ValueError(f"Q={qn}, T={t_len}: too many per_entry blocks for "
                         "one launch")
    return {"route": name, "scratch_bytes": 0}


def sivf_scan_cuda(queries: torch.Tensor, table: torch.Tensor,
                   data: torch.Tensor, ids: torch.Tensor, norms: torch.Tensor,
                   bitmap: torch.Tensor, metric: str = "l2"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q,D] f32, table [Q,T] i32 -> (dists [Q,T*C] f32, labels
    [Q,T*C] i32).

    data [n_slabs,C,D] f32, ids [n_slabs,C] i32, norms [n_slabs,C] f32,
    bitmap [n_slabs,C/32] i32, all contiguous on one CUDA device. The
    route is :func:`route`'s. Launches on the current stream and raises if
    a launch is refused.
    """
    return scan_route(None, queries, table, data, ids, norms, bitmap, metric)


def scan_route(route_name: str | None, queries: torch.Tensor,
               table: torch.Tensor, data: torch.Tensor, ids: torch.Tensor,
               norms: torch.Tensor, bitmap: torch.Tensor, metric: str = "l2"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sivf_scan_cuda` on the named route (``None``: the shapes'
    own), so that both routes can be held to the same inputs."""
    global launches, launches_grouped, launches_per_entry
    dev = queries.device
    qn, d_dim, n_slabs, c, words = raw_scan_operands(
        queries, table, data, ids, norms, bitmap, metric)
    plan = launch_plan(queries, table, data, route_name)
    t_len = table.shape[1]
    dists = torch.empty((qn, t_len * c), dtype=torch.float32, device=dev)
    labels = torch.empty((qn, t_len * c), dtype=torch.int32, device=dev)
    grouped = plan["route"] == "grouped"
    fn = _fn(plan["route"])
    args = [queries.data_ptr(), table.data_ptr(), data.data_ptr(),
            ids.data_ptr(), norms.data_ptr(), bitmap.data_ptr(),
            dists.data_ptr(), labels.data_ptr(), qn, t_len]
    with torch.cuda.device(dev):
        stream = _build.stream_of(dev)
        if grouped:
            scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                                  device=dev)
            err = fn(*args, n_slabs, c, d_dim, words, int(metric == "l2"),
                     scratch.data_ptr(), plan["scratch_bytes"], stream)
        else:
            err = fn(*args, c, d_dim, words, int(metric == "l2"), stream)
    if err:
        raise RuntimeError(f"sivf_scan ({plan['route']}) launch failed: "
                           f"cudaError {err}")
    if qn and t_len:                  # the C side launches nothing for 0
        launches += 1
        if grouped:
            launches_grouped += 1
        else:
            launches_per_entry += 1
    return dists, labels
