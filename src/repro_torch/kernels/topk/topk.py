"""Row-wise k smallest: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/topk/topk.py::topk_pallas``, with the semantics
of its plain version (``ref.topk_ref``: total order, lower column on
ties, a chosen ``+inf`` keeps its label). The kernel is ``csrc/topk.cu``,
in two routes chosen by :func:`route` from ``k`` alone:

* ``warp`` (``k <= 32``): a block a row; each warp keeps its k smallest
  keys as a sorted list across its lanes and screens each 16-byte load
  as a whole against the list's k-th key, then key by key where a lane
  passes; the few passing keys merge into the list 32 at a time, and the
  warps' lists merge at the end.
* ``block`` (any ``k``; the default for ``k > 32``): the first port's
  kernel, one block a row, each thread keeping the 16 smallest keys of
  its strided slice, then ``k`` rounds of a block-wide minimum (with
  refills past 16).

None copies the Pallas kernel's masking, which can pick an already
extracted column again once a row has fewer than ``k`` finite entries.

What bounds it on an H100: bytes, one read of each row's distances (plus
the ``k`` labels and outputs).

The wrapper reads no device value on the host; there is no fallback to
the plain version on a CUDA tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.topk.ref import check_operands

launches = 0            # calls launched by this wrapper (any route)
launches_warp = 0       # ... on the warp route
launches_block = 0      # ... on the block route

ROUTES = ("warp", "block")
MAX_WARP_K = 32         # the warp route's k: one key a lane
_MAX_LEN = 2 ** 31 - 1024
_P = ctypes.c_void_p
_I = ctypes.c_int
_fns: dict[str, ctypes._CFuncPtr] = {}      # entry point -> bound function


def _fn(name: str):
    fn = _fns.get(name)
    if fn is not None:
        return fn
    lib = _build.load("topk")
    fn = lib.topk_launch if name == "block" else lib.topk_warp_launch
    fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    fn.restype = _I
    _fns[name] = fn
    return fn


def route(qn: int, n: int, k: int) -> str:
    """The kernel route for ``[Q, L]`` rows and ``k``, from shapes alone:
    ``warp`` for ``k <= 32``, else ``block``."""
    return "warp" if k <= MAX_WARP_K else "block"


def launch_plan(dists: torch.Tensor, k: int, route_name: str | None = None
                ) -> dict:
    """The launch's shape-only plan: ``route`` (:func:`route` unless
    ``route_name`` names one; neither route has scratch). Reads shapes
    only (meta tensors do); raises ``ValueError`` where the route cannot
    take the shapes."""
    qn, n = dists.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, L={n}]")
    if n >= _MAX_LEN:
        raise ValueError(f"L={n}: a column must fit 31 bits")
    name = route_name or route(qn, n, k)
    if name not in ROUTES:
        raise ValueError(f"unknown route {name}; one of {ROUTES}")
    if name == "warp" and k > MAX_WARP_K:
        raise ValueError(f"the warp route takes k <= {MAX_WARP_K}, got {k}")
    return {"route": name}


def topk_cuda(dists: torch.Tensor, labels: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """dists [Q,L] f32, labels [Q,L] i32 on one CUDA device -> (dists
    [Q,k], labels [Q,k]), ``1 <= k <= L``. The route is
    :func:`launch_plan`'s. Launches on the current stream and raises if a
    launch is refused."""
    return topk_route(None, dists, labels, k)


def topk_route(route_name: str | None, dists: torch.Tensor,
               labels: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_cuda` on the named route (``None``: the shapes' own),
    so that every route can be held to the same inputs."""
    global launches, launches_warp, launches_block
    dev = dists.device
    check_operand("dists", dists, dev, torch.float32, 2)
    check_operand("labels", labels, dev, torch.int32, 2)
    check_operands(dists, labels, k)
    plan = launch_plan(dists, k, route_name)
    qn, n = dists.shape
    out_d = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_l = torch.empty((qn, k), dtype=torch.int32, device=dev)
    name = plan["route"]
    with torch.cuda.device(dev):
        err = _fn(name)(dists.data_ptr(), labels.data_ptr(), out_d.data_ptr(),
                        out_l.data_ptr(), qn, n, k, _build.stream_of(dev))
    if err:
        raise RuntimeError(f"topk ({name}) launch failed: cudaError {err}")
    if qn:                            # the C side launches nothing for 0
        launches += 1
        if name == "warp":
            launches_warp += 1
        else:
            launches_block += 1
    return out_d, out_l
