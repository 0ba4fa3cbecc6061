"""Row-wise k smallest: the hand-written CUDA kernel's wrapper.

Replaces ``repro/kernels/topk/topk.py::topk_pallas``, with the semantics
of its plain version (``ref.topk_ref``: total order, lower column on
ties, a chosen ``+inf`` keeps its label). The kernel is ``csrc/topk.cu``:
one block per row, each thread keeping the 16 smallest keys of its
strided slice in registers, then ``k`` rounds of a block-wide minimum.
It does not copy the Pallas kernel's masking, which can pick an already
extracted column again once a row has fewer than ``k`` finite entries.

What bounds it on an H100: bytes, one read of each row's distances (plus
the ``k`` labels and outputs); the row is read once when ``k <= 16``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.topk.ref import check_operands

launches = 0            # kernel launches made by this wrapper

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("topk").topk_launch
    fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def topk_cuda(dists: torch.Tensor, labels: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """dists [Q,L] f32, labels [Q,L] i32 on one CUDA device -> (dists
    [Q,k], labels [Q,k]), ``1 <= k <= L``. Launches on the current stream
    and raises if the launch is refused."""
    global launches
    dev = dists.device
    check_operand("dists", dists, dev, torch.float32, 2)
    check_operand("labels", labels, dev, torch.int32, 2)
    check_operands(dists, labels, k)
    qn, n = dists.shape
    if n >= 2 ** 31 - 1024:
        raise ValueError(f"L={n}: a column must fit 31 bits")
    out_d = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_l = torch.empty((qn, k), dtype=torch.int32, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dists.data_ptr(), labels.data_ptr(), out_d.data_ptr(),
                 out_l.data_ptr(), qn, n, k, stream)
    if err:
        raise RuntimeError(f"topk launch failed: cudaError {err}")
    if qn:                            # the C side launches nothing for 0
        launches += 1
    return out_d, out_l
