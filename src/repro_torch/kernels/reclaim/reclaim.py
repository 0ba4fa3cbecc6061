"""Slab reclamation on the card: the hand-written CUDA kernel's wrapper.

Not a port of a TPU kernel. It replaces the sequential part of the
reference delete's ``fori_loop`` (``repro/core/index.py:361-401``): the
unlink, dense-table swap-with-last and free-stack push of the slabs that a
delete batch reclaims. ``csrc/reclaim.cu`` runs them on one thread in row
order and reads the slab count from device memory, so a delete never
waits for the host. What bounds it is the latency of about 20 dependent
global accesses per reclaimed slab. Its plain version is ``ref.reclaim_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0        # kernel launches made by this wrapper

_P = ctypes.c_void_p


def _fn():
    fn = _build.load("reclaim").reclaim_launch
    fn.argtypes = [_P] * 12 + [ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return fn


def reclaim_cuda(slabs: torch.Tensor, count: torch.Tensor,
                 heads: torch.Tensor, nxt: torch.Tensor, prv: torch.Tensor,
                 owner: torch.Tensor, cursor: torch.Tensor,
                 free_stack: torch.Tensor, free_top: torch.Tensor,
                 tables: torch.Tensor, table_len: torch.Tensor,
                 table_pos: torch.Tensor) -> None:
    """Reclaim ``slabs[:count]`` in place; every operand int32, contiguous,
    on one CUDA device (``count`` and ``free_top`` hold one value each)."""
    global launches
    ops = (slabs, count, heads, nxt, prv, owner, cursor, free_stack,
           free_top, tables, table_len, table_pos)
    for t in ops:
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                "reclaim_cuda takes contiguous int32 CUDA tensors, got "
                f"{t.dtype} on {t.device}; the CPU path is ref.reclaim_ref")
    if {t.device for t in ops} != {slabs.device}:
        raise ValueError("all operands must be on one device")
    if count.numel() != 1 or free_top.numel() != 1 or tables.dim() != 2:
        raise ValueError("count and free_top hold one value; tables is 2-D")
    fn = _fn()
    with torch.cuda.device(slabs.device):
        err = fn(*(t.data_ptr() for t in ops), tables.shape[1],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"reclaim launch failed: cudaError {err}")
    launches += 1
