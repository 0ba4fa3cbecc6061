"""One-token decode attention over a paged KV cache: the hand-written
CUDA kernel's wrapper.

Replaces ``repro/kernels/paged_attention/paged_attention.py::
paged_attention_pallas`` with the semantics of its plain version
(``ref.paged_attention_ref``). The kernel is ``csrc/paged_attention.cu``:
one block per (KV head, sequence) serving that head's ``g`` query heads,
so each live page row is read once; the sequence's table entries are
walked in 32-slot chunks staged in shared memory as float32, one warp per
query head keeping the online softmax.

What bounds it on an H100: bytes, each live K/V row of the window read
once (``sum(length - start) * Hkv * (dk + dv)`` elements).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operand
from repro_torch.kernels.paged_attention.ref import check_operands

launches = 0            # kernel launches made by this wrapper

SMEM_LIMIT = 232448 - 256     # an H100 block's shared memory, less the
                              # kernel's static row table
_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


def smem_bytes(hq: int, hkv: int, dk: int, dv: int) -> int:
    """Dynamic shared memory of one block (``csrc/paged_attention.cu``)."""
    g = hq // hkv
    return 4 * (32 * (dk + 1) + 32 * dv + g * (dk + dv) + 2 * g)


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor, starts: torch.Tensor,
                         scale: float | None = None) -> torch.Tensor:
    """q [B,Hq,dk]; pages [P,page,Hkv,dk|dv]; int32 tables [B,maxp],
    lengths and starts [B]; all contiguous on one CUDA device -> [B,Hq,dv]
    in q's dtype. Launches on the current stream and raises if the launch
    is refused."""
    global launches
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths),
                    ("starts", starts)):
        check_operand(name, t, dev)
    check_operands(q, k_pages, v_pages, block_tables, lengths, starts)
    b, hq, dk = q.shape
    n_pages, page, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    maxp = block_tables.shape[1]
    if not (1 <= dk <= 512 and 1 <= dv <= 512):
        raise ValueError(f"dk={dk}, dv={dv} must lie in [1, 512]")
    if smem_bytes(hq, hkv, dk, dv) > SMEM_LIMIT:
        raise ValueError(f"Hq/Hkv={hq // hkv} with dk={dk}, dv={dv} needs "
                         "more shared memory than a block has")
    if maxp * page >= 2 ** 31:
        raise ValueError("maxp * page must fit 31 bits")
    scale = dk ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, dv), dtype=q.dtype, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(),
                 starts.data_ptr(), out.data_ptr(), b, hq, hkv, dk, dv,
                 page, maxp, float(scale), int(q.dtype == torch.bfloat16),
                 stream)
    if err:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    if b and hq:                      # the C side launches nothing for 0
        launches += 1
    return out
