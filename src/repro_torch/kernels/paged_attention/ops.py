"""Public entry point of the paged decode attention, dispatched by device.

Counterpart of ``repro/kernels/paged_attention/ops.py::paged_attention``.
A CPU tensor takes the plain version (``ref.paged_attention_ref``); a
CUDA tensor launches the hand-written kernel
(``paged_attention.paged_attention_cuda``) or raises. There is no
fallback from the card to the plain version. The launch count lives on
the kernel's wrapper (``paged_attention.launches``). A ``meta`` tensor
takes the ``meta`` route (``kernels._meta``): an empty output of the
kernel's shape, and :func:`work` recorded with every slot of the block
table live (``meta`` tensors hold no lengths).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _meta
from repro_torch.kernels.paged_attention import paged_attention as kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, starts: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q [B,Hq,dk]; pages [P,page,Hkv,dk|dv]; tables [B,maxp] (-1 pad);
    lengths, starts [B] -> [B,Hq,dv]; the window is
    ``starts <= slot < lengths``."""
    if q.device.type == "meta":
        live = block_tables.numel() * k_pages.shape[1]
        bytes_, flops = work(q, k_pages, v_pages, block_tables, live)
        _meta.record("paged_attention", flops, bytes_)
        return q.new_empty(q.shape[:2] + (v_pages.shape[-1],))
    if starts is None:
        starts = torch.zeros_like(lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, starts, scale)
    return kernel.paged_attention_cuda(
        q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
        block_tables.contiguous(), lengths.contiguous(), starts.contiguous(),
        scale)


def work(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
         block_tables: torch.Tensor, live: int) -> tuple:
    """(bytes, flops) one call must move and do over ``live`` window slots
    (a slot whose table entry is -1 is no work): each live K/V row read
    once, q, the tables and the output once; ``q k`` of dk and ``P v`` of
    dv per live slot and q head."""
    hkv, dk = k_pages.shape[2:]
    dv = v_pages.shape[-1]
    b, hq, _ = q.shape
    es = q.element_size()
    bytes_ = live * hkv * (dk + dv) * es + 2 * b * hq * max(dk, dv) * es \
        + block_tables.numel() * 4 + 2 * b * 4
    return bytes_, live * hq * 2 * (dk + dv)
