"""Public entry point of the paged decode attention, dispatched by device.

Counterpart of ``repro/kernels/paged_attention/ops.py::paged_attention``.
A CPU tensor takes the plain version (``ref.paged_attention_ref``); a
CUDA tensor launches the hand-written kernel
(``paged_attention.paged_attention_cuda``) or raises. There is no
fallback from the card to the plain version. The launch count lives on
the kernel's wrapper (``paged_attention.launches``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import paged_attention as kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, starts: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q [B,Hq,dk]; pages [P,page,Hkv,dk|dv]; tables [B,maxp] (-1 pad);
    lengths, starts [B] -> [B,Hq,dv]; the window is
    ``starts <= slot < lengths``."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, starts, scale)
    return kernel.paged_attention_cuda(
        q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
        block_tables.contiguous(), lengths.contiguous(), starts.contiguous(),
        scale)
