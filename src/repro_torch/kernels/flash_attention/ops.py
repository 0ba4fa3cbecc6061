"""Public entry point of the tiled attention, dispatched by device.

Counterpart of ``repro/kernels/flash_attention/ops.py::flash_attention``.
A CPU tensor takes the plain version (``ref.mha_ref``); a CUDA tensor
launches the hand-written kernel (``flash_attention.flash_attention_cuda``)
or raises. There is no fallback from the card to the plain version. The
launch count lives on the kernel's wrapper (``flash_attention.launches``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.flash_attention.ref import mha_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """q [B,Hq,Sq,dh]; k, v [B,Hkv,Sk,dh] -> [B,Hq,Sq,dh]."""
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, scale=scale)
    return kernel.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal, scale)
