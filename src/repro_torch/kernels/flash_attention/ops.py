"""Public entry point of the tiled attention, dispatched by device.

Counterpart of ``repro/kernels/flash_attention/ops.py::flash_attention``.
A CPU tensor takes the plain version (``ref.mha_ref``); a CUDA tensor
launches the hand-written kernel (``flash_attention.flash_attention_cuda``)
or raises. There is no fallback from the card to the plain version. The
launch count lives on the kernel's wrapper (``flash_attention.launches``).
A ``meta`` tensor takes the ``meta`` route (``kernels._meta``): an empty
output of the kernel's shape, and :func:`work` recorded.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _meta
from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.flash_attention.ref import mha_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None
                    ) -> torch.Tensor:
    """q [B,Hq,Sq,dh]; k, v [B,Hkv,Sk,dh] -> [B,Hq,Sq,dh]."""
    if q.device.type == "meta":
        bytes_, flops = work(q, k, causal)
        _meta.record("flash_attention", flops, bytes_)
        return q.new_empty(q.shape)
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, scale=scale)
    return kernel.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal, scale)


def work(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
         dv: int | None = None) -> tuple:
    """(bytes, flops) one call must move and do: q, k, v and the output
    once; ``q k`` of dh and ``P v`` of ``dv`` (the V width the function
    needs, dh unless given: MLA pads V from 64 to 96 and needs only 64)
    per visible (q row, k column) pair and q head (causal rows aligned at
    the ends, as the kernel masks them)."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = dh if dv is None else dv
    rows = np.arange(sq) + (sk - sq)
    visible = int(np.clip(rows + 1, 0, sk).sum()) if causal else sq * sk
    es = q.element_size()
    return ((b * hq * sq * (dh + dv) + b * hkv * sk * (dh + dv)) * es,
            2 * b * hq * (dh + dv) * visible)
