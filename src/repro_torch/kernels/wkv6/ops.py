"""Public entry point of the WKV6 recurrence, dispatched by device.

Counterpart of ``repro/kernels/wkv6/ops.py::wkv6``, with the initial
state in and the final state out. A CPU tensor takes the plain version
(``ref.wkv6_ref``); a CUDA tensor launches the hand-written kernel
(``wkv6.wkv6_cuda``) or raises. There is no fallback from the card to the
plain version. The launch count lives on the kernel's wrapper
(``wkv6.launches``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6 import wkv6 as kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, w [B,T,H,dk]; v [B,T,H,dv]; u [H,dk]; s0 [B,H,dk,dv], all
    float32 -> (y [B,T,H,dv], s_T [B,H,dk,dv])."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    return kernel.wkv6_cuda(*(x.contiguous() for x in (r, k, v, w, u, s0)))
