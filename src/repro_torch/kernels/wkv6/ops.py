"""Public entry point of the WKV6 recurrence, dispatched by device.

Counterpart of ``repro/kernels/wkv6/ops.py::wkv6``, with the initial
state in and the final state out. A CPU tensor takes the plain version
(``ref.wkv6_ref``); a CUDA tensor launches the hand-written kernel
(``wkv6.wkv6_cuda``) or raises. There is no fallback from the card to the
plain version. The launch count lives on the kernel's wrapper
(``wkv6.launches``). A ``meta`` tensor takes the ``meta`` route
(``kernels._meta``): empty outputs of the kernel's shapes, and
:func:`work` recorded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _meta
from repro_torch.kernels.wkv6 import wkv6 as kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, w [B,T,H,dk]; v [B,T,H,dv]; u [H,dk]; s0 [B,H,dk,dv], all
    float32 -> (y [B,T,H,dv], s_T [B,H,dk,dv])."""
    if r.device.type == "meta":
        bytes_, flops, _ = work(r, k, v, w, u, s0)
        return _meta.outputs("wkv6", flops, bytes_, (r, k, v, w, u, s0),
                             (v, s0))
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    return kernel.wkv6_cuda(*(x.contiguous() for x in (r, k, v, w, u, s0)))


def work(r, k, v, w, u, s0) -> tuple:
    """(bytes, flops, 0) of one call: r, k, v, w, y once, u, s0 and s_T
    once; per (step, head) 5 flops a state element (2 for r . S, 3 for
    S = w S + k v) and the bonus as a scalar times v (3 a row of k, 2 a
    column)."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    bytes_ = 4 * (b * t * h * (3 * dk + 2 * dv) + h * dk + 2 * b * h * dk * dv)
    return bytes_, b * t * h * (5 * dk * dv + 3 * dk + 2 * dv), 0
