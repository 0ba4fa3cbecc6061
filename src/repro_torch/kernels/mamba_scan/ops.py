"""Public entry point of the selective scan, dispatched by device.

Counterpart of ``repro/kernels/mamba_scan/ops.py::mamba_scan``, with the
initial state in and the final state out. A CPU tensor takes the plain
version (``ref.mamba_scan_ref``); a CUDA tensor launches the hand-written
kernel (``mamba_scan.mamba_scan_cuda``) or raises. There is no fallback
from the card to the plain version. The launch count lives on the
kernel's wrapper (``mamba_scan.launches``). A ``meta`` tensor takes the
``meta`` route (``kernels._meta``): empty outputs of the kernel's
shapes, and :func:`work` recorded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _meta
from repro_torch.kernels.mamba_scan import mamba_scan as kernel
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


def mamba_scan(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u, delta [B,T,di]; a [di,n]; b, c [B,T,n]; d [di]; h0 [B,di,n], all
    float32 -> (y [B,T,di], h_T [B,di,n])."""
    if u.device.type == "meta":
        bytes_, flops, _ = work(u, delta, a, b, c, d, h0)
        return _meta.outputs("mamba_scan", flops, bytes_,
                             (u, delta, a, b, c, d, h0), (u, h0))
    if u.device.type == "cpu":
        return mamba_scan_ref(u, delta, a, b, c, d, h0)
    return kernel.mamba_scan_cuda(
        *(x.contiguous() for x in (u, delta, a, b, c, d, h0)))


def work(u, delta, a, b, c, d, h0) -> tuple:
    """(bytes, flops, exps) of one call: u, delta, y once, a, b, c, d
    once, h0 and h_T once; per (step, channel, state element) 6 flops and
    one exp, per (step, channel) 3 flops."""
    bsz, t, di = u.shape
    n = a.shape[1]
    bytes_ = 4 * (3 * bsz * t * di + di * n + 2 * bsz * t * n + di
                  + 2 * bsz * di * n)
    return bytes_, bsz * t * di * (6 * n + 3), bsz * t * di * n
