"""Plain PyTorch selective scan: the oracle for ``csrc/mamba_scan.cu``.

Counterpart of ``repro/kernels/mamba_scan/ref.py::mamba_scan_ref`` and of
the reference's ``models/mamba.py::_ssm_sequential``: one step at a time
over all of T (any T >= 1, no chunking)::

    h_t = exp(delta_t * a) * h_{t-1} + (delta_t * u_t) b_t^T
    y_t = h_t c_t + d * u_t

from the initial state ``h0`` (zero when not given, the reference's
prefill), returning the output and the final state, both float32.
"""
from __future__ import annotations

import torch


def check_operands(u, delta, a, b, c, d, h0) -> None:
    """Raise unless u, delta [B,T,di], a [di,n], b, c [B,T,n], d [di] and
    h0 [B,di,n] are float32 with T >= 1."""
    for name, x in (("u", u), ("delta", delta), ("a", a), ("b", b),
                    ("c", c), ("d", d), ("h0", h0)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if u.dim() != 3 or u.shape[1] < 1 or a.dim() != 2:
        raise ValueError(f"want u [B,T>=1,di] and a [di,n], got "
                         f"{tuple(u.shape)}, {tuple(a.shape)}")
    bsz, t, di = u.shape
    n = a.shape[1]
    for name, x, shape in (("delta", delta, (bsz, t, di)), ("a", a, (di, n)),
                           ("b", b, (bsz, t, n)), ("c", c, (bsz, t, n)),
                           ("d", d, (di,)), ("h0", h0, (bsz, di, n))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


def mamba_scan_ref(u, delta, a, b, c, d, h0=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """u, delta [B,T,di]; a [di,n]; b, c [B,T,n]; d [di]; h0 [B,di,n] ->
    (y [B,T,di], h_T [B,di,n])."""
    if h0 is None:
        h0 = u.new_zeros((u.shape[0], u.shape[2], a.shape[1]))
    check_operands(u, delta, a, b, c, d, h0)
    h, ys = h0, []
    for t in range(u.shape[1]):
        dt = delta[:, t]                                     # [B,di]
        h = torch.exp(dt[..., None] * a) * h \
            + (dt * u[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, 1) + d * u, h


def mamba_scan_split_ref(u, delta, a, b, c, d, h0=None, elems: int = 4,
                         channels: int = 32
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/mamba_scan.cu``'s order of operations in plain PyTorch, the
    same function as :func:`mamba_scan_ref`: the channels in groups of
    ``channels`` (the last one partial where it does not divide di), each
    channel's state in lanes of ``elems`` consecutive elements; the state
    update rounds as :func:`mamba_scan_ref`'s, and y is each lane's
    partial ``sum_i h_i c_i`` in element order, then the lanes in
    ascending order, plus ``d u``."""
    if h0 is None:
        h0 = u.new_zeros((u.shape[0], u.shape[2], a.shape[1]))
    check_operands(u, delta, a, b, c, d, h0)
    n = a.shape[1]
    lanes = [range(lo, min(n, lo + elems)) for lo in range(0, n, elems)]
    y, h = torch.empty_like(u), h0.clone()
    for c0 in range(0, u.shape[2], channels):
        cg = slice(c0, c0 + channels)
        hg = h[:, cg]
        for t in range(u.shape[1]):
            dt, ut = delta[:, t, cg], u[:, t, cg]
            hg = torch.exp(dt[..., None] * a[cg]) * hg \
                + (dt * ut)[..., None] * b[:, t, None, :]
            prod = hg * c[:, t, None, :]
            acc = None
            for lane in lanes:
                part = prod[..., lane[0]]
                for i in lane[1:]:
                    part = part + prod[..., i]
                acc = part if acc is None else acc + part
            y[:, t, cg] = acc + d[cg] * ut
        h[:, cg] = hg
    return y, h
