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
