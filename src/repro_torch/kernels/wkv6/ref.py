"""Plain PyTorch WKV6 recurrence: the oracle for ``csrc/wkv6.cu``.

Counterpart of ``repro/kernels/wkv6/ref.py::wkv6_ref`` and of the
reference's ``models/rwkv.py::_wkv_sequential``: one step at a time over
all of T (any T >= 1, no chunking), per (batch, head)::

    y_t = (S + diag(u) k_t^T v_t)^T r_t
    S  <- diag(w_t) S + k_t^T v_t

from the initial state ``s0`` (zero when not given, the reference's
prefill), returning the output and the final state, both float32.
"""
from __future__ import annotations

import torch


def check_operands(r, k, v, w, u, s0) -> None:
    """Raise unless r, k, w [B,T,H,dk], v [B,T,H,dv], u [H,dk] and
    s0 [B,H,dk,dv] are float32 with T >= 1."""
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if r.dim() != 4 or r.shape[1] < 1:
        raise ValueError(f"r must be [B,T>=1,H,dk], got {tuple(r.shape)}")
    b, t, h, dk = r.shape
    dv = v.shape[-1] if v.dim() == 4 else -1
    for name, x, shape in (("k", k, (b, t, h, dk)), ("w", w, (b, t, h, dk)),
                           ("v", v, (b, t, h, dv)), ("u", u, (h, dk)),
                           ("s0", s0, (b, h, dk, dv))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


def wkv6_ref(r, k, v, w, u, s0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, w [B,T,H,dk]; v [B,T,H,dv]; u [H,dk]; s0 [B,H,dk,dv] ->
    (y [B,T,H,dv], s_T [B,H,dk,dv])."""
    if s0 is None:
        s0 = r.new_zeros((r.shape[0], r.shape[2], r.shape[3], v.shape[-1]))
    check_operands(r, k, v, w, u, s0)
    s, bonus, ys = s0, u[None, :, :, None], []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B,H,dk,dv]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + bonus * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s
