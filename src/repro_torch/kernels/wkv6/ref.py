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


def wkv6_split_ref(r, k, v, w, u, s0=None, rows: int = 4, cols: int = 32,
                   chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/wkv6.cu``'s order of operations in plain PyTorch, the same
    function as :func:`wkv6_ref`: the state's columns in groups of
    ``cols`` (the last one partial where ``cols`` does not divide dv),
    its rows in slices of ``rows``; per step each slice's partial
    ``sum_i r_i S_ij`` in row order, kept for the chunk of ``chunk``
    steps, then summed slice by slice in ascending order, plus the
    factored bonus ``beta_t v_j`` with ``beta_t = sum_i r_i u_i k_i``."""
    if s0 is None:
        s0 = r.new_zeros((r.shape[0], r.shape[2], r.shape[3], v.shape[-1]))
    check_operands(r, k, v, w, u, s0)
    b, steps, h, dk = r.shape
    dv = v.shape[-1]
    if dk % rows:
        raise ValueError(f"rows={rows} must divide dk={dk}")
    slices = dk // rows
    beta = (r * u * k).sum(-1)                               # [B,T,H]
    y, s = r.new_empty((b, steps, h, dv)), s0.clone()
    for c0 in range(0, dv, cols):
        cg = slice(c0, c0 + cols)
        sg = s[..., cg]                                      # [B,H,dk,cg]
        for t0 in range(0, steps, chunk):
            parts = []
            for t in range(t0, min(steps, t0 + chunk)):
                prod = (r[:, t, :, :, None] * sg).unflatten(2, (slices, rows))
                acc = prod[:, :, :, 0]
                for i in range(1, rows):
                    acc = acc + prod[:, :, :, i]
                parts.append(acc)                            # [B,H,sl,cg]
                sg = w[:, t, :, :, None] * sg \
                    + k[:, t, :, :, None] * v[:, t, :, None, cg]
            for tt, part in enumerate(parts, t0):
                acc = part[:, :, 0]
                for sl in range(1, slices):
                    acc = acc + part[:, :, sl]
                y[:, tt, :, cg] = acc + beta[:, tt, :, None] * v[:, tt, :, cg]
        s[..., cg] = sg
    return y, s
