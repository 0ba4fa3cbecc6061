"""Plain PyTorch attention: the oracle for ``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention/ref.py::mha_ref``: the
whole score matrix in float32, GQA by repeating K/V heads, causal masking
aligned at the ends (q row i sits at absolute position ``i + Sk - Sq``),
any ``Sq, Sk >= 1``.
"""
from __future__ import annotations

import torch


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> None:
    """Raise unless q [B,Hq,Sq,dh] and k, v [B,Hkv,Sk,dh] share a dtype
    (float32 or bfloat16), Hkv divides Hq, and Sq, Sk >= 1."""
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"want one float32 or bfloat16 dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Hq,Sq,dh] and k, v [B,Hkv,Sk,dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                         "batch, head_dim or head grouping disagree")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError("Sq and Sk must be at least 1")


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, scale: float | None = None
            ) -> torch.Tensor:
    """q [B,Hq,Sq,dh]; k,v [B,Hkv,Sk,dh] -> [B,Hq,Sq,dh] in q's dtype."""
    check_operands(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    kq = k.repeat_interleave(g, dim=1).float()
    vq = v.repeat_interleave(g, dim=1).float()
    s = torch.matmul(q.float(), kq.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.matmul(p, vq).to(q.dtype)


def mha_p_bf16_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: float | None = None,
                   terms: int = 2) -> torch.Tensor:
    """:func:`mha_ref` with P carried to ``P V`` in bf16: scores and
    softmax in float32, the row sum from the float32 P, and P as
    ``terms`` bf16 terms (1: ``bf16(P)``, as ``scaled_dot_product_attention``
    rounds it; 2: ``hi + bf16(P - hi)``, as the tensor-core route of
    ``csrc/flash_attention.cu`` does). Used by the tests and the chip
    smoke run."""
    check_operands(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    kq = k.repeat_interleave(g, dim=1).float()
    vq = v.repeat_interleave(g, dim=1).float()
    s = torch.matmul(q.float(), kq.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    carried = torch.zeros_like(p)
    for _ in range(terms):
        carried += (p - carried).to(torch.bfloat16).float()
    return (torch.matmul(carried, vq) / l).to(q.dtype)
