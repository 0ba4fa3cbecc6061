"""Grouped-query attention, full-sequence (prefill) and paged decode.

Counterpart of the GQA half of ``repro/models/attention.py``: ``init_gqa``,
``_head_mask``, ``_gqa_qkv`` (qk-norm included), ``gqa_full`` and
``gqa_decode_paged``. MLA, cross-attention and the dense-cache
``gqa_decode`` are not ported.

``impl`` picks the attention arithmetic:
  * ``"kernel"`` (default): the ops entry points, which dispatch by device,
    so the hand-written kernels run on the card (``ops.flash_attention``
    on ``[B,H,S,dh]`` as the reference's ``gqa_full(impl="pallas")``
    does, ``ops.paged_attention``) and the plain versions on the CPU;
  * ``"ref"``: the plain versions on any device, named by callers that
    hold the kernels against them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.common import (
    apply_rope,
    dense,
    dense_init,
    param_group,
    rms_norm_1d,
)
from repro_torch.sharding.rules import ShardPlan

IMPLS = ("kernel", "ref")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: want one of {IMPLS}")


def _head_mask(plan: ShardPlan, n_real: int, device=None) -> torch.Tensor:
    """[H_pad] 1.0 for real heads, 0.0 for padding heads."""
    return (torch.arange(plan.n_heads_padded, device=device) < n_real
            ).to(torch.float32)


def init_gqa(gen: torch.Generator, cfg: ModelConfig, plan: ShardPlan,
             device, dtype=torch.float32) -> nn.ParameterDict:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = plan.n_heads_padded, plan.n_kv_heads_padded
    p = {"wq": dense_init(gen, d, hq * dh, device, dtype),
         "wk": dense_init(gen, d, hkv * dh, device, dtype),
         "wv": dense_init(gen, d, hkv * dh, device, dtype),
         "wo": dense_init(gen, hq * dh, d, device, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
    return param_group(**p)


def _gqa_qkv(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
             positions: torch.Tensor, rope: bool = True):
    """x [B,S,d] -> q [B,S,Hq,dh], k and v [B,S,Hkv,dh]."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    hq, hkv = plan.n_heads_padded, plan.n_kv_heads_padded
    q = dense(p["wq"], x).reshape(b, s, hq, dh)
    k = dense(p["wk"], x).reshape(b, s, hkv, dh)
    v = dense(p["wv"], x).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm_1d(q, p["q_norm"])
        k = rms_norm_1d(k, p["k_norm"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_full(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
             positions: torch.Tensor, causal: bool = True,
             impl: str = "kernel"):
    """Full-sequence attention. Returns (out [B,S,d], (k, v) for caching,
    each [B,S,Hkv,dh])."""
    check_impl(impl)
    b, s, _ = x.shape
    dh = cfg.head_dim
    q, k, v = _gqa_qkv(p, cfg, plan, x, positions)
    attend = flash_ops.flash_attention if impl == "kernel" else mha_ref
    o = attend(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
               v.transpose(1, 2).contiguous(), causal=causal).transpose(1, 2)
    o = o * _head_mask(plan, cfg.n_heads, x.device)[None, None, :, None].to(
        o.dtype)
    o = o.reshape(b, s, plan.n_heads_padded * dh)
    return dense(p["wo"], o), (k, v)


def paged_write_rows(tables: torch.Tensor, lengths: torch.Tensor,
                     starts: torch.Tensor, page: int):
    """Where each sequence's new token goes: ``(rows, pages, slots)`` of the
    rows that write. A row writes when the table entry of its slot
    ``lengths // page`` holds a page and its window is not past its end
    (``lengths >= starts``); the reference sends the other rows to a
    dropped index. Sequences never share a page, so the targets are
    distinct. Same for every layer: compute it once per decode step."""
    b = tables.shape[0]
    pslot = (lengths // page).clamp(0, tables.shape[1] - 1).long()
    pidx = tables[torch.arange(b, device=tables.device), pslot]
    ok = (pidx >= 0) & (lengths >= starts)
    rows = torch.nonzero(ok).flatten()
    return rows, pidx[rows].long(), (lengths[rows] % page).long()


def gqa_decode_paged(p, cfg: ModelConfig, plan: ShardPlan, x: torch.Tensor,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     tables: torch.Tensor, lengths: torch.Tensor,
                     starts: torch.Tensor, positions: torch.Tensor,
                     write: tuple, impl: str = "kernel"):
    """One-token decode over the slab-paged KV cache.

    x [B,1,d]; k_pages/v_pages [n_pages, page, Hkv, dh] (one layer's pool,
    updated in place: the new token's K/V go into their page slot, a
    masked write of the rows that write); tables [B, maxp] int32;
    lengths/starts [B] int32 cache-coordinate window; positions [B]
    absolute positions for RoPE; ``write`` the step's
    :func:`paged_write_rows`. Returns (out [B,1,d], k_pages, v_pages).
    """
    check_impl(impl)
    b = x.shape[0]
    q, k_new, v_new = _gqa_qkv(p, cfg, plan, x, positions[:, None])
    rows, pages, slots = write
    k_pages[pages, slots] = k_new[rows, 0].to(k_pages.dtype)
    v_pages[pages, slots] = v_new[rows, 0].to(v_pages.dtype)
    attend = paged_ops.paged_attention if impl == "kernel" \
        else paged_attention_ref
    o = attend(q[:, 0].contiguous(), k_pages, v_pages, tables, lengths + 1,
               starts)
    o = o * _head_mask(plan, cfg.n_heads, x.device)[None, :, None].to(
        o.dtype)
    return dense(p["wo"], o.reshape(b, 1, -1)), k_pages, v_pages
